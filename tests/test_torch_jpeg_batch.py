"""The batched JPEG pixel stage (``ops/kernels/jpeg.py``: J1, one launch per
batch of images) on the CPU.

* A mixed batch (gray, 4:2:0, 4:4:4, CMYK, YCCK, progressive files cut
  short, the 1280x960 one smoothed, an arithmetic-coded file, MJPEG frames, an EXIF-rotated file; 180x240 and
  1280x960) through the batched entry points decodes, in both of OpenCV's
  modes, to exactly what the JAX package's ``load_img`` (cv2.imread) and
  ``serving._decode_image`` (cv2.imdecode) give: tolerance 0.
* The tile plan that the kernel reads (``plan_batch``, and ``tile_plan``,
  the kernel's per-tile arithmetic) covers every pixel of every image once,
  and every sample a tile's pixels read lies in the blocks it transforms,
  in its shared-memory region and inside the image.
* J1's CTAs run on the host (``csrc/jpeg.cu`` built by g++,
  ``scl_jpeg_pixels_host``: the kernel's own steps, thread by thread) are
  bit-equal to the plain stage on the fixtures, alone and batched, and on
  random coefficients over sampling layouts, orientations, the block
  smoothing and blocks whose IDCT leaves int32.
* A refused file in a batch raises, naming it; ``extract_files`` over the
  fixtures and the service's ``/embed_batch`` equal the JAX package's within
  1e-5 (the frameworks sum in other orders).
"""

import base64
import dataclasses
import json
import shutil
import threading
import urllib.error
import urllib.request
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from flax import traverse_util

from soft_contrastive_learning_torch import serving
from soft_contrastive_learning_torch.core.config import ModelConfig
from soft_contrastive_learning_torch.evaluation.inference import DescriptorExtractor
from soft_contrastive_learning_torch.models.weights import params_from_flax
from soft_contrastive_learning_torch.ops.kernels import jpeg as kjpeg
from soft_contrastive_learning_torch.utils import jpeg
from soft_contrastive_learning_torch.utils.io import (
    decode_img, decode_imgs, finish_imgs, prepare_img, save_img)
from soft_contrastive_learning_tpu import serving as jserving
from soft_contrastive_learning_tpu.core import config as jcfg
from soft_contrastive_learning_tpu.evaluation import inference as jinference
from soft_contrastive_learning_tpu.models.model import init_params as jax_init_params
from soft_contrastive_learning_tpu.utils.io import load_img as jax_load_img

torch.set_num_threads(1)  # tier-1 runs several workers on one host

FIXTURES = Path(__file__).resolve().parents[1] / "soft_contrastive_learning_torch" / "assets" / "jpeg"
DIGESTS = json.loads((FIXTURES / "digests.json").read_text())
MIXED = ("gray.jpg", "c420_q95.jpg", "c444.jpg", "cmyk_pil.jpg", "ycck_420.jpg",
         "progressive_cut_2_3.jpg", "c420_q95_arith.jpg", "mjpeg_180x240.jpg", "orient6.jpg",
         "frame_1280x960.jpg", "frame_progressive_cut.jpg", "mjpeg_1280x960.jpg")
# (h, v) of the first component and of the others
LAYOUTS = (((2, 2), (1, 1)), ((2, 1), (1, 1)), ((1, 2), (1, 1)), ((1, 1), (1, 1)),
           ((4, 1), (1, 1)), ((2, 2), (2, 1)), ((3, 1), (1, 1)), ((1, 3), (1, 1)),
           ((4, 4), (1, 1)), ((1, 1), (2, 2)), ((2, 2), (1, 2)), ((1, 1),), ((2, 2),))
SIZES = ((37, 45), (8, 3), (1, 1), (17, 9), (33, 130), (9, 257), (140, 260))
H, W = 32, 40


def _read(name):
    return (FIXTURES / name).read_bytes()


@pytest.fixture(scope="module")
def mixed():
    """The mixed batch's coefficients in each mode (the plain decoder)."""
    return {mode: [jpeg.decode_coefficients(_read(n), n, mode) for n in MIXED]
            for mode in ("file", "buffer")}


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this host: J1's CTAs cannot be built to run on it")
    return kjpeg.build_host_library(tmp_path_factory.mktemp("j1_host"))


def _frame(h, w, layout, nc, colour, orientation):
    comps = [jpeg.Component(i + 1, *(layout[0] if i == 0 else layout[-1]), 0) for i in range(nc)]
    hm, vm = max(c.h for c in comps), max(c.v for c in comps)
    for c in comps:
        c.dw, c.dh = -(-w * c.h // hm), -(-h * c.v // vm)
        if nc == 1:  # a non-interleaved frame of its own blocks
            c.bw, c.bh = -(-c.dw // 8), -(-c.dh // 8)
        else:
            c.bw, c.bh = -(-w // (8 * hm)) * c.h, -(-h // (8 * vm)) * c.v
    return jpeg.Frame(h, w, colour, orientation, comps)


def _random_batch(seed, orientation):
    """Random coefficients over every layout and size at one orientation:
    3- and 4-component colour transforms, block smoothing on some (some
    rows after the last whole iMCU row), and some blocks large enough, or
    tables of 16 bits, that the IDCT leaves int32."""
    rng = np.random.default_rng(seed)
    out = []
    for layout in LAYOUTS:
        for h, w in SIZES:
            nc = 1 if len(layout) == 1 else int(rng.choice([3, 4]))
            colour = (jpeg.GRAY if nc == 1 else
                      int(rng.choice([jpeg.YCC, jpeg.RGB] if nc == 3 else [jpeg.CMYK, jpeg.YCCK])))
            f = _frame(h, w, layout, nc, colour, orientation)
            if rng.random() < 0.4:
                bits = rng.integers(-1, 3, (nc, 20))
                bits[:, 0] = rng.integers(0, 2, nc)
                bits[:, 10] = 0
                if rng.random() < 0.5:
                    bits[1:, 1:10] = -1  # chroma: only the DC known
                f.smoothing = (int(rng.integers(-1, f.imcu_rows + 1)), *bits.flatten().tolist())
            n = f.block_offsets()[-1]
            coefs = np.zeros((n, 64), np.int16)
            coefs[:, 0] = rng.integers(-1100, 1100, n)
            coefs[:, 1:12] = rng.integers(-60, 61, (n, 11))
            if rng.random() < 0.3:
                at = rng.integers(0, n, max(1, n // 7))
                coefs[at] = rng.integers(-32768, 32768, (len(at), 64))
            hi = 65536 if rng.random() < 0.2 else 9
            quant = rng.integers(1, hi, (nc, 64)).astype(np.int32)
            out.append(jpeg.Coefficients(f, coefs, quant))
    return out


def _plain(co):
    return kjpeg._plain(co).numpy()


# ------------------------------------------------------------------ OpenCV's pixels
@pytest.mark.parametrize("mode", ["file", "buffer"])
def test_a_mixed_batch_decodes_to_opencvs_pixels(mixed, mode):
    """The batched entry points on the CPU (``decode_imgs``, and
    ``jpeg_pixels_batch`` / ``jpeg_pixels_host`` of the coefficients) give
    every image of the mixed batch the JAX package's pixels, byte for byte:
    ``load_img`` (cv2.imread) for ``file``, ``serving._decode_image``
    (cv2.imdecode) for ``buffer``."""
    assert any(co.frame.smoothing is not None for co in mixed[mode])
    got = decode_imgs([_read(n) for n in MIXED], list(MIXED), "cpu", source=mode)
    tensors = kjpeg.jpeg_pixels_batch(mixed[mode], "cpu")
    arrays = kjpeg.jpeg_pixels_host(mixed[mode], "cpu")
    for name, img, t, a in zip(MIXED, got, tensors, arrays):
        want = (jax_load_img(str(FIXTURES / name)) if mode == "file"
                else jserving._decode_image(_read(name)))
        np.testing.assert_array_equal(img, want, err_msg=name)
        np.testing.assert_array_equal(t.numpy(), want, err_msg=name)
        np.testing.assert_array_equal(a, want, err_msg=name)


def test_a_batch_of_pngs_and_jpegs_decodes_as_one_by_one(tmp_path):
    """``decode_imgs`` of PNGs and JPEGs mixed equals ``decode_img`` of each,
    in order; ``prepare_img`` gives a PNG's pixels and a JPEG's
    coefficients."""
    rng = np.random.default_rng(3)
    png = tmp_path / "x.png"
    save_img(rng.integers(0, 256, (20, 30, 3), dtype=np.uint8), str(png))
    datas = [_read("c420_q95.jpg"), png.read_bytes(), _read("orient8.jpg"), png.read_bytes()]
    names = ["a", "b", "c", "d"]
    prepared = [prepare_img(d, n, "cpu") for d, n in zip(datas, names)]
    assert [isinstance(p, jpeg.Coefficients) for p in prepared] == [True, False, True, False]
    got = decode_imgs(datas, names, "cpu")
    for d, n, img, again in zip(datas, names, got, finish_imgs(prepared, "cpu")):
        np.testing.assert_array_equal(img, decode_img(d, n, "cpu"))
        np.testing.assert_array_equal(again, img)
    # a JPEG's bytes to a tensor, a batch of one
    np.testing.assert_array_equal(kjpeg.decode_jpeg(datas[2], "c", "cpu").numpy(), got[2])


def test_a_batch_splits_only_past_its_chunk_size(mixed, monkeypatch):
    """``_chunks`` cuts a batch where its coefficients pass ``CHUNK_BYTES``
    (an image larger than that alone is a chunk of its own), and the
    batch's images come back in order."""
    batch = mixed["file"]
    assert kjpeg._chunks(batch) == [batch]
    size = batch[0].coefs.nbytes + batch[1].coefs.nbytes
    monkeypatch.setattr(kjpeg, "CHUNK_BYTES", size)
    chunks = kjpeg._chunks(batch)
    assert [co for c in chunks for co in c] == batch
    assert all(sum(co.coefs.nbytes for co in c) <= size or len(c) == 1 for c in chunks)
    assert len(chunks[0]) == 2 and len(chunks) > 2
    for co, img in zip(batch[:3], kjpeg.jpeg_pixels_host(batch[:3], "cpu")):
        np.testing.assert_array_equal(img, _plain(co))


# ------------------------------------------------------------------ the tile plan
def _reads(lo, n, size, ratio, fancy):
    """The sample indices (along one axis) that pixels lo .. lo + n - 1 read
    through the upsampling: repetition, or the triangle filter's nearer
    sample and its neighbour (clamped to the component's samples)."""
    px = np.arange(lo, lo + n)
    if ratio == 1:
        return px
    if not fancy:
        return px // ratio
    i = px >> 1
    nb = np.where(px & 1, np.minimum(i + 1, size - 1), np.maximum(i - 1, 0))
    return np.concatenate([i, nb])


def _check_plan(frames, fill=0):
    plan = kjpeg.plan_batch(frames, fill)
    assert plan.prefix[0] == 0 and (np.diff(plan.prefix) > 0).all()
    ends = [at + shape[0] * shape[1] * 3 for at, shape in plan.outputs]
    assert all(at % 16 == 0 for at, _ in plan.outputs)
    assert all(e <= at for e, (at, _) in zip(ends, plan.outputs[1:])) and ends[-1] <= plan.out_bytes
    for f, entry, tiles in zip(frames, plan.table, np.diff(plan.prefix)):
        covered = np.zeros((f.height, f.width), np.int32)
        for t in range(tiles):
            (r0, c0, th, tw), comps = kjpeg.tile_plan(entry, t)
            assert th > 0 and tw > 0 and th * tw <= 32 * 128
            covered[r0 : r0 + th, c0 : c0 + tw] += 1
            for c, row, (by0, bx0, by_lo, by_hi, bx_lo, bx_hi) in zip(f.components, entry["c"],
                                                                    comps):
                assert 0 <= by_lo <= by0 < by_hi <= c.bh and 0 <= bx_lo <= bx0 < bx_hi <= c.bw
                rows = _reads(r0, th, c.dh, int(row["vr"]), bool(row["fancy"]))
                cols = _reads(c0, tw, c.dw, int(row["hr"]), bool(row["fancy"]))
                # inside the image, in the blocks the tile transforms, and in its region
                assert rows.min() >= 0 and rows.max() < c.dh and cols.min() >= 0
                assert cols.max() < c.dw
                assert rows.min() >= 8 * by_lo and rows.max() < 8 * by_hi
                assert cols.min() >= 8 * bx_lo and cols.max() < 8 * bx_hi
                assert rows.min() >= 8 * by0 - 1 and rows.max() <= 8 * (by0 + c.v)
                assert cols.min() >= 8 * bx0 - 8 and cols.max() < 8 * (bx0 + entry["span"] * c.h) + 8
        assert (covered == 1).all()
    return plan


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda lay: "x".join(f"{h}{v}" for h, v in lay))
def test_the_tile_plan_covers_every_pixel_once(layout):
    """Every layout at every size and orientation, one batch: the tiles
    cover each image's pixels exactly once, and each tile's reads stay in
    its blocks, its region and the image (``_check_plan``)."""
    frames = [_frame(h, w, layout, 1 if len(layout) == 1 else 3, jpeg.GRAY if len(layout) == 1
                     else jpeg.YCC, o) for h, w in SIZES + ((960, 1280),) for o in range(1, 9)]
    plan = _check_plan(frames)
    assert plan.tiles == sum(f.imcu_rows * entry["spans"] for f, entry in zip(frames, plan.table))


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda lay: "x".join(f"{h}{v}" for h, v in lay))
def test_a_batch_too_small_to_fill_the_card_is_cut_into_narrower_tiles(layout):
    """One image at each size and orientation, planned for a card of 132
    SMs: where 128-pixel tiles give fewer tiles than SMs, the plan halves
    the tiles' width (down to 16 pixels, or one MCU where that is wider)
    until they do, and the narrower tiles pass ``_check_plan``; a batch
    that fills the card keeps 128-pixel tiles."""
    nc = 1 if len(layout) == 1 else 3
    for h, w in SIZES + ((960, 1280),):
        for o in (1, 6):
            f = _frame(h, w, layout, nc, jpeg.GRAY if nc == 1 else jpeg.YCC, o)
            wide, plan = kjpeg.plan_batch([f]), _check_plan([f], fill=132)
            mcu = 8 * int(plan.table[0]["hmax"])
            width = int(plan.table[0]["span"]) * mcu
            assert plan.tiles >= wide.tiles and width <= max(kjpeg.TILE_WIDTH, mcu)
            if wide.tiles >= 132:
                assert plan.tiles == wide.tiles and (plan.table == wide.table).all()
            elif plan.tiles < 132:  # as narrow as it goes
                assert width == max(kjpeg.MIN_TILE_WIDTH, mcu)
            else:  # the widest tiles that fill the card
                assert kjpeg.plan_batch([f], fill=10**6).tiles >= plan.tiles
                half = 2 * width if width < max(kjpeg.TILE_WIDTH, mcu) else None
                assert half is None or kjpeg._entry(kjpeg._key(f), half)[1] < 132


def test_the_tile_plan_of_the_fixtures(mixed):
    """The mixed batch's plan (both modes) passes ``_check_plan``; a smoothed
    image makes the batch take the smoothing instantiation, its DC stage
    more shared memory than it alone needs unsmoothed; one CTA's shared
    memory stays far below the card's 227 KB."""
    for mode in ("file", "buffer"):
        plan = _check_plan([co.frame for co in mixed[mode]])
        plain = kjpeg.plan_batch([co.frame for co in mixed[mode] if co.frame.smoothing is None])
        assert plan.smooth and not plain.smooth and plain.smem <= plan.smem < 48 * 1024
        smoothed = [co.frame for co in mixed[mode] if co.frame.smoothing is not None]
        unsmoothed = [dataclasses.replace(f, smoothing=None) for f in smoothed]
        assert kjpeg.plan_batch(unsmoothed).smem < kjpeg.plan_batch(smoothed).smem


def test_the_plan_refuses_what_the_kernel_does_not_take():
    two = _frame(16, 16, ((2, 2), (1, 1)), 3, jpeg.YCC, 1)
    two.components = two.components[:2]
    with pytest.raises(ValueError, match="2 components"):
        kjpeg.plan_batch([two])


# ------------------------------------------------------------------ J1's CTAs on the host
@pytest.mark.parametrize("mode", ["file", "buffer"])
def test_j1_on_the_host_equals_the_plain_stage_on_the_fixtures(host_lib, mixed, mode):
    """J1's CTAs, run on the host, on every fixture that decodes in ``mode``
    alone, then on all of them in one batch, then on 64 180x240 images in
    one batch: bit-equal to ``pixels_plain``."""
    batch = [jpeg.decode_coefficients(_read(n), n, mode)
             for n, modes in sorted(DIGESTS["fixtures"].items())
             if "sha256" in modes[mode] and modes[mode]["shape"][0] < 900]
    batch += [co for co in mixed[mode] if co.frame.height == 960]
    want = [_plain(co) for co in batch]
    for co, w in zip(batch, want):
        np.testing.assert_array_equal(kjpeg.pixels_on_host(host_lib, [co])[0], w)
    for got, w in zip(kjpeg.pixels_on_host(host_lib, batch), want):
        np.testing.assert_array_equal(got, w)
    small = [co for co in batch if co.frame.height == 180][:8] * 8
    for got, co in zip(kjpeg.pixels_on_host(host_lib, small), small):
        np.testing.assert_array_equal(got, _plain(co))


@pytest.mark.parametrize("mode", ["file", "buffer"])
def test_j1_on_the_host_in_narrow_tiles_equals_the_plain_stage(host_lib, mixed, mode):
    """J1's CTAs on the host, each fixture alone planned as the card plans
    a lone image (132 SMs: narrower tiles), and the mixed batch in the
    narrowest tiles: bit-equal to ``pixels_plain``."""
    batch = [jpeg.decode_coefficients(_read(n), n, mode)
             for n, modes in sorted(DIGESTS["fixtures"].items())
             if "sha256" in modes[mode] and modes[mode]["shape"][0] < 900]
    for co in batch:
        np.testing.assert_array_equal(kjpeg.pixels_on_host(host_lib, [co], fill=132)[0],
                                      _plain(co))
    for co, got in zip(mixed[mode], kjpeg.pixels_on_host(host_lib, mixed[mode], fill=10**6)):
        np.testing.assert_array_equal(got, _plain(co))


@pytest.mark.parametrize("orientation", [1, 5, 6, 8])
def test_j1_on_the_host_in_narrow_tiles_equals_the_plain_stage_on_random_coefficients(
        host_lib, orientation):
    """``_random_batch`` in the narrowest tiles through J1's CTAs on the
    host: bit-equal to ``pixels_plain`` image by image."""
    batch = _random_batch(10 + orientation, orientation)
    for co, got in zip(batch, kjpeg.pixels_on_host(host_lib, batch, fill=10**6)):
        np.testing.assert_array_equal(got, _plain(co))


@pytest.mark.parametrize("orientation", range(1, 9))
def test_j1_on_the_host_equals_the_plain_stage_on_random_coefficients(host_lib, orientation):
    """``_random_batch`` (every layout and size, smoothing, int32-leaving
    blocks) as one batch through J1's CTAs on the host: bit-equal to
    ``pixels_plain`` image by image."""
    batch = _random_batch(orientation, orientation)
    assert any(co.frame.smoothing for co in batch)
    for co, got in zip(batch, kjpeg.pixels_on_host(host_lib, batch)):
        np.testing.assert_array_equal(got, _plain(co))


# ------------------------------------------------------------------ refusals and callers
def test_a_truncated_upload_in_a_batch_raises_naming_it():
    """In buffer mode (cv2.imdecode) a truncated file refuses the batch:
    ``decode_imgs`` and the service's ``decode_batch`` raise naming it, and
    no image of the batch is decoded; in file mode the batch decodes."""
    datas = [_read("c420_q95.jpg"), _read("truncated_no_eoi.jpg"), _read("c444.jpg")]
    with pytest.raises(ValueError, match=r"^b\.jpg: .*truncated"):
        decode_imgs(datas, ["a.jpg", "b.jpg", "c.jpg"], "cpu", source="buffer")
    assert len(decode_imgs(datas, ["a.jpg", "b.jpg", "c.jpg"], "cpu", source="file")) == 3
    with pytest.raises(ValueError, match="undecodable"):  # JAX's upload decode refuses it too
        jserving._decode_image(datas[1])
    service = serving.DescriptorService(ModelConfig(vlad_cores=4, image_height=H, image_width=W,
                                                    compute_dtype="float32"),
                                        _random_params(), batch_size=2, device="cpu")
    with pytest.raises(ValueError, match=r"^upload 1: .*truncated"):
        service.decode_batch(datas)


def test_a_launch_runs_on_the_decoders_device(monkeypatch):
    """``_Decoder.launch`` enters its own device before it calls the
    library, whichever device is current in the calling thread (a decode
    thread's or an HTTP handler's is cuda:0), holds the decoder's lock only
    around the call, and counts one launch."""
    calls, entered = [], []

    class Device:
        def __init__(self, device):
            self.device = device

        def __enter__(self):
            entered.append(self.device)

        def __exit__(self, *exc):
            entered.pop()

    class Lib:
        def scl_jpeg_pixels(self, *args):
            calls.append((list(entered), args[-1], dec.lock.locked()))
            return 0

    monkeypatch.setattr(kjpeg, "_lib", lambda: Lib())
    monkeypatch.setattr(torch.cuda, "device", Device)
    monkeypatch.setattr(kjpeg.jpeg_pixels_cuda, "launches", 0)
    dec = object.__new__(kjpeg._Decoder)
    dec.device, dec.lock = torch.device("cuda", 1), threading.Lock()
    plan = kjpeg.plan_batch([_frame(16, 16, ((2, 2), (1, 1)), 3, jpeg.YCC, 1)])
    stream = type("Stream", (), {"cuda_stream": 77})()
    thread = threading.Thread(target=dec.launch, args=(plan, (0, 0), 0, 0, 0, stream))
    thread.start()
    thread.join()
    assert calls == [([torch.device("cuda", 1)], 77, True)] and not entered
    assert not dec.lock.locked()
    assert kjpeg.jpeg_pixels_cuda.launches == 1


def test_an_unindexed_cuda_device_is_resolved_where_it_is_given(monkeypatch):
    """``indexed_device`` names the calling thread's current card; the
    extractor, the service and the file source resolve their device so,
    before any decode thread or HTTP handler (whose current device is
    cuda:0) decodes for it."""
    from soft_contrastive_learning_torch.core.config import indexed_device
    from soft_contrastive_learning_torch.data.pipeline import FilesystemSource

    monkeypatch.setattr(torch.cuda, "current_device", lambda: 3)
    assert indexed_device("cuda") == torch.device("cuda", 3)
    assert indexed_device("cuda:1") == torch.device("cuda", 1)
    assert indexed_device("cpu") == torch.device("cpu")
    assert FilesystemSource("", "", device="cuda").device == torch.device("cuda", 3)
    assert FilesystemSource("", "").device is None
    seen = {}
    monkeypatch.setattr(serving, "resolve_device", lambda d: torch.device(d))
    monkeypatch.setattr(serving, "DescriptorExtractor",
                        lambda *a, device, **k: seen.setdefault("extractor", device) and
                        type("E", (), {"raw": True})())
    service = serving.DescriptorService(ModelConfig(vlad_cores=4, image_height=H, image_width=W,
                                                    compute_dtype="float32"), {}, device="cuda")
    assert service.device == seen["extractor"] == torch.device("cuda", 3)


def _random_params():
    from soft_contrastive_learning_torch.models.model import EmbeddingNet

    torch.manual_seed(0)
    return EmbeddingNet(ModelConfig(vlad_cores=4, image_height=H, image_width=W,
                                    compute_dtype="float32")).state_dict()


@pytest.fixture(scope="module")
def models():
    jax_cfg = jcfg.ModelConfig(vlad_cores=4, image_height=H, image_width=W,
                               compute_dtype="float32", use_pallas=False)
    jax_params = jax_init_params(jax_cfg, jax.random.key(0))
    flat = {k: np.asarray(v) for k, v in
            traverse_util.flatten_dict(jax.device_get(jax_params), sep="/").items()}
    cfg = ModelConfig(vlad_cores=4, image_height=H, image_width=W, compute_dtype="float32")
    return cfg, params_from_flax(flat, cfg), jax_cfg, jax_params


def test_extract_files_over_the_fixtures_equals_jax(models, tmp_path):
    """The fixtures that cv2.imread reads (a cut file among them, and the
    1280x960 frame), as files: the port's extractor (chunks of 4 batches of
    4, each chunk's JPEGs in one pixel-stage call) gives JAX's descriptors
    within 1e-5; a file OpenCV cannot read makes both raise."""
    cfg, params, jax_cfg, jax_params = models
    names = [n for n, modes in sorted(DIGESTS["fixtures"].items()) if "sha256" in modes["file"]
             and (modes["file"]["shape"][0] < 900 or n == "frame_1280x960.jpg")]
    for n in names:
        shutil.copy(FIXTURES / n, tmp_path / n)
    ours = DescriptorExtractor(cfg, params, batch_size=4, device="cpu")
    theirs = jinference.DescriptorExtractor(jax_cfg, jax_params, batch_size=4)
    got = ours.extract_files(names, str(tmp_path))
    want = np.asarray(theirs.extract_files(names, str(tmp_path)))
    assert got.shape == want.shape == (len(names), cfg.descriptor_dim) and len(names) > 16
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    shutil.copy(FIXTURES / "refused_lossless.jpg", tmp_path / "refused_lossless.jpg")
    bad = names[:5] + ["refused_lossless.jpg"]
    with pytest.raises(ValueError, match="refused_lossless.jpg: .*lossless"):
        ours.extract_files(bad, str(tmp_path))
    with pytest.raises(Exception):
        theirs.extract_files(bad, str(tmp_path))
    ours.close()


def test_embed_batch_of_jpeg_uploads_equals_jax(models):
    """``/embed_batch`` of six JPEG uploads over HTTP (4:2:0, YCCK, smoothed,
    arithmetic, an MJPEG frame, the 1280x960 frame) gives the JAX service's
    descriptors of cv2.imdecode's pixels within 1e-5; one truncated upload
    among them gets a 400 naming it."""
    cfg, params, jax_cfg, jax_params = models
    uploads = [_read(n) for n in ("c420_q95.jpg", "ycck_420.jpg", "progressive_cut_2_3.jpg",
                                  "c420_q95_arith.jpg", "mjpeg_180x240.jpg",
                                  "frame_1280x960.jpg")]
    service = serving.DescriptorService(cfg, params, batch_size=8, device="cpu")
    theirs = jserving.DescriptorService(jax_cfg, jax_params, batch_size=8)
    server = serving.serve(service, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}/embed_batch"

    def post(datas):
        body = json.dumps({"images_b64": [base64.b64encode(d).decode() for d in datas]}).encode()
        req = urllib.request.Request(url, data=body, headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=300) as resp:
                return resp.status, json.loads(resp.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    try:
        status, got = post(uploads)
        refused = post(uploads[:2] + [_read("truncated_no_eoi.jpg")])
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert status == 200
    want = np.asarray(theirs.embed([jserving._decode_image(d) for d in uploads]))
    np.testing.assert_allclose(np.asarray(got["descriptors"]), want, atol=1e-5, rtol=0)
    assert refused[0] == 400 and refused[1]["error"].startswith("upload 2: ")
    assert "truncated" in refused[1]["error"]
