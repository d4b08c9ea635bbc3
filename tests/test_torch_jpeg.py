"""The port's JPEG decoder against the JAX package's reader (OpenCV's
libjpeg-turbo) on the CPU: every committed fixture and every file OpenCV
writes at random sizes, qualities, subsamplings, restart intervals and in
progressive mode decodes through the plain entropy decoder and the plain
pixel stage to the pixels ``soft_contrastive_learning_tpu.utils.io.load_img``
and the JAX service's upload decode give, EXIF orientation included. Every
comparison is exact (tolerance 0): the decode is integer arithmetic end to
end. Neither OpenCV nor PIL exposes a JPEG's coefficients, so the entropy
decoder is held to OpenCV through the decoded pixels. The refused variants
raise a ValueError naming the file and the reason. J1 itself and the compiled entropy decoder run only on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``)."""

import hashlib
import io
import json
import os
import struct

import cv2
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from PIL import Image

from soft_contrastive_learning_torch.ops.kernels import jpeg as kjpeg
from soft_contrastive_learning_torch.utils import jpeg
from soft_contrastive_learning_torch.utils.io import decode_img, load_img
from soft_contrastive_learning_tpu.serving import _decode_image as jax_decode_upload
from soft_contrastive_learning_tpu.utils.io import load_img as jax_load_img

torch.set_num_threads(1)  # tier-1 runs several workers on one host

FIXTURES = os.path.join(os.path.dirname(jpeg.__file__), os.pardir, "assets", "jpeg")
with open(os.path.join(FIXTURES, "digests.json")) as _f:
    DIGESTS = json.load(_f)
SAMPLING = {"420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
            "444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411}


def _textured(rng, h, w):
    y, x = np.mgrid[:h, :w]
    base = np.stack([(x * 3 + y) % 256, (y * 5) % 256, ((x - y) * 2) % 256], -1)
    return np.clip(base + rng.integers(-30, 31, (h, w, 3)), 0, 255).astype(np.uint8)


def _encode(rgb, *params):
    ok, buf = cv2.imencode(".jpg", np.ascontiguousarray(rgb[..., ::-1]), list(params))
    assert ok
    return buf.tobytes()


@pytest.mark.parametrize("name", sorted(DIGESTS["decoded"]))
def test_fixture_decodes_as_jax_reads_it(name):
    """Each committed fixture: the port's CPU decode equals JAX's load_img
    (cv2.imread) and JAX's upload decode (cv2.imdecode), and its digest is
    the one committed beside it (what the card is held to)."""
    path = os.path.join(FIXTURES, name)
    got = load_img(path)
    assert got.dtype == np.uint8 and got.flags["C_CONTIGUOUS"]
    assert list(got.shape) == DIGESTS["decoded"][name]["shape"]
    np.testing.assert_array_equal(got, jax_load_img(path))
    with open(path, "rb") as f:
        data = f.read()
    np.testing.assert_array_equal(decode_img(data, name, "cpu"), jax_decode_upload(data))
    assert hashlib.sha256(got.tobytes()).hexdigest() == DIGESTS["decoded"][name]["sha256"]


@pytest.mark.parametrize("name", sorted(DIGESTS["refused"]))
def test_refused_fixture_names_file_and_reason(name):
    path = os.path.join(FIXTURES, name)
    with pytest.raises(ValueError, match=DIGESTS["refused"][name]) as e:
        load_img(path)
    assert str(e.value).startswith(path + ": ")


@settings(max_examples=30, deadline=None, derandomize=True,
          suppress_health_check=[HealthCheck.too_slow])
@given(h=st.integers(1, 70), w=st.integers(1, 70), quality=st.integers(1, 100),
       sampling=st.sampled_from(sorted(SAMPLING)), restart=st.integers(0, 5),
       progressive=st.booleans(), seed=st.integers(0, 2 ** 16))
def test_random_opencv_files_decode_as_opencv(h, w, quality, sampling, restart, progressive,
                                              seed):
    """Files OpenCV writes: any size (partial MCUs), quality, subsampling,
    restart interval (0: none) and baseline or progressive mode."""
    rgb = _textured(np.random.default_rng(seed), h, w)
    params = [cv2.IMWRITE_JPEG_QUALITY, quality, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
              SAMPLING[sampling], cv2.IMWRITE_JPEG_RST_INTERVAL, restart]
    if progressive:
        params += [cv2.IMWRITE_JPEG_PROGRESSIVE, 1]
    data = _encode(rgb, *params)
    np.testing.assert_array_equal(decode_img(data, "h", "cpu"), jax_decode_upload(data))


@pytest.mark.parametrize("mode", ["L", "RGB"])
@pytest.mark.parametrize("subsampling", [0, 1, 2])
@pytest.mark.parametrize("progressive", [False, True])
def test_pil_files_decode_as_opencv(mode, subsampling, progressive):
    """PIL's writer (its own scan script in progressive mode, JFIF)."""
    rgb = _textured(np.random.default_rng(subsampling), 37, 53)
    buf = io.BytesIO()
    Image.fromarray(rgb).convert(mode).save(buf, "JPEG", quality=85, subsampling=subsampling,
                                            progressive=progressive)
    data = buf.getvalue()
    np.testing.assert_array_equal(decode_img(data, "p", "cpu"), jax_decode_upload(data))


def _exif_app1(orientation, order):
    mark = b"MM" if order == ">" else b"II"
    tiff = (mark + struct.pack(order + "HI", 42, 8) + struct.pack(order + "H", 1)
            + struct.pack(order + "HHIHH", 0x0112, 3, 1, orientation, 0)
            + struct.pack(order + "I", 0))
    body = b"Exif\x00\x00" + tiff
    return b"\xff\xe1" + struct.pack(">H", len(body) + 2) + body


@pytest.mark.parametrize("order", [">", "<"])
@pytest.mark.parametrize("orientation", [0, 1, 2, 3, 4, 5, 6, 7, 8, 9])
def test_exif_orientation_as_opencv(orientation, order):
    """An APP1 Orientation in either byte order turns the image as OpenCV
    turns it; values outside 1-8 leave it as decoded."""
    rgb = _textured(np.random.default_rng(orientation), 19, 30)
    data = _encode(rgb, cv2.IMWRITE_JPEG_QUALITY, 90)
    data = data[:2] + _exif_app1(orientation, order) + data[2:]
    got = decode_img(data, "o", "cpu")
    np.testing.assert_array_equal(got, jax_decode_upload(data))
    assert got.shape == ((30, 19, 3) if orientation in (5, 6, 7, 8) else (19, 30, 3))


def test_incomplete_progressive_file_is_refused_where_libjpeg_smooths():
    """A progressive file that ends after its first scans: libjpeg smooths
    its blocks (OpenCV returns an image); the port refuses it, naming the
    reason. The complete file is not smoothed and decodes exactly."""
    rgb = _textured(np.random.default_rng(3), 48, 64)
    data = _encode(rgb, cv2.IMWRITE_JPEG_PROGRESSIVE, 1)
    sos = [i for i in range(len(data) - 1) if data[i : i + 2] == b"\xff\xda"]
    cut = data[: sos[2]] + b"\xff\xd9"
    assert cv2.imdecode(np.frombuffer(cut, np.uint8), cv2.IMREAD_COLOR) is not None
    with pytest.raises(ValueError, match="cut.jpg: progressive JPEG.*smooths"):
        decode_img(cut, "cut.jpg", "cpu")
    np.testing.assert_array_equal(decode_img(data, "x", "cpu"), jax_decode_upload(data))


@pytest.mark.parametrize("scale", [3, 5])
def test_range_limit_is_opencv_s_clamp(scale):
    """A gray checkerboard written at quality 100, its table then patched to
    ``scale``: the IDCT's outputs fall far outside [0, 255], and OpenCV
    (libjpeg-turbo's SIMD IDCT) clamps them, which the port does.
    ``jidctint.c``'s table would wrap the outputs 512 or more away instead,
    and part from OpenCV at scale 5."""
    a = np.zeros((16, 16), np.uint8)
    a[::2, ::2] = 255
    a[1::2, 1::2] = 255
    a[:8, 8:] = 200
    data = bytearray(cv2.imencode(".jpg", a, [cv2.IMWRITE_JPEG_QUALITY, 100])[1])
    at = data.find(b"\xff\xdb")
    length = data[at + 2] * 256 + data[at + 3]
    data[at + 5 : at + 2 + length] = bytes([scale]) * (length - 3)
    np.testing.assert_array_equal(decode_img(bytes(data), "t", "cpu"),
                                  jax_decode_upload(bytes(data)))


def test_idct_of_a_dc_block_and_the_range_clamp():
    """A block with only a DC term is flat at DC * q / 8 + 128 (the islow
    IDCT's descale); samples past [0, 255] are clamped."""
    for dc, q, want in ((0, 1, 128), (80, 1, 138), (-1024, 1, 0), (1016, 1, 255), (3, 16, 134)):
        coefs = torch.zeros(1, 64, dtype=torch.int16)
        coefs[0, 0] = dc
        quant = torch.ones(64, dtype=torch.int32)
        quant[0] = q
        out = jpeg.idct_plain(coefs, quant)
        assert out.shape == (1, 8, 8) and (out == want).all(), (dc, q, out[0, 0, 0])


def test_upsample_modes_as_libjpeg_chooses_them():
    c = jpeg.Component(1, 1, 1, 0, dw=3, dh=3)
    assert jpeg.upsample_mode(c, 2, 2) == (2, 2, True)
    assert jpeg.upsample_mode(c, 2, 1) == (2, 1, True)
    assert jpeg.upsample_mode(c, 1, 2) == (1, 2, True)
    assert jpeg.upsample_mode(c, 4, 1) == (4, 1, False)
    narrow = jpeg.Component(1, 1, 1, 0, dw=2, dh=9)
    assert jpeg.upsample_mode(narrow, 2, 2) == (2, 2, False)
    assert jpeg.upsample_mode(narrow, 1, 2) == (1, 2, True)


def test_wrapper_on_cpu_tensors_is_the_plain_stage():
    """``jpeg_pixels_cuda`` on CPU tensors runs ``pixels_plain``; the
    kernel's geometry rows put the planes one after another."""
    with open(os.path.join(FIXTURES, "odd_181x243.jpg"), "rb") as f:
        co = jpeg.decode_coefficients(f.read(), "odd")
    coefs, quant = torch.from_numpy(co.coefs), torch.from_numpy(co.quant)
    before = kjpeg.jpeg_pixels_cuda.launches
    got = kjpeg.jpeg_pixels_cuda(coefs, quant, co.frame)
    assert kjpeg.jpeg_pixels_cuda.launches == before  # no kernel launched
    np.testing.assert_array_equal(got.numpy(), jpeg.pixels_plain(coefs, quant, co.frame).numpy())
    geom = kjpeg._geometry(co.frame)
    assert geom[:, 0].tolist() == co.frame.block_offsets()[:-1]
    assert geom[:, 1].tolist() == [64 * b for b in co.frame.block_offsets()[:-1]]
    assert geom[1:, 6:].tolist() == [[2, 2, 1], [2, 2, 1]]  # 4:2:0 chroma, fancy


def test_a_jpeg_training_tree_reads_and_caches_as_jax(tmp_path):
    """A prep tree whose ``{t}.png`` files hold JPEG bytes (cv2.imread, and
    so the JAX file source, reads by content): the port's file source gives
    JAX's pixels, and its decoded cache equals JAX's byte for byte (the
    images are 40x56, resized to 32x40 on the way in)."""
    import filecmp

    from soft_contrastive_learning_torch.data import decoded_cache as tdc
    from soft_contrastive_learning_torch.data.pipeline import FilesystemSource
    from soft_contrastive_learning_torch.utils.io import save_csv
    from soft_contrastive_learning_tpu.data import decoded_cache as jdc
    from soft_contrastive_learning_tpu.data.pipeline import FilesystemSource as JaxSource

    rng = np.random.default_rng(6)
    img_root, shuffled = tmp_path / "imgs", tmp_path / "shuffled"
    (img_root / "2014-12-02-15-30-08_stereo_centre_01").mkdir(parents=True)
    shuffled.mkdir()
    ts = [str(1418000000000000 + 100000 * i) for i in range(6)]
    for i, t in enumerate(ts):
        flags = [cv2.IMWRITE_JPEG_PROGRESSIVE, 1] if i % 2 else []
        (img_root / "2014-12-02-15-30-08_stereo_centre_01" / f"{t}.png").write_bytes(
            _encode(_textured(rng, 40, 56), *flags))
    save_csv({"date": ["2014-12-02-15-30-08"] * 6, "folder": ["1"] * 6, "t": ts,
              "easting": [0.0] * 6, "northing": [0.0] * 6}, str(shuffled / "train_ref_000.csv"))
    ours = FilesystemSource(str(img_root), str(shuffled), device="cpu")
    theirs = JaxSource(str(img_root), str(shuffled))
    for t in ts:
        key = ("2014-12-02-15-30-08", "1", t)
        np.testing.assert_array_equal(ours.load_image(key), theirs.load_image(key))
    quiet = lambda *_: None  # noqa: E731
    tdc.cache_training_sets(ours, ["train_ref"], 32, 40, True, str(tmp_path / "port"), log=quiet)
    jdc.cache_training_sets(theirs, ["train_ref"], 32, 40, True, str(tmp_path / "jax"), log=quiet)
    for name in sorted(os.listdir(tmp_path / "jax")):
        assert filecmp.cmp(tmp_path / "port" / name, tmp_path / "jax" / name, shallow=False)
