"""The port's JPEG decoder against the JAX package's reader (OpenCV's
libjpeg-turbo) on the CPU: every committed fixture and every file OpenCV
writes at random sizes, qualities, subsamplings, restart intervals and in
progressive mode decodes through the plain entropy decoder and the plain
pixel stage to the pixels ``soft_contrastive_learning_tpu.utils.io.load_img``
and the JAX service's upload decode give, EXIF orientation included. Every
comparison is exact (tolerance 0): the decode is integer arithmetic end to
end. Neither OpenCV nor PIL exposes a JPEG's coefficients, so the entropy
decoder is held to OpenCV through the decoded pixels. Both of OpenCV's
readers are held: ``cv2.imread`` of a file (``load_img``, source "file")
and ``cv2.imdecode`` of bytes (``decode_img``, source "buffer"), on files
cut short, corrupt, without Huffman tables, CMYK/YCCK, smoothed and
arithmetic-coded; where OpenCV gives no image the port raises a
ValueError naming the file and the reason. The one recorded divergence,
coefficients that take the IDCT out of libjpeg-turbo's 16-bit SIMD lanes,
is pinned by ``idct_in_16_bit_lanes``. J1 itself and the compiled entropy
decoder run only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``)."""

import hashlib
import io
import json
import os
import struct
import tempfile

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


MODES = ("file", "buffer")
FIXTURE_BYTES = {}


def _fixture(name):
    if name not in FIXTURE_BYTES:
        with open(os.path.join(FIXTURES, name), "rb") as f:
            FIXTURE_BYTES[name] = f.read()
    return FIXTURE_BYTES[name]


def _port(data, name, mode, path=None):
    """The port's CPU decode of ``data`` as ``mode`` reads it: ``load_img``
    of the file, ``decode_img`` of the bytes."""
    return load_img(path) if mode == "file" else decode_img(data, name, "cpu")


def _jax(data, path, mode):
    """JAX's read (cv2.imread / cv2.imdecode), None where it gives no image."""
    try:
        return jax_load_img(path) if mode == "file" else jax_decode_upload(data)
    except (FileNotFoundError, ValueError):
        return None


def _opencv(data, mode):
    """cv2's read of bytes as RGB, None where it gives no image."""
    if mode == "file":
        with tempfile.NamedTemporaryFile(suffix=".jpg") as f:
            f.write(data)
            f.flush()
            bgr = cv2.imread(f.name)
    else:
        bgr = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    return None if bgr is None else np.ascontiguousarray(bgr[..., ::-1])


@pytest.mark.parametrize("name", sorted(
    n for n, v in DIGESTS["fixtures"].items() if any("sha256" in m for m in v.values())))
def test_fixture_decodes_as_jax_reads_it(name):
    """Each committed fixture in both of OpenCV's modes: the port's CPU
    decode through ``load_img`` equals JAX's load_img (cv2.imread) and
    through ``decode_img`` JAX's upload decode (cv2.imdecode), and its digest
    is the one committed beside it (what the card is held to); where JAX
    gets no image the port refuses."""
    path = os.path.join(FIXTURES, name)
    data = _fixture(name)
    for mode, want in DIGESTS["fixtures"][name].items():
        theirs = _jax(data, path, mode)
        if "refused" in want:
            assert theirs is None, mode
            with pytest.raises(ValueError, match=want["refused"]):
                _port(data, name, mode, path)
            continue
        got = _port(data, name, mode, path)
        assert got.dtype == np.uint8 and got.flags["C_CONTIGUOUS"]
        assert list(got.shape) == want["shape"], mode
        np.testing.assert_array_equal(got, theirs, err_msg=mode)
        assert hashlib.sha256(got.tobytes()).hexdigest() == want["sha256"], mode


@pytest.mark.parametrize("name", sorted(
    n for n, v in DIGESTS["fixtures"].items() if any("refused" in m for m in v.values())))
def test_refused_fixture_names_file_and_reason(name):
    path = os.path.join(FIXTURES, name)
    for mode, want in DIGESTS["fixtures"][name].items():
        if "refused" not in want:
            continue
        with pytest.raises(ValueError, match=want["refused"]) as e:
            _port(_fixture(name), path, mode, path)
        assert str(e.value).startswith(path + ": ")


@pytest.mark.parametrize("name", sorted(DIGESTS["diverges"]))
def test_recorded_divergence_lies_outside_the_16_bit_lanes(name):
    """A fixture OpenCV decodes to other pixels than the port does: its
    coefficients take the IDCT out of the range where libjpeg-turbo's SIMD
    code (16-bit lanes) is exact, where the port computes exactly."""
    data = _fixture(name)
    for mode in MODES:
        co = jpeg.decode_coefficients(data, name, mode)
        assert not jpeg.idct_in_16_bit_lanes(torch.from_numpy(co.coefs),
                                             torch.from_numpy(co.quant), co.frame)
        theirs = _opencv(data, mode)
        assert theirs is not None and theirs.shape == _port(
            data, name, mode, os.path.join(FIXTURES, name)).shape


def test_file_and_buffer_modes_as_opencv_reads_them(tmp_path):
    """``load_img`` reads a JPEG file as cv2.imread does (a file cut short
    decodes, the rest grey); ``decode_img`` reads bytes as cv2.imdecode does
    (refused), and takes the mode as an argument."""
    data = _fixture("truncated_no_eoi.jpg")
    path = str(tmp_path / "cut.jpg")
    with open(path, "wb") as f:
        f.write(data)
    np.testing.assert_array_equal(load_img(path), jax_load_img(path))
    np.testing.assert_array_equal(decode_img(data, path, "cpu", source="file"),
                                  jax_load_img(path))
    with pytest.raises(ValueError, match="cut.jpg: JPEG data ends before"):
        decode_img(data, path, "cpu")
    with pytest.raises(ValueError, match="undecodable"):
        jax_decode_upload(data)
    with pytest.raises(ValueError, match="'file' or 'buffer'"):
        decode_img(data, path, "cpu", source="stream")
    with pytest.raises(ValueError, match="'file' or 'buffer'"):
        kjpeg.entropy_decode(data, path, "stream")


@pytest.mark.parametrize("arith, huffman", [("c420_q95_arith.jpg", "c420_q95.jpg"),
                                            ("restart3_arith_dac.jpg", "restart3.jpg")])
def test_arithmetic_transcode_decodes_to_its_huffman_original(arith, huffman):
    """A real SOF9 file (the fixture script's encoder over a Huffman
    fixture's coefficients; the second with restart intervals and DAC
    conditioning): OpenCV and the port decode it to the Huffman original's
    pixels, and to the same coefficients."""
    a, h = _fixture(arith), _fixture(huffman)
    assert a[:2] == b"\xff\xd8" and b"\xff\xc9" in a and b"\xff\xc0" not in a
    np.testing.assert_array_equal(_opencv(a, "buffer"), _opencv(h, "buffer"))
    np.testing.assert_array_equal(decode_img(a, arith, "cpu"), decode_img(h, huffman, "cpu"))
    ca, ch = jpeg.decode_coefficients(a, arith), jpeg.decode_coefficients(h, huffman)
    np.testing.assert_array_equal(ca.coefs, ch.coefs)


def test_mjpeg_frames_take_the_default_tables_sequential_only():
    """A frame without DHT segments (an MJPEG camera's) decodes with ITU
    T.81 K.3's tables, libjpeg's defaults, to the original's pixels; a
    progressive file without them is refused, as OpenCV refuses it
    (libjpeg installs the defaults for sequential frames only)."""
    for frame, original in (("mjpeg_180x240.jpg", "c420_q95.jpg"),
                            ("mjpeg_1280x960.jpg", "frame_1280x960.jpg")):
        assert b"\xff\xc4" not in _fixture(frame)[: _fixture(frame).find(b"\xff\xda")]
    np.testing.assert_array_equal(decode_img(_fixture("mjpeg_180x240.jpg"), "m", "cpu"),
                                  decode_img(_fixture("c420_q95.jpg"), "c", "cpu"))
    stripped = _fixture("refused_progressive_no_dht.jpg")
    assert b"\xff\xc4" not in stripped and b"\xff\xc4" in _fixture("progressive_cv2.jpg")
    assert _opencv(stripped, "buffer") is None
    with pytest.raises(ValueError, match="Huffman table"):
        decode_img(stripped, "p", "cpu")


@pytest.mark.parametrize("code", [0xC3, 0xC5, 0xC6, 0xC7, 0xCB, 0xCD, 0xCE, 0xCF])
def test_lossless_and_hierarchical_frames_are_refused_as_opencv_refuses_them(code):
    """The SOF marker of a baseline fixture patched to a lossless or
    hierarchical type: OpenCV gives no image, and the port refuses naming
    it."""
    data = bytearray(_fixture("c420_q95.jpg"))
    data[data.find(b"\xff\xc0") + 1] = code
    for mode in MODES:
        assert _opencv(bytes(data), mode) is None
        with pytest.raises(ValueError, match="lossless|hierarchical"):
            decode_img(bytes(data), "s", "cpu", source=mode)


@pytest.mark.parametrize("name", ["progressive_cv2.jpg", "progressive_pil.jpg"])
def test_sof10_patched_progressive_files_decode(name):
    """SOF10 (arithmetic progressive) patched onto the progressive fixtures:
    OpenCV decodes both (the Huffman data read as arithmetic); the port
    decodes both, equal to OpenCV where the IDCT stays in the 16-bit lanes
    (the cv2 file's coefficients leave them: ``diverges``)."""
    data = bytearray(_fixture(name))
    data[data.find(b"\xff\xc2") + 1] = 0xCA
    co = jpeg.decode_coefficients(bytes(data), name)
    got = decode_img(bytes(data), name, "cpu")
    theirs = _opencv(bytes(data), "buffer")
    assert theirs is not None and got.shape == theirs.shape
    if jpeg.idct_in_16_bit_lanes(torch.from_numpy(co.coefs), torch.from_numpy(co.quant),
                                 co.frame):
        np.testing.assert_array_equal(got, theirs)
    else:
        assert name.replace(".jpg", "_sof10.jpg") in DIGESTS["diverges"]


SMALL = "small_32x48.jpg"


@settings(max_examples=60, deadline=None, derandomize=True,
          suppress_health_check=[HealthCheck.too_slow])
@given(change=st.one_of(
    st.tuples(st.just("cut"), st.integers(3, 812), st.just(0)),
    st.tuples(st.just("cut+eoi"), st.integers(3, 812), st.just(0)),
    st.tuples(st.just("byte"), st.integers(2, 812), st.integers(0, 255))))
def test_cut_and_changed_files_decode_exactly_where_opencv_does(change):
    """A committed fixture cut at any point (with or without an EOI marker
    after) or with any one byte changed, in both modes: the port decodes
    exactly where OpenCV does and refuses exactly where it gives no image;
    the pixels are equal wherever the IDCT stays in libjpeg-turbo's 16-bit
    lanes (the recorded divergence)."""
    kind, at, value = change
    data = _fixture(SMALL)
    assert len(data) == 813
    if kind == "cut":
        data = data[:at]
    elif kind == "cut+eoi":
        data = data[:at] + b"\xff\xd9"
    else:
        data = data[:at] + bytes([value]) + data[at + 1 :]
    for mode in MODES:
        theirs = _opencv(data, mode)
        try:
            got = decode_img(data, "f", "cpu", source=mode)
        except ValueError as e:
            assert theirs is None, (mode, str(e))
            continue
        assert theirs is not None and got.shape == theirs.shape, mode
        co = jpeg.decode_coefficients(data, "f", mode)
        if jpeg.idct_in_16_bit_lanes(torch.from_numpy(co.coefs), torch.from_numpy(co.quant),
                                     co.frame):
            np.testing.assert_array_equal(got, theirs, err_msg=mode)


@pytest.mark.parametrize("sampling", [0, 1, 2])
@pytest.mark.parametrize("transform", [None, 0, 1, 2])
def test_cmyk_and_ycck_as_opencv(sampling, transform):
    """PIL's CMYK files (Adobe transform 0) at 4:4:4, 4:2:2 and 4:2:0, and
    the same with the transform patched to 1 or 2 (libjpeg reads both as
    YCCK) or the APP14 marker taken out (CMYK): OpenCV's CMYK -> BGR of
    libjpeg's samples."""
    rgb = _textured(np.random.default_rng(sampling), 37, 53)
    buf = io.BytesIO()
    Image.fromarray(rgb).convert("CMYK").save(buf, "JPEG", quality=85, subsampling=sampling)
    data = bytearray(buf.getvalue())
    at = data.find(b"\xff\xeeAdobe"[:2])
    if transform is None:
        length = data[at + 2] << 8 | data[at + 3]
        data = data[:at] + data[at + 2 + length :]
    else:
        data[at + 4 + 11] = transform
    np.testing.assert_array_equal(decode_img(bytes(data), "k", "cpu"),
                                  jax_decode_upload(bytes(data)))


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
    """A progressive file that ends after its first scans (cut before the
    third, with and without an EOI marker): libjpeg smooths its blocks, and
    the port decodes it to OpenCV's pixels in both modes (without the EOI
    an upload is refused, as cv2.imdecode gives no image). The complete file
    is not smoothed and decodes exactly."""
    rgb = _textured(np.random.default_rng(3), 48, 64)
    data = _encode(rgb, cv2.IMWRITE_JPEG_PROGRESSIVE, 1)
    sos = [i for i in range(len(data) - 1) if data[i : i + 2] == b"\xff\xda"]
    cut = data[: sos[2]] + b"\xff\xd9"
    co = jpeg.decode_coefficients(cut, "cut.jpg")
    assert co.frame.smoothing is not None and co.frame.smoothing[0] == 2  # every row whole
    for mode in MODES:
        np.testing.assert_array_equal(decode_img(cut, "cut.jpg", "cpu", source=mode),
                                      _opencv(cut, mode))
    np.testing.assert_array_equal(decode_img(data[: sos[2]], "c", "cpu", source="file"),
                                  _opencv(data[: sos[2]], "file"))
    with pytest.raises(ValueError, match="c: JPEG data ends before"):
        decode_img(data[: sos[2]], "c", "cpu")
    assert jpeg.decode_coefficients(data, "x").frame.smoothing is None
    np.testing.assert_array_equal(decode_img(data, "x", "cpu"), jax_decode_upload(data))


def test_smoothing_windows_as_libjpeg_reads_them():
    """The 5x5 windows of the block smoothing: columns repeat the edge
    block; rows follow libjpeg's image_block_row arithmetic, whose last iMCU
    row counts its rows as if every iMCU row had as many (here a luma
    component 3 blocks high at v = 2: its last row takes the row above as
    the one two above), and rows past the array read DC 0."""
    c = jpeg.Component(1, 2, 2, 0, dw=17, dh=17, bw=4, bh=4)
    rows, cols = jpeg.smoothing_neighbours(c, 2)
    assert cols == [[0, 0, 0, 1, 2], [0, 0, 1, 2, 2], [0, 1, 2, 2, 2], [1, 2, 2, 2, 2]]
    assert rows[0] == [0, 0, 0, 1, 2] and rows[1] == [0, 0, 1, 2, 3]
    assert rows[2] == [1, 1, 2, 2, 2]  # last iMCU row: one row counted, image_block_row 1
    gray = jpeg.Component(1, 1, 2, 0, dw=8, dh=17, bw=1, bh=3)  # one component at v = 2
    rows, _ = jpeg.smoothing_neighbours(gray, 2)
    assert rows[1] == [0, 0, 1, 2, -1]  # the padded fourth row: DC 0


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
    kernel's table entry gives each component's first block, its upsampling
    and its sampling, and no smoothing."""
    with open(os.path.join(FIXTURES, "odd_181x243.jpg"), "rb") as f:
        co = jpeg.decode_coefficients(f.read(), "odd")
    coefs, quant = torch.from_numpy(co.coefs), torch.from_numpy(co.quant)
    before = kjpeg.jpeg_pixels_cuda.launches
    got = kjpeg.jpeg_pixels_cuda(coefs, quant, co.frame)
    assert kjpeg.jpeg_pixels_cuda.launches == before  # no kernel launched
    np.testing.assert_array_equal(got.numpy(), jpeg.pixels_plain(coefs, quant, co.frame).numpy())
    entry = kjpeg.plan_batch([co.frame]).table[0]
    comps = entry["c"][:3]
    assert comps["block0"].tolist() == co.frame.block_offsets()[:-1]
    assert [[c["hr"], c["vr"], c["fancy"]] for c in comps[1:]] == [[2, 2, 1], [2, 2, 1]]
    assert comps["v"].tolist() == [2, 1, 1] and not comps["bits"].any() and not entry["smooth"]


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
