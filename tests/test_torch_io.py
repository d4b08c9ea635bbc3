"""The port's file IO against the JAX package's and OpenCV: its PNG decoder
is pixel-equal to ``cv2.imread`` (then BGR -> RGB) on PNGs written with
every row filter forced, per image and mixed per row, in gray, gray +
alpha, RGB and RGBA at odd widths, and on 16-bit, palette, 1-4 bit gray,
Adam7-interlaced and ``eXIf``-oriented PNGs; its writer's files read back
through ``cv2.imread`` unchanged; what it does not decode, PNG or JPEG, is
refused with the reason; and the CSV helpers equal the JAX package's,
quirks included. Every comparison here is exact (tolerance 0). The JPEG
decoder's own tests are in ``tests/test_torch_jpeg.py``."""

import struct
import zlib

import cv2
import numpy as np
import pytest

from soft_contrastive_learning_torch.utils import io as tio
from soft_contrastive_learning_tpu.utils import io as jio

SHAPES = [(7, 5, 3), (9, 13, 1), (11, 17, 2), (6, 3, 4), (1, 1, 3), (33, 65, 3)]


def _image(rng, shape, smooth):
    if smooth:  # runs and gradients, where the predictors differ most
        walk = np.cumsum(rng.integers(-3, 4, shape), axis=1) + rng.integers(0, 256, shape[2])
        return np.clip(walk, 0, 255).astype(np.uint8)
    return rng.integers(0, 256, shape, dtype=np.uint8)


def _cv2_rgb(path):
    return cv2.cvtColor(cv2.imread(str(path), cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)


def _as_rgb(img):
    """What IMREAD_COLOR makes of an image: gray thrice, alpha dropped."""
    if img.shape[2] <= 2:
        return np.repeat(img[:, :, :1], 3, axis=2)
    return img[:, :, :3]


@pytest.mark.parametrize("filters", [0, 1, 2, 3, 4, "mixed"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("smooth", [False, True])
def test_decoder_equals_cv2_for_every_filter(tmp_path, shape, filters, smooth):
    rng = np.random.default_rng([*shape, 5 if filters == "mixed" else filters, int(smooth)])
    img = _image(rng, shape, smooth)
    rows = rng.integers(0, 5, shape[0]) if filters == "mixed" else filters
    path = tmp_path / "x.png"
    tio.save_img(img if shape[2] > 1 else img[:, :, 0], str(path), filters=rows)
    want = _cv2_rgb(path)
    assert np.array_equal(want, _as_rgb(img))  # the writer's file, read by OpenCV
    got = tio.load_img(str(path))
    assert got.dtype == np.uint8 and got.flags["C_CONTIGUOUS"]
    assert np.array_equal(got, want)


@pytest.mark.parametrize("level", [0, 9])
def test_cv2_written_png_decodes_as_cv2_reads_it(tmp_path, level):
    """A file OpenCV wrote (libpng chooses each row's filter, split IDATs
    at level 0) decodes to OpenCV's own pixels, and the JAX package's
    load_img reads the same."""
    rng = np.random.default_rng(level)
    img = _image(rng, (90, 121, 3), smooth=True)
    path = tmp_path / "cv.png"
    cv2.imwrite(str(path), cv2.cvtColor(img, cv2.COLOR_RGB2BGR),
                [cv2.IMWRITE_PNG_COMPRESSION, level])
    got = tio.load_img(str(path))
    assert np.array_equal(got, img)
    assert np.array_equal(got, jio.load_img(str(path)))


def test_writer_round_trips_and_jax_reads_it(tmp_path):
    rng = np.random.default_rng(1)
    img = _image(rng, (180, 240, 3), smooth=True)
    path = str(tmp_path / "w.png")
    tio.save_img(img, path)
    assert np.array_equal(jio.load_img(path), img)
    assert np.array_equal(tio.load_img(path), img)
    with pytest.raises(ValueError, match="PNG files only"):
        tio.save_img(img, str(tmp_path / "w.jpg"))


def _png(ihdr_fields, raw=b"\x00\x00\x00\x00", corrupt=False):
    """A minimal PNG with the given IHDR (w, h, depth, colour type,
    compression, filter, interlace)."""
    def chunk(kind, body):
        crc = zlib.crc32(kind + body) ^ (1 if corrupt and kind == b"IDAT" else 0)
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", crc)
    return (tio.PNG_SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", *ihdr_fields))
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def _jpeg(patch=None, **kw):
    """A 16x24 JPEG from OpenCV, its SOF0 marker code or precision byte
    patched: the refusal happens at the frame header, before the data."""
    rng = np.random.default_rng(3)
    data = bytearray(cv2.imencode(".jpg", rng.integers(0, 256, (16, 24, 3), dtype=np.uint8))[1])
    sof = data.find(b"\xff\xc0")
    if patch == "code":
        data[sof + 1] = kw["code"]
    elif patch == "precision":
        data[sof + 4] = kw["bits"]
    elif patch == "cut":
        data = data[: len(data) * 2 // 3]
    return bytes(data)


def _cmyk_jpeg(sampling=None):
    """PIL's 8x8 CMYK JPEG; with ``sampling`` its first components'
    sampling bytes patched."""
    import io

    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(np.full((8, 8, 3), 90, np.uint8)).convert("CMYK").save(buf, "JPEG")
    data = bytearray(buf.getvalue())
    for k, value in enumerate(sampling or ()):
        data[data.find(b"\xff\xc0") + 11 + 3 * k] = value
    return bytes(data)


@pytest.mark.parametrize("data,reason", [
    (_png((1, 1, 4, 2, 0, 0, 0)), "colour type 2 at 4 bits"),
    (_png((1, 1, 8, 3, 0, 0, 0)), "palette PNG without a valid PLTE"),
    (_png((1, 1, 8, 2, 0, 0, 2)), "interlace method"),
    (_png((1, 1, 8, 2, 0, 0, 0), corrupt=True), "CRC"),
    (_png((2, 1, 8, 2, 0, 0, 0)), "expected"),
    (b"\xff\xd8\xff\xe0" + bytes(16), "JPEG"),
    (b"GIF89a" + bytes(16), "not a PNG"),
    pytest.param(_jpeg("cut"), "JPEG.*truncated", id="jpeg-truncated"),
    pytest.param(_jpeg("code", code=0xCB), "arithmetic-coded lossless", id="jpeg-arithmetic"),
    pytest.param(_jpeg("code", code=0xCE), "arithmetic-coded hierarchical progressive",
                 id="jpeg-arithmetic-progressive"),
    pytest.param(_jpeg("code", code=0xC3), "lossless", id="jpeg-lossless"),
    pytest.param(_jpeg("precision", bits=12), "12-bit JPEG", id="jpeg-12-bit"),
    pytest.param(_cmyk_jpeg(sampling=(0x31, 0x21)), "fractional sampling", id="jpeg-cmyk"),
])
def test_decoder_refuses_with_the_reason(tmp_path, data, reason):
    """What OpenCV gives no image for, read as an upload (``decode_img``,
    cv2.imdecode's reading of bytes: a cut JPEG is refused there, where
    ``load_img`` reads a cut file to its end as cv2.imread does): arithmetic
    lossless and hierarchical frames, 12-bit samples, a CMYK frame with
    components sampled 3x1 and 2x1."""
    path = tmp_path / "bad.png"
    path.write_bytes(data)
    with pytest.raises(ValueError, match=reason):
        tio.decode_img(data, str(path))
    if data[:2] == b"\xff\xd8":
        assert cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR) is None


@pytest.mark.parametrize("data", [
    pytest.param(_jpeg("cut"), id="jpeg-truncated"),
    pytest.param(_jpeg("code", code=0xC9), id="jpeg-arithmetic"),
    pytest.param(_jpeg("code", code=0xCA), id="jpeg-arithmetic-progressive"),
    pytest.param(_cmyk_jpeg(), id="jpeg-cmyk"),
])
def test_decoder_reads_what_opencv_reads(tmp_path, data):
    """Files the decoder once refused, as the JAX package's load_img
    (cv2.imread) reads them: a cut JPEG (the rest grey), an SOF9 marker on
    Huffman data (read as arithmetic coding), PIL's CMYK JPEG; and SOF10 on
    a baseline file, which OpenCV refuses (a sequential scan in a
    progressive frame) and the port with it."""
    path = str(tmp_path / "f.jpg")
    with open(path, "wb") as f:
        f.write(data)
    try:
        want = jio.load_img(path)
    except FileNotFoundError:
        with pytest.raises(ValueError, match="progressive scan parameters"):
            tio.load_img(path)
        return
    assert np.array_equal(tio.load_img(path), want)


def test_decoder_refuses_real_16_bit_palette_and_jpeg_files(tmp_path):
    """Files that earlier versions of the decoder refused, written by
    OpenCV and PIL (a 16-bit RGB PNG, a palette PNG, a JPEG), now decode to
    the JAX package's pixels; a missing file still raises
    FileNotFoundError."""
    from PIL import Image

    rng = np.random.default_rng(2)
    cv2.imwrite(str(tmp_path / "a.png"), rng.integers(0, 65535, (5, 7, 3), dtype=np.uint16))
    Image.fromarray(_image(rng, (5, 7, 3), False)).convert("P").save(tmp_path / "b.png")
    cv2.imwrite(str(tmp_path / "c.jpg"), _image(rng, (8, 8, 3), False))
    for name in ("a.png", "b.png", "c.jpg"):
        path = str(tmp_path / name)
        assert np.array_equal(tio.load_img(path), jio.load_img(path)), name
    with pytest.raises(FileNotFoundError):
        tio.load_img(str(tmp_path / "missing.png"))


def _png_rows(w, h, depth, ctype, rows, chunks=(), interlace=0):
    """A PNG of already-packed, unfiltered rows (filter byte 0 added), with
    extra chunks before IDAT."""
    def chunk(kind, body):
        crc = struct.pack(">I", zlib.crc32(kind + body))
        return struct.pack(">I", len(body)) + kind + body + crc
    raw = b"".join(b"\x00" + r for r in rows)
    return (tio.PNG_SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0,
                                                           interlace))
            + b"".join(chunk(k, b) for k, b in chunks) + chunk(b"IDAT", zlib.compress(raw))
            + chunk(b"IEND", b""))


def _pack(samples, depth):
    """One row of samples (w, ch) as PNG bytes: big-endian 16-bit, or
    1-4 bit values packed from the most significant bit."""
    flat = np.asarray(samples).reshape(-1)
    if depth == 16:
        return flat.astype(">u2").tobytes()
    if depth == 8:
        return flat.astype(np.uint8).tobytes()
    bits = "".join(format(int(v), f"0{depth}b") for v in flat)
    bits += "0" * (-len(bits) % 8)
    return int(bits, 2).to_bytes(len(bits) // 8, "big")


def _adam7_rows(img, depth):
    """The rows of the seven Adam7 passes of an (h, w, ch) image, in order."""
    rows = []
    for x0, y0, dx, dy in ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4),
                           (1, 0, 2, 2), (0, 1, 1, 2)):
        sub = img[y0::dy, x0::dx]
        if sub.shape[0] and sub.shape[1]:
            rows += [_pack(r, depth) for r in sub]
    return rows


def _exif(orientation, order=">"):
    mark = b"MM" if order == ">" else b"II"
    return (mark + struct.pack(order + "HI", 42, 8) + struct.pack(order + "H", 1)
            + struct.pack(order + "HHIHH", 0x0112, 3, 1, orientation, 0)
            + struct.pack(order + "I", 0))


PNG_VARIANTS = {
    # name: (ihdr depth, colour type, sample range, channels, interlace)
    "rgb16": (16, 2, 65536, 3, 0), "rgba16": (16, 6, 65536, 4, 0), "gray16": (16, 0, 65536, 1, 0),
    "gray_alpha16": (16, 4, 65536, 2, 0), "gray1": (1, 0, 2, 1, 0), "gray2": (2, 0, 4, 1, 0),
    "gray4": (4, 0, 16, 1, 0), "palette8": (8, 3, 256, 1, 0), "palette4": (4, 3, 16, 1, 0),
    "palette1": (1, 3, 2, 1, 0), "adam7_rgb": (8, 2, 256, 3, 1), "adam7_gray2": (2, 0, 4, 1, 1),
    "adam7_rgba16": (16, 6, 65536, 4, 1), "adam7_palette4": (4, 3, 16, 1, 1),
}


@pytest.mark.parametrize("shape", [(5, 7), (13, 17), (1, 1), (2, 9)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("variant", sorted(PNG_VARIANTS))
def test_png_variants_decode_as_cv2_reads_them(tmp_path, variant, shape):
    """16-bit (high byte), palette (tRNS dropped; indices past a short
    palette black), 1-4 bit gray (scaled) and Adam7 PNGs, decoded to what
    OpenCV and the JAX package's load_img read."""
    depth, ctype, top, ch, interlace = PNG_VARIANTS[variant]
    h, w = shape
    rng = np.random.default_rng([h, w, depth, ctype, interlace])
    img = rng.integers(0, top, (h, w, ch))
    chunks = []
    if ctype == 3:  # a palette shorter than the index range, and a tRNS
        n = max(1, top * 3 // 4)
        chunks = [(b"PLTE", rng.integers(0, 256, 3 * n, dtype=np.uint8).tobytes()),
                  (b"tRNS", bytes([0, 128]))]
    rows = _adam7_rows(img, depth) if interlace else [_pack(r, depth) for r in img]
    path = tmp_path / "v.png"
    path.write_bytes(_png_rows(w, h, depth, ctype, rows, chunks, interlace))
    got = tio.load_img(str(path))
    assert np.array_equal(got, _cv2_rgb(path))
    assert np.array_equal(got, jio.load_img(str(path)))


@pytest.mark.parametrize("order", [">", "<"])
@pytest.mark.parametrize("orientation", range(1, 9))
def test_png_exif_orientation_as_cv2(tmp_path, orientation, order):
    """OpenCV turns a PNG by its eXIf chunk's Orientation, as a JPEG by
    its APP1: so does the port (both byte orders)."""
    rng = np.random.default_rng(orientation)
    img = rng.integers(0, 256, (5, 7, 3), dtype=np.uint8)
    path = tmp_path / "o.png"
    path.write_bytes(_png_rows(7, 5, 8, 2, [r.tobytes() for r in img],
                               [(b"eXIf", _exif(orientation, order))]))
    got = tio.load_img(str(path))
    assert got.shape == ((7, 5, 3) if orientation >= 5 else (5, 7, 3))
    assert np.array_equal(got, _cv2_rgb(path))
    assert np.array_equal(got, jio.load_img(str(path)))


CSV_CASES = {
    "table": "a,b\n1,x\n2,y\n",
    "header_only": "a,b,c\n",
    "empty": "",
    "ragged": "a,b\n1\n2,3,4\n",
    "semicolons": "a;b\n1;2\n",
}


@pytest.mark.parametrize("case", sorted(CSV_CASES))
@pytest.mark.parametrize("kw", [{}, {"has_header": False},
                                {"has_header": False, "keys": ["p", "q"]}, {"delimiter": ";"}])
def test_load_csv_and_load_table_equal_jax(tmp_path, case, kw):
    path = tmp_path / "t.csv"
    path.write_text(CSV_CASES[case])
    assert tio.load_csv(str(path), **kw) == jio.load_csv(str(path), **kw)
    kw_table = {k: v for k, v in kw.items() if k != "keys"}
    assert tio.load_table(str(path), **kw_table) == jio.load_table(str(path), **kw_table)


def test_header_only_csv_returns_the_key_list(tmp_path):
    path = tmp_path / "h.csv"
    path.write_text("date,folder,t\n")
    assert tio.load_csv(str(path)) == ["date", "folder", "t"]
    assert tio.load_table(str(path)) == {"date": [], "folder": [], "t": []}


@pytest.mark.parametrize("data", [
    {"a": [1, 2], "b": ["x", "y"]},
    {"a": np.arange(3), "b": np.linspace(0, 1, 3)},
    {"a": 1.5, "b": "s"},
    {},
])
def test_save_csv_and_text_equal_jax(tmp_path, data):
    tio.save_csv(data, str(tmp_path / "port.csv"))
    jio.save_csv(data, str(tmp_path / "jax.csv"))
    assert (tmp_path / "port.csv").read_text() == (tmp_path / "jax.csv").read_text()
    tio.save_txt("line\n", str(tmp_path / "t.txt"))
    tio.save_txt("more", str(tmp_path / "t.txt"), mode="a")
    assert tio.load_txt(str(tmp_path / "t.txt")) == jio.load_txt(str(tmp_path / "t.txt"))
    tio.mkdir(str(tmp_path / "d" / "e"))
    tio.mkdir(str(tmp_path / "d" / "e"))
    assert (tmp_path / "d" / "e").is_dir()


def test_decoding_a_toy_city_view_of_every_filter_equals_the_render(tmp_path):
    """The flagship's input size: a rendered 180x240 view written with each
    filter for every row decodes to the rendered pixels."""
    from soft_contrastive_learning_torch.data.toycity import ToyCity

    img = ToyCity(num_points=4, img_h=180, img_w=240, seed=5).image(1)
    for f in range(5):
        path = str(tmp_path / f"{f}.png")
        tio.save_img(img, path, filters=f)
        assert np.array_equal(tio.load_img(path), img)
