"""The port's file IO against the JAX package's and OpenCV: its PNG decoder
is pixel-equal to ``cv2.imread`` (then BGR -> RGB) on PNGs written with
every row filter forced, per image and mixed per row, in gray, gray +
alpha, RGB and RGBA at odd widths; its writer's files read back through
``cv2.imread`` unchanged; what it does not decode is refused with the
reason; and the CSV helpers equal the JAX package's, quirks included.
Every comparison here is exact (tolerance 0)."""

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


@pytest.mark.parametrize("data,reason", [
    (_png((1, 1, 16, 2, 0, 0, 0)), "16-bit"),
    (_png((1, 1, 8, 3, 0, 0, 0)), "palette"),
    (_png((1, 1, 8, 2, 0, 0, 1)), "Adam7"),
    (_png((1, 1, 8, 2, 0, 0, 0), corrupt=True), "CRC"),
    (_png((2, 1, 8, 2, 0, 0, 0)), "expected"),
    (b"\xff\xd8\xff\xe0" + bytes(16), "JPEG"),
    (b"GIF89a" + bytes(16), "not a PNG"),
])
def test_decoder_refuses_with_the_reason(tmp_path, data, reason):
    path = tmp_path / "bad.png"
    path.write_bytes(data)
    with pytest.raises(ValueError, match=reason):
        tio.load_img(str(path))


def test_decoder_refuses_real_16_bit_palette_and_jpeg_files(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(2)
    cv2.imwrite(str(tmp_path / "a.png"), rng.integers(0, 65535, (5, 7, 3), dtype=np.uint16))
    Image.fromarray(_image(rng, (5, 7, 3), False)).convert("P").save(tmp_path / "b.png")
    cv2.imwrite(str(tmp_path / "c.jpg"), _image(rng, (8, 8, 3), False))
    for name, reason in (("a.png", "16-bit"), ("b.png", "palette"), ("c.jpg", "JPEG")):
        with pytest.raises(ValueError, match=reason):
            tio.load_img(str(tmp_path / name))
    with pytest.raises(FileNotFoundError):
        tio.load_img(str(tmp_path / "missing.png"))


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
