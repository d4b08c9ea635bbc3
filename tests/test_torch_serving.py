"""The serving slice of the PyTorch port end to end on the CPU, against the
JAX package's DescriptorService on the same trained weights, images and
index; and the port's HTTP surface on localhost."""

import base64
import json
import sys
import threading
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soft_contrastive_learning_tpu import flagship
from soft_contrastive_learning_tpu.core.config import ModelConfig as JaxModelConfig
from soft_contrastive_learning_tpu.serving import DescriptorService as JaxDescriptorService
from soft_contrastive_learning_tpu.utils.cv import normalize_geometry as jax_normalize_geometry
from soft_contrastive_learning_torch import serving
from soft_contrastive_learning_torch.cli import build_parser
from soft_contrastive_learning_torch.core.config import ModelConfig
from soft_contrastive_learning_torch.evaluation.inference import pad_to_multiple
from soft_contrastive_learning_torch.models.weights import load_trained_params
from soft_contrastive_learning_torch.ops.kernels.topk import topk_l2_cuda
from soft_contrastive_learning_torch.serving import DescriptorService
from soft_contrastive_learning_torch.utils.cv import normalize_geometry

torch.set_num_threads(1)  # tier-1 runs several workers on one host

H, W = 64, 80
# fp32 on both sides: unit-norm descriptors agree to ~1e-7 per entry, so
# 1e-5 max-abs. Search ids identical; distances to 1e-5 relative, or 1e-3
# absolute near zero (an image finding itself), where the sqrt magnifies the
# fp32 cancellation in |q|^2 - 2q.r + |r|^2 (1e-7 becomes ~3e-4).
ATOL = 1e-5


@pytest.fixture(scope="module")
def services():
    jcfg = JaxModelConfig(image_height=H, image_width=W, compute_dtype="float32",
                          use_pallas=False)
    jax_service = JaxDescriptorService(jcfg, flagship.load_trained_params(jcfg), batch_size=4)
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 256, (10, H, W, 3), dtype=np.uint8)
    index = np.asarray(jax_service.embed(imgs[:7]))
    jax_service = JaxDescriptorService(jcfg, flagship.load_trained_params(jcfg),
                                       batch_size=4, index=index)
    cfg = ModelConfig(image_height=H, image_width=W, compute_dtype="float32")
    service = DescriptorService(cfg, load_trained_params(cfg=cfg), batch_size=4,
                                index=index, device="cpu")
    return jax_service, service, imgs, index


def test_embed_matches_jax(services):
    jax_service, service, imgs, index = services
    got = service.embed(imgs[:5])  # 5 images: one full batch and a padded one
    assert got.shape == (5, 64 * 512) and got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(jax_service.embed(imgs[:5])), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, index[:5], atol=ATOL, rtol=0)


@pytest.mark.parametrize("stream_min_rows", [65536, 4])
def test_search_matches_jax_on_both_branches(services, monkeypatch, stream_min_rows):
    """65,536: the dense branch; 4: the streamed branch (K2's plain version
    on the CPU) — the threshold is lowered in the port only."""
    jax_service, service, imgs, _ = services
    monkeypatch.setattr(serving, "STREAM_MIN_ROWS", stream_min_rows)
    before = topk_l2_cuda.launches
    got_d, got_i = service.search(imgs[3:], k=4)
    want_d, want_i = jax_service.search(imgs[3:], k=4)
    assert topk_l2_cuda.launches == before
    np.testing.assert_array_equal(got_i, np.asarray(want_i))
    np.testing.assert_allclose(got_d, np.asarray(want_d), rtol=ATOL, atol=1e-3)
    np.testing.assert_array_equal(got_i[:4, 0], [3, 4, 5, 6])  # index images find themselves


def test_search_k_above_index_size(services):
    _, service, imgs, _ = services
    d, i = service.search(imgs[:2], k=50)
    assert d.shape == (2, 7) and i.shape == (2, 7)


def test_search_without_index_raises(services):
    _, service, imgs, _ = services
    bare = DescriptorService(service.cfg, load_trained_params(cfg=service.cfg), batch_size=4,
                             device="cpu")
    with pytest.raises(ValueError, match="no retrieval index"):
        bare.search(imgs[:1])


def test_cuda_without_a_card_raises():
    """No silent CPU fallback: asking for CUDA where there is none fails."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    cfg = ModelConfig(image_height=H, image_width=W, compute_dtype="float32")
    with pytest.raises(RuntimeError, match="CUDA"):
        DescriptorService(cfg, load_trained_params(cfg=cfg))


def test_pad_to_multiple():
    x = np.arange(5)[:, None]
    assert pad_to_multiple(x, 4)[:, 0].tolist() == [0, 1, 2, 3, 4, 0, 0, 0]
    assert pad_to_multiple(x, 5) is x


@pytest.mark.parametrize("shape,keep_aspect", [((90, 150, 3), True), ((100, 100, 3), False),
                                               ((64, 80, 3), True)])
def test_normalize_geometry_matches_jax(shape, keep_aspect):
    img = np.random.default_rng(4).integers(0, 256, shape, dtype=np.uint8)
    got = normalize_geometry(img, H, W, keep_aspect=keep_aspect)
    np.testing.assert_array_equal(got, jax_normalize_geometry(img, H, W, keep_aspect=keep_aspect))


def test_resize_without_opencv_raises(monkeypatch):
    """Where OpenCV is missing (the card's machine) an image at the model's
    size passes as it is, and one that needs a resize is resized by the
    port's own INTER_LINEAR (``utils/cv.py::resize_linear``) to JAX's
    pixels; nothing raises any more."""
    monkeypatch.setitem(sys.modules, "cv2", None)  # makes `import cv2` fail
    img = np.zeros((H, W, 3), np.uint8)
    assert normalize_geometry(img, H, W, keep_aspect=True) is img
    other = np.random.default_rng(5).integers(0, 256, (90, 120, 3), dtype=np.uint8)
    np.testing.assert_array_equal(normalize_geometry(other, H, W, keep_aspect=True),
                                  jax_normalize_geometry(other, H, W, keep_aspect=True))


@pytest.mark.parametrize("reduction,vlad_cores", [("1fc", 8), ("3fc", 8), ("spp", 8),
                                                  ("pca", 8), ("none", 0)])
def test_reduced_services_match_jax(reduction, vlad_cores):
    """``/embed`` returns what JAX's does: the dense or SPP output at its
    width, the raw descriptor for 'pca' and 'none' (here the flattened
    map); ``embed_dim`` says which. The JAX init carried across, fp32:
    within 1e-5 of the largest entry; a search over the reduced index
    finds the same ids."""
    from flax import traverse_util

    import jax

    from soft_contrastive_learning_tpu.models.model import init_params as jax_init_params
    from soft_contrastive_learning_torch.models.weights import params_from_flax

    common = dict(vlad_cores=vlad_cores, reduction=reduction, out_dim=24, image_height=H,
                  image_width=W, compute_dtype="float32")
    jcfg = JaxModelConfig(use_pallas=False, **common)
    cfg = ModelConfig(**common)
    params = jax_init_params(jcfg, jax.random.key(0))
    flat = {k: np.asarray(v) for k, v in traverse_util.flatten_dict(params, sep="/").items()}
    imgs = np.random.default_rng(1).integers(0, 256, (5, H, W, 3), dtype=np.uint8)
    jax_service = JaxDescriptorService(jcfg, params, batch_size=4)
    want = np.asarray(jax_service.embed(imgs))
    index = want[:3]
    jax_service = JaxDescriptorService(jcfg, params, batch_size=4, index=index)
    service = DescriptorService(cfg, params_from_flax(flat, cfg), batch_size=4, index=index,
                                device="cpu")
    got = service.embed(imgs)
    assert service.embed_dim == jax_service.embed_dim == got.shape[1]
    assert got.shape[1] == (24 if reduction.endswith("fc") else cfg.descriptor_dim)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    np.testing.assert_array_equal(service.search(imgs, k=2)[1],
                                  np.asarray(jax_service.search(imgs, k=2)[1]))


def test_cli_serve_flags():
    args = build_parser().parse_args(["serve", "--index", "f.pickle", "--batch_size", "8"])
    assert (args.index, args.batch_size, args.device, args.port) == ("f.pickle", 8, "cuda", 8377)
    assert args.vlad_cores == 64 and args.reduction == "none"
    assert args.quant_scales == ""
    args = build_parser().parse_args(["serve", "--quant_scales", "s.json", "--device", "cpu"])
    assert (args.quant_scales, args.device) == ("s.json", "cpu")


@pytest.fixture(scope="module")
def server_url(services):
    _, service, imgs, index = services
    server = serving.serve(service, port=0)  # ephemeral localhost port
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{server.server_address[1]}", imgs, index
    server.shutdown()
    server.server_close()
    thread.join(timeout=10)


def _png(img):
    import cv2

    ok, buf = cv2.imencode(".png", cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
    assert ok
    return buf.tobytes()


def _post(url, data, content_type="application/json"):
    req = urllib.request.Request(url, data=data, headers={"Content-Type": content_type})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_http_healthz(server_url):
    url, _, _ = server_url
    with urllib.request.urlopen(url + "/healthz", timeout=60) as resp:
        payload = json.loads(resp.read())
    assert payload == {"status": "ok", "backend": "cpu", "dim": 64 * 512}


def test_http_embed_batch_and_search(server_url):
    url, imgs, index = server_url
    body = json.dumps({"images_b64": [base64.b64encode(_png(im)).decode() for im in imgs[:3]],
                       "k": 2}).encode()
    status, payload = _post(url + "/embed_batch", body)
    assert status == 200
    np.testing.assert_allclose(np.asarray(payload["descriptors"]), index[:3], atol=ATOL)
    status, payload = _post(url + "/search", body)
    assert status == 200
    assert np.asarray(payload["indices"])[:, 0].tolist() == [0, 1, 2]
    assert np.asarray(payload["distances"]).shape == (3, 2)


def test_http_upload_decodes_without_opencv(server_url, monkeypatch, tmp_path):
    """The upload decoder is the port's own codec: with cv2 unimportable, a
    PNG posted to the live server returns JAX's descriptor; a JPEG (4:2:0
    and progressive) returns the descriptor of the same pixels posted as
    PNG, the pixels OpenCV decodes it to; a truncated JPEG gets a 400 with
    the decoder's reason."""
    import cv2

    from soft_contrastive_learning_torch.utils.io import save_img

    url, imgs, index = server_url
    jpegs = [cv2.imencode(".jpg", imgs[0], flags)[1].tobytes()
             for flags in ([], [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])]
    decoded = [cv2.imdecode(np.frombuffer(j, np.uint8), cv2.IMREAD_COLOR)[:, :, ::-1]
               for j in jpegs]
    monkeypatch.setitem(sys.modules, "cv2", None)  # makes `import cv2` fail

    def as_png(img, name):
        path = str(tmp_path / name)
        save_img(np.ascontiguousarray(img), path)
        with open(path, "rb") as f:
            return f.read()

    status, payload = _post(url + "/embed", as_png(imgs[0], "up.png"), "image/png")
    assert status == 200
    np.testing.assert_allclose(np.asarray(payload["descriptor"]), index[0], atol=ATOL)
    for k, (jpeg, pixels) in enumerate(zip(jpegs, decoded)):
        status, from_jpeg = _post(url + "/embed", jpeg, "image/jpeg")
        assert status == 200, from_jpeg
        status, from_png = _post(url + "/embed", as_png(pixels, f"{k}.png"), "image/png")
        assert status == 200
        assert from_jpeg["descriptor"] == from_png["descriptor"]
    body = json.dumps({"images_b64": [base64.b64encode(jpegs[0][:300]).decode()]}).encode()
    status, payload = _post(url + "/embed_batch", body)
    assert status == 400 and "JPEG" in payload["error"] and "truncated" in payload["error"]


def test_http_truncated_jpeg_upload_is_refused_as_jax_refuses_it(server_url):
    """A JPEG cut short (the committed fixture, half a baseline file without
    its EOI): JAX's upload decode (cv2.imdecode) gives no image and raises;
    the port's service, which decodes uploads as cv2.imdecode reads bytes,
    answers 400 with its reason, where ``load_img`` of the same bytes as a
    file (cv2.imread) decodes them."""
    import os

    from soft_contrastive_learning_torch.utils import io as tio
    from soft_contrastive_learning_tpu.serving import _decode_image

    url, imgs, index = server_url
    path = os.path.join(os.path.dirname(tio.__file__), os.pardir, "assets", "jpeg",
                        "truncated_no_eoi.jpg")
    with open(path, "rb") as f:
        data = f.read()
    with pytest.raises(ValueError, match="undecodable"):
        _decode_image(data)
    status, payload = _post(url + "/embed", data, "image/jpeg")
    assert status == 400 and "upload: JPEG data ends before" in payload["error"]
    assert "truncated" in payload["error"]
    assert tio.load_img(path).shape == (180, 240, 3)


def test_http_embed_and_errors(server_url):
    url, imgs, index = server_url
    status, payload = _post(url + "/embed", _png(imgs[0]), "image/png")
    assert status == 200
    np.testing.assert_allclose(np.asarray(payload["descriptor"]), index[0], atol=ATOL)
    assert _post(url + "/embed", b"not an image", "image/png")[0] == 400
    assert _post(url + "/nope", b"{}")[0] == 404


@pytest.fixture(scope="module")
def quant_services():
    """JAX's service and the port's with the same int8 scales (JAX's
    calibration on the trained weights), fp32 heads, at 64x80. JAX's
    service runs its ``quantized_embed`` eagerly, as tests/test_quant.py
    runs it; its jitted embed is kept beside it (``jitted``): under jit
    XLA's CPU backend contracts the dequant's multiply and add, which flips
    int8 ties (tests/test_torch_quant.py), so the jitted descriptors sit at
    row cosine ~0.9999 to JAX's own eager ones, and to the port's."""
    from soft_contrastive_learning_tpu.models.quant import calibrate_scales, quantized_embed

    jcfg = JaxModelConfig(image_height=H, image_width=W, compute_dtype="float32",
                          use_pallas=False)
    jparams = flagship.load_trained_params(jcfg)
    rng = np.random.default_rng(6)
    imgs = rng.integers(0, 256, (9, H, W, 3), dtype=np.uint8)
    scales = calibrate_scales(jparams, imgs[:4].astype(np.float32))

    def jax_service(index=None):
        svc = JaxDescriptorService(jcfg, jparams, batch_size=4, index=index,
                                   quant_scales=scales)
        jitted = svc.extractor._embed
        svc.extractor._embed = lambda p, x: quantized_embed(jcfg, p, scales, x)
        return svc, jitted

    index = np.asarray(jax_service()[0].embed(imgs[:6]))
    svc, jitted = jax_service(index)
    cfg = ModelConfig(image_height=H, image_width=W, compute_dtype="float32")
    service = DescriptorService(cfg, load_trained_params(cfg=cfg), batch_size=4, index=index,
                                device="cpu", quant_scales=scales)
    return svc, service, imgs, (jparams, jitted)


def _row_cos(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (a * b).sum(1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))


def test_quantized_service_matches_jax(quant_services):
    """``quant_scales``: the port's int8 service against JAX's with the same
    scales: the same width, row cosine >= 0.99999; against JAX's jitted
    embed as close as JAX's own eager embed is (within 1e-9)."""
    jax_service, service, imgs, (jparams, jitted) = quant_services
    got = service.embed(imgs)
    want = jax_service.embed(imgs)
    assert service.embed_dim == jax_service.embed_dim == got.shape[1] == 64 * 512
    assert _row_cos(got, want).min() >= 0.99999
    jit_full = np.asarray(jitted(jparams, jnp.asarray(imgs[:4]))[1])
    assert (_row_cos(got[:4], jit_full) >= _row_cos(want[:4], jit_full) - 1e-9).all()


@pytest.mark.parametrize("stream_min_rows", [65536, 4])
def test_quantized_search_matches_jax_on_both_branches(quant_services, monkeypatch,
                                                       stream_min_rows):
    jax_service, service, imgs, _ = quant_services
    monkeypatch.setattr(serving, "STREAM_MIN_ROWS", stream_min_rows)
    got_d, got_i = service.search(imgs, k=3)
    np.testing.assert_array_equal(got_i, np.asarray(jax_service.search(imgs, k=3)[1]))
    np.testing.assert_array_equal(got_i[:6, 0], np.arange(6))
