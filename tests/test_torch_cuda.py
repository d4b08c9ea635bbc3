"""The port's CUDA kernels on a card, held to their plain PyTorch versions.

Every test here needs an NVIDIA GPU and skips without one. The module
imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from soft_contrastive_learning_torch import serving
from soft_contrastive_learning_torch.core.config import ModelConfig
from soft_contrastive_learning_torch.models.model import EmbeddingNet
from soft_contrastive_learning_torch.models.weights import load_trained_params
from soft_contrastive_learning_torch.losses.ms import wms_loss
from soft_contrastive_learning_torch.ops.kernels.netvlad import (
    VladAggregateFn,
    netvlad_aggregate_cuda,
    vlad_aggregate,
)
from soft_contrastive_learning_torch.ops.kernels.topk import topk_l2_cuda, topk_l2_stream_plain
from soft_contrastive_learning_torch.ops.kernels.wms import wms_loss_cuda, wms_loss_fused
from soft_contrastive_learning_torch.ops.topk import topk_l2_streamed

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _vlad_inputs(device, b, n, d, k, logit_dtype):
    gen = torch.Generator(device=device).manual_seed(b + n + d + k)
    x = torch.randn((b, n, d), generator=gen, device=device)
    x = x / x.norm(dim=-1, keepdim=True)
    logits = (3.0 * torch.randn((b, n, k), generator=gen, device=device)).to(logit_dtype)
    centers = torch.randn((d, k), generator=gen, device=device) / d ** 0.5
    return x, logits, centers


@pytest.mark.parametrize("logit_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,d,k", [(8, 165, 512, 64), (3, 20, 36, 8)])
def test_k1_matches_plain(cuda, logit_dtype, b, n, d, k):
    """fp32 FMA in the kernel against fp32 cuBLAS (TF32 off) in the plain
    version: unit-norm outputs agree to ~1e-8, held to 1e-6."""
    x, logits, centers = _vlad_inputs(cuda, b, n, d, k, logit_dtype)
    before = netvlad_aggregate_cuda.launches
    got = netvlad_aggregate_cuda(x, logits, centers)
    torch.cuda.synchronize()
    assert netvlad_aggregate_cuda.launches == before + 1
    torch.testing.assert_close(got, vlad_aggregate(x, logits, centers), atol=1e-6, rtol=0)


def test_k1_refuses_what_it_does_not_take(cuda):
    x, logits, centers = _vlad_inputs(cuda, 1, 4, 8, 6, torch.float32)
    with pytest.raises(ValueError, match="K % 4"):
        netvlad_aggregate_cuda(x, logits, centers)
    x, logits, centers = _vlad_inputs(cuda, 1, 4, 8, 4, torch.float16)
    with pytest.raises(TypeError):
        netvlad_aggregate_cuda(x, logits, centers)


def _eighths(rng, shape, device):
    """Multiples of 1/8 in [-1, 1]: every dot product is exact in fp32, so
    the kernel and the plain version must agree exactly, ties included."""
    return torch.from_numpy(rng.integers(-8, 9, shape) / 8.0).float().to(device)


@pytest.mark.parametrize("q_n,r_n,d,k", [
    (64, 3000, 512, 5),  # ragged last chunk
    (70, 1000, 256, 128),  # two query tiles, k at its maximum
    (3, 100, 64, 128),  # R < k: (inf, -1) padding
    (5, 513, 4100, 7),  # D not a multiple of the 32-column stage
])
def test_k2_matches_plain(cuda, q_n, r_n, d, k):
    rng = np.random.default_rng(q_n + r_n + d)
    q = _eighths(rng, (q_n, d), cuda)
    r = _eighths(rng, (r_n, d), cuda)
    r[r_n // 2 :] = r[: r_n - r_n // 2].clone()  # duplicated rows: exact ties
    before = topk_l2_cuda.launches
    got_d, got_i = topk_l2_cuda(q, r, k)
    torch.cuda.synchronize()
    assert topk_l2_cuda.launches == before + 1
    want_d, want_i = topk_l2_stream_plain(q, r, k)
    assert torch.equal(got_i, want_i)
    torch.testing.assert_close(got_d, want_d, atol=0, rtol=0)


def test_k2_refuses_what_it_does_not_take(cuda):
    q = torch.zeros((2, 8), device=cuda)
    with pytest.raises(ValueError, match="k <= 128"):
        topk_l2_cuda(q, q, 129)
    with pytest.raises(ValueError, match="D % 4"):
        topk_l2_cuda(q[:, :6].contiguous(), q[:, :6].contiguous(), 1)


def test_streamed_chunks_queries(cuda):
    rng = np.random.default_rng(1)
    q = _eighths(rng, (300, 128), cuda)
    r = _eighths(rng, (2000, 128), cuda)
    got = topk_l2_streamed(q, r, 9)
    want = topk_l2_stream_plain(q, r, 9)
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])


def test_model_with_k1_matches_plain_model(cuda):
    """Trained weights, fp32 convs with TF32 off: the same network with and
    without K1 gives the same descriptors (cosine >= 0.99999)."""
    imgs = torch.from_numpy(
        np.random.default_rng(2).integers(0, 256, (4, 64, 80, 3), dtype=np.uint8)).to(cuda)
    outs = []
    for use_kernels in (True, False):
        cfg = ModelConfig(image_height=64, image_width=80, compute_dtype="float32",
                          use_kernels=use_kernels)
        model = EmbeddingNet(cfg)
        model.load_state_dict(load_trained_params(cfg=cfg))
        with torch.inference_mode():
            outs.append(model.to(cuda).eval()(imgs)[1])
    assert ((outs[0] * outs[1]).sum(1) >= 0.99999).all()


def test_service_streams_through_k2(cuda, monkeypatch):
    cfg = ModelConfig(image_height=64, image_width=80)
    params = load_trained_params(cfg=cfg)
    imgs = np.random.default_rng(3).integers(0, 256, (6, 64, 80, 3), dtype=np.uint8)
    index = serving.DescriptorService(cfg, params, batch_size=4).embed(imgs)
    service = serving.DescriptorService(cfg, params, batch_size=4, index=index)
    monkeypatch.setattr(serving, "STREAM_MIN_ROWS", 4)
    before = (netvlad_aggregate_cuda.launches, topk_l2_cuda.launches)
    _, ids = service.search(imgs[:3], k=2)
    assert netvlad_aggregate_cuda.launches > before[0]
    assert topk_l2_cuda.launches == before[1] + 1
    assert ids[:, 0].tolist() == [0, 1, 2]


def test_k1_refuses_a_bare_call_that_would_cut_the_graph(cuda):
    x, logits, centers = _vlad_inputs(cuda, 2, 20, 36, 8, torch.float32)
    x.requires_grad_()
    with pytest.raises(RuntimeError, match="VladAggregateFn"):
        netvlad_aggregate_cuda(x, logits, centers)
    with torch.no_grad():
        netvlad_aggregate_cuda(x, logits, centers)


def test_k1_function_gradients_are_plain_autograd(cuda):
    """The backward is the plain formula's autograd on the same inputs, so
    the gradients agree to rounding of the recomputation (1e-6); the forward
    is K1."""
    x, logits, centers = _vlad_inputs(cuda, 4, 165, 512, 64, torch.bfloat16)
    ins = [t.clone().requires_grad_() for t in (x, logits, centers)]
    ref = [t.clone().requires_grad_() for t in (x, logits, centers)]
    g = torch.randn((4, 512 * 64), device=cuda)
    before = netvlad_aggregate_cuda.launches
    got = torch.autograd.grad(VladAggregateFn.apply(*ins), ins, g)
    assert netvlad_aggregate_cuda.launches == before + 1
    want = torch.autograd.grad(vlad_aggregate(*ref), ref, g)
    assert got[1].dtype == torch.bfloat16
    for a, b in zip(got, want):
        torch.testing.assert_close(a.float(), b.float(), atol=1e-6, rtol=0)


def _wms_inputs(device, b, d, seed):
    """``chip_smoke.py``'s K3 inputs: places on a line and rows whose
    similarity falls with distance, so that MS mining moves the loss
    (``test_torch_wms.py`` checks that on the CPU)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    return chip_smoke.wms_inputs(torch, np, b, d, seed, device=device)


@pytest.mark.parametrize("mining", [True, False])
@pytest.mark.parametrize("b,d", [(50, 32768), (100, 2048), (1024, 512), (7, 33)])
def test_k3_matches_plain(cuda, b, d, mining):
    """fp32 FMA Gram against cuBLAS fp32 (TF32 off): the loss agrees to
    1e-5 relative, the bound chip_smoke.py holds it to. Mining moves the
    plain loss by at least 100x that bound on these inputs, so a kernel that
    ignored the flag could not pass."""
    geo, emb = _wms_inputs(cuda, b, d, b + d)
    before = wms_loss_cuda.launches
    got = wms_loss_cuda(geo, emb, 0.8, 15.0, ms_mining=mining)
    torch.cuda.synchronize()
    assert wms_loss_cuda.launches == before + 1
    want = wms_loss(geo, emb, 0.8, 15.0, ms_mining=mining)
    other = wms_loss(geo, emb, 0.8, 15.0, ms_mining=not mining)
    assert abs(other.item() - want.item()) >= 1e-3 * max(1.0, abs(want.item()))
    assert abs(got.item() - want.item()) <= 1e-5 * max(1.0, abs(want.item()))
    again = wms_loss_cuda(geo, emb, 0.8, 15.0, ms_mining=mining)
    assert torch.equal(got, again)  # no atomics: the same bits every run


def test_k3_function_gradient_is_plain_autograd(cuda):
    geo, emb = _wms_inputs(cuda, 50, 32768, 5)
    e1, e2 = emb.clone().requires_grad_(), emb.clone().requires_grad_()
    (g1,) = torch.autograd.grad(wms_loss_fused(geo, e1, 0.8, 15.0), e1)
    (g2,) = torch.autograd.grad(wms_loss(geo, e2, 0.8, 15.0), e2)
    torch.testing.assert_close(g1, g2, atol=1e-6, rtol=0)


def test_k3_refuses_what_it_does_not_take(cuda):
    geo, emb = _wms_inputs(cuda, 4, 8, 0)
    with pytest.raises(TypeError):
        wms_loss_cuda(geo, emb.double(), 0.8, 15.0)
    with pytest.raises(ValueError, match="shape"):
        wms_loss_cuda(geo[:3], emb, 0.8, 15.0)
    with pytest.raises(RuntimeError, match="WmsLossFn"):
        wms_loss_cuda(geo, emb.requires_grad_(), 0.8, 15.0)
