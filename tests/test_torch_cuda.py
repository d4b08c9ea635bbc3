"""The port's CUDA kernels on a card, held to their plain PyTorch versions.

Every test here needs an NVIDIA GPU and skips without one. The module
imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import dataclasses
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
    netvlad_backward_cuda,
    vlad_aggregate,
    vlad_aggregate_backward,
)
from soft_contrastive_learning_torch.ops.kernels.probe_gemm import (
    CONFIGS,
    choose_config,
    probe_gemm,
    probe_gemm_plain,
    transpose_s8,
)
from soft_contrastive_learning_torch.ops.kernels.topk import (
    tf32_split,
    topk_l2_3xtf32_plain,
    topk_l2_cuda,
    topk_l2_stream_plain,
)
from soft_contrastive_learning_torch.ops.kernels.winograd import (
    WinogradConvFn,
    direct_conv,
    weight_transform_cuda,
    winograd_conv_cuda,
    winograd_stage,
)
from soft_contrastive_learning_torch.ops.kernels.wms import wms_loss_cuda, wms_loss_fused
from soft_contrastive_learning_torch.ops.topk import topk_l2_streamed
from soft_contrastive_learning_torch.ops.winograd import (
    weight_transform,
    winograd_conv_plain,
    winograd_stage_plain,
)

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
@pytest.mark.parametrize("b,n,d,k", [(8, 165, 512, 64), (3, 20, 36, 8), (1, 165, 512, 64),
                                     (50, 165, 512, 64), (64, 165, 512, 64), (2, 7, 100, 12)])
def test_k1_matches_plain(cuda, logit_dtype, b, n, d, k):
    """fp32 FMA in the kernel against fp32 cuBLAS (TF32 off) in the plain
    version: unit-norm outputs agree to ~1e-8, held to 1e-6. A cluster of 4
    blocks per image along D: at D=36 two of them hold no rows, at D=100 the
    last chunk is ragged; K=8 and 12 leave thread columns idle."""
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


@pytest.mark.parametrize("r_n", [50, 1000, 33025])
@pytest.mark.parametrize("k", [1, 5, 128])
@pytest.mark.parametrize("q_n", [1, 64, 70, 256])
def test_k2_across_query_tiles_and_block_counts(cuda, q_n, k, r_n):
    """Exact inputs with duplicated rows, ids and distances equal to the
    plain version's: 1 to 4 query tiles of 64 (70: a second tile of 6), R
    ragged against the 128-row tile, below one tile (50: one block of the
    cluster pair has no tile) and over more tiles than blocks (33,025: 259
    tiles, a run of several pairs a cluster)."""
    rng = np.random.default_rng(q_n * k + r_n)
    q = _eighths(rng, (q_n, 256), cuda)
    r = _eighths(rng, (r_n, 256), cuda)
    r[r_n // 2 :] = r[: r_n - r_n // 2].clone()
    before = topk_l2_cuda.launches
    got_d, got_i = topk_l2_cuda(q, r, k)
    torch.cuda.synchronize()
    assert topk_l2_cuda.launches == before + 1
    want_d, want_i = topk_l2_stream_plain(q, r, k)
    assert torch.equal(got_i, want_i)
    torch.testing.assert_close(got_d, want_d, atol=0, rtol=0)


def test_k2_at_d_4100(cuda):
    """D = 4,100: 128 whole 32-column stages and one of 4 columns, the rest
    of its box zero-filled by TMA; two query tiles, k at its maximum."""
    rng = np.random.default_rng(4100)
    q = _eighths(rng, (70, 4100), cuda)
    r = _eighths(rng, (2000, 4100), cuda)
    got_d, got_i = topk_l2_cuda(q, r, 128)
    want_d, want_i = topk_l2_stream_plain(q, r, 128)
    assert torch.equal(got_i, want_i)
    torch.testing.assert_close(got_d, want_d, atol=0, rtol=0)


def test_k2_reads_the_low_mantissa_bits(cuda):
    """Inputs with bits in the 13 positions below tf32's. Refs equal in
    their tf32 part rank by their low bits alone: the kernel's ids are the
    3xTF32 emulation's (and the plain version's), which the hi product alone
    would rank all equal. On normals, whose every element has low bits, ids
    equal the emulation's outside near-ties (within 1e-5 in squared
    distance) and distances agree within 1e-5 relative."""
    d, n = 256, 3000
    s = np.random.default_rng(6).permutation(n) % 64
    r = torch.from_numpy(0.5 + s[:, None] * 2.0**-17 + np.zeros((n, d))).float().to(cuda)
    assert (tf32_split(r)[0] == 0.5).all()
    q = torch.ones((5, d), device=cuda)
    got_d, got_i = topk_l2_cuda(q, r, 128)
    want_d, want_i = topk_l2_3xtf32_plain(q.cpu(), r.cpu(), 128)
    assert torch.equal(got_i.cpu(), want_i)
    assert torch.equal(got_i, topk_l2_stream_plain(q, r, 128)[1])
    assert not torch.equal(want_i, topk_l2_stream_plain(q.cpu(), tf32_split(r)[0].cpu(), 128)[1])

    gen = torch.Generator(device=cuda).manual_seed(7)
    q = torch.randn((64, 512), generator=gen, device=cuda)
    r = torch.randn((5000, 512), generator=gen, device=cuda)
    got_d, got_i = topk_l2_cuda(q, r, 20)
    want_d, want_i = topk_l2_3xtf32_plain(q.cpu(), r.cpu(), 21)
    got_sq, want_sq = got_d.cpu().double() ** 2, want_d.double() ** 2
    steps = (want_sq[:, 1:] - want_sq[:, :-1]).abs()
    inf = torch.full((64, 1), float("inf"), dtype=torch.float64)
    gaps = torch.minimum(torch.cat([inf, steps[:, :-1]], 1), steps)
    scale = want_sq.max().item()
    differ = got_i.cpu() != want_i[:, :20]
    assert not (differ & (gaps > 1e-5 * scale)).any()
    torch.testing.assert_close(got_d.cpu(), want_d[:, :20], atol=0, rtol=1e-5)


def test_k2_on_unit_vectors_at_the_descriptor_width(cuda):
    """The served search's gate on descriptors' geometry: unit vectors at
    D = 32,768, so the products run over 1,024 stages. Squared distances
    within 1e-5 of the exact ones (fp64; the plain version's fp32 sums are
    themselves ~1e-5 off at this width), ids equal to the exact ranking's
    outside near-ties within 1e-5; 8 of the queries are refs, found at rank
    0."""
    gen = torch.Generator(device=cuda).manual_seed(8)
    r = torch.randn((3000, 32768), generator=gen, device=cuda)
    r = r / r.norm(dim=1, keepdim=True)
    q = torch.randn((64, 32768), generator=gen, device=cuda)
    q[:8] = r[::375]
    q = q / q.norm(dim=1, keepdim=True)
    got_d, got_i = topk_l2_cuda(q, r, 5)
    q64, r64 = q.double(), r.double()
    exact = (q64 * q64).sum(1, keepdim=True) - 2.0 * (q64 @ r64.T) + (r64 * r64).sum(1)[None, :]
    want_sq, want_i = torch.sort(exact, dim=1, stable=True)
    want_sq, want_i = want_sq[:, :6], want_i[:, :6]
    assert (got_d.double() ** 2 - want_sq[:, :5]).abs().max().item() <= 1e-5
    steps = (want_sq[:, 1:] - want_sq[:, :-1]).abs()
    inf = torch.full((64, 1), float("inf"), dtype=torch.float64, device=cuda)
    gaps = torch.minimum(torch.cat([inf, steps[:, :-1]], 1), steps)
    assert not ((got_i != want_i[:, :5]) & (gaps > 1e-5)).any()
    assert torch.equal(got_i[:8, 0], torch.arange(0, 3000, 375, device=cuda))


def test_k2_refuses_what_it_does_not_take(cuda):
    q = torch.zeros((2, 8), device=cuda)
    with pytest.raises(ValueError, match="k <= 128"):
        topk_l2_cuda(q, q, 129)
    with pytest.raises(ValueError, match="D % 4"):
        topk_l2_cuda(q[:, :6].contiguous(), q[:, :6].contiguous(), 1)


@pytest.mark.parametrize("d", [64, 66, 256, 4096])
def test_k2_at_the_top_n_widths(cuda, d):
    """The whitened widths of the top-N sweep, through topk_l2_streamed as
    evaluation/topn.py calls it above its threshold: 300 queries (two
    launches: 256 + 44), k = 25, exact inputs with duplicated rows. D = 64
    is two 32-column stages; D = 66 is padded to 68 with zero columns (the
    repair: K2 reads rows 16 bytes apart) and must give the unpadded plain
    version's ids and distances; 4,096 is 128 stages."""
    rng = np.random.default_rng(d)
    q = _eighths(rng, (300, d), cuda)
    r = _eighths(rng, (6000, d), cuda)
    r[3000:] = r[:3000].clone()
    before = topk_l2_cuda.launches
    got_d, got_i = topk_l2_streamed(q, r, 25)
    torch.cuda.synchronize()
    assert topk_l2_cuda.launches == before + 2
    want_d, want_i = topk_l2_stream_plain(q, r, 25)
    assert torch.equal(got_i, want_i)
    torch.testing.assert_close(got_d, want_d, atol=0, rtol=0)


@pytest.mark.parametrize("d", [66, 256, 4096])
def test_k2_at_the_top_n_widths_against_fp64(cuda, d):
    """Standard normals (what whitening gives) at the sweep's widths: squared
    distances within 1e-5 of the query's top-1 squared distance from the
    exact (fp64) ones, ids equal to the exact ranking's outside near-ties
    within that."""
    gen = torch.Generator(device=cuda).manual_seed(d)
    q = torch.randn((64, d), generator=gen, device=cuda)
    r = torch.randn((20000, d), generator=gen, device=cuda)
    got_d, got_i = topk_l2_streamed(q, r, 25)
    q64, r64 = q.double(), r.double()
    exact = (q64 * q64).sum(1, keepdim=True) - 2.0 * (q64 @ r64.T) + (r64 * r64).sum(1)[None, :]
    want_sq, want_i = torch.sort(exact, dim=1, stable=True)
    want_sq, want_i = want_sq[:, :26], want_i[:, :26]
    tol = 1e-5 * want_sq[:, :1]
    assert ((got_d.double() ** 2 - want_sq[:, :25]).abs() <= tol).all()
    steps = (want_sq[:, 1:] - want_sq[:, :-1]).abs()
    inf = torch.full((64, 1), float("inf"), dtype=torch.float64, device=cuda)
    gaps = torch.minimum(torch.cat([inf, steps[:, :-1]], 1), steps)
    assert not ((got_i != want_i[:, :25]) & (gaps > tol)).any()


def test_top_n_single_streams_through_k2_above_the_threshold(cuda, monkeypatch):
    """evaluation/topn.py sends more than _TILED_THRESHOLD refs to K2 (a
    width that is not a multiple of 4 included) and fewer to the dense
    path; on exact inputs both give the plain version's ids."""
    from soft_contrastive_learning_torch.evaluation import topn

    rng = np.random.default_rng(2)
    q = _eighths(rng, (40, 66), cuda)
    r = _eighths(rng, (3000, 66), cuda)
    ref_xy, query_xy = rng.uniform(0, 100, (3000, 2)), rng.uniform(0, 100, (40, 2))
    monkeypatch.setattr(topn, "_TILED_THRESHOLD", 2000)
    before = topk_l2_cuda.launches
    streamed = topn.top_n_single(r, q, ref_xy, query_xy, 0.0, n=25, device=cuda)
    assert topk_l2_cuda.launches == before + 1
    monkeypatch.setattr(topn, "_TILED_THRESHOLD", 200_000)
    dense = topn.top_n_single(r, q, ref_xy, query_xy, 0.0, n=25, device=cuda)
    assert topk_l2_cuda.launches == before + 1
    want_i = topk_l2_stream_plain(q, r, 25)[1].cpu().numpy()
    assert streamed[0] == dense[0] == want_i.tolist()


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


def _bf16_steps(got, want):
    """|got - want| in units of the bf16 step at |want| (2^-8 relative), or
    of the fp32 gate 1e-6 max(1, max |want|) where the bf16 grid is finer:
    near zero two fp32 summation orders differ by more than a bf16 step of
    the value."""
    w = want.float()
    step = torch.ldexp(torch.ones_like(w), torch.frexp(w.abs().clamp_min(1e-30))[1] - 8)
    floor = 1e-6 * max(1.0, w.abs().max().item())
    return ((got.float() - w).abs() / torch.clamp(step, min=floor)).max().item()


@pytest.mark.parametrize("logit_dtype", [torch.float32, torch.bfloat16])
def test_k1_function_gradients_are_plain_autograd(cuda, logit_dtype):
    """The forward and the backward are K1's kernels (one launch each); the
    gradients are autograd's of the plain formula up to the two fp32
    summation orders: within 1e-6 of each gradient's largest entry (at
    least 1). A bf16 logits gradient is the fp32 one rounded on each side,
    so an entry whose fp32 values straddle a rounding boundary moves by one
    bf16 step, and no further (near zero, where a bf16 step is finer than
    the fp32 gate, by that gate)."""
    x, logits, centers = _vlad_inputs(cuda, 4, 165, 512, 64, logit_dtype)
    ins = [t.clone().requires_grad_() for t in (x, logits, centers)]
    ref = [t.clone().requires_grad_() for t in (x, logits, centers)]
    g = torch.randn((4, 512 * 64), device=cuda)
    before = (netvlad_aggregate_cuda.launches, netvlad_backward_cuda.launches)
    got = torch.autograd.grad(VladAggregateFn.apply(*ins), ins, g)
    assert (netvlad_aggregate_cuda.launches, netvlad_backward_cuda.launches) == \
        (before[0] + 1, before[1] + 1)
    want = torch.autograd.grad(vlad_aggregate(*ref), ref, g)
    assert got[1].dtype == logit_dtype
    for i, (a, b) in enumerate(zip(got, want)):
        if i == 1 and logit_dtype == torch.bfloat16:
            assert _bf16_steps(a, b) <= 1.0
        else:
            torch.testing.assert_close(a.float(), b.float(), rtol=0,
                                       atol=1e-6 * max(1.0, b.float().abs().max().item()))


@pytest.mark.parametrize("logit_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,d,k", [(50, 165, 512, 64), (3, 20, 36, 8), (2, 7, 100, 12)])
def test_k1_backward_kernel_matches_the_plain_backward(cuda, logit_dtype, b, n, d, k):
    """K1's backward kernel against ``vlad_aggregate_backward`` (the closed
    form it implements) on the forward kernel's output and scales: the same
    gates as against autograd; and twice the same bits (dC is summed over
    images in a fixed order, no atomics)."""
    x, logits, centers = _vlad_inputs(cuda, b, n, d, k, logit_dtype)
    g = torch.randn((b, d * k), device=cuda, generator=torch.Generator(cuda).manual_seed(7))
    ins = [t.clone().requires_grad_() for t in (x, logits, centers)]
    out = VladAggregateFn.apply(*ins)
    scales = out.grad_fn.saved_tensors[4]
    assert scales.shape == (b, k + 1)
    got = netvlad_backward_cuda(x, logits, centers, out.detach(), scales, g)
    again = netvlad_backward_cuda(x, logits, centers, out.detach(), scales, g)
    torch.cuda.synchronize()
    assert all(torch.equal(p, q) for p, q in zip(got, again))
    want = vlad_aggregate_backward(x, logits, centers, g)
    assert [t.dtype for t in got] == [torch.float32, logit_dtype, torch.float32]
    for i, (a, w) in enumerate(zip(got, want)):
        assert a.shape == w.shape
        if i == 1 and logit_dtype == torch.bfloat16:
            assert _bf16_steps(a, w) <= 1.0
        else:
            torch.testing.assert_close(a.float(), w.float(), rtol=0,
                                       atol=1e-6 * max(1.0, w.float().abs().max().item()))


def test_k1_inference_writes_no_residual(cuda):
    """Under no_grad the model's aggregation is the bare forward (no scales
    written, no graph); with grad it is the Function, which keeps them."""
    from soft_contrastive_learning_torch.ops.kernels.netvlad import vlad_aggregate_fused

    x, logits, centers = _vlad_inputs(cuda, 2, 20, 36, 8, torch.float32)
    centers.requires_grad_()
    with torch.no_grad():
        assert vlad_aggregate_fused(x, logits, centers).grad_fn is None
    out = vlad_aggregate_fused(x, logits, centers)
    assert "VladAggregateFn" in type(out.grad_fn).__name__
    assert len(out.grad_fn.saved_tensors) == 5


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
    ignored the flag could not pass. One cooperative launch a call, the
    same bits every run."""
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


@pytest.mark.parametrize("b,d", [(50, 32768), (100, 32768), (1024, 512)])
def test_k3_is_one_launch_with_the_same_bits(cuda, b, d):
    """At the three batch sizes K3 runs in training and in chip_smoke.py: one
    kernel launch per call in a profile of the call, the same bits over
    three runs, and the grid barrier's and the ticket's words back at zero
    afterwards."""
    from torch.profiler import ProfilerActivity, profile

    from soft_contrastive_learning_torch.ops.kernels import wms

    geo, emb = _wms_inputs(cuda, b, d, b + 1)
    first = wms_loss_cuda(geo, emb, 0.8, 15.0)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        again = wms_loss_cuda(geo, emb, 0.8, 15.0)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type.name == "CUDA" and "wms" in e.name]
    assert len(kernels) in (0, 1)  # 0: the profiler recorded no kernel on this machine
    third = wms_loss_cuda(geo, emb, 0.8, 15.0)
    assert torch.equal(first, again) and torch.equal(first, third)
    barrier = wms._barrier(emb.device, torch.cuda.current_stream().cuda_stream)
    assert barrier.tolist()[0] == 0 and barrier.tolist()[2] == 0


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


def _conv_inputs(device, b, h, w, c, f, dtype=torch.bfloat16):
    gen = torch.Generator(device=device).manual_seed(b + h + w + c + f)
    x = torch.randn((b, h, w, c), generator=gen, device=device).to(dtype)
    weight = torch.randn((f, c, 3, 3), generator=gen, device=device) / (9 * c) ** 0.5
    bias = 0.1 * torch.randn((f,), generator=gen, device=device)
    return x, weight, bias


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("b,h,w,c,f", [
    (2, 8, 8, 128, 128),  # even, whole tiles
    (2, 11, 15, 256, 128),  # odd H and W: ragged last tile row and column
    (3, 9, 9, 128, 64),  # 75 tiles: a ragged last block of 32
    (4, 22, 30, 512, 512),  # the flagship's conv4_2, 16 channel chunks
    (50, 45, 60, 128, 256),  # conv3_1 at the training batch: 34,500 tiles, ragged last block
    (50, 22, 30, 512, 512),  # conv4_2 at the training batch: 8,250 tiles, ragged last block
    # every Winograd layer shape of the flagship at 180x240, B = 2 (2 x 16 tile
    # rectangles for conv2, 4 x 8 for the rest; 45 x 60 and 11 x 15 are odd)
    (2, 90, 120, 128, 128), (2, 45, 60, 128, 256), (2, 45, 60, 256, 256),
    (2, 22, 30, 256, 512), (2, 22, 30, 512, 512), (2, 11, 15, 512, 512),
])
def test_k4_matches_plain(cuda, b, h, w, c, f, relu):
    """Same roundings, another order of the fp32 sums: fp32 output within
    1e-4 of the largest output, the bound chip_smoke.py holds it to; bf16
    output equal after that tolerance; the same bits twice (no atomics)."""
    x, weight, bias = _conv_inputs(cuda, b, h, w, c, f)
    before = winograd_conv_cuda.launches
    got = winograd_conv_cuda(x, weight, bias, relu=relu, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert winograd_conv_cuda.launches == before + 1
    want = winograd_conv_plain(x, weight, bias, relu=relu, out_dtype=torch.float32)
    tol = 1e-4 * want.abs().max().item()
    torch.testing.assert_close(got, want, atol=tol, rtol=0)
    assert torch.equal(got, winograd_conv_cuda(x, weight, bias, relu=relu,
                                               out_dtype=torch.float32))
    got16 = winograd_conv_cuda(x, weight, bias, relu=relu)
    assert got16.dtype == torch.bfloat16
    torch.testing.assert_close(got16.float(), want, atol=tol, rtol=2.0 ** -7)


@pytest.mark.parametrize("c,f", [(128, 64), (512, 512), (5, 3)])
def test_k4_weight_transform_gives_the_plain_version_s_bits(cuda, c, f):
    """The same fp32 sums in the same order, rounded to bf16 once."""
    _, weight, _ = _conv_inputs(cuda, 1, 2, 2, c, f)
    got = weight_transform_cuda(weight)
    assert got.shape == (16, c, f) and got.dtype == torch.bfloat16
    assert torch.equal(got, weight_transform(weight).bfloat16())
    assert torch.equal(got, weight_transform(weight.cpu()).bfloat16().to(cuda))


def test_k4_takes_fp32_activations(cuda):
    """fp32 in, fp32 out, x rounded to bf16 on the way in, as the fp32
    compute type runs it."""
    x, weight, bias = _conv_inputs(cuda, 2, 11, 15, 128, 64, dtype=torch.float32)
    got = winograd_conv_cuda(x, weight, bias, relu=True)
    want = winograd_conv_plain(x, weight, bias, relu=True)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, atol=1e-4 * want.abs().max().item(), rtol=0)
    assert torch.equal(got, winograd_conv_cuda(x.bfloat16(), weight, bias, relu=True,
                                               out_dtype=torch.float32))


def test_k4_refuses_what_it_does_not_take(cuda):
    x, weight, bias = _conv_inputs(cuda, 2, 8, 8, 128, 64)
    with pytest.raises(ValueError, match="NHWC-contiguous"):
        winograd_conv_cuda(x.permute(0, 2, 1, 3), weight, bias)
    with pytest.raises(ValueError, match="C % 32"):
        winograd_conv_cuda(x[..., :24].contiguous(), weight[:, :24].contiguous(), bias)
    with pytest.raises(ValueError, match="F % 64"):
        winograd_conv_cuda(x, weight[:48].contiguous(), bias[:48].contiguous())
    with pytest.raises(TypeError):
        winograd_conv_cuda(x.half(), weight, bias)
    with pytest.raises(ValueError, match="bias on"):
        winograd_conv_cuda(x, weight, bias.cpu())
    with pytest.raises(RuntimeError, match="WinogradConvFn"):
        winograd_conv_cuda(x, weight.requires_grad_(), bias)
    flat = torch.empty(x.numel() + 1, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="16-byte-aligned"):  # TMA's base address
        winograd_conv_cuda(flat[1:].view(x.shape), weight.detach(), bias)


@pytest.mark.parametrize("relu", [False, True])
def test_k4_function_gradients_are_the_direct_conv_s(cuda, relu):
    """K4 forward; for one cotangent the backward is cuDNN's for the direct
    bf16 conv at the saved inputs: one bf16 step (2^-7) of each gradient's
    largest entry, since cuDNN may pick another algorithm for the same
    call."""
    x, weight, bias = _conv_inputs(cuda, 4, 22, 30, 256, 128)
    g = torch.randn((4, 22, 30, 128), device=cuda).bfloat16()

    def grads(fn):
        ins = [t.clone().requires_grad_() for t in (x, weight, bias)]
        return torch.autograd.grad(fn(*ins, relu), ins, g)

    before = winograd_conv_cuda.launches
    got = grads(WinogradConvFn.apply)
    assert winograd_conv_cuda.launches == before + 1
    want = grads(direct_conv)
    assert [t.dtype for t in got] == [torch.bfloat16, torch.float32, torch.float32]
    for a, r in zip(got, want):
        assert (a.float() - r.float()).abs().max() <= 2.0 ** -7 * r.float().abs().max()


def test_model_winograd_configuration_runs_k4(cuda):
    """Trained weights at 64x80: 10 K4 launches a forward, descriptors at
    cosine >= 0.999 to the standard bf16 model's."""
    imgs = torch.from_numpy(
        np.random.default_rng(4).integers(0, 256, (4, 64, 80, 3), dtype=np.uint8)).to(cuda)
    outs = []
    before = winograd_conv_cuda.launches
    for on in (True, False):
        cfg = ModelConfig(image_height=64, image_width=80, winograd=on)
        model = EmbeddingNet(cfg)
        model.load_state_dict(load_trained_params(cfg=cfg))
        with torch.inference_mode():
            outs.append(model.to(cuda).eval()(imgs)[1])
    assert winograd_conv_cuda.launches == before + 10
    assert ((outs[0] * outs[1]).sum(1) >= 0.999).all()


def _gemm_operands(device, shape_a, shape_b, dtype, exact):
    """Seeded operands: int8 values, or bf16 multiples of 1/8 in [-1, 1]
    (every product and partial sum exact in fp32), or bf16 normals."""
    gen = torch.Generator(device=device).manual_seed(sum(shape_a) + sum(shape_b))
    if dtype == torch.int8:
        return tuple(torch.randint(-127, 128, sh, generator=gen, device=device, dtype=torch.int8)
                     for sh in (shape_a, shape_b))
    if exact:
        return tuple((torch.randint(-8, 9, sh, generator=gen, device=device).float() / 8)
                     .bfloat16() for sh in (shape_a, shape_b))
    return tuple(torch.randn(sh, generator=gen, device=device).bfloat16()
                 for sh in (shape_a, shape_b))


@pytest.mark.parametrize("in_dtype,out_dtype", [(torch.bfloat16, torch.float32),
                                                (torch.bfloat16, torch.bfloat16),
                                                (torch.int8, torch.int32)])
@pytest.mark.parametrize("shape_a,shape_b", [((512, 256), (256, 256)),       # every tile shape
                                             ((16, 240, 128), (16, 128, 128)),  # ragged, batched
                                             ((3, 1000, 192), (3, 192, 320))])
def test_probe_gemm_is_bit_equal_to_plain_on_exact_operands(cuda, in_dtype, out_dtype, shape_a,
                                                            shape_b):
    """Whatever the order of the K loop, exact sums give the same bits: each
    type pair at every tile shape that divides N and K, rows past M masked."""
    a, b = _gemm_operands(cuda, shape_a, shape_b, in_dtype, exact=True)
    want = probe_gemm_plain(a, b, out_dtype)
    fits = [i for i, (_, bn, bk) in enumerate(CONFIGS[in_dtype])
            if shape_b[-1] % bn == 0 and shape_b[-2] % bk == 0]
    assert fits
    for config in [None] + fits:
        before = probe_gemm.launches
        got = probe_gemm(a, b, out_dtype, config)
        torch.cuda.synchronize()
        assert probe_gemm.launches == before + 1
        assert got.dtype == out_dtype and torch.equal(got, want), config


def test_probe_gemm_on_normals_and_what_it_refuses(cuda):
    """fp32 results within 1e-3 sqrt(K) max|a| max|b| of the plain version
    (two fp32 summation orders); bf16 results within one bf16 step or, near
    zero, twice the fp32 results' own difference."""
    a, b = _gemm_operands(cuda, (1024, 512), (512, 384), torch.bfloat16, exact=False)
    want = probe_gemm_plain(a, b, torch.float32)
    got = probe_gemm(a, b, torch.float32)
    e = (got - want).abs().max().item()
    assert e <= 1e-3 * 512 ** 0.5 * a.float().abs().max().item() * b.float().abs().max().item()
    w16 = probe_gemm_plain(a, b, torch.bfloat16).float()
    step = torch.ldexp(torch.ones_like(w16), torch.frexp(w16.abs().clamp_min(1e-30))[1] - 8)
    diff = (probe_gemm(a, b, torch.bfloat16).float() - w16).abs()
    assert (diff <= torch.clamp(step, min=2 * e)).all()
    with pytest.raises(ValueError, match="N % 256"):
        probe_gemm(a, b, torch.float32, config=0)
    with pytest.raises(ValueError, match="contiguous"):
        probe_gemm(a.t().contiguous().t(), b)
    with pytest.raises(ValueError, match="b on"):
        probe_gemm(a, b.cpu())
    with pytest.raises(TypeError, match="bfloat16 or int8"):
        probe_gemm(a.half(), b.half())
    flat = torch.empty(a.numel() + 8, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="16-byte-aligned"):  # TMA's base address
        probe_gemm(flat[1 : 1 + a.numel()].view(a.shape), b)
    with pytest.raises(ValueError, match="K % 64"):
        probe_gemm(a[:, :96].contiguous(), b[:96].contiguous(), torch.float32, config=1)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [1, 127, 129, 240, 360, 1000])
def test_every_wgmma_tile_is_bit_equal_at_ragged_m(cuda, m, out_dtype):
    """Each bf16 tile shape (wgmma fed by TMA) on exact operands, batched,
    with M not a multiple of the 128-row tile: TMA fills the rows past M of
    each batch entry with zeros and the epilogue drops them."""
    a, b = _gemm_operands(cuda, (3, m, 192), (3, 192, 256), torch.bfloat16, exact=True)
    want = probe_gemm_plain(a, b, out_dtype)
    for config in range(len(CONFIGS[torch.bfloat16])):
        got = probe_gemm(a, b, out_dtype, config)
        torch.cuda.synchronize()
        assert got.dtype == out_dtype and torch.equal(got, want), config


@pytest.mark.parametrize("m", [1, 127, 129, 240, 1000])
def test_every_int8_tile_is_bit_equal_at_ragged_m(cuda, m):
    """Each int8 tile shape (wgmma fed by TMA, after the transpose of B) on
    any int8 values, batched, with M not a multiple of the 128-row tile."""
    a, b = _gemm_operands(cuda, (3, m, 256), (3, 256, 256), torch.int8, exact=True)
    want = probe_gemm_plain(a, b, torch.int32)
    for config in range(len(CONFIGS[torch.int8])):
        got = probe_gemm(a, b, torch.int32, config)
        torch.cuda.synchronize()
        assert got.dtype == torch.int32 and torch.equal(got, want), config


def test_transpose_s8_is_the_transpose(cuda):
    """The int8 path's first kernel alone, as ``chip_smoke.py`` times it."""
    b = _gemm_operands(cuda, (1, 64), (2, 192, 320), torch.int8, exact=True)[1]
    assert torch.equal(transpose_s8(b), b.transpose(1, 2).contiguous())
    assert torch.equal(transpose_s8(b[0].contiguous())[0], b[0].t())


def test_choose_config_routes_by_type(cuda):
    """bf16 takes a bf16 wgmma tile (BK 64), int8 an int8 wgmma one (BK 128
    at the large problem), on the card as on the CPU."""
    assert CONFIGS[torch.bfloat16][choose_config(8192, 8192, 4096)] == (128, 256, 64)
    assert CONFIGS[torch.int8][choose_config(8192, 8192, 4096, dtype=torch.int8)] == \
        (128, 256, 128)


@pytest.mark.parametrize("b,h,w,c,f", [(2, 11, 15, 256, 128), (50, 22, 30, 512, 512),
                                       (3, 90, 120, 128, 128), (3, 5, 7, 128, 64)])
def test_winograd_stages_match_their_plain_versions(cuda, b, h, w, c, f):
    """``dma`` and ``transform``: integer checksums, equal. ``matmul``:
    within 1e-4 of the largest entry (two fp32 summation orders). ``full``:
    K4 itself, the same bits as ``winograd_conv_cuda``. The second shape
    ends in a ragged block of tiles; the third takes 2 x 16 tile rectangles
    (the others 4 x 8); the fourth has 3 tile blocks, rounded up to two
    clusters of 2 whose last block loads nothing but zeros and U."""
    x, weight, bias = _conv_inputs(cuda, b, h, w, c, f)
    for stage in ("dma", "transform"):
        before = winograd_stage.launches
        got = winograd_stage(stage, x, weight)
        torch.cuda.synchronize()
        assert winograd_stage.launches == before + 1
        assert torch.equal(got, winograd_stage_plain(stage, x, weight)), stage
    got, want = winograd_stage("matmul", x, weight), winograd_stage_plain("matmul", x, weight)
    assert got.shape == want.shape
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()
    before = (winograd_stage.launches, winograd_conv_cuda.launches)
    full = winograd_stage("full", x, weight, bias, relu=True)
    assert (winograd_stage.launches, winograd_conv_cuda.launches) == (before[0], before[1] + 1)
    assert torch.equal(full, winograd_conv_cuda(x, weight, bias, relu=True))
    with pytest.raises(ValueError, match="C % 32"):
        winograd_stage(0, x[..., :24].contiguous(), weight[:, :24].contiguous())


# ---------------------------------------------------------------- heads and the streaming PCAs

@pytest.mark.parametrize("reduction", ["1fc", "2fc", "pca", "spp"])
def test_heads_on_the_card_match_their_plain_path(cuda, reduction):
    """Trained backbone and a seeded head at 64x80, fp32: the output and
    full_out with the kernels at cosine >= 0.99999 to the plain path's; K1
    once a forward where NetVLAD runs (not with 'spp')."""
    from soft_contrastive_learning_torch.checkpoints.manager import warm_start_params
    from soft_contrastive_learning_torch.models.model import init_params

    imgs = torch.from_numpy(
        np.random.default_rng(5).integers(0, 256, (4, 64, 80, 3), dtype=np.uint8)).to(cuda)
    outs = []
    before = netvlad_aggregate_cuda.launches
    for kernels in (True, False):
        cfg = ModelConfig(image_height=64, image_width=80, compute_dtype="float32",
                          reduction=reduction, use_kernels=kernels)
        params, _ = warm_start_params(init_params(cfg, 0), load_trained_params(
            cfg=ModelConfig(image_height=64, image_width=80)))
        model = EmbeddingNet(cfg)
        model.load_state_dict(params)
        with torch.inference_mode():
            outs.append(model.to(cuda).eval()(imgs))
    assert netvlad_aggregate_cuda.launches == before + (reduction != "spp")
    for got, want in zip(outs[0], outs[1]):
        assert got.shape == want.shape
        cos = (got * want).sum(1) / (got.norm(dim=1) * want.norm(dim=1))
        assert (cos >= 0.99999).all(), cos


def test_dropout_masks_on_the_card_come_from_the_step_s_generator(cuda):
    """The same CUDA generator state draws the same masks; the global CUDA
    generator is not touched."""
    from soft_contrastive_learning_torch.models.heads import dropout

    x = torch.ones(8, 4096, device=cuda)
    before = torch.cuda.get_rng_state()
    a = dropout(x, 0.5, torch.Generator(device=cuda).manual_seed(3))
    b = dropout(x, 0.5, torch.Generator(device=cuda).manual_seed(3))
    assert torch.equal(a, b) and torch.equal(torch.cuda.get_rng_state(), before)
    assert abs((a == 0).float().mean().item() - 0.5) < 0.02


def test_async_pca_updater_takes_card_tensors(cuda):
    """Tensors on the card, with a graph: the worker copies them to the host
    itself, and the state equals the same updates from host arrays."""
    from soft_contrastive_learning_torch.pca.async_updater import AsyncPCAUpdater
    from soft_contrastive_learning_torch.pca.incremental import StreamingPCA

    rng = np.random.default_rng(6)
    blocks = [rng.standard_normal((20, 256)).astype(np.float32) for _ in range(4)]
    pcas = []
    for on_card in (True, False):
        pca = StreamingPCA(8)
        pca.init(blocks[0])
        updater = AsyncPCAUpdater(pca, None)
        for x in blocks[1:]:
            if on_card:
                w = torch.from_numpy(x).to(cuda).requires_grad_()
                updater.submit(w * 1.0, None)
            else:
                updater.submit(x, None)
            updater.feed_states()
        updater.close()
        pcas.append(pca.state_dict())
    assert all(np.array_equal(np.asarray(pcas[0][k]), np.asarray(pcas[1][k])) for k in pcas[0])


@pytest.mark.parametrize("name", ["incremental_residual_mm", "incremental_mm"])
def test_incremental_loss_on_the_card_matches_float64(cuda, name):
    """At the flagship's width (D = 32,768, loss_dim 64, 2 tuples of 1+12+12):
    the fp32 loss within 1e-5 of its float64 evaluation, the gradient within
    5e-4 of its largest entry (the ``losses`` phase's gates)."""
    from soft_contrastive_learning_torch.core.config import LossConfig, TupleConfig
    from soft_contrastive_learning_torch.losses.incremental import PCAState
    from soft_contrastive_learning_torch.losses.registry import build_loss, split_batch
    from soft_contrastive_learning_torch.pca.incremental import StreamingPCA

    gen = torch.Generator(device=cuda).manual_seed(7)
    emb = torch.randn((50, 32768), generator=gen, device=cuda)
    emb = emb / emb.norm(dim=1, keepdim=True)
    pca = StreamingPCA(64)
    pca.init(np.random.default_rng(8).standard_normal((100, 32768)).astype(np.float32) / 128)
    fn = build_loss(LossConfig(name=name, loss_dim=64), TupleConfig(), 2)
    res = {}
    for dtype in (torch.float32, torch.float64):
        st = PCAState(*(torch.as_tensor(np.asarray(a)).to(cuda, dtype)
                        for a in (pca.s, pca.v, pca.m, np.float32(pca.seen))))
        e = emb.to(dtype, copy=True).requires_grad_()
        total = fn(split_batch(e, 2, (1, 12, 12)), {}, st).total
        res[dtype] = (total.item(), torch.autograd.grad(total, e)[0].double())
    (v32, g32), (v64, g64) = res[torch.float32], res[torch.float64]
    assert abs(v32 - v64) <= 1e-5 * max(1.0, abs(v64))
    assert (g32 - g64).abs().max().item() <= 5e-4 * g64.abs().max().item()


def _q1_inputs(device, b, h, w, c, f, taps, seed):
    """Seeded int8 x (B, H, W, C) and K-major w (F, T, T, C) over the full
    int8 range, and an epilogue's fp32 mult and bias at the trained stack's
    magnitudes."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randint(-127, 128, (b, h, w, c), generator=gen, device=device, dtype=torch.int8)
    wt = torch.randint(-127, 128, (f, taps, taps, c), generator=gen, device=device,
                       dtype=torch.int8)
    mult = torch.rand(f, generator=gen, device=device) * 4e-4 / c
    bias = torch.randn(f, generator=gen, device=device)
    return x, wt, mult, bias


@pytest.mark.parametrize("b,h,w,c,f", [
    (2, 11, 15, 512, 512),   # conv5's map: a ragged tile in both directions
    (2, 22, 30, 256, 512),   # conv4_1
    (1, 45, 60, 128, 256),   # conv3_1
    (1, 18, 24, 64, 128),    # C = 64 (BK 64), F = 128 (BN 128)
    (3, 9, 17, 64, 64),      # BN 64, odd sizes
    (1, 5, 7, 64, 64),       # a map smaller than one tile
])
@pytest.mark.parametrize("out_f32,relu", [(False, True), (False, False), (True, False)])
def test_q1_int8_conv_equals_its_plain_version(cuda, b, h, w, c, f, out_f32, relu):
    """Q1 (implicit GEMM on integer wgmma fed by TMA, SAME padding by TMA's
    zero fill, the epilogue fused) against int8_conv_plain: the int8 maps
    equal, the fp32 output equal (the same fp32 multiply and add). Q1 takes
    the fp32 output (the stack's conv5_3) at F a multiple of 256 only and
    refuses it below."""
    from soft_contrastive_learning_torch.ops.kernels.int8_conv import (
        int8_conv, int8_conv_plain)

    x, wt, mult, bias = _q1_inputs(cuda, b, h, w, c, f, 3, b + h + w + c + f)
    inv = float(np.float32(1.0 / 0.05))
    if out_f32 and f % 256:
        with pytest.raises(ValueError, match="F of 256 for an fp32 output"):
            int8_conv(x, wt, mult, bias, inv, relu, out_f32)
        return
    got = int8_conv(x, wt, mult, bias, inv, relu, out_f32)
    want = int8_conv_plain(x, wt, mult, bias, inv, relu, out_f32)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and got.shape == want.shape == (b, h, w, f)
    if out_f32:
        assert torch.equal(got, want), (got - want).abs().max().item()
    else:
        assert torch.equal(got, want), (got != want).sum().item()
        assert got.abs().max().item() > 0


def test_q1_stem_columns_through_the_kernel(cuda):
    """The stem (C = 3): the packed 3x3 columns that Q1_stem gathers in its
    producer, by ``stem_weight``, equal the plain 3x3 conv (no columns) of
    the requantized three channels."""
    from soft_contrastive_learning_torch.ops.kernels.int8_conv import (
        int8_conv_plain, int8_stem, requant_plain, stem_weight)

    _, wt, mult, bias = _q1_inputs(cuda, 1, 1, 1, 3, 64, 3, 11)
    gen = torch.Generator(device=cuda).manual_seed(11)
    img = torch.randint(0, 256, (2, 13, 21, 3), generator=gen, device=cuda, dtype=torch.uint8)
    avg = torch.tensor([123.68, 116.779, 103.939], device=cuda)
    inv_in, inv = float(np.float32(1.0 / 1.2)), float(np.float32(1.0 / 0.02))
    mult = mult * 10.0
    got = int8_stem(img, avg, inv_in, stem_weight(wt), mult, bias, inv)
    want = int8_conv_plain(requant_plain(img.float() - avg, inv_in), wt, mult, bias, inv, True,
                           False)
    torch.cuda.synchronize()
    assert torch.equal(got, want), (got != want).sum().item()
    assert got.abs().max().item() > 0


# (C, F, fp32 out) reaching each tile shape tile_shape picks: int8 8x16 tiles
# by 64 at BK 64 with the weights resident (C = F = 64: one consumer
# warpgroup, two blocks an SM); 16x16 by 128 at BK 64, F one tile or several,
# also where F is a multiple of 256 but C not of 128; 8x16 by 256 at BK 128;
# fp32 8x16 by 256 at BK 64
Q1_TILE_CASES = [(64, 64, False), (64, 128, False), (128, 128, False), (64, 256, False),
                 (128, 384, False), (128, 256, False), (512, 512, False), (64, 256, True),
                 (128, 512, True), (512, 512, True)]


@pytest.mark.parametrize("h,w", [(11, 15), (13, 21), (45, 60)])
@pytest.mark.parametrize("c,f,out_f32", Q1_TILE_CASES)
def test_q1_every_tile_shape_at_the_edge_maps(cuda, c, f, out_f32, h, w):
    """Every tile shape Q1 compiles, on maps whose edges cut its tiles (TMA's
    zero fill on the loads, its clipping on the stores): equal to the plain
    version, int8 and fp32."""
    from soft_contrastive_learning_torch.ops.kernels.int8_conv import (
        _lib, int8_conv, int8_conv_plain, tile_shape)

    th, _, bn, bk, cons = tile_shape(c, f, out_f32)
    assert _lib().scl_int8_conv_config(0, th, bn, bk, int(out_f32), cons, c) >= 4
    assert _lib().scl_int8_conv_config(4, th, bn, bk, int(out_f32), cons, c) == (bn == 64)
    x, wt, mult, bias = _q1_inputs(cuda, 2, h, w, c, f, 3, c + f + h + w)
    inv = float(np.float32(1.0 / 0.05))
    got = int8_conv(x, wt, mult, bias, inv, True, out_f32)
    want = int8_conv_plain(x, wt, mult, bias, inv, True, out_f32)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (2, h, w, f) and got.dtype == want.dtype
    assert torch.equal(got, want), (got != want).sum().item()


@pytest.mark.parametrize("b,h,w,c,f", [
    (64, 45, 60, 128, 256),   # 1,536 tiles: many more than resident blocks
    (7, 90, 120, 64, 128),    # 2,688 tiles, not a multiple of the SM count
    (1, 180, 240, 64, 64),    # B = 1: 180 tiles over the full map
    (1, 11, 15, 512, 512),    # 4 tiles: fewer than the SMs
    (3, 22, 30, 512, 512),    # 36 tiles at K = 4,608
])
def test_q1_persistent_grid(cuda, b, h, w, c, f):
    """The persistent blocks walk every tile once, whatever the count of
    tiles against the SMs: equal to the plain version, and the same bits
    twice."""
    from soft_contrastive_learning_torch.ops.kernels.int8_conv import (
        int8_conv, int8_conv_plain)

    x, wt, mult, bias = _q1_inputs(cuda, b, h, w, c, f, 3, b * h + w + c + f)
    inv = float(np.float32(1.0 / 0.05))
    got = int8_conv(x, wt, mult, bias, inv, True, False)
    again = int8_conv(x, wt, mult, bias, inv, True, False)
    want = int8_conv_plain(x, wt, mult, bias, inv, True, False)
    torch.cuda.synchronize()
    assert torch.equal(got, want), (got != want).sum().item()
    assert torch.equal(got, again)


@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32])
@pytest.mark.parametrize("b,h,w", [(2, 11, 15), (2, 13, 21), (2, 45, 60), (3, 180, 240),
                                   (1, 1, 1)])
def test_q1_stem_equals_its_plain_version(cuda, dtype, b, h, w):
    """Q1_stem (the requant of the raw pixels, the 3x3 gather into 32-byte A
    rows and conv1_1 in one kernel) against its plain version (the torch
    requant, ``stem_columns``, the plain conv): the int8 maps equal, from
    uint8 and from fp32 pixels, on maps whose edges cut its 8x16 tiles."""
    from soft_contrastive_learning_torch.ops.kernels.int8_conv import (
        int8_stem, int8_stem_plain, stem_weight)

    gen = torch.Generator(device=cuda).manual_seed(b + h + w)
    if dtype == torch.uint8:
        img = torch.randint(0, 256, (b, h, w, 3), generator=gen, device=cuda, dtype=torch.uint8)
    else:
        img = torch.rand((b, h, w, 3), generator=gen, device=cuda) * 255.0
    avg = torch.tensor([123.68, 116.779, 103.939], device=cuda)
    inv_in = float(np.float32(1.0 / 1.2))
    _, wt, mult, bias = _q1_inputs(cuda, 1, 1, 1, 3, 64, 3, 5)
    mult = mult * 10.0
    inv = float(np.float32(1.0 / 0.02))
    args = (avg, inv_in, stem_weight(wt), mult, bias, inv)
    got = int8_stem(img, *args)
    want = int8_stem_plain(img, *args)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (b, h, w, 64) and got.dtype == torch.int8
    assert torch.equal(got, want), (got != want).sum().item()
    assert got.abs().max().item() > 0


@pytest.mark.parametrize("shape", [(2, 180, 240, 64), (3, 11, 15, 512), (1, 45, 60, 256)])
def test_q1_pool_equals_its_plain_version(cuda, shape):
    from soft_contrastive_learning_torch.ops.kernels.int8_conv import (
        int8_pool, int8_pool_plain)

    gen = torch.Generator(device=cuda).manual_seed(sum(shape))
    x = torch.randint(-128, 128, shape, generator=gen, device=cuda, dtype=torch.int8)
    got = int8_pool(x)
    torch.cuda.synchronize()
    assert torch.equal(got, int8_pool_plain(x))


def test_q1_refuses_what_it_does_not_take(cuda):
    from soft_contrastive_learning_torch.ops.kernels.int8_conv import (
        int8_conv, int8_pool, int8_stem, stem_weight)

    x, wt, mult, bias = _q1_inputs(cuda, 1, 8, 8, 48, 64, 3, 3)
    with pytest.raises(ValueError, match="multiples of 64"):
        int8_conv(x, wt, mult, bias, 1.0, True, False)
    x, wt, mult, bias = _q1_inputs(cuda, 1, 8, 8, 64, 64, 1, 3)
    with pytest.raises(ValueError, match="3x3"):
        int8_conv(x, wt, mult, bias, 1.0, True, False)
    for c, f in ((256, 64), (64, 192)):  # F = 64 only at C = 64, its weights resident
        x, wt, mult, bias = _q1_inputs(cuda, 1, 8, 8, c, f, 3, 3)
        with pytest.raises(ValueError, match="F of 128 but at C = F = 64"):
            int8_conv(x, wt, mult, bias, 1.0, True, False)
    with pytest.raises(ValueError, match="multiple of 16"):
        int8_pool(torch.zeros((1, 4, 4, 8), dtype=torch.int8, device=cuda))
    _, w3, mult, bias = _q1_inputs(cuda, 1, 1, 1, 3, 64, 3, 3)
    avg = torch.zeros(3, device=cuda)
    with pytest.raises(TypeError, match="uint8 or fp32"):
        int8_stem(torch.zeros((1, 4, 4, 3), dtype=torch.int32, device=cuda), avg, 1.0,
                  stem_weight(w3), mult, bias, 1.0)
    with pytest.raises(ValueError, match="packed int8 weights"):
        int8_stem(torch.zeros((1, 4, 4, 3), device=cuda), avg, 1.0, w3, mult, bias, 1.0)


def test_async_refresh_on_the_card_equals_a_sync_one(cuda, tmp_path):
    """The async mining refresh on the card: the worker embeds (K1) with its
    copy of the boundary's weights on the training stream, while the live
    weights move; its window and neighbour order equal a sync refresh's
    from the same weights bit for bit, and a whole async epoch lands every
    refresh."""
    import threading

    from soft_contrastive_learning_torch.core.config import (
        LossConfig, TrainConfig, TupleConfig)
    from soft_contrastive_learning_torch.data.pipeline import ToyCitySource
    from soft_contrastive_learning_torch.train.trainer import Trainer

    cfg = TrainConfig(
        model=ModelConfig(vlad_cores=8, image_height=64, image_width=80),
        tuples=TupleConfig(positives_per_tuple=3, negatives_per_tuple=3,
                           hard_positives_per_tuple=1, hard_negatives_per_tuple=1),
        loss=LossConfig(name="wms", fused_wms=True), tuples_per_batch=1, max_epoch=1,
        mining_step=6, mining_cache_size=10, eval_step=10**9, save_step=10**9,
        num_eval_queries=4, eval_ref_r=4, async_mining=True, seed=0)
    tr = Trainer(cfg, ToyCitySource(num_points=24, radius=30.0, img_h=64, img_w=80, seed=3),
                 out_dir=str(tmp_path), device="cuda")
    meta = tr.source.epoch_meta(cfg.local_ref_set, 0)
    anchors = np.asarray(tr.source.anchor_indices(cfg.local_ref_set, cfg.train_ref_r, 0), int)
    tr._ensure_image_pool(meta)
    tr._mining_refresh(0, 6, 1, meta, anchors)
    want = (tr.mining_cache._indices.copy(), tr.mining_cache._order.copy())
    tr.mining_cache.refresh(np.zeros(1, dtype=int), np.zeros((1, 1), dtype=int))
    before = netvlad_aggregate_cuda.launches
    tr._spawn_mining_refresh(0, 6, 1, meta, anchors)
    with torch.no_grad():  # launched behind the snapshot's copy on the same stream
        for p in tr.state.model.parameters():
            p.mul_(-1.0)
    tr._join_mining()
    assert netvlad_aggregate_cuda.launches - before == 3  # 16 images in chunks of 7
    np.testing.assert_array_equal(tr.mining_cache._indices, want[0])
    np.testing.assert_array_equal(tr.mining_cache._order, want[1])

    spawned = []
    spawn = tr._spawn_mining_refresh
    tr._spawn_mining_refresh = lambda *a: (spawned.append(a[1]), spawn(*a))[1]
    tr.mining.refresh_count = 0
    tr.train_one_epoch(0)
    assert spawned == [6, 12, 18] and tr.mining.refresh_count == 4
    assert tr._mining_thread is None and tr._mining_error is None
    assert not [t for t in threading.enumerate() if t.name == "mining-refresh"]
    losses = [r["value"] for r in tr.writers["local"].read_all() if r["tag"] == "loss"]
    assert len(losses) == 24 and np.isfinite(losses).all()
    tr.close()


def test_k2_on_each_shard_of_a_sharded_search(cuda):
    """``topk_l2_sharded`` over two ranks that share the card (gloo): K2
    runs on each rank's half of the index, and every rank's merged result
    equals an fp64 search of the whole index (inputs in eighths: every
    squared distance exact; duplicated rows, whose ties go to the smaller
    id): ids identical, distances within 1e-6 relative."""
    from soft_contrastive_learning_torch import dryrun
    from soft_contrastive_learning_torch.launch.multihost import run_ranks

    rng = np.random.default_rng(21)
    refs = (rng.integers(-8, 9, (10_000, 256)) / 8.0).astype(np.float32)
    refs[7_000] = refs[12]  # a tie across the two shards
    queries = (rng.integers(-8, 9, (64, 256)) / 8.0).astype(np.float32)
    queries[0] = refs[12]
    sq = ((queries[:, None, :].astype(np.float64) - refs[None].astype(np.float64)) ** 2).sum(-1)
    want_i = np.argsort(sq, axis=1, kind="stable")[:, :5]
    want_d = np.sqrt(np.take_along_axis(sq, want_i, axis=1))
    ranks = run_ranks(dryrun.sharded_topk, 2, (queries, refs, 5), device="cuda", timeout_s=300)
    for got_d, got_i, launches in ranks:
        assert launches >= 1
        np.testing.assert_array_equal(got_i, want_i)
        np.testing.assert_allclose(got_d, want_d, rtol=1e-6, atol=0)
    assert ranks[0][1][0, 0] == 12


def test_prep_image_ops_on_the_card_equal_the_cpu(cuda, tmp_path):
    """The downsize's demosaic -> undistort -> resize on RobotCar-sized
    Bayer frames (960x1280, a LUT whose corners leave the frame): the card's
    bits are the CPU's, op by op."""
    from soft_contrastive_learning_torch.data.robotcar.downsize import (
        UndistortLUT, demosaic_gbrg, downsize_batch)

    rng = np.random.default_rng(31)
    raw = torch.from_numpy(rng.integers(0, 256, (3, 960, 1280), dtype=np.uint8))
    yy, xx = np.mgrid[0:960, 0:1280].astype(np.float64)
    k = 1 + 0.1 * (((xx - 639.5) / 640) ** 2 + ((yy - 479.5) / 480) ** 2)
    path = str(tmp_path / "lut.bin")
    np.stack([(639.5 + (xx - 639.5) * k).ravel(), (479.5 + (yy - 479.5) * k).ravel()]).tofile(path)
    lut_cpu, lut_card = UndistortLUT(path, (960, 1280), "cpu"), UndistortLUT(path, (960, 1280),
                                                                             cuda)
    rgb = demosaic_gbrg(raw)
    assert torch.equal(demosaic_gbrg(raw.to(cuda)).cpu(), rgb)
    assert torch.equal(lut_card(rgb.to(cuda)).cpu(), lut_cpu(rgb))
    small = downsize_batch(raw, 240, lut_cpu)
    assert small.shape == (3, 180, 240, 3)
    assert torch.equal(downsize_batch(raw.to(cuda), 240, lut_card).cpu(), small)


@pytest.mark.parametrize("b", [8, 64])
def test_int8_packed_stem_equals_q1(cuda, b):
    """The int8 stack with ``packed_stem`` (im2col + torch._int_mm for
    conv1_1 .. conv2_1) against the direct stack (Q1_stem, Q1, Q1_pool) on
    the trained flagship at 180x240: conv5_3's fp32 map equal bit for bit."""
    from soft_contrastive_learning_torch.models.quant import QuantizedConvStack, calibrate_scales

    cfg = ModelConfig(compute_dtype="float32")
    params = load_trained_params(cfg=cfg)
    images = np.random.default_rng(b).integers(0, 256, (b, 180, 240, 3), dtype=np.uint8)
    scales = calibrate_scales(params, images[:8], cuda)
    packed = QuantizedConvStack(params, scales, cuda, packed_stem=True)
    direct = QuantizedConvStack(params, scales, cuda)
    x = torch.from_numpy(images).to(cuda)
    assert torch.equal(packed(x), direct(x))


JPEG_FIXTURES = Path(__file__).resolve().parents[1] / "soft_contrastive_learning_torch" / "assets" / "jpeg"


def _jpeg_digests():
    import json

    return json.loads((JPEG_FIXTURES / "digests.json").read_text())


def test_j1_and_the_compiled_decoder_on_the_fixtures(cuda):
    """Every committed JPEG fixture in both of OpenCV's modes (``file``:
    cv2.imread, ``buffer``: cv2.imdecode): the compiled entropy decoder gives
    the plain Python decoder's coefficients, tables and frame (smoothing
    state included); J1 on the card is bit-equal to the plain pixel stage on
    the card and hashes to OpenCV's committed digest; where OpenCV gives no
    image both decoders refuse with the reason."""
    import hashlib

    from soft_contrastive_learning_torch.ops.kernels.jpeg import entropy_decode, jpeg_pixels_cuda
    from soft_contrastive_learning_torch.utils.jpeg import decode_coefficients, pixels_plain

    table = _jpeg_digests()
    for name, modes in table["fixtures"].items():
        data = (JPEG_FIXTURES / name).read_bytes()
        for mode, want in modes.items():
            if "refused" in want:
                for decode in (entropy_decode, decode_coefficients):
                    with pytest.raises(ValueError, match=want["refused"]):
                        decode(data, name, mode)
                continue
            co = entropy_decode(data, name, mode)
            ref = decode_coefficients(data, name, mode)
            assert np.array_equal(co.coefs, ref.coefs) and np.array_equal(co.quant, ref.quant), name
            assert co.frame == ref.frame, name
            coefs, quant = torch.from_numpy(co.coefs).to(cuda), torch.from_numpy(co.quant).to(cuda)
            got = jpeg_pixels_cuda(coefs, quant, co.frame)
            plain = pixels_plain(coefs, quant, co.frame)
            torch.cuda.synchronize()
            assert torch.equal(got, plain), (name, mode)
            assert list(got.shape) == want["shape"], name
            assert hashlib.sha256(got.cpu().numpy().tobytes()).hexdigest() == want["sha256"], name


def test_compiled_decoder_equals_plain_on_cut_and_changed_files(cuda):
    """The 32x48 fixture cut at every 7th byte (with and without an EOI
    after) and with 300 single bytes changed, as a file and as bytes: the
    compiled entropy decoder refuses where the plain one does and otherwise
    gives its coefficients, tables and frame."""
    from soft_contrastive_learning_torch.ops.kernels.jpeg import entropy_decode
    from soft_contrastive_learning_torch.utils.jpeg import decode_coefficients

    seed = (JPEG_FIXTURES / "small_32x48.jpg").read_bytes()
    rng = np.random.default_rng(18)
    cases = [seed[:c] for c in range(3, len(seed), 7)]
    cases += [seed[:c] + b"\xff\xd9" for c in range(3, len(seed), 7)]
    for _ in range(300):
        d = bytearray(seed)
        d[rng.integers(2, len(d))] = rng.integers(0, 256)
        cases.append(bytes(d))

    def outcome(fn, data, mode):
        try:
            co = fn(data, "f", mode)
        except ValueError:
            return None
        return co.coefs.tobytes(), co.quant.tobytes(), co.frame

    for data in cases:
        for mode in ("file", "buffer"):
            assert outcome(entropy_decode, data, mode) == outcome(decode_coefficients, data, mode)


@pytest.mark.parametrize("colour", ["cmyk", "ycck"])
@pytest.mark.parametrize("smooth", [False, True])
def test_j1_equals_plain_with_four_components_and_smoothing(cuda, colour, smooth):
    """J1 against the plain stage on random coefficients of 4-component
    frames (CMYK and YCCK, 4:2:0 and 4:4:4) and 3-component ones, with and
    without block smoothing (random known bits per coefficient, some rows
    after the last whole iMCU row), over partial MCUs and orientations."""
    from soft_contrastive_learning_torch.ops.kernels.jpeg import jpeg_pixels_cuda
    from soft_contrastive_learning_torch.utils import jpeg

    gen = torch.Generator().manual_seed(int(smooth) * 7 + len(colour))
    for (h, w), layout, orientation in (((37, 45), ((2, 2), (1, 1)), 1), ((181, 243), ((1, 1),), 6),
                                        ((17, 9), ((2, 1), (1, 1)), 3), ((8, 3), ((1, 1),), 1)):
        for nc in (4, 3):
            comps = [jpeg.Component(i + 1, *(layout[0] if i == 0 else layout[-1]), 0)
                     for i in range(nc)]
            hm, vm = max(c.h for c in comps), max(c.v for c in comps)
            for c in comps:
                c.dw, c.dh = -(-w * c.h // hm), -(-h * c.v // vm)
                c.bw = -(-w // (8 * hm)) * c.h
                c.bh = -(-h // (8 * vm)) * c.v
            col = {"cmyk": jpeg.CMYK, "ycck": jpeg.YCCK}[colour] if nc == 4 else jpeg.YCC
            frame = jpeg.Frame(h, w, col, orientation, comps)
            if smooth:
                bits = torch.randint(-1, 3, (nc, 20), generator=gen)
                bits[:, 0] = torch.randint(0, 2, (nc,), generator=gen)
                bits[:, 10] = 0
                if nc == 3:
                    bits[1:, 1:10] = -1  # chroma: only the DC known (interpolated)
                frame.smoothing = (frame.imcu_rows // 2, *bits.flatten().tolist())
            n = frame.block_offsets()[-1]
            coefs = torch.zeros((n, 64), dtype=torch.int16)
            coefs[:, 0] = torch.randint(-700, 700, (n,), generator=gen, dtype=torch.int16)
            coefs[:, 1:12] = torch.randint(-4, 5, (n, 11), generator=gen, dtype=torch.int16)
            quant = torch.randint(1, 9, (nc, 64), generator=gen, dtype=torch.int32)
            plain = jpeg.pixels_plain(coefs, quant, frame)
            got = jpeg_pixels_cuda(coefs.to(cuda), quant.to(cuda), frame)
            torch.cuda.synchronize()
            assert torch.equal(got.cpu(), plain), (h, w, nc)


@pytest.mark.parametrize("orientation", range(1, 9))
@pytest.mark.parametrize("layout", [((2, 2), (1, 1)), ((2, 1), (1, 1)), ((1, 2), (1, 1)),
                                    ((1, 1), (1, 1)), ((4, 1), (1, 1)), ((2, 2), (2, 1)),
                                    ((1, 1),)])
def test_j1_equals_plain_on_random_coefficients(cuda, layout, orientation):
    """J1 against the plain stage on random coefficients (DC and low AC
    terms, some saturating) over sampling layouts, partial MCUs, narrow
    chroma and every orientation."""
    from soft_contrastive_learning_torch.ops.kernels.jpeg import jpeg_pixels_cuda
    from soft_contrastive_learning_torch.utils import jpeg

    gen = torch.Generator().manual_seed(orientation * 31 + len(layout))
    for h, w in ((37, 45), (8, 3), (181, 243), (1, 1)):
        comps = [jpeg.Component(i + 1, layout[i % len(layout)][0], layout[i % len(layout)][1], 0)
                 for i in range(1 if len(layout) == 1 else 3)]
        if len(comps) == 3:
            comps[2].h, comps[2].v = comps[1].h, comps[1].v
        hm, vm = max(c.h for c in comps), max(c.v for c in comps)
        for c in comps:
            c.dw, c.dh = -(-w * c.h // hm), -(-h * c.v // vm)
            c.bw = -(-w // (8 * hm)) * c.h if len(comps) > 1 else -(-c.dw // 8)
            c.bh = -(-h // (8 * vm)) * c.v if len(comps) > 1 else -(-c.dh // 8)
        colour = jpeg.GRAY if len(comps) == 1 else jpeg.YCC
        frame = jpeg.Frame(h, w, colour, orientation, comps)
        n = frame.block_offsets()[-1]
        coefs = torch.zeros((n, 64), dtype=torch.int16)
        coefs[:, 0] = torch.randint(-1100, 1100, (n,), generator=gen, dtype=torch.int16)
        coefs[:, 1:10] = torch.randint(-60, 61, (n, 9), generator=gen, dtype=torch.int16)
        quant = torch.randint(1, 9, (len(comps), 64), generator=gen, dtype=torch.int32)
        plain = jpeg.pixels_plain(coefs, quant, frame)
        got = jpeg_pixels_cuda(coefs.to(cuda), quant.to(cuda), frame)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), plain), (h, w)


def test_j1_refuses_what_it_does_not_take(cuda):
    from soft_contrastive_learning_torch.ops.kernels.jpeg import entropy_decode, jpeg_pixels_cuda

    co = entropy_decode((JPEG_FIXTURES / "c420_q95.jpg").read_bytes(), "c420_q95.jpg")
    coefs, quant = torch.from_numpy(co.coefs).to(cuda), torch.from_numpy(co.quant).to(cuda)
    with pytest.raises(TypeError):
        jpeg_pixels_cuda(coefs.to(torch.int32), quant, co.frame)
    with pytest.raises(ValueError):
        jpeg_pixels_cuda(coefs[:-1], quant, co.frame)
    with pytest.raises(ValueError):
        jpeg_pixels_cuda(coefs, quant.cpu(), co.frame)
    two = dataclasses.replace(co.frame, components=co.frame.components[:2])
    with pytest.raises(ValueError, match="2 components"):  # no colour of two planes
        jpeg_pixels_cuda(coefs[: two.block_offsets()[-1]], quant[:2], two)


def test_j1_batches_every_fixture_in_one_launch(cuda):
    """Every fixture that decodes, in both modes, as one batch: one J1
    launch (``jpeg_pixels_batch``, on the decoder's stream), each image
    bit-equal to the plain stage on the card and hashing to OpenCV's digest;
    the same through ``jpeg_pixels_host`` (one launch, one download); 64
    180x240 images in one launch."""
    import hashlib

    from soft_contrastive_learning_torch.ops.kernels.jpeg import (
        entropy_decode, jpeg_pixels_batch, jpeg_pixels_cuda, jpeg_pixels_host)
    from soft_contrastive_learning_torch.utils.jpeg import pixels_plain

    table = _jpeg_digests()
    batch, want = [], []
    for name, modes in sorted(table["fixtures"].items()):
        for mode, entry in modes.items():
            if "sha256" in entry:
                batch.append(entropy_decode((JPEG_FIXTURES / name).read_bytes(), name, mode))
                want.append(entry)
    before = jpeg_pixels_cuda.launches
    got = jpeg_pixels_batch(batch, cuda)
    host = jpeg_pixels_host(batch, cuda)
    assert jpeg_pixels_cuda.launches - before == 2
    for co, img, arr, entry in zip(batch, got, host, want):
        plain = pixels_plain(torch.from_numpy(co.coefs).to(cuda), torch.from_numpy(co.quant).to(cuda),
                             co.frame)
        assert torch.equal(img, plain) and np.array_equal(arr, plain.cpu().numpy())
        assert hashlib.sha256(arr.tobytes()).hexdigest() == entry["sha256"]
    small = [co for co in batch if co.frame.height == 180][:16] * 4
    before = jpeg_pixels_cuda.launches
    for co, img in zip(small, jpeg_pixels_batch(small, cuda)):
        assert np.array_equal(img.cpu().numpy(), pixels_plain(
            torch.from_numpy(co.coefs), torch.from_numpy(co.quant), co.frame).numpy())
    assert jpeg_pixels_cuda.launches - before == 1 and len(small) == 64


def test_decode_imgs_on_the_card_equals_the_cpu(cuda, tmp_path):
    """``decode_imgs`` of PNGs and JPEGs on the card (the JPEGs in one J1
    launch) equals the CPU's decode; a truncated upload in buffer mode
    raises naming it, with no launch."""
    from soft_contrastive_learning_torch.ops.kernels.jpeg import jpeg_pixels_cuda
    from soft_contrastive_learning_torch.utils.io import decode_imgs, save_img

    png = tmp_path / "x.png"
    save_img(np.random.default_rng(0).integers(0, 256, (20, 30, 3), dtype=np.uint8), str(png))
    names = ["c420_q95.jpg", "orient7.jpg", "ycck_420.jpg", "frame_1280x960.jpg"]
    datas = [(JPEG_FIXTURES / n).read_bytes() for n in names] + [png.read_bytes()]
    before = jpeg_pixels_cuda.launches
    got = decode_imgs(datas, names + ["x.png"], cuda)
    assert jpeg_pixels_cuda.launches - before == 1
    for a, b in zip(got, decode_imgs(datas, names + ["x.png"], "cpu")):
        assert np.array_equal(a, b)
    cut = (JPEG_FIXTURES / "truncated_no_eoi.jpg").read_bytes()
    before = jpeg_pixels_cuda.launches
    with pytest.raises(ValueError, match=r"^cut\.jpg: .*truncated"):
        decode_imgs(datas[:2] + [cut], names[:2] + ["cut.jpg"], cuda)
    assert jpeg_pixels_cuda.launches == before


def test_j1_from_eight_threads_at_once_gives_opencvs_pixels(cuda):
    """``decode_img`` of the fixtures from 8 threads at once, then
    ``decode_imgs`` batches from 4: each thread packs into and downloads
    through its own pinned buffers and enqueues on the decoder's one stream;
    every image hashes to OpenCV's digest (buffer mode)."""
    import hashlib
    from concurrent.futures import ThreadPoolExecutor

    from soft_contrastive_learning_torch.utils.io import decode_img, decode_imgs

    table = _jpeg_digests()
    names = [n for n, modes in sorted(table["fixtures"].items()) if "sha256" in modes["buffer"]]
    datas = {n: (JPEG_FIXTURES / n).read_bytes() for n in names}
    work = (names * 4)[: 4 * len(names)]

    def digest(img):
        return hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest()

    with ThreadPoolExecutor(max_workers=8) as pool:
        got = list(pool.map(lambda n: decode_img(datas[n], n, cuda, source="buffer"), work))
        chunks = [work[i : i + 7] for i in range(0, len(work), 7)]
        batched = list(pool.map(lambda c: decode_imgs([datas[n] for n in c], c, cuda,
                                                      source="buffer"), chunks))
    for n, img in zip(work, got):
        assert digest(img) == table["fixtures"][n]["buffer"]["sha256"], n
    for c, imgs in zip(chunks, batched):
        for n, img in zip(c, imgs):
            assert digest(img) == table["fixtures"][n]["buffer"]["sha256"], n
