"""K1: fused NetVLAD aggregation, forward and backward as hand-written CUDA
kernels for Hopper.

Replaces ``soft_contrastive_learning_tpu/ops/pallas/netvlad_kernel.py``
(``_netvlad_kernel``, and the backward of the ``vlad_aggregate_fused``
custom_vjp). The kernels are ``csrc/netvlad.cu``: each image is split over a
cluster of 4 blocks along the descriptor dimension, its features arrive by
TMA, and the per-cluster sums cross between the blocks through distributed
shared memory; its source note gives the bound and the design.

Beside them, the plain PyTorch versions: ``vlad_aggregate`` (the forward)
and ``vlad_aggregate_backward`` (the backward's closed form, step by step).
They are the wrappers' path for CPU tensors and what ``chip_smoke.py`` holds
the kernels against; the CPU tests hold ``vlad_aggregate_backward`` to
autograd of ``vlad_aggregate`` and to JAX.

``VladAggregateFn`` is the differentiable op: on CUDA tensors its forward
launches the forward kernel with the backward's residuals (1/u_k and 1/g per
image) and its backward launches the backward kernel; on CPU tensors both
are the plain versions. ``vlad_aggregate_fused`` takes the Function only
where autograd records a graph, so inference writes no residual. The bare
wrapper records no graph and refuses a call that would need one.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from soft_contrastive_learning_torch.ops.kernels import _build
from soft_contrastive_learning_torch.ops.kernels._autograd import refuse_graph

_EPS = 1e-12
_SMEM_LIMIT = 232448  # dynamic shared memory one Hopper block may use


def vlad_aggregate(
    features: torch.Tensor,  # (B, N, D) channel-L2-normalized descriptors
    assign_logits: torch.Tensor,  # (B, N, K)
    neg_centers: torch.Tensor,  # (D, K), matconvnet sign convention (added)
) -> torch.Tensor:
    """Aggregate to an L2-normalized (B, D*K) VLAD descriptor (d-major)."""
    a = torch.softmax(assign_logits.float(), dim=-1)
    x = features.float()
    agg = torch.einsum("bnk,bnd->bkd", a, x)  # (B, K, D)
    mass = a.sum(dim=1)  # (B, K)
    v = agg + mass[:, :, None] * neg_centers.float().T[None, :, :]
    # intra-normalization over D per cluster, eps inside the sqrt
    v = v / torch.sqrt((v * v).sum(dim=-1, keepdim=True) + _EPS)
    # d-major flatten: descriptor index = d * K + k
    v = v.transpose(1, 2).reshape(v.shape[0], -1)
    return v / torch.sqrt((v * v).sum(dim=-1, keepdim=True) + _EPS)


def vlad_aggregate_backward(
    features: torch.Tensor,
    assign_logits: torch.Tensor,
    neg_centers: torch.Tensor,
    grad: torch.Tensor,  # (B, D*K), d-major like the output
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradients of ``vlad_aggregate`` for the cotangent ``grad``, in
    closed form: (d features, d logits, d centers), each in its input's
    dtype. Per image, with V = x^T a + C diag(m) (D, K), u_k its column norms,
    W = V / u, g = |W| and y = W / g (every norm with 1e-12 inside the sqrt):

        dW = dy/g - W <W, dy>/g^3
        dV_.k = dW_.k/u_k - V_.k <V_.k, dW_.k>/u_k^3
        dx = a dV^T,  da = x dV + 1 (sum_d C_dk dV_dk)
        ds = a (da - rowsum(a da)),  dC = sum_b m_bk dV_b
    """
    b, _, d = features.shape
    k = assign_logits.shape[-1]
    a = torch.softmax(assign_logits.float(), dim=-1)  # (B, N, K)
    x = features.float()
    c = neg_centers.float()
    mass = a.sum(dim=1)  # (B, K)
    v = torch.einsum("bnk,bnd->bdk", a, x) + c[None] * mass[:, None, :]  # (B, D, K)
    u = torch.sqrt((v * v).sum(dim=1, keepdim=True) + _EPS)  # (B, 1, K)
    w = v / u
    g = torch.sqrt((w * w).sum(dim=(1, 2), keepdim=True) + _EPS)  # (B, 1, 1)
    dy = grad.float().reshape(b, d, k)
    dw = dy / g - w * (w * dy).sum(dim=(1, 2), keepdim=True) / g ** 3
    dv = dw / u - v * (v * dw).sum(dim=1, keepdim=True) / u ** 3
    dx = torch.einsum("bnk,bdk->bnd", a, dv)
    da = torch.einsum("bnd,bdk->bnk", x, dv) + (c[None] * dv).sum(dim=1)[:, None, :]
    ds = a * (da - (a * da).sum(dim=-1, keepdim=True))
    dc = (mass[:, None, :] * dv).sum(dim=0)
    return dx.to(features.dtype), ds.to(assign_logits.dtype), dc.to(neg_centers.dtype)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("netvlad")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.scl_netvlad_aggregate.argtypes = [p, p, i, p, p, p, i, i, i, i, p]
    lib.scl_netvlad_backward.argtypes = [p, p, i, p, p, p, p, p, p, p, p, i, i, i, i, p]
    for fn in (lib.scl_netvlad_aggregate, lib.scl_netvlad_backward):
        fn.restype = i
    lib.scl_netvlad_smem_bytes.argtypes = [i, i, i]
    lib.scl_netvlad_active_clusters.argtypes = [i, i, i]
    for name in ("smem_bytes", "max_clusters", "max_dim", "max_positions", "cluster_blocks",
                 "active_clusters"):
        getattr(lib, f"scl_netvlad_{name}").restype = i
    return lib


@functools.cache
def _limits() -> Tuple[int, int, int]:
    """The kernels' largest K, D and N."""
    lib = _lib()
    return (lib.scl_netvlad_max_clusters(), lib.scl_netvlad_max_dim(),
            lib.scl_netvlad_max_positions())


@functools.lru_cache(maxsize=64)
def _smem_bytes(n: int, k: int, backward: bool) -> int:
    return _lib().scl_netvlad_smem_bytes(n, k, int(backward))


def _checked(features, assign_logits, neg_centers, backward: bool) -> Tuple[int, int, int, int]:
    """(B, N, D, K) of inputs the kernels take; raises on anything else."""
    if features.device.type != "cuda":
        raise ValueError(f"K1: unsupported device {features.device}")
    b, n, d = features.shape
    k = assign_logits.shape[-1]
    if assign_logits.shape != (b, n, k) or neg_centers.shape != (d, k):
        raise ValueError(
            f"shape mismatch: features {tuple(features.shape)}, logits "
            f"{tuple(assign_logits.shape)}, centers {tuple(neg_centers.shape)}")
    if {assign_logits.device, neg_centers.device} != {features.device}:
        raise ValueError("features, logits and centers must be on one device")
    if features.dtype != torch.float32 or neg_centers.dtype != torch.float32:
        raise TypeError("K1 takes float32 features and centers")
    if assign_logits.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"K1 takes float32 or bfloat16 logits, got {assign_logits.dtype}")
    max_k, max_d, max_n = _limits()
    if k > max_k or k % 4 or d % 4 or d > max_d or not 0 < n <= max_n:
        raise ValueError(f"K1 needs K <= {max_k}, K % 4 == 0, D % 4 == 0, D <= {max_d} and "
                         f"0 < N <= {max_n}; got K={k}, D={d}, N={n}")
    if _smem_bytes(n, k, backward) > _SMEM_LIMIT:
        raise ValueError(f"K1{' backward' if backward else ''}: N={n}, K={k} exceeds one "
                         "block's shared memory")
    return b, n, d, k


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _aggregate(features, assign_logits, neg_centers, with_scales: bool):
    """The forward kernel on checked CUDA inputs: (out, scales or None)."""
    b, n, d, k = _checked(features, assign_logits, neg_centers, backward=False)
    out = torch.empty((b, d * k), dtype=torch.float32, device=features.device)
    scales = (torch.empty((b, k + 1), dtype=torch.float32, device=features.device)
              if with_scales else None)
    if b == 0:
        return out, scales
    x = features.contiguous()
    s = assign_logits.contiguous()
    c = neg_centers.contiguous()
    if x.data_ptr() % 16:
        raise ValueError("K1 needs 16-byte-aligned features (TMA's base address)")
    lib = _lib()
    with torch.cuda.device(features.device):
        err = lib.scl_netvlad_aggregate(
            x.data_ptr(), s.data_ptr(), int(s.dtype == torch.bfloat16), c.data_ptr(),
            out.data_ptr(), None if scales is None else scales.data_ptr(), b, n, d, k, _stream())
    _build.check(lib, err, "netvlad_aggregate_cuda")
    netvlad_aggregate_cuda.launches += 1
    return out, scales


def netvlad_aggregate_cuda(
    features: torch.Tensor, assign_logits: torch.Tensor, neg_centers: torch.Tensor
) -> torch.Tensor:
    """``vlad_aggregate`` through K1 for CUDA tensors; the plain version for
    CPU tensors. Takes x fp32, logits fp32 or bf16, centers fp32; raises on
    anything the kernel does not take, and on an input that requires grad
    while grad mode is on (use ``VladAggregateFn`` there)."""
    refuse_graph("netvlad_aggregate_cuda", "VladAggregateFn", features, assign_logits,
                 neg_centers)
    if features.device.type == "cpu":
        return vlad_aggregate(features, assign_logits, neg_centers)
    return _aggregate(features, assign_logits, neg_centers, with_scales=False)[0]


netvlad_aggregate_cuda.launches = 0


def netvlad_backward_cuda(
    features: torch.Tensor,
    assign_logits: torch.Tensor,
    neg_centers: torch.Tensor,
    out: torch.Tensor,  # (B, D*K) the forward's output
    scales: torch.Tensor,  # (B, K + 1): 1/u_k and 1/g per image, from the forward
    grad: torch.Tensor,  # (B, D*K)
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(d features, d logits, d centers) through K1's backward kernel (and
    dC's fixed-order sum over images) for CUDA tensors; on CPU tensors
    ``vlad_aggregate_backward`` (which recomputes what ``out`` and
    ``scales`` hold). The logits' gradient comes back in their dtype."""
    if features.device.type == "cpu":
        return vlad_aggregate_backward(features, assign_logits, neg_centers, grad)
    b, n, d, k = _checked(features, assign_logits, neg_centers, backward=True)
    if out.shape != (b, d * k) or scales.shape != (b, k + 1) or grad.shape != (b, d * k):
        raise ValueError(f"K1 backward: out {tuple(out.shape)}, scales {tuple(scales.shape)}, "
                         f"grad {tuple(grad.shape)} for B={b}, D={d}, K={k}")
    dev = features.device
    dx = torch.empty((b, n, d), dtype=torch.float32, device=dev)
    ds = torch.empty((b, n, k), dtype=assign_logits.dtype, device=dev)
    dc = torch.empty((d, k), dtype=torch.float32, device=dev)
    if b == 0:
        return dx, ds, dc.zero_()
    x = features.contiguous()
    s = assign_logits.contiguous()
    c = neg_centers.contiguous()
    dy = grad.float().contiguous()
    if x.data_ptr() % 16:
        raise ValueError("K1 needs 16-byte-aligned features (TMA's base address)")
    dv_mass = torch.empty((b, d, k), dtype=torch.float32, device=dev)  # m_bk dV_b, for dC
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.scl_netvlad_backward(
            x.data_ptr(), s.data_ptr(), int(s.dtype == torch.bfloat16), c.data_ptr(),
            out.contiguous().data_ptr(), dy.data_ptr(), scales.contiguous().data_ptr(),
            dx.data_ptr(), ds.data_ptr(), dc.data_ptr(), dv_mass.data_ptr(), b, n, d, k,
            _stream())
    _build.check(lib, err, "netvlad_backward_cuda")
    netvlad_backward_cuda.launches += 1
    return dx, ds, dc


netvlad_backward_cuda.launches = 0


class VladAggregateFn(torch.autograd.Function):
    """K1 forward and backward kernels on CUDA tensors; the plain
    ``vlad_aggregate`` and ``vlad_aggregate_backward`` on CPU tensors. The
    forward keeps its output and the per-image scales for the backward. The
    logits' gradient comes back in the logits' dtype (bf16 on the main
    path), as the cast in the plain formula gives it."""

    @staticmethod
    def forward(ctx, features, assign_logits, neg_centers):
        if features.device.type == "cpu":
            ctx.save_for_backward(features, assign_logits, neg_centers)
            return vlad_aggregate(features, assign_logits, neg_centers)
        out, scales = _aggregate(features, assign_logits, neg_centers, with_scales=True)
        ctx.save_for_backward(features, assign_logits, neg_centers, out, scales)
        return out

    @staticmethod
    def backward(ctx, grad):
        saved = ctx.saved_tensors
        if len(saved) == 3:
            grads = vlad_aggregate_backward(*saved, grad)
        else:
            grads = netvlad_backward_cuda(*saved, grad)
        return tuple(g if need else None for g, need in zip(grads, ctx.needs_input_grad))


def vlad_aggregate_fused(
    features: torch.Tensor, assign_logits: torch.Tensor, neg_centers: torch.Tensor
) -> torch.Tensor:
    """``vlad_aggregate`` through K1: ``VladAggregateFn`` where autograd
    records a graph (grad mode on and an input that requires grad), else the
    bare forward, which writes no residual."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (features, assign_logits, neg_centers)):
        return VladAggregateFn.apply(features, assign_logits, neg_centers)
    return netvlad_aggregate_cuda(features, assign_logits, neg_centers)
