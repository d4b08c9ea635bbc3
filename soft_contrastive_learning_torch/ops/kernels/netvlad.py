"""K1: fused NetVLAD aggregation, a hand-written CUDA kernel for Hopper.

Replaces ``soft_contrastive_learning_tpu/ops/pallas/netvlad_kernel.py``
(``_netvlad_kernel``). The kernel is ``csrc/netvlad.cu``: one block per
image keeps the softmax and the (D, K) result in shared memory and streams
the features from device memory; its source note gives the bound and the
design. ``vlad_aggregate`` below is its plain PyTorch version: the CPU path
of the wrapper, and what ``chip_smoke.py`` holds the kernel against.

``VladAggregateFn`` keeps the JAX split (``vlad_aggregate_fused``, a
custom_vjp): K1 runs the forward, and the backward is autograd of the plain
formula, recomputed from the saved inputs. The bare wrapper records no
graph and refuses a call that would need one.
"""

from __future__ import annotations

import ctypes

import torch

from soft_contrastive_learning_torch.ops.kernels import _build
from soft_contrastive_learning_torch.ops.kernels._autograd import plain_backward, refuse_graph

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


def _lib() -> ctypes.CDLL:
    lib = _build.load("netvlad")
    fn = lib.scl_netvlad_aggregate
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.scl_netvlad_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.scl_netvlad_smem_bytes.restype = ctypes.c_size_t
    lib.scl_netvlad_max_clusters.argtypes = []
    lib.scl_netvlad_max_clusters.restype = ctypes.c_int
    return lib


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
    if features.device.type != "cuda":
        raise ValueError(f"netvlad_aggregate_cuda: unsupported device {features.device}")
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
    lib = _lib()
    if k > lib.scl_netvlad_max_clusters() or k % 4 or d % 4:
        raise ValueError(f"K1 needs K <= {lib.scl_netvlad_max_clusters()}, K % 4 == 0 "
                         f"and D % 4 == 0; got K={k}, D={d}")
    if lib.scl_netvlad_smem_bytes(n, d, k) > _SMEM_LIMIT:
        raise ValueError(f"K1: N={n}, D={d}, K={k} exceeds one block's shared memory")
    out = torch.empty((b, d * k), dtype=torch.float32, device=features.device)
    if b == 0:
        return out
    x = features.contiguous()
    s = assign_logits.contiguous()
    c = neg_centers.contiguous()
    with torch.cuda.device(features.device):
        err = lib.scl_netvlad_aggregate(
            x.data_ptr(), s.data_ptr(), int(s.dtype == torch.bfloat16), c.data_ptr(),
            out.data_ptr(), b, n, d, k, torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "netvlad_aggregate_cuda")
    netvlad_aggregate_cuda.launches += 1
    return out


netvlad_aggregate_cuda.launches = 0


class VladAggregateFn(torch.autograd.Function):
    """K1 forward (the plain version on CPU tensors); backward = autograd of
    the plain ``vlad_aggregate`` recomputed from the saved inputs. The
    logits' gradient comes back in the logits' dtype (bf16 on the main
    path), as the cast in the plain formula gives it."""

    @staticmethod
    def forward(ctx, features, assign_logits, neg_centers):
        ctx.save_for_backward(features, assign_logits, neg_centers)
        return netvlad_aggregate_cuda(features, assign_logits, neg_centers)

    @staticmethod
    def backward(ctx, grad):
        return plain_backward(vlad_aggregate, ctx.saved_tensors, ctx.needs_input_grad, grad)
