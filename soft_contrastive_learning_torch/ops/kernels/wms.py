"""K3: the fused wms loss forward, a hand-written CUDA kernel for Hopper.

Replaces ``soft_contrastive_learning_tpu/ops/pallas/wms_kernel.py``
(``_wms_kernel``, ``wms_loss_pallas``, and the ``wms_loss_fused``
custom_vjp). The kernel is ``csrc/wms.cu``: D-split Gram partials, a
deterministic reduce, one block per row for the masks, mining and terms,
and a fixed-order mean; its source note gives the bound and the design. It
runs every batch size (the TPU kernel failed to compile at B >= 1024).

The plain version is ``losses/ms.py::wms_loss`` with ``wfunction='exp'``
and ``sumfunction='ms'``: the CPU path of the wrapper, what ``chip_smoke.py``
holds the kernel against, and the source of the backward. ``WmsLossFn``
keeps the JAX split: K3 forward, autograd of the plain formula backward,
recomputed from the saved (geo, emb).
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from soft_contrastive_learning_torch.losses.ms import wms_loss
from soft_contrastive_learning_torch.ops.kernels import _build
from soft_contrastive_learning_torch.ops.kernels._autograd import plain_backward, refuse_graph

_TILE_ROWS = 32  # csrc/wms.cu kTile
_STAGE_COLS = 32  # csrc/wms.cu kStage
_MIN_CHUNK_COLS = 256  # a D-chunk long enough to amortize staging
_TARGET_BLOCKS = 528  # four blocks per SM on the H100's 132


def plan_chunks(b: int, d: int) -> Tuple[int, int]:
    """(n_chunks, chunk_cols) for the Gram pass: enough D-chunks that the
    (tiles x tiles x chunks) grid fills the card, each at least 256 columns
    and a multiple of the 32-column stage, together covering D."""
    tiles = math.ceil(b / _TILE_ROWS) ** 2
    n = min(max(1, math.ceil(_TARGET_BLOCKS / tiles)), max(1, math.ceil(d / _MIN_CHUNK_COLS)))
    chunk_cols = math.ceil(math.ceil(d / n) / _STAGE_COLS) * _STAGE_COLS
    return math.ceil(d / chunk_cols), chunk_cols


def _lib() -> ctypes.CDLL:
    lib = _build.load("wms")
    fn = lib.scl_wms_loss
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_float] * 6
                   + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def wms_loss_cuda(
    geo_distances: torch.Tensor,  # (B, B) fp32
    embeddings: torch.Tensor,  # (B, D) fp32
    d_alpha: float,
    d_beta: float,
    alpha: float = 2.0,
    beta: float = 50.0,
    lamb: float = 1.0,
    eps: float = 0.1,
    ms_mining: bool = True,
) -> torch.Tensor:
    """The exp/ms ``wms_loss`` through K3 for CUDA tensors; the plain
    version for CPU tensors. Returns a () fp32 tensor with no autograd
    graph (``WmsLossFn`` adds the backward); raises on anything the kernel
    does not take."""
    refuse_graph("wms_loss_cuda", "WmsLossFn", geo_distances, embeddings)
    if embeddings.device.type == "cpu":
        return wms_loss(geo_distances, embeddings, d_alpha, d_beta, alpha, beta, lamb, eps,
                        ms_mining, wfunction="exp", sumfunction="ms")
    if embeddings.device.type != "cuda" or geo_distances.device != embeddings.device:
        raise ValueError(f"wms_loss_cuda: embeddings on {embeddings.device}, "
                         f"geo on {geo_distances.device}")
    if embeddings.ndim != 2 or geo_distances.shape != (embeddings.shape[0],) * 2:
        raise ValueError(f"shape mismatch: embeddings {tuple(embeddings.shape)}, "
                         f"geo {tuple(geo_distances.shape)}")
    if embeddings.dtype != torch.float32 or geo_distances.dtype != torch.float32:
        raise TypeError("K3 takes float32 embeddings and geo distances")
    b, d = embeddings.shape
    if b == 0 or d == 0 or b * b >= 2**31:
        raise ValueError(f"K3 takes 0 < B, B*B < 2^31 and D > 0; got B={b}, D={d}")
    lib = _lib()
    n_chunks, chunk_cols = plan_chunks(b, d)
    emb = embeddings.contiguous()
    geo = geo_distances.contiguous()
    part = torch.empty((n_chunks, b, b), dtype=torch.float32, device=emb.device)
    gram = torch.empty((b, b), dtype=torch.float32, device=emb.device)
    terms = torch.empty((b,), dtype=torch.float32, device=emb.device)
    out = torch.empty((), dtype=torch.float32, device=emb.device)
    with torch.cuda.device(emb.device):
        err = lib.scl_wms_loss(
            emb.data_ptr(), geo.data_ptr(), part.data_ptr(), gram.data_ptr(),
            terms.data_ptr(), out.data_ptr(), b, d, n_chunks, chunk_cols,
            d_alpha, d_beta, alpha, beta, lamb, eps, int(bool(ms_mining)),
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "wms_loss_cuda")
    wms_loss_cuda.launches += 1
    return out


wms_loss_cuda.launches = 0


def _exp_ms_wms_loss(geo, emb, *hparams):
    return wms_loss(geo, emb, *hparams, wfunction="exp", sumfunction="ms")


class WmsLossFn(torch.autograd.Function):
    """K3 forward (the plain version on CPU tensors); backward = autograd of
    the plain exp/ms ``wms_loss`` recomputed from the saved (geo, emb)."""

    @staticmethod
    def forward(ctx, geo, emb, d_alpha, d_beta, alpha, beta, lamb, eps, ms_mining):
        ctx.save_for_backward(geo, emb)
        ctx.hparams = (d_alpha, d_beta, alpha, beta, lamb, eps, ms_mining)
        return wms_loss_cuda(geo, emb, d_alpha, d_beta, alpha, beta, lamb, eps, ms_mining)

    @staticmethod
    def backward(ctx, grad):
        grads = plain_backward(_exp_ms_wms_loss, ctx.saved_tensors, ctx.needs_input_grad[:2],
                               grad, *ctx.hparams)
        return (*grads, *(None,) * 7)


def wms_loss_fused(
    geo_distances: torch.Tensor,
    embeddings: torch.Tensor,
    d_alpha: float,
    d_beta: float,
    alpha: float = 2.0,
    beta: float = 50.0,
    lamb: float = 1.0,
    eps: float = 0.1,
    ms_mining: bool = True,
) -> torch.Tensor:
    """Differentiable exp/ms wms loss with K3 as its forward on CUDA."""
    return WmsLossFn.apply(geo_distances, embeddings, d_alpha, d_beta, alpha, beta, lamb,
                           eps, ms_mining)
