"""K3: the fused wms loss forward, a hand-written CUDA kernel for Hopper.

Replaces ``soft_contrastive_learning_tpu/ops/pallas/wms_kernel.py``
(``_wms_kernel``, ``wms_loss_pallas``, and the ``wms_loss_fused``
custom_vjp). The kernel is ``csrc/wms.cu``: one cooperative launch whose
phases, between grid-wide barriers and a last-block ticket, form the upper
triangle of the Gram in (64-row tile pair, 128-column chunk) items, reduce
it in a fixed order, take each row's masks, mining and term, and the
fixed-order mean; its source note gives the bound and the design. It runs
every batch size (the TPU kernel failed to compile at B >= 1024).

The plain version is ``losses/ms.py::wms_loss`` with ``wfunction='exp'``
and ``sumfunction='ms'``: the CPU path of the wrapper, what ``chip_smoke.py``
holds the kernel against, and the source of the backward. ``WmsLossFn``
keeps the JAX split: K3 forward, autograd of the plain formula backward,
recomputed from the saved (geo, emb).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, Tuple

import torch

from soft_contrastive_learning_torch.losses.ms import wms_loss
from soft_contrastive_learning_torch.ops.kernels import _build
from soft_contrastive_learning_torch.ops.kernels._autograd import plain_backward, refuse_graph

_TILE_ROWS = 64  # csrc/wms.cu kTile
_ITEM_COLS = 128  # csrc/wms.cu kItemCols
_ENTRIES_PER_BLOCK = 32  # the reduce phase's entries per block


def tile_pairs(b: int) -> int:
    """Tile pairs ti <= tj of the Gram's upper triangle (64-row tiles)."""
    tiles = math.ceil(b / _TILE_ROWS)
    return tiles * (tiles + 1) // 2


@functools.lru_cache(maxsize=64)
def plan_chunks(b: int, d: int) -> Tuple[int, int]:
    """(n_chunks, chunk_cols) of the Gram phase: 128-column chunks covering
    D; a Gram item is (tile pair, chunk)."""
    return math.ceil(d / _ITEM_COLS), _ITEM_COLS


@functools.lru_cache(maxsize=64)
def workspace_layout(b: int, d: int) -> Dict[str, int]:
    """Float offsets of the kernel's one workspace: the Gram partials (tile
    pair, chunk, 64 x 64), the Gram (B, B), the row terms (B) and the loss
    (1), and the total."""
    n_chunks, _ = plan_chunks(b, d)
    layout = {"part": 0, "gram": n_chunks * tile_pairs(b) * _TILE_ROWS ** 2}
    layout["terms"] = layout["gram"] + b * b
    layout["out"] = layout["terms"] + b
    layout["total"] = layout["out"] + 1
    return layout


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("wms")
    fn = lib.scl_wms_loss
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_float] * 6
                   + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.scl_wms_resident_blocks.restype = ctypes.c_int
    return lib


@functools.cache
def _resident_blocks(device_index: int) -> int:
    """The largest cooperative grid of the kernel on this device (the query
    also sets the kernel's shared-memory attribute, before its first
    launch)."""
    lib = _lib()
    with torch.cuda.device(device_index):
        n = lib.scl_wms_resident_blocks()
    if n <= 0:
        _build.check(lib, -n, "wms_loss_cuda: occupancy query")
    return n


# the grid barrier's two words and the last-block ticket per (device,
# stream): zero between launches
_barriers: Dict[Tuple[int, int], torch.Tensor] = {}


def _barrier(device: torch.device, stream: int) -> torch.Tensor:
    key = (device.index, stream)
    if key not in _barriers:
        _barriers[key] = torch.zeros(3, dtype=torch.int32, device=device)
    return _barriers[key]


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
    n_chunks, _ = plan_chunks(b, d)
    layout = workspace_layout(b, d)
    emb = embeddings.contiguous()
    geo = geo_distances.contiguous()
    if emb.data_ptr() % 16:
        raise ValueError("K3 needs 16-byte-aligned embeddings (16-byte loads)")
    dev = emb.device
    ws = torch.empty((layout["total"],), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        # enough blocks for the Gram items, the reduce's entry groups and the
        # rows' warps
        pairs = tile_pairs(b)
        work = max(pairs * n_chunks, pairs * _TILE_ROWS ** 2 // _ENTRIES_PER_BLOCK,
                   math.ceil(b / 8))
        err = lib.scl_wms_loss(
            emb.data_ptr(), geo.data_ptr(), ws.data_ptr(), _barrier(dev, stream).data_ptr(), b,
            d, n_chunks, min(_resident_blocks(dev.index), work), d_alpha, d_beta, alpha, beta,
            lamb, eps, int(bool(ms_mining)), stream)
    _build.check(lib, err, "wms_loss_cuda")
    wms_loss_cuda.launches += 1
    return ws[layout["out"]]


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
