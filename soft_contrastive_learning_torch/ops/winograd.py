"""Winograd F(2x2, 3x3) convolution in plain PyTorch, the counterpart of
``soft_contrastive_learning_tpu/ops/winograd.py``.

    Y = A^T [ (G g G^T) .o. (B^T d B) ] A            (Lavin & Gray, 2015)

Each 2x2 output tile takes 16 multiplies per (input, output) channel pair
instead of 36; summed over the input channels, the 16 elementwise products
are 16 independent (tiles, C) @ (C, F) matrix products. The transform
matrices have entries 0, +-1, +-1/2, exact in binary floating point.

Layouts: activations are NHWC, as at the JAX package's functions; weights
are the port's ``Conv2d.weight``, OIHW (F, C, 3, 3); the transformed filter
U is (16, C, F) with position ``4 a + b`` for row frequency ``a`` and column
frequency ``b``.

Two functions compute the convolution:

* ``winograd_conv``: the fp32 reference, every step in fp32;
* ``winograd_conv_plain``: the plain version of the fused CUDA kernel
  (``ops/kernels/winograd.py``), with that kernel's arithmetic and its
  roundings: bf16 operands, a bf16 input transform that rounds at every
  add, fp32 sums of the products, an fp32 output transform, bias and ReLU
  in fp32, then the cast. The CPU path of the kernel's wrapper and what the
  kernel is held against on the card.

``winograd_stage_plain`` is the plain version of that kernel cut short at a
stage (``dma``, ``transform``, ``matmul``, ``full``), which the ablation
script ``soft_contrastive_learning_torch/perf/winograd_ablate.py`` times;
``block_rows``, ``block_grid`` and ``block_boxes`` give the kernel's block
layout, which the stages' checksums depend on.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

G = ((1.0, 0.0, 0.0), (0.5, 0.5, 0.5), (0.5, -0.5, 0.5), (0.0, 0.0, 1.0))
BT = ((1.0, 0.0, -1.0, 0.0), (0.0, 1.0, 1.0, 0.0), (0.0, -1.0, 1.0, 0.0), (0.0, 1.0, 0.0, -1.0))
AT = ((1.0, 1.0, 1.0, 0.0), (0.0, 1.0, -1.0, -1.0))


def _g_rows(k0: torch.Tensor, k1: torch.Tensor, k2: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """G (k0, k1, k2)^T with each three-term sum taken left to right,
    .5 ((k0 +- k1) + k2): the halving is exact, so the order of the two adds
    fixes every bit (it is the order the JAX einsum takes on the CPU)."""
    return k0, 0.5 * ((k0 + k1) + k2), 0.5 * ((k0 - k1) + k2), k2


def weight_transform(weight: torch.Tensor) -> torch.Tensor:
    """OIHW (F, C, 3, 3) conv weight -> (16, C, F) fp32 Winograd-domain
    filter, ``U[4 a + b] = sum_ij G[a, i] G[b, j] w[:, :, i, j]^T``, rows
    first, then columns, in fp32 sums of a fixed order (the CUDA kernel takes
    the same, so the two give the same bits on any device)."""
    if weight.ndim != 4 or weight.shape[2:] != (3, 3):
        raise ValueError(f"expected an OIHW 3x3 weight, got shape {tuple(weight.shape)}")
    k = weight.float().permute(2, 3, 1, 0)  # (3, 3, C, F)
    rows = _g_rows(k[0], k[1], k[2])  # 4 x (3, C, F)
    return torch.stack([u for t in rows for u in _g_rows(t[0], t[1], t[2])])


def _tiles(x: torch.Tensor) -> Tuple[list, int, int]:
    """The 16 stride-2 views ``d[a][b][n, i, j, c] = xp[n, 2 i + a, 2 j + b,
    c]`` of the zero-padded input (SAME halo of 1, bottom/right up to whole
    tiles), and the tile counts (th, tw)."""
    _, h, w, _ = x.shape
    th, tw = -(-h // 2), -(-w // 2)
    xp = F.pad(x, (0, 0, 1, 2 * tw - w + 1, 1, 2 * th - h + 1))
    d = [[xp[:, a : a + 2 * th - 1 : 2, b : b + 2 * tw - 1 : 2, :] for b in range(4)]
         for a in range(4)]
    return d, th, tw


def _input_transform(d: list) -> list:
    """B^T d B as adds and subtractions only, rows first, then columns, in
    the kernel's order (d0-d2, d1+d2, d2-d1, d1-d3). In bf16 every add rounds
    once. Returns the 16 (n, th, tw, C) tensors, position 4 a + b."""
    rows = [(d[0][b] - d[2][b], d[1][b] + d[2][b], d[2][b] - d[1][b], d[1][b] - d[3][b])
            for b in range(4)]
    out = []
    for a in range(4):
        t0, t1, t2, t3 = (rows[b][a] for b in range(4))
        out += [t0 - t2, t1 + t2, t2 - t1, t1 - t3]
    return out


def _output_transform(m: torch.Tensor) -> torch.Tensor:
    """A^T m A in fp32; m: (4, 4, n, th, tw, F) -> (n, 2 th, 2 tw, F), sums
    taken left to right as the kernel takes them."""
    t0 = m[0] + m[1] + m[2]
    t1 = m[1] - m[2] - m[3]
    y00, y01 = t0[0] + t0[1] + t0[2], t0[1] - t0[2] - t0[3]
    y10, y11 = t1[0] + t1[1] + t1[2], t1[1] - t1[2] - t1[3]
    n, th, tw, f = y00.shape
    row0 = torch.stack([y00, y01], dim=3).reshape(n, th, 2 * tw, f)
    row1 = torch.stack([y10, y11], dim=3).reshape(n, th, 2 * tw, f)
    return torch.stack([row0, row1], dim=2).reshape(n, 2 * th, 2 * tw, f)


def _check(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor]) -> None:
    if x.ndim != 4 or weight.ndim != 4 or weight.shape[1:] != (x.shape[-1], 3, 3):
        raise ValueError(f"expected NHWC x and an OIHW 3x3 weight over its channels, got "
                         f"{tuple(x.shape)} and {tuple(weight.shape)}")
    if bias is not None and bias.shape != (weight.shape[0],):
        raise ValueError(f"bias shape {tuple(bias.shape)} for {weight.shape[0]} filters")


def _products(v: list, u: torch.Tensor, shape: Tuple[int, ...]) -> torch.Tensor:
    """The 16 (P, C) @ (C, F) products summed in fp32 -> (4, 4, n, th, tw, F)."""
    n, th, tw, c = shape
    vm = torch.stack([t.reshape(n * th * tw, c) for t in v]).float()
    return torch.bmm(vm, u.float()).reshape(4, 4, n, th, tw, u.shape[-1])


def winograd_conv(x: torch.Tensor, weight: torch.Tensor,
                  bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """SAME 3x3 stride-1 conv by Winograd F(2x2, 3x3), all in fp32: matches
    a direct convolution up to reassociation, for any H, W (odd sizes are
    padded up to whole tiles and cropped). x NHWC, weight OIHW; fp32 out."""
    _check(x, weight, bias)
    n, h, w, c = x.shape
    d, th, tw = _tiles(x.float())
    m = _products(_input_transform(d), weight_transform(weight), (n, th, tw, c))
    y = _output_transform(m)[:, :h, :w, :]
    return y if bias is None else y + bias.float()


def winograd_conv_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                        relu: bool = False,
                        out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The fused kernel's arithmetic, rounding where it rounds: x -> bf16; U
    transformed in fp32, then -> bf16; the input transform in bf16, one
    rounding per add; the 16 products of bf16 operands summed in fp32 (the
    operands are upcast first: a product of two bf16 values is exact in
    fp32, and a bf16 matmul would round its output); the output transform,
    ``+ bias`` and ReLU in fp32; then the cast to ``out_dtype`` (default:
    x's dtype)."""
    _check(x, weight, bias)
    out_dtype = out_dtype or x.dtype
    n, h, w, c = x.shape
    d, th, tw = _tiles(x.to(torch.bfloat16))
    u = weight_transform(weight).to(torch.bfloat16)
    m = _products(_input_transform(d), u, (n, th, tw, c))
    y = _output_transform(m)[:, :h, :w, :] + bias.float()
    if relu:
        y = torch.clamp(y, min=0.0)
    return y.to(out_dtype)


STAGES = ("dma", "transform", "matmul", "full")


def stage_index(stage: int | str) -> int:
    """0..3 from a stage's number or name."""
    if isinstance(stage, str):
        if stage not in STAGES:
            raise ValueError(f"unknown stage {stage!r}; expected one of {STAGES}")
        return STAGES.index(stage)
    if not 0 <= int(stage) < len(STAGES):
        raise ValueError(f"stage {stage} outside 0..{len(STAGES) - 1}")
    return int(stage)


BLOCK_TILES = 32  # 2x2 output tiles per block of the fused kernel
BLOCK_FEATURES = 64  # output channels per block
CHUNK = 32  # input channels per step of its loop over C
CLUSTER = 2  # blocks that share U's loads (a thread-block cluster)
BLOCK_ROWS = (2, 4)  # a block's tiles: rows x (32 / rows) of one image


def block_rows(h: int, w: int) -> int:
    """The fused kernel's tile rectangle for an H x W input: the rows (of
    ``BLOCK_ROWS``) that pad the tile grid least, then the smaller input box,
    (2 rows + 2) x (2 cols + 2) pixels. The flagship at 180x240: 2 (2 x 16)
    for conv2 (45 x 60 tiles), 4 (4 x 8) for conv3-conv5."""
    th, tw = -(-h // 2), -(-w // 2)

    def cost(rows):
        cols = BLOCK_TILES // rows
        return (-(-th // rows) * rows * -(-tw // cols) * cols,
                (2 * rows + 2) * (2 * cols + 2))

    return min(BLOCK_ROWS, key=cost)


def block_grid(n: int, h: int, w: int, rows: int) -> Tuple[int, int, int]:
    """(rectangles down an image gi, across it gj, tile blocks rounded up to
    whole clusters) of the fused kernel's grid."""
    th, tw = -(-h // 2), -(-w // 2)
    gi, gj = -(-th // rows), -(-tw // (BLOCK_TILES // rows))
    return gi, gj, -(-(n * gi * gj) // CLUSTER) * CLUSTER


def _bits_sum(t: torch.Tensor, dims: Tuple[int, ...]) -> torch.Tensor:
    """The sum over ``dims`` of the 16-bit patterns of a bf16 tensor, int64."""
    return (t.contiguous().view(torch.int16).to(torch.int64) & 0xFFFF).sum(dims)


def block_boxes(x: torch.Tensor, rows: int) -> torch.Tensor:
    """The input box of every block of the fused kernel, as its TMA load
    gives it: (tile blocks rounded up to whole clusters, 2 rows + 2,
    2 cols + 2, C) bf16, the pixels from (2 i0 - 1, 2 j0 - 1) of the block's
    first tile (i0, j0), zero outside the image; blocks past the last are
    all zero."""
    n, h, w, c = x.shape
    cols = BLOCK_TILES // rows
    gi, gj, padded = block_grid(n, h, w, rows)
    xp = x.new_zeros((n, 2 * gi * rows + 2, 2 * gj * cols + 2, c), dtype=torch.bfloat16)
    xp[:, 1 : h + 1, 1 : w + 1] = x.to(torch.bfloat16)
    boxes = xp.unfold(1, 2 * rows + 2, 2 * rows).unfold(2, 2 * cols + 2, 2 * cols)
    boxes = boxes.permute(0, 1, 2, 4, 5, 3).reshape(n * gi * gj, 2 * rows + 2, 2 * cols + 2, c)
    return F.pad(boxes, (0, 0, 0, 0, 0, 0, 0, padded - n * gi * gj))


def _u_sample(u: torch.Tensor) -> torch.Tensor:
    """Per feature block, the sum of the 16-bit patterns of the words of U
    that the dma and transform stages sample in every chunk: consumer thread
    t (0..511) reads position t % 16, channel t / 16, features 2 ((t / 4) % 32)
    and one more."""
    _, c, f = u.shape
    t = torch.arange(512, device=u.device)
    p, ch, fp = t % 16, t // 16, 2 * ((t // 4) % 32)
    total = torch.zeros(f // BLOCK_FEATURES, dtype=torch.int64, device=u.device)
    for c0 in range(0, c, CHUNK):
        for f0 in range(0, f, BLOCK_FEATURES):
            for e in (0, 1):
                total[f0 // BLOCK_FEATURES] += _bits_sum(u[p, c0 + ch, f0 + fp + e], (0,))
    return total


def winograd_stage_plain(stage: int | str, x: torch.Tensor, weight: torch.Tensor,
                         bias: Optional[torch.Tensor] = None, relu: bool = False,
                         out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """What the fused kernel writes when it is cut short at ``stage``, built
    from the pieces of ``winograd_conv_plain``. A block of the kernel owns a
    rows x (32 / rows) rectangle of 2x2 output tiles of one image (rows from
    ``block_rows``) and 64 output channels; the blocks run row-major over
    (image, rectangle row, rectangle column), rounded up to whole clusters
    of ``CLUSTER``, and bring in, per chunk of 32 input channels, one input
    box (``block_boxes``) and U's chunk.

    * 0 ``dma``: (tile blocks, F / 64) int64: the sum, mod 2^32,
      of the 16-bit patterns of a fixed sample of what the block brings in:
      of its box, the pixels ``(k P) // 32`` (k = 0..31, in the box's
      row-major order of its P pixels) over all channels; of U, the words
      ``_u_sample`` names in every chunk.
    * 1 ``transform``: the same with the box's sample replaced by every
      value of V = B^T d B in bf16 over the block's 32 tiles (those past the
      image's tile grid included: the kernel transforms them too) and all
      channels.
    * 2 ``matmul``: (tiles, F) fp32: ``M[0] = V[0] @ U[0]``, the products of
      position 0.
    * 3 ``full``: ``winograd_conv_plain`` (needs ``bias``).
    """
    stage = stage_index(stage)
    _check(x, weight, bias)
    if stage == 3:
        if bias is None:
            raise ValueError("the full stage needs a bias")
        return winograd_conv_plain(x, weight, bias, relu=relu, out_dtype=out_dtype)
    n, h, w, c = x.shape
    f = weight.shape[0]
    u = weight_transform(weight).to(torch.bfloat16)
    if stage == 2:
        d, th, tw = _tiles(x.to(torch.bfloat16))
        v0 = _input_transform(d)[0]
        return v0.reshape(n * th * tw, c).float() @ u[0].float()
    if f % BLOCK_FEATURES or c % CHUNK:
        raise ValueError(f"the dma and transform stages take C % {CHUNK} == 0 and "
                         f"F % {BLOCK_FEATURES} == 0; got C={c}, F={f}")
    rows = block_rows(h, w)
    boxes = block_boxes(x, rows)  # (blocks, 2 rows + 2, 2 cols + 2, C)
    if stage == 0:
        px = boxes.reshape(boxes.shape[0], -1, c)
        sample = (torch.arange(32, device=x.device) * px.shape[1]) // 32
        per_block = _bits_sum(px[:, sample], (1, 2))
    else:
        cols = BLOCK_TILES // rows
        d = [[boxes[:, a : a + 2 * rows - 1 : 2, b : b + 2 * cols - 1 : 2] for b in range(4)]
             for a in range(4)]
        per_block = sum(_bits_sum(t, (1, 2, 3)) for t in _input_transform(d))
    per_features = _u_sample(u)
    return (per_block[:, None] + per_features[None, :]) & 0xFFFFFFFF
