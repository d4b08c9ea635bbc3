"""VGG16 + NetVLAD in plain PyTorch, in fp32 and as an exact emulation of
post-training int8 (or, for the control, int4) quantization.

The network: 13 3x3 'same' convs in 5 blocks (ReLU after each conv the
block spec marks; after blocks 1-4 a floor 2x2 max-pool, then ReLU; conv5_3
without ReLU), the conv5_3 map L2-normalized over channels (eps 1e-12
inside the max), NetVLAD: a bias-free 1x1 assignment, softmax over the
clusters, residuals to the (negated, added) centers, intra-normalization
(eps inside the sqrt), a d-major flatten and a final L2 norm.

The int8 scheme (symmetric PTQ): per-output-channel weight scales
absmax/127 (1 for an all-zero channel), round half to even, clip +-127;
per-tensor activation scales absmax/127 of each conv's input on an fp32
forward over calibration images; each conv sums integers exactly (here in
float64, exact below 2^53), dequantizes as fp32 ``acc * (s_in * s_w) +
bias``, applies ReLU (a block's end included) and requantizes for the next
conv; the pools run on the int8 values; conv5_3 stays fp32. NetVLAD then
reads the features rounded to the compute dtype (bf16), its logits a
product in it.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

# (relu after the conv) per conv, by block; the pool follows each block but the last
RELU = ((True, False), (True, False), (True, True, False), (True, True, False),
        (True, True, False))
CONVS: List[str] = [f"vgg16.block{b + 1}.conv{b + 1}_{c + 1}"
                    for b, block in enumerate(RELU) for c in range(len(block))]


@contextmanager
def full_fp32():
    """TF32 off for cuBLAS and cuDNN: an fp32 product is an fp32 product."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def l2_normalize(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    return x * torch.rsqrt(torch.clamp((x * x).sum(dim=dim, keepdim=True), min=1e-12))


def netvlad(feat: torch.Tensor, params: Dict[str, torch.Tensor]) -> torch.Tensor:
    """(B, H, W, D) normalized features -> (B, D*K) descriptor, in the
    features' dtype."""
    b, h, w, d = feat.shape
    x = feat.reshape(b, h * w, d)
    assign = params["netvlad.assignment.weight"].reshape(-1, d).to(x.dtype)
    a = torch.softmax(x @ assign.T, dim=-1)
    centers = params["netvlad.cluster_centers"].to(x.dtype)  # (D, K)
    v = torch.einsum("bnk,bnd->bkd", a, x) + a.sum(dim=1)[:, :, None] * centers.T[None]
    v = v / torch.sqrt((v * v).sum(dim=-1, keepdim=True) + 1e-12)
    v = v.transpose(1, 2).reshape(b, -1)
    return v / torch.sqrt((v * v).sum(dim=-1, keepdim=True) + 1e-12)


def netvlad_served(feat: torch.Tensor, params: Dict[str, torch.Tensor],
                   compute: torch.dtype) -> torch.Tensor:
    """NetVLAD as the served path feeds it: the features rounded to the
    compute dtype, the assignment logits a product of operands in it,
    rounded to it; the aggregation in float64 from there."""
    b, h, w, d = feat.shape
    x = feat.to(compute).to(torch.float64).reshape(b, h * w, d)
    assign = params["netvlad.assignment.weight"].reshape(-1, d)
    logits = (x @ assign.to(compute).to(torch.float64).T).to(compute)
    a = torch.softmax(logits.to(torch.float64), dim=-1)
    centers = params["netvlad.cluster_centers"].to(torch.float64)
    v = torch.einsum("bnk,bnd->bkd", a, x) + a.sum(dim=1)[:, :, None] * centers.T[None]
    v = v / torch.sqrt((v * v).sum(dim=-1, keepdim=True) + 1e-12)
    v = v.transpose(1, 2).reshape(b, -1)
    return v / torch.sqrt((v * v).sum(dim=-1, keepdim=True) + 1e-12)


def fake_fp8(x: torch.Tensor) -> torch.Tensor:
    """x through float8 e4m3 with a per-tensor scale (absmax to 448); the
    gradient passes straight through."""
    scale = x.detach().abs().amax().clamp(min=1e-30) / 448.0
    q = (x.detach() / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
    return x + (q - x.detach())


def conv_stack(params: Dict[str, torch.Tensor], images: torch.Tensor,
               fp8: bool = False, record: Optional[list] = None) -> torch.Tensor:
    """NHWC images in [0, 255] -> the conv5_3 map (B, H, W, 512) before
    normalization, in fp32 (``fp8``: each conv's input and weight through
    ``fake_fp8``, the control). ``record`` collects each conv input's absmax."""
    x = images.float() - params["vgg16.average_rgb"].float()
    x = x.permute(0, 3, 1, 2)
    i = 0
    for bi, block in enumerate(RELU):
        for relu in block:
            if record is not None:
                record.append(x.abs().amax())
            w = params[f"{CONVS[i]}.weight"].float()
            x = F.conv2d(fake_fp8(x) if fp8 else x, fake_fp8(w) if fp8 else w,
                         params[f"{CONVS[i]}.bias"].float(), padding=1)
            if relu:
                x = F.relu(x)
            i += 1
        if bi < len(RELU) - 1:
            x = F.relu(F.max_pool2d(x, 2, 2))
    return x.permute(0, 2, 3, 1)


def descriptor_fp32(params, images: torch.Tensor, fp8: bool = False) -> torch.Tensor:
    """The fp32 forward (the training reference): (B, 32,768) descriptors."""
    return netvlad(l2_normalize(conv_stack(params, images, fp8)), params)


@torch.no_grad()
def calibrate(params, images: torch.Tensor, levels: int = 127) -> List[float]:
    """Each conv input's scale, absmax / levels of an fp32 forward (1 for an
    all-zero input), one per conv in order."""
    record: list = []
    with full_fp32():
        conv_stack(params, images, record=record)
    return [m / levels if m > 0 else 1.0 for m in torch.stack(record).cpu().tolist()]


def _f32(v: float) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32)


@torch.no_grad()
def descriptor_int(params, scales: List[float], images: torch.Tensor, levels: int = 127,
                   compute: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The quantized forward, integer sums exact: (B, 32,768) float64
    descriptors. ``levels`` 127 is int8; 7 is int4 (the control).
    ``compute``: the dtype NetVLAD's inputs are rounded to."""
    dev = images.device

    def requant(y: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
        return torch.clamp(torch.round(y * inv), -levels, levels)

    inv = [_f32(1.0 / s).to(dev) for s in scales]  # fp32(1 / s), as an fp32 multiplier
    a = requant(images.float() - params["vgg16.average_rgb"].float(), inv[0])
    a = a.permute(0, 3, 1, 2).to(torch.float64)
    i = 0
    y = None
    for bi, block in enumerate(RELU):
        for ci, relu in enumerate(block):
            w = params[f"{CONVS[i]}.weight"].float()
            sw = w.abs().amax(dim=(1, 2, 3)) / levels
            sw = torch.where(sw > 0, sw, torch.ones_like(sw))
            w8 = torch.clamp(torch.round(w / sw[:, None, None, None]), -levels, levels)
            acc = F.conv2d(a, w8.to(torch.float64), padding=1)  # exact integer sums
            mult = (_f32(scales[i]).to(dev) * sw)[None, :, None, None]
            y = acc.float() * mult + params[f"{CONVS[i]}.bias"].float()[None, :, None, None]
            last = i == len(CONVS) - 1
            if last:
                break
            if relu or ci == len(block) - 1:
                y = F.relu(y)
            a = requant(y, inv[i + 1]).to(torch.float64)
            if ci == len(block) - 1:
                a = F.max_pool2d(a, 2, 2)
            i += 1
    feat = l2_normalize(y.permute(0, 2, 3, 1))  # fp32, as the served path normalizes
    return netvlad_served(feat, params, compute)
