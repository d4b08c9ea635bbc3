"""Post-training int8 quantization of the VGG16 conv stack (inference), the
counterpart of ``soft_contrastive_learning_tpu/models/quant.py``.

Scheme, as JAX's (standard symmetric post-training quantization):

* weights: per-output-channel scales, absmax/127 (1.0 for an all-zero
  channel), round half to even, clipped to +-127;
* activations: per-tensor scales calibrated once from a representative
  batch (absmax/127 of each conv's input on an fp32 forward, 1.0 for a dead
  layer), saved as JSON (``indent=1``, ``sort_keys=True``), so that a scales
  file of either package serves in the other;
* each conv runs int8 x int8 -> int32 through Q1 (``ops/kernels/int8_conv.py``
  on a CUDA device) with dequant, bias, ReLU and the next layer's requant in
  its epilogue, and the 2x2 max-pools run on the requantized int8 (Q1_pool):
  only int8 tensors materialize between convs; the first conv (Q1_stem)
  centres and requantizes the raw uint8 or fp32 image itself, so no fp32 or
  column copy of the input materializes either;
* conv5_3 comes out as fp32 with no ReLU, for the channel L2-norm and the
  heads (NetVLAD through K1 on bf16 features, SPP, dense), in the compute
  dtype as in JAX.

Differences from JAX, none in the values: the weights are quantized once,
when ``QuantizedConvStack`` is built (JAX quantizes them inside each jitted
call), and laid out K-major as (F, 3, 3, C) int8 (``wgmma`` takes s8 only
K-major); the stem (C = 3) runs as a 1x1 conv of packed 3x3 columns
(``int8_conv.int8_stem``: the columns built in the kernel on the card, by
``stem_columns`` on the CPU), the same integer sums.

``packed_stem=True`` (``ModelConfig.packed_stem``) runs conv1_1, conv1_2,
pool1 and conv2_1 width-packed, as JAX's ``_packed_int8_stem``, where the
images' height is even and their width a multiple of 4 (elsewhere the
standard stem runs, as in JAX): each packed VALID (3, 2) conv is an im2col
gather and ``torch._int_mm`` (the library's int8 GEMM standing for XLA's
int8 conv) with Q1's epilogue in torch ops (``epilogue_plain``). The
packing only reindexes the same int8 values and the int32 sums are exact,
so conv2_2's input, and the conv5_3 map, equal the direct path's bit for
bit. Opt-in, as in JAX.

Parameters are an ``EmbeddingNet`` state_dict (``models/weights.py``).
"""

from __future__ import annotations

import json
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from soft_contrastive_learning_torch.core.config import ModelConfig, torch_dtype
from soft_contrastive_learning_torch.models.heads import spatial_pyramid_pool
from soft_contrastive_learning_torch.models.model import EmbeddingNet
from soft_contrastive_learning_torch.models.vgg16 import VGG_BLOCKS, l2_normalize
from soft_contrastive_learning_torch.ops.kernels.int8_conv import (
    epilogue_plain,
    int8_conv,
    int8_pool,
    int8_stem,
    requant_plain,
    stem_weight,
)
from soft_contrastive_learning_torch.ops.packed_stem import (
    pack_input,
    pack_kernel,
    packed_maxpool,
    repack_shifted,
    unpack_width,
)

CONV_NAMES: List[str] = [
    f"block{bi + 1}/{name}" for bi, specs in enumerate(VGG_BLOCKS) for (name, _, _) in specs
]


def _param(params: Mapping[str, torch.Tensor], conv: str, leaf: str) -> torch.Tensor:
    return params[f"vgg16.{conv.replace('/', '.')}.{leaf}"]


def _images(images, device=None, keep_uint8: bool = False) -> torch.Tensor:
    """NHWC images (uint8 or float, numpy or tensor) as RGB (a gray image
    expanded) on ``device``: fp32, or with ``keep_uint8`` as Q1_stem reads
    them, uint8 kept as it is (another dtype cast to fp32), contiguous."""
    x = torch.as_tensor(np.asarray(images) if not isinstance(images, torch.Tensor) else images)
    x = x.to(device or x.device)
    if not (keep_uint8 and x.dtype == torch.uint8):
        x = x.float()
    x = x.expand(-1, -1, -1, 3) if x.shape[-1] == 1 else x
    return x.contiguous() if keep_uint8 else x


def _inv(scale: float) -> float:
    """``1 / scale`` as the fp32 value JAX multiplies by (a weakly typed
    Python float cast to the array's fp32)."""
    return float(np.float32(1.0 / scale))


def _float_conv_stack(params, images: torch.Tensor, record_absmax: bool
                      ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """fp32 reference conv stack (calibration only; mirrors models/vgg16.py
    with pool-then-ReLU). TF32 off: the absmax is of the fp32 forward."""
    maxes = []
    dev = images.device
    a = images - params["vgg16.average_rgb"].float().to(dev)
    a = a.permute(0, 3, 1, 2)
    idx = 0
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        for bi, specs in enumerate(VGG_BLOCKS):
            for _name, _, relu in specs:
                if record_absmax:
                    maxes.append(a.abs().max())
                a = F.conv2d(a, _param(params, CONV_NAMES[idx], "weight").float().to(dev),
                             _param(params, CONV_NAMES[idx], "bias").float().to(dev), padding=1)
                if relu:
                    a = F.relu(a)
                idx += 1
            if bi < len(VGG_BLOCKS) - 1:
                a = F.relu(F.max_pool2d(a, kernel_size=2, stride=2))
    return a.permute(0, 2, 3, 1), maxes


@torch.inference_mode()
def calibrate_scales(params, images, device=None) -> Dict[str, float]:
    """Per-conv input activation scales (absmax/127) from an fp32 forward
    over a representative batch (NHWC, [0, 255]); 1.0 for a layer whose
    input is all zero. ``params`` is the EmbeddingNet state_dict; the
    forward runs on ``device`` (default: the images' own)."""
    _, maxes = _float_conv_stack(params, _images(images, device), record_absmax=True)
    maxes = torch.stack(maxes).cpu().tolist()  # one transfer
    return {name: (m / 127.0 if m > 0 else 1.0) for name, m in zip(CONV_NAMES, maxes)}


def save_scales(scales: Dict[str, float], path: str) -> None:
    with open(path, "w") as f:
        json.dump(scales, f, indent=1, sort_keys=True)


def load_scales(path: str) -> Dict[str, float]:
    with open(path) as f:
        return {k: float(v) for k, v in json.load(f).items()}


def _quantize_weight(weight: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """An OIHW fp32 conv weight -> (int8 (F, 3, 3, C) K-major, fp32 (F,)
    per-output-channel scales): absmax/127, 1.0 for an all-zero channel (0/0
    would spread NaN through the descriptor), round half to even, +-127."""
    k = weight.float()
    s = k.abs().amax(dim=(1, 2, 3)) / 127.0
    s = torch.where(s > 0, s, torch.ones_like(s))
    k8 = torch.clamp(torch.round(k / s[:, None, None, None]), -127, 127).to(torch.int8)
    return k8.permute(0, 2, 3, 1).contiguous(), s


def _packed_int8_conv(xp: torch.Tensor, layer: dict) -> torch.Tensor:
    """VALID (3, 2) conv of the packed int8 map xp (B, H+2, W/2+1, 2C) by a
    packed layer (``_packed_layer``) -> its int8 packed output (B, H, W/2,
    2F): the (3, 2, 2C) windows gathered as rows (K padded to the weight's),
    ``torch._int_mm`` to int32, Q1's epilogue."""
    b, hp, wp, c2 = xp.shape
    h, w2 = hp - 2, wp - 1
    cols = xp.unfold(1, 3, 1).unfold(2, 2, 1)  # (B, H, W/2, 2C, 3, 2), a view
    cols = cols.permute(0, 1, 2, 4, 5, 3).reshape(b * h * w2, 6 * c2)
    cols = F.pad(cols, (0, layer["weight"].shape[0] - cols.shape[1]))
    acc = torch._int_mm(cols, layer["weight"]).reshape(b, h, w2, -1)
    return epilogue_plain(acc, layer["mult"], layer["bias"], layer["inv_next"], True, False)


def _packed_layer(k8: torch.Tensor, mult: torch.Tensor, bias: torch.Tensor,
                  inv_next: float) -> dict:
    """A stem conv's int8 (F, 3, 3, C) weight packed (``pack_kernel``) as
    the (K, 2F) matrix of ``_packed_int8_conv``, K = 6 * 2C padded to a
    multiple of 8 (``torch._int_mm`` on the card), its per-channel
    multipliers and biases twice (the two width phases)."""
    kp = pack_kernel(k8.permute(1, 2, 3, 0))  # HWIO (3, 2, 2C, 2F)
    w = kp.reshape(-1, kp.shape[-1])
    w = F.pad(w, (0, 0, 0, -w.shape[0] % 8)).contiguous()
    return dict(weight=w, mult=torch.cat([mult, mult]), bias=torch.cat([bias, bias]),
                inv_next=inv_next)


class QuantizedConvStack:
    """The int8 VGG16 conv stack with its weights quantized once onto
    ``device``. Calling it maps NHWC images to the fp32 conv5_3 map
    (pre-normalization). ``packed_stem``: conv1_1 .. conv2_1 width-packed
    where the images allow it (module docstring)."""

    def __init__(self, params, scales: Dict[str, float], device="cuda",
                 packed_stem: bool = False):
        missing = sorted(set(CONV_NAMES) - set(scales))
        if missing:
            raise ValueError(f"quantization scales lack {missing}")
        self.device = torch.device(device)
        self.average_rgb = params["vgg16.average_rgb"].float().to(self.device)
        self.inv_in = _inv(scales[CONV_NAMES[0]])  # the input's requant
        self.layers = []
        self.packed = []  # conv1_1, conv1_2, conv2_1 packed, with packed_stem
        idx = 0
        for bi, specs in enumerate(VGG_BLOCKS):
            for si, (_name, _, relu) in enumerate(specs):
                name = CONV_NAMES[idx]
                k8, sk = _quantize_weight(_param(params, name, "weight").to(self.device))
                last = idx == len(CONV_NAMES) - 1
                block_end = si == len(specs) - 1
                # float32(s_in) * sk in fp32, as JAX's weakly typed s_in * sk
                mult = torch.tensor(np.float32(scales[name]), device=self.device) * sk
                self.layers.append(dict(
                    weight=stem_weight(k8) if idx == 0 else k8, mult=mult.contiguous(),
                    bias=_param(params, name, "bias").float().to(self.device).contiguous(),
                    inv_next=1.0 if last else _inv(scales[CONV_NAMES[idx + 1]]),
                    # a block boundary takes ReLU before the requant and the pool
                    relu=not last and (relu or block_end), out_f32=last,
                    pool=block_end and not last))
                if packed_stem and idx < 3:
                    self.packed.append(_packed_layer(k8, self.layers[-1]["mult"],
                                                     self.layers[-1]["bias"],
                                                     self.layers[-1]["inv_next"]))
                idx += 1

    def packed_stem(self, images: torch.Tensor) -> torch.Tensor:
        """JAX's ``_packed_int8_stem``: NHWC images (H even, W % 4 == 0) ->
        conv2_2's int8 input (B, H/2, W/2, 128), width-packed through
        conv1_1, conv1_2, pool1 (a phase and row max on the requantized
        int8) and conv2_1."""
        c11, c12, c21 = self.packed
        a8 = requant_plain(_images(images, self.device) - self.average_rgb, self.inv_in)
        y1 = _packed_int8_conv(pack_input(a8), c11)
        a8 = packed_maxpool(_packed_int8_conv(repack_shifted(y1), c12))
        return unpack_width(_packed_int8_conv(pack_input(a8), c21))

    def __call__(self, images) -> torch.Tensor:
        x = _images(images, self.device, keep_uint8=True)
        if self.packed and x.shape[1] % 2 == 0 and x.shape[2] % 4 == 0:
            a8, rest = self.packed_stem(x), self.layers[3:]  # conv2_2 onward
        else:
            stem, rest = self.layers[0], self.layers[1:]  # conv1_1: no pool
            a8 = int8_stem(x, self.average_rgb, self.inv_in, stem["weight"], stem["mult"],
                           stem["bias"], stem["inv_next"], stem["relu"])
        y = None
        for layer in rest:
            y = int8_conv(a8, layer["weight"], layer["mult"], layer["bias"], layer["inv_next"],
                          layer["relu"], layer["out_f32"])
            a8 = int8_pool(y) if layer["pool"] else y
        return y  # conv5_3: no pool, no ReLU


def quantized_conv_stack(params, scales: Dict[str, float], images,
                         packed_stem: bool = False) -> torch.Tensor:
    """int8 VGG16 conv stack -> fp32 conv5_3 map (pre-normalization), on the
    images' device, the weights quantized for this call."""
    x = _images(images)
    return QuantizedConvStack(params, scales, x.device, packed_stem)(x)


class QuantizedEmbedder:
    """Calibrate-once, quantize-once int8 embedding engine on ``device``.

    >>> emb = QuantizedEmbedder(cfg, params, calib_images)
    >>> descriptors = emb(images)          # reduced output
    >>> full = emb.full(images)            # raw descriptor (pre-reduction)
    >>> output, full = emb.embed(images)   # EmbeddingNet.forward's contract
    """

    def __init__(self, cfg: ModelConfig, params, calib_images=None,
                 scales: Optional[Dict[str, float]] = None, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        if scales is None:
            if calib_images is None:
                raise ValueError("QuantizedEmbedder needs calibration images or scales")
            scales = calibrate_scales(params, calib_images, self.device)
        self.scales = dict(scales)
        self.stack = QuantizedConvStack(params, self.scales, self.device, cfg.packed_stem)
        # the heads (NetVLAD, dense) as the float model holds them
        model = EmbeddingNet(cfg)
        model.load_state_dict(params)
        self.model = model.to(self.device).eval()

    @torch.inference_mode()
    def embed(self, images) -> Tuple[torch.Tensor, torch.Tensor]:
        """(output, full_out), as ``EmbeddingNet.forward`` returns them."""
        cfg = self.cfg
        feat = l2_normalize(self.stack(images), dim=-1)
        if cfg.reduction == "spp":
            output = spatial_pyramid_pool(feat, cfg.spp_levels)
            return output, output
        if self.model.netvlad is not None:
            # the features in the compute dtype, as JAX hands them to NetVLAD
            full_out = self.model.netvlad(feat.to(torch_dtype(cfg.compute_dtype)).float())
        else:
            full_out = feat.reshape(feat.shape[0], -1)
        if self.model.fc_head is not None:
            return self.model.fc_head(full_out, train=False), full_out
        return full_out, full_out  # 'none', 'pca'

    def __call__(self, images) -> torch.Tensor:
        return self.embed(images)[0]

    def full(self, images) -> torch.Tensor:
        return self.embed(images)[1]


def quantized_embed(cfg: ModelConfig, params, scales: Dict[str, float], images
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The full quantized forward, (output, full_out) as ``EmbeddingNet``'s,
    on the images' device, the weights quantized for this call."""
    x = _images(images)
    return QuantizedEmbedder(cfg, params, scales=scales, device=x.device).embed(x)
