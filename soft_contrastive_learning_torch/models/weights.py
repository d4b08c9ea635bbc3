"""Load the flagship's flax parameters into the port's modules.

The committed trained artifact is
``soft_contrastive_learning_tpu/assets/flagship_trained.npz``: 29 float16
arrays keyed by flax param path (``vgg16/block3/conv3_2/kernel``,
``netvlad/assignment/kernel``, ...). It is read by file path; nothing of the
JAX package is imported. The mapping onto ``EmbeddingNet.state_dict()``:

* ``a/b/c/kernel`` HWIO (3, 3, Cin, Cout) -> ``a.b.c.weight`` OIHW;
* ``netvlad/assignment/kernel`` (1, 1, 512, K) -> (K, 512, 1, 1);
* ``netvlad/cluster_centers`` stays (512, K), negated sign kept;
* everything else keeps its name with dots for slashes.

A missing or extra key or a wrong shape raises, as the JAX loader does
(``flagship.py::load_trained_params``): a stale artifact must not half-load.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from soft_contrastive_learning_torch.core.config import ModelConfig, torch_dtype
from soft_contrastive_learning_torch.models.vgg16 import VGG_BLOCKS

TRAINED_PARAMS_PATH = (
    Path(__file__).resolve().parents[2]
    / "soft_contrastive_learning_tpu" / "assets" / "flagship_trained.npz"
)


def flax_param_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    """The flax param paths and shapes of ``cfg``'s EmbeddingNet."""
    shapes: Dict[str, tuple] = {"vgg16/average_rgb": (3,)}
    cin = 3
    for bi, specs in enumerate(VGG_BLOCKS):
        for name, cout, _ in specs:
            shapes[f"vgg16/block{bi + 1}/{name}/kernel"] = (3, 3, cin, cout)
            shapes[f"vgg16/block{bi + 1}/{name}/bias"] = (cout,)
            cin = cout
    shapes["netvlad/assignment/kernel"] = (1, 1, 512, cfg.vlad_cores)
    shapes["netvlad/cluster_centers"] = (512, cfg.vlad_cores)
    return shapes


def params_from_flax(
    flat: Mapping[str, np.ndarray], cfg: Optional[ModelConfig] = None
) -> Dict[str, torch.Tensor]:
    """Flat flax params (slash keys, HWIO kernels) -> an EmbeddingNet
    state_dict in ``cfg.param_dtype`` on the CPU."""
    cfg = cfg or ModelConfig()
    expect = flax_param_shapes(cfg)
    missing, extra = sorted(set(expect) - set(flat)), sorted(set(flat) - set(expect))
    if missing or extra:
        raise ValueError(f"params do not match the architecture (missing {missing[:3]}, "
                         f"extra {extra[:3]})")
    dtype = torch_dtype(cfg.param_dtype)
    state = {}
    for key, shape in expect.items():
        arr = np.asarray(flat[key])
        if arr.shape != shape:
            raise ValueError(f"shape mismatch at {key}: {arr.shape} vs {shape}")
        t = torch.from_numpy(np.array(arr))  # a writable copy
        parts = key.split("/")
        if parts[-1] == "kernel":
            t = t.permute(3, 2, 0, 1)  # HWIO -> OIHW
            parts[-1] = "weight"
        state[".".join(parts)] = t.to(dtype).contiguous()
    return state


def load_trained_params(
    path: Optional[str | Path] = None, cfg: Optional[ModelConfig] = None
) -> Dict[str, torch.Tensor]:
    """The trained flagship npz (default: the committed artifact) as a
    state_dict."""
    with np.load(path or TRAINED_PARAMS_PATH) as data:
        flat = {k: data[k] for k in data.files}
    return params_from_flax(flat, cfg)
