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

``train_state_from_flax`` carries a whole JAX ``TrainState`` across: the flax
params and the optax moments, handed over as numpy arrays, become the port's
model and a ``torch.optim`` optimizer in the same state, so that both take
the same next step. (The two packages do not read each other's checkpoint
files; this is the seam between them.)
"""

from __future__ import annotations

from pathlib import Path
from typing import TYPE_CHECKING, Dict, Mapping, Optional

import numpy as np
import torch

from soft_contrastive_learning_torch.core.config import ModelConfig, torch_dtype
from soft_contrastive_learning_torch.models.vgg16 import VGG_BLOCKS

if TYPE_CHECKING:
    from soft_contrastive_learning_torch.core.config import TrainConfig
    from soft_contrastive_learning_torch.train.step import TrainState

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
    flat: Mapping[str, np.ndarray], cfg: Optional[ModelConfig] = None, partial: bool = False
) -> Dict[str, torch.Tensor]:
    """Flat flax params (slash keys, HWIO kernels) -> an EmbeddingNet
    state_dict in ``cfg.param_dtype`` on the CPU. ``partial``: a subset of
    the architecture's keys is allowed (a warm start's donor) and only those
    are returned; an unknown key or a wrong shape still raises."""
    cfg = cfg or ModelConfig()
    expect = flax_param_shapes(cfg)
    missing, extra = sorted(set(expect) - set(flat)), sorted(set(flat) - set(expect))
    if (missing and not partial) or extra:
        raise ValueError(f"params do not match the architecture (missing {missing[:3]}, "
                         f"extra {extra[:3]})")
    dtype = torch_dtype(cfg.param_dtype)
    state = {}
    for key, shape in expect.items():
        if key not in flat:
            continue
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


def train_state_from_flax(
    cfg: "TrainConfig",
    params: Mapping[str, np.ndarray],
    step: int,
    mu: Optional[Mapping[str, np.ndarray]] = None,
    nu: Optional[Mapping[str, np.ndarray]] = None,
    count: Optional[int] = None,
    trace: Optional[Mapping[str, np.ndarray]] = None,
    device: str | torch.device = "cpu",
) -> "TrainState":
    """The port's ``TrainState`` from a JAX one handed over as numpy arrays.

    ``params``: the flax params, flat with slash keys, as ``params_from_flax``
    takes them; ``step``: ``TrainState.step``. The optimizer's moments have
    the params' keys and layouts and go through the same mapping:

    * ``cfg.optimizer == 'adam'``: optax's ``ScaleByAdamState`` as ``mu``,
      ``nu`` and ``count`` -> ``exp_avg``, ``exp_avg_sq`` and ``step`` of
      ``torch.optim.Adam`` (both scale ``mu / (1 - b1^count)`` by
      ``1 / (sqrt(nu / (1 - b2^count)) + eps)``);
    * ``'momentum'``: optax's ``TraceState.trace`` -> SGD's
      ``momentum_buffer`` (both keep ``g + momentum * trace``).

    With ``count == 0`` or no moments the optimizer starts fresh, as
    ``init_train_state`` leaves it."""
    from soft_contrastive_learning_torch.models.model import EmbeddingNet
    from soft_contrastive_learning_torch.train.step import init_train_state

    model = EmbeddingNet(cfg.model)
    model.load_state_dict(params_from_flax(params, cfg.model))
    state = init_train_state(cfg, model.to(device))
    state.step = int(step)
    names = [name for name, _ in state.model.named_parameters()]
    if cfg.optimizer == "adam":
        if (mu is None) != (nu is None) or (mu is not None and count is None):
            raise ValueError("Adam's state needs mu, nu and count together")
        moments = {} if mu is None or int(count) == 0 else {
            "exp_avg": params_from_flax(mu, cfg.model),
            "exp_avg_sq": params_from_flax(nu, cfg.model)}
    else:
        moments = {} if trace is None else {"momentum_buffer": params_from_flax(trace, cfg.model)}
    if moments:
        packed = state.optimizer.state_dict()
        packed["state"] = {
            i: {key: values[name] for key, values in moments.items()}
            for i, name in enumerate(names)}
        if cfg.optimizer == "adam":
            for entry in packed["state"].values():
                entry["step"] = torch.tensor(float(count), dtype=torch.float32)
        state.optimizer.load_state_dict(packed)
    return state
