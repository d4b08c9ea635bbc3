"""Checkpoints of the full training state, the counterpart of
``soft_contrastive_learning_tpu/checkpoints/manager.py`` with its names.

Three roles under one run directory, as there: ``rolling`` (written inside
each eval, the newest ``max_to_keep`` kept), ``epoch`` and ``part`` (each
epoch's end and every ``save_step`` anchors, all kept). The payload is the
model's and the optimizer's ``state_dict``, the step, and the trainer's
``extras`` (sampler and eval generator states and the position inside the
epoch), so that training resumes exactly; also the train state's dropout
generator and, once initialized, the trainer's streaming PCAs (``pca`` and
``loss_pca``: ``StreamingPCA.state_dict()``, numpy arrays and floats). A
checkpoint written before the PCAs were initialized restores with none.

The format is the port's own: ``checkpoints/<role>/<step>/state.pt``, a
``torch.save`` of a dictionary of CPU tensors and plain Python values that
``torch.load(..., weights_only=True)`` reads. It is written under a
temporary name and renamed, so a killed run leaves no half file. ``save``
is synchronous and ``wait`` has nothing to wait for. The two packages do
not read each other's checkpoints: the JAX package writes orbax trees of
flax parameters and optax states, and orbax imports JAX, which the port
never does. State crosses between them as numpy arrays through
``models/weights.py::train_state_from_flax``, and the streaming PCAs'
state dicts as they are, through ``save``'s ``pca`` and ``loss_pca``.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

# Parameter scopes that a warm start copies (the JAX package's
# WARM_START_SCOPES): top-level module names of the EmbeddingNet state_dict.
WARM_START_SCOPES = ("vgg16", "netvlad")
STATE_FILE = "state.pt"

_RNG_BYTES = 512  # fixed-size buffer for serialized numpy Generator states


def numpy_rng_to_array(gen: np.random.Generator) -> np.ndarray:
    """A numpy Generator's bit-generator state as a fixed-size uint8 array."""
    raw = json.dumps(gen.bit_generator.state).encode()
    assert len(raw) < _RNG_BYTES, "rng state unexpectedly large"
    buf = np.zeros(_RNG_BYTES, np.uint8)
    buf[: len(raw)] = np.frombuffer(raw, np.uint8)
    return buf


def numpy_rng_from_array(buf) -> np.random.Generator:
    raw = bytes(np.asarray(buf, np.uint8)).rstrip(b"\x00")
    gen = np.random.default_rng()
    gen.bit_generator.state = json.loads(raw.decode())
    return gen


def _to_cpu(value: Any) -> Any:
    """Tensors detached onto the CPU, numpy arrays as tensors, containers
    walked; plain Python values as they are."""
    if torch.is_tensor(value):
        return value.detach().cpu()
    if isinstance(value, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(value))
    if isinstance(value, np.generic):
        return value.item()
    if isinstance(value, Mapping):
        return {k: _to_cpu(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_to_cpu(v) for v in value]
    return value


class RunCheckpoints:
    ROLES = ("rolling", "epoch", "part")

    def __init__(self, out_dir: str, max_to_keep: int = 1, enabled: bool = True):
        """``enabled=False`` is read-only: ``save`` does nothing and nothing
        is created under ``out_dir``; ``latest`` and ``restore`` still
        work."""
        self.out_dir = out_dir
        self.enabled = enabled
        self._max_to_keep = max_to_keep

    def _role_root(self, role: str) -> str:
        if role not in self.ROLES:
            raise ValueError(f"unknown checkpoint role {role!r}; expected one of {self.ROLES}")
        return os.path.abspath(os.path.join(self.out_dir, "checkpoints", role))

    def _steps(self, role: str) -> list:
        """The steps of ``role`` that hold a finished ``state.pt``, ascending."""
        root = self._role_root(role)
        if not os.path.isdir(root):
            return []
        return sorted(int(name) for name in os.listdir(root)
                      if name.isdigit() and os.path.exists(os.path.join(root, name, STATE_FILE)))

    def save(self, role: str, step: int, train_state, extras: Optional[dict] = None,
             pca: Optional[dict] = None, loss_pca: Optional[dict] = None) -> None:
        """Write ``train_state`` (``train/step.py::TrainState``), ``extras``
        and the streaming PCAs' state dicts (None: not initialized) as
        ``<role>/<step>/state.pt``; for ``rolling`` then drop all but the
        newest ``max_to_keep``."""
        if not self.enabled:
            return
        step_dir = os.path.join(self._role_root(role), str(int(step)))
        os.makedirs(step_dir, exist_ok=True)
        payload = {
            "model": _to_cpu(train_state.model.state_dict()),
            "optimizer": _to_cpu(train_state.optimizer.state_dict()),
            "step": int(train_state.step),
            "extras": _to_cpu(extras) if extras is not None else None,
        }
        rng = getattr(train_state, "rng", None)  # the dropout generator
        if rng is not None:
            payload["rng"] = rng.get_state()
        for key, sd in (("pca", pca), ("loss_pca", loss_pca)):
            if sd is not None:
                payload[key] = _to_cpu(sd)
        path = os.path.join(step_dir, STATE_FILE)
        tmp = f"{path}.{os.getpid()}.tmp"
        try:
            torch.save(payload, tmp)
            os.replace(tmp, path)  # atomic: a reader sees the old file or the new one
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        if role == "rolling" and self._max_to_keep is not None:
            for old in self._steps(role)[: -self._max_to_keep or None]:
                shutil.rmtree(os.path.join(self._role_root(role), str(old)), ignore_errors=True)

    def wait(self) -> None:
        """Nothing to wait for: ``save`` returns when the file is in place.
        Kept because the JAX manager's saves are asynchronous and its
        callers wait before they exit."""

    def latest(self, role: str = "rolling") -> Optional[int]:
        steps = self._steps(role)
        return steps[-1] if steps else None

    def load(self, role: str, step: int) -> Dict[str, Any]:
        """The payload of ``<role>/<step>`` as it was saved, on the CPU."""
        path = os.path.join(self._role_root(role), str(int(step)), STATE_FILE)
        return torch.load(path, map_location="cpu", weights_only=True)

    def restore(self, role: str, step: int, like_state
                ) -> Tuple[Any, Optional[dict], Optional[dict], Optional[dict]]:
        """Load ``<role>/<step>`` into ``like_state`` in place (its model,
        optimizer and dropout generator, on their device) and return
        ``(like_state, pca, loss_pca, extras)`` as the JAX manager does: the
        PCA state dicts with numpy arrays, None where the checkpoint holds
        none."""
        payload = self.load(role, step)
        like_state.model.load_state_dict(payload["model"])
        like_state.optimizer.load_state_dict(payload["optimizer"])
        like_state.step = int(payload["step"])
        if "rng" in payload and getattr(like_state, "rng", None) is not None:
            like_state.rng.set_state(payload["rng"])
        pcas = [None if payload.get(key) is None else
                {k: v.numpy() if torch.is_tensor(v) else v for k, v in payload[key].items()}
                for key in ("pca", "loss_pca")]
        return like_state, *pcas, payload.get("extras")

    def close(self) -> None:
        """Nothing is held open between calls."""


def warm_start_params(fresh_params: Mapping[str, torch.Tensor],
                      donor_params: Mapping[str, torch.Tensor], scopes=WARM_START_SCOPES):
    """Copy the ``scopes`` (top-level module names) of a donor state_dict
    into a freshly initialized one; whatever else it holds stays fresh.
    Returns the merged state_dict and the scopes that were copied."""
    merged = dict(fresh_params)
    copied = []
    for scope in scopes:
        keys = [k for k in merged if k.split(".", 1)[0] == scope and k in donor_params]
        if keys:
            merged.update({k: donor_params[k] for k in keys})
            copied.append(scope)
    return merged, copied


def load_run_params(run_dir: str, role: Optional[str] = None):
    """The newest trained parameters of a training-run directory
    (``checkpoints/`` + ``config.json``): the train -> serve seam. Returns
    ``(model_config, state_dict)``; the run's saved ModelConfig is
    authoritative, since it matches the parameters."""
    from soft_contrastive_learning_torch.core.config import TrainConfig
    from soft_contrastive_learning_torch.models.model import init_params

    cfg_path = os.path.join(run_dir, "config.json")
    if not os.path.exists(cfg_path):
        raise FileNotFoundError(f"{run_dir} is not a training run dir (no config.json)")
    cfg = TrainConfig.load(cfg_path)
    # enabled=False: loading must never create directories in the run
    ckpts = RunCheckpoints(run_dir, max_to_keep=cfg.max_to_keep, enabled=False)
    # Roles count steps in different units ('epoch' saves the epoch index,
    # the others the global step), so the newest-WRITTEN checkpoint is picked
    # by its directory's mtime, not by its number.
    best = None  # (mtime, step, role)
    for r in ([role] if role else RunCheckpoints.ROLES):
        try:
            s = ckpts.latest(r)
        except OSError as e:
            logging.getLogger(__name__).warning(
                "checkpoint role %r unreadable under %s: %s", r, run_dir, e)
            s = None
        if s is None:
            continue
        mtime = os.path.getmtime(os.path.join(ckpts._role_root(r), str(s)))
        if best is None or mtime > best[0]:
            best = (mtime, s, r)
    if best is None:
        raise FileNotFoundError(f"no checkpoints under {run_dir}/checkpoints")
    _, step, r = best
    params = ckpts.load(r, step)["model"]
    # Hold the saved parameters to the run's OWN architecture, so that a stale
    # checkpoint (config.json edited, or the module tree changed since) fails
    # here and not deep inside a later forward.
    expect_sd = {k: (tuple(v.shape), v.dtype) for k, v in init_params(cfg.model, 0).items()}
    saved_sd = {k: (tuple(v.shape), v.dtype) for k, v in params.items()}
    if expect_sd != saved_sd:
        missing = sorted(set(expect_sd) - set(saved_sd))[:3]
        extra = sorted(set(saved_sd) - set(expect_sd))[:3]
        shapes = sorted(k for k in set(expect_sd) & set(saved_sd)
                        if expect_sd[k] != saved_sd[k])[:3]
        raise ValueError(
            f"checkpoint {run_dir}/checkpoints/{r}/{int(step)} does not match "
            f"the run's ModelConfig (stale architecture?): "
            f"missing={missing} extra={extra} shape/dtype-mismatch={shapes}")
    return cfg.model, params
