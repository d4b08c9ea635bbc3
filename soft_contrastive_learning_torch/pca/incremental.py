"""Streaming (incremental) PCA with a forgetting factor, own copy of
``soft_contrastive_learning_tpu/pca/incremental.py`` (numpy only there too;
the port imports nothing of the JAX package): ``skl_init``,
``single_skl_increment``, ``multiple_skl_increments`` and ``StreamingPCA``,
with the same float64 numpy arithmetic on the host, so that both packages
give the same bits on the same inputs.

The state is ``(s, v, m, seen, true_seen, var)``: ``v`` (out_dim, D) the
components, ``m`` (D,) the mean, ``var`` (out_dim,) the explained variance,
so that whitening is ``(X - m) @ v.T / sqrt(var)``. An update stacks
``[f * diag(s) @ v ; X - mean(X) ; mean-correction row]`` and keeps the top
``out_dim`` of its SVD (sklearn ``IncrementalPCA.partial_fit``, with the
forgetting factor ``f`` of Ross et al. 2008 on the old spectrum). ``seen``
is the forgetting-decayed sample count that drives the mean, ``true_seen``
the count of real samples. The differentiable counterpart of one update's
spectrum is ``losses/incremental.py::incremental_s``, on the same stack.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

Array = np.ndarray


def skl_init(features: Array, out_dim: int) -> List:
    """Batch-PCA initialization from the first feature block."""
    x = np.asarray(features, dtype=np.float64)
    n, d = x.shape
    m = x.mean(axis=0)
    u, s, vt = np.linalg.svd(x - m, full_matrices=False)
    k = min(out_dim, len(s))
    s_out = np.zeros(out_dim)
    v_out = np.zeros((out_dim, d))
    s_out[:k] = s[:k]
    v_out[:k] = vt[:k]
    var = np.maximum(s_out**2 / max(n - 1, 1), 1e-12)
    return [
        s_out.astype(np.float32),
        v_out.astype(np.float32),
        m.astype(np.float32),
        float(n),
        float(n),
        var.astype(np.float32),
    ]


def single_skl_increment(
    features: Array,
    s: Array,
    v: Array,
    m: Array,
    seen: float,
    true_seen: float,
    forgetting: float,
) -> List:
    """One rank-update of the running PCA with forgetting factor ``forgetting``
    applied to the old spectrum (f = 1 recovers sklearn partial_fit)."""
    x = np.asarray(features, dtype=np.float64)
    n, d = x.shape
    s = np.asarray(s, dtype=np.float64)
    v = np.asarray(v, dtype=np.float64)
    m = np.asarray(m, dtype=np.float64)
    out_dim = len(s)

    mx = x.mean(axis=0)
    seen_eff = forgetting * seen
    total = seen_eff + n
    mean_correction = np.sqrt(seen_eff * n / total) * (mx - m)
    b = np.vstack(
        [
            forgetting * s[:, None] * v,
            x - mx,
            mean_correction[None, :],
        ]
    )
    _, s_new, vt_new = np.linalg.svd(b, full_matrices=False)
    k = min(out_dim, len(s_new))
    s_out = np.zeros(out_dim)
    v_out = np.zeros((out_dim, d))
    s_out[:k] = s_new[:k]
    v_out[:k] = vt_new[:k]

    m_new = (seen_eff * m + n * mx) / total
    true_seen_new = true_seen + n
    var = np.maximum(s_out**2 / max(total - 1, 1), 1e-12)
    return [
        s_out.astype(np.float32),
        v_out.astype(np.float32),
        m_new.astype(np.float32),
        float(total),
        float(true_seen_new),
        var.astype(np.float32),
    ]


def multiple_skl_increments(
    features: Array,
    batch_size: int,
    s: Array,
    v: Array,
    m: Array,
    seen: float,
    true_seen: float,
    forgetting: float,
) -> List:
    """Apply single increments over ``batch_size`` chunks
    (reference call site train/train.py:1047-1049)."""
    x = np.asarray(features)
    state = [s, v, m, seen, true_seen, None]
    for start in range(0, len(x), batch_size):
        chunk = x[start : start + batch_size]
        if len(chunk) == 0:
            break
        state = single_skl_increment(
            chunk, state[0], state[1], state[2], state[3], state[4], forgetting
        )
    return state


@dataclass
class StreamingPCA:
    """Object wrapper holding the 6-tuple state; thread-safe mutation belongs
    to the caller (the trainer serializes updates through its queue)."""

    out_dim: int
    forgetting: float = 0.4
    s: Array = None
    v: Array = None
    m: Array = None
    seen: float = 0.0
    true_seen: float = 0.0
    var: Array = None

    @property
    def initialized(self) -> bool:
        return self.s is not None

    def init(self, features: Array) -> None:
        self.s, self.v, self.m, self.seen, self.true_seen, self.var = skl_init(
            features, self.out_dim
        )

    def update(self, features: Array) -> None:
        if not self.initialized:
            self.init(features)
            return
        self.s, self.v, self.m, self.seen, self.true_seen, self.var = (
            single_skl_increment(
                features, self.s, self.v, self.m, self.seen, self.true_seen,
                self.forgetting,
            )
        )

    def update_multi(self, features: Array, batch_size: int) -> None:
        if not self.initialized:
            self.init(features)
            return
        self.s, self.v, self.m, self.seen, self.true_seen, self.var = (
            multiple_skl_increments(
                features, batch_size, self.s, self.v, self.m, self.seen,
                self.true_seen, self.forgetting,
            )
        )

    def whiten(self, features: Array) -> Array:
        """(X - m) @ v.T / sqrt(var) (reference train/train.py:1052-1053)."""
        return ((features - self.m) @ self.v.T) / np.sqrt(self.var)

    def state_dict(self) -> dict:
        return {
            "s": self.s, "v": self.v, "m": self.m,
            "seen": self.seen, "true_seen": self.true_seen, "var": self.var,
            "out_dim": self.out_dim, "forgetting": self.forgetting,
        }

    @classmethod
    def from_state_dict(cls, d: dict) -> "StreamingPCA":
        obj = cls(out_dim=int(d["out_dim"]), forgetting=float(d["forgetting"]))
        obj.s, obj.v, obj.m = d["s"], d["v"], d["m"]
        obj.seen, obj.true_seen, obj.var = float(d["seen"]), float(d["true_seen"]), d["var"]
        return obj
