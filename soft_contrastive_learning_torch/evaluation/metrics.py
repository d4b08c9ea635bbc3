"""Localization metrics in numpy, for the in-training eval.

Own copy of ``soft_contrastive_learning_tpu/evaluation/metrics.py`` without
``fixed_split_recall`` (the quality experiments' protocol): geographic
distance of the top-n latent retrievals, cumulative-min top-n curves,
%-correctly-localized against tolerance, and AUC@Top1 over a 25-point grid
per radius. ``save_curve_plot`` imports matplotlib when it is called.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

# numpy renamed trapz -> trapezoid in 2.0; support both.
_trapezoid = getattr(np, "trapezoid", None) or np.trapz


def geo_dists_of_retrievals(
    query_xy: np.ndarray,  # (Q, 2)
    ref_xy: np.ndarray,  # (R, 2)
    retrieved_indices: np.ndarray,  # (Q, K) indices into refs
) -> np.ndarray:
    """(Q, K) geographic distance of each retrieved reference."""
    return np.linalg.norm(
        ref_xy[retrieved_indices] - query_xy[:, None, :], axis=-1
    )


def cumulative_min_topn(d_retrieved: np.ndarray) -> np.ndarray:
    """top_n[i, j] = best geographic distance among the first j+1 retrievals."""
    return np.minimum.accumulate(d_retrieved, axis=1)


def pct_within(dists: np.ndarray, thresholds: np.ndarray) -> np.ndarray:
    """% of entries below each threshold: (Q,) x (X,) -> (X,)."""
    return (dists[None, :] < thresholds[:, None]).mean(axis=1) * 100.0


def localization_summary(
    query_xy: np.ndarray,
    ref_xy: np.ndarray,
    retrieved_indices: np.ndarray,  # (Q, K) latent top-k
    optimal_dists: np.ndarray,  # (Q,) distance to geographically nearest ref
    radii=(50, 25, 10),
    num_points: int = 25,
) -> Tuple[Dict[str, float], Dict[int, Dict[str, np.ndarray]]]:
    """Scalars {'{r}m-auc@Top1', '%<{r}m@Top1'} + per-radius curve bundles."""
    d_retr = geo_dists_of_retrievals(query_xy, ref_xy, retrieved_indices)
    top_n = cumulative_min_topn(d_retr)
    scalars: Dict[str, float] = {}
    curves: Dict[int, Dict[str, np.ndarray]] = {}
    for rad in radii:
        x = np.linspace(0, rad, num=num_points)
        per_n = np.stack([pct_within(top_n[:, n], x) for n in range(top_n.shape[1])])
        optimum = pct_within(np.asarray(optimal_dists).reshape(-1), x)
        auc = float(_trapezoid(per_n[0], x))
        scalars[f"{rad}m-auc@Top1"] = auc
        scalars[f"%<{rad}m@Top1"] = float(per_n[0, -1])
        curves[rad] = {"x": x, "top_n": per_n, "optimum": optimum}
    return scalars, curves


def save_curve_plot(curves: Dict[str, np.ndarray], rad: int, title: str, out_file: str) -> None:
    """Tolerance-curve PDF: one line per top-n and the optimum."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plt.clf()
    x = curves["x"]
    for n in range(curves["top_n"].shape[0]):
        plt.plot(x, curves["top_n"][n])
    plt.plot(x, curves["optimum"])
    plt.legend([f"Top-{n + 1}" for n in range(curves["top_n"].shape[0])] + ["Optimum"])
    plt.ylabel("Correctly localized")
    plt.xlabel("Tolerance [m]")
    plt.xlim(0, rad)
    plt.title(title)
    plt.savefig(out_file)
