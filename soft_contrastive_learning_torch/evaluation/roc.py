"""ROC / paper-figure compiler, the counterpart of
``soft_contrastive_learning_tpu/evaluation/roc.py``: read top-N pickles for
named checkpoints x query conditions, and plot %-correctly-localized against
the distance threshold (0-25 m, 50 points) with the geographic upper bound,
one panel per query condition, into a PDF (and PGF where a LaTeX toolchain
is present). ``RocSeries`` declares a curve; the defaults are the paper's
10-model comparison over its five query conditions. A sheet grows by whole
columns past five conditions, so the legend keeps the last cell.

``correctly_localized_curve`` and ``load_top1_dists`` need numpy only;
``compile_roc`` imports matplotlib when it is called and, where it is not
installed, raises saying so.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np

from soft_contrastive_learning_torch.utils.io import load_pickle


@dataclass
class RocSeries:
    """One curve: a checkpoint's top-n results under a display style."""

    name: str  # checkpoint code used in pickle filenames
    label: str  # legend label
    color: str = "#000000"
    line: str = "-"
    marker: str = ""
    fillstyle: str = "none"


DEFAULT_QUERIES = (
    ("oxford_night", "Oxford RobotCar, night", 0),
    ("oxford_overcast", "Oxford RobotCar, overcast", 40),
    ("oxford_snow", "Oxford RobotCar, snow", 50),
    ("oxford_sunny", "Oxford RobotCar, sunny", 50),
    ("pittsburgh_query", "Pittsburgh", 10),
)

# The paper's model comparison.
DEFAULT_SERIES = (
    RocSeries("offtheshelf", "Off-the-shelf", "#000000", ":", ""),
    RocSeries("pittsnetvlad", "Triplet trained on Pittsburgh", "#ff6b1c", ":", "^"),
    RocSeries("triplet", "Triplet", "#f03577", "--", "^"),
    RocSeries("quadruplet", "Quadruplet", "#5f396b", "--", "s"),
    RocSeries("lazy_triplet", "Lazy triplet", "#1934e6", "--", "^"),
    RocSeries("lazy_quadruplet", "Lazy quadruplet", "#0e6606", "-.", "s"),
    RocSeries("huber_distance_triplet", "Trip. + Huber dist.", "#B0C4DE", "-.", "^"),
    RocSeries("logratio", "Log-ratio", "#990000", "--", "v"),
    RocSeries("ms_loss", "Multi-similarity", "#663300", "-.", "o"),
    RocSeries("wms", "Ours", "#11d194", "-", "d", "full"),
)


def correctly_localized_curve(
    top1_geo_dists: np.ndarray, t_max: float = 25.0, num: int = 50
) -> Tuple[np.ndarray, np.ndarray]:
    """(thresholds, % of queries whose top-1 retrieval is within threshold)."""
    x = np.linspace(0, t_max, num=num)
    d = np.asarray(top1_geo_dists).reshape(-1)
    y = (d[None, :] < x[:, None]).mean(axis=1) * 100.0
    return x, y


def load_top1_dists(pickle_path: str) -> Tuple[np.ndarray, np.ndarray]:
    """(top-1 retrieval geo dists, ground-truth optimal geo dists) from a
    top-N pickle (``evaluation/topn.py``), written by either package."""
    top_i, top_g_dists, top_f_dists, gt_i, gt_g_dist, ref_idx = load_pickle(pickle_path)
    top_g = np.asarray(top_g_dists)
    return top_g[:, 0], np.asarray(gt_g_dist)


def compile_roc(
    top_n_root: str,
    out_root: str,
    setting: str = "l0.0_dim256",
    queries: Sequence[Tuple[str, str, float]] = DEFAULT_QUERIES,
    series: Sequence[RocSeries] = DEFAULT_SERIES,
    t_max: float = 25.0,
    save_pgf: bool = False,
) -> Optional[str]:
    """Multi-panel figure over query conditions; returns the PDF path (None if
    no pickle was found at all)."""
    try:
        import matplotlib
    except ImportError as e:
        raise RuntimeError("compile_roc draws the figure with matplotlib, which is not "
                           "installed; correctly_localized_curve and load_top1_dists compute "
                           "the curves without it") from e

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(out_root, exist_ok=True)
    # a 2x3 sheet (5 panels and the legend cell) at least; more query
    # conditions add whole columns, so the legend keeps the last cell
    rows = 2
    cols = max(3, -(-(len(queries) + 1) // rows))
    fig, axs = plt.subplots(rows, cols, figsize=(10 * cols / 3, 8))
    found_any = False

    for i, (query, title, min_y) in enumerate(queries):
        ax = axs[i % rows, i // rows]
        printed_gt = False
        max_y = 0.0
        for series_i, s in enumerate(series):
            path = os.path.join(top_n_root, setting, f"{query}_{s.name}.pickle")
            if not os.path.exists(path):
                continue
            found_any = True
            top1, gt = load_top1_dists(path)
            if not printed_gt:
                printed_gt = True
                x, y = correctly_localized_curve(gt, t_max)
                ax.plot(x, y, label="Upper bound", linewidth=0.75, c="#000000")
                ax.set_title(title)
                ax.grid(True)
            x, y = correctly_localized_curve(top1, t_max)
            max_y = max(max_y, float(np.max(y)))
            ax.plot(
                x, y, label=s.label, linestyle=s.line, marker=s.marker,
                linewidth=0.75, markevery=series_i % rows + cols, c=s.color,
                markersize=3, fillstyle=s.fillstyle,
            )
        if printed_gt:
            ax.set_xlim([0, t_max])
            # clamp: weak checkpoint sets can peak below the panel's floor
            ax.set_ylim([min_y, max(min(max_y + 5, 100), min_y + 1)])

    axs[-1, -1].axis("off")
    for c in range(cols):
        axs[-1, c].set_xlabel("Distance threshold d [m]")
    for r in range(rows):
        axs[r, 0].set_ylabel("Correctly localized [%]")
    handles, labels = axs[0, 0].get_legend_handles_labels()
    if handles:
        axs[-1, -1].legend(handles, labels, loc="center left", fontsize="medium")

    if not found_any:
        plt.close(fig)
        return None
    out_name = os.path.join(
        out_root, f"{setting.replace('.', '')}_roc.pdf"
    )
    plt.savefig(out_name, bbox_inches="tight", pad_inches=0)
    if save_pgf:
        try:
            plt.savefig(out_name.replace(".pdf", ".pgf"), bbox_inches="tight",
                        pad_inches=0)
        except Exception:
            pass  # no LaTeX toolchain
    plt.close(fig)
    return out_name
