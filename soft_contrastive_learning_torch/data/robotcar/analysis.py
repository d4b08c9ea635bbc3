"""Side-analysis stages 009 (dataset statistics) and 010 (feature-distance
scale factor). Own copy of
``soft_contrastive_learning_tpu/data/robotcar/analysis.py``.

Capability parity with reference prepare_data/009_plot_statistics.py:20-88 and
prepare_data/010_get_scale_factor.py:24-62.
"""

from __future__ import annotations

import os
from collections import Counter
from typing import Dict, List, Sequence

import numpy as np

from soft_contrastive_learning_torch.data.robotcar.stages import PrepContext
from soft_contrastive_learning_torch.utils.io import load_table as load_csv
from soft_contrastive_learning_torch.utils.io import save_csv, save_pickle
from soft_contrastive_learning_torch.utils.plot import dict_to_bar


def plot_statistics(ctx: PrepContext, tag_root: str = "") -> None:
    """Images/dates per tag, month, and hour per fold
    (reference prepare_data/009_plot_statistics.py:20-88)."""
    in_dir = ctx.dir("clean_merged_parametrized")
    out_dir = ctx.dir("statistics")
    date_tags: Dict[str, List[str]] = {}
    if tag_root and os.path.isdir(tag_root):
        for date in os.listdir(tag_root):
            tag_file = os.path.join(tag_root, date, "tags.csv")
            if os.path.exists(tag_file):
                loaded = load_csv(tag_file)
                date_tags[date] = loaded if isinstance(loaded, list) else list(loaded)

    for fold in ctx.folds:
        path = os.path.join(in_dir, f"{fold}.csv")
        if not os.path.exists(path):
            continue
        data = load_csv(path)
        per_date = Counter(data["date"])
        save_csv(dict(per_date), os.path.join(out_dir, f"images_per_date_{fold}.csv"))

        per_month = {m: 0 for m in range(1, 13)}
        per_hour = {h: 0 for h in range(24)}
        dates_per_month = {m: 0 for m in range(1, 13)}
        dates_per_hour = {h: 0 for h in range(24)}
        per_tag: Dict[str, int] = {}
        for date, count in per_date.items():
            month, hour = int(date[5:7]), int(date[11:13])
            per_month[month] += count
            per_hour[hour] += count
            dates_per_month[month] += 1
            dates_per_hour[hour] += 1
            for tag in date_tags.get(date, []):
                per_tag[tag] = per_tag.get(tag, 0) + count
        save_csv(per_month, os.path.join(out_dir, f"images_per_month_{fold}.csv"))
        save_csv(per_hour, os.path.join(out_dir, f"images_per_hour_{fold}.csv"))
        save_csv(dates_per_month, os.path.join(out_dir, f"dates_per_month_{fold}.csv"))
        save_csv(dates_per_hour, os.path.join(out_dir, f"dates_per_hour_{fold}.csv"))
        if per_tag:
            save_csv(per_tag, os.path.join(out_dir, f"images_per_tag_{fold}.csv"))
        if ctx.make_plots:
            dict_to_bar(per_month, os.path.join(out_dir, f"images_per_month_{fold}.pdf"))
            dict_to_bar(per_hour, os.path.join(out_dir, f"images_per_hour_{fold}.pdf"))


def scale_factor(
    features: np.ndarray,  # (N, D) embeddings
    xy: np.ndarray,  # (N, 2) positions
    positives: Sequence[Sequence[int]],  # per-index positive lists
    out_root: str,
    name: str = "scale_factor",
) -> Dict[str, float]:
    """Empirical distribution of squared feature vs squared metric distances
    among positive pairs — the justification for f_max_squared = 2.0
    (reference prepare_data/010_get_scale_factor.py:24-62 and
    train/train.py:695-696)."""
    f_dists: List[float] = []
    e_dists: List[float] = []
    for i in range(len(xy)):
        for j in positives[i]:
            if j < i:
                f_dists.append(float(np.sum((features[i] - features[j]) ** 2)))
                e_dists.append(float(np.sum((xy[i] - xy[j]) ** 2)))
    os.makedirs(out_root, exist_ok=True)
    save_pickle([e_dists, f_dists], os.path.join(out_root, f"{name}.pickle"))
    stats = {
        "f_mean": float(np.mean(f_dists)) if f_dists else 0.0,
        "e_mean": float(np.mean(e_dists)) if e_dists else 0.0,
        "f_med": float(np.median(f_dists)) if f_dists else 0.0,
        "e_med": float(np.median(e_dists)) if e_dists else 0.0,
        "f_max": float(np.max(f_dists)) if f_dists else 0.0,
        "e_max": float(np.max(e_dists)) if e_dists else 0.0,
    }
    save_csv(stats, os.path.join(out_root, f"{name}.csv"))
    return stats
