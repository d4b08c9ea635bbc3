"""RobotCar metadata ETL stages 002-008 and 011-014. Own copy of
``soft_contrastive_learning_tpu/data/robotcar/prep.py``, without sklearn
and OpenCV:

* sklearn's ``KDTree`` becomes ``scipy.spatial.cKDTree`` for the 2-D
  radius queries (005, 014) and a sorted array for the 1-D nearest
  neighbours (002 in time, 011 along the geodesic): ``_radius_neighbors``
  and ``_nearest_1d``. Both return JAX's order where distances differ;
  among equal distances the lower index comes first, where sklearn's order
  follows its tree's layout (and, for sorted radius results, its
  quicksort). 014's unsorted radius query returns ascending indices, where
  sklearn returns tree order: ``rng.choice`` then draws other anchors
  (``tests/test_torch_robotcar_prep.py`` runs JAX's stages with a tree of
  this order to compare them).
* ``KMeans(n_clusters=2, random_state=0, n_init=10)`` on 005's 1-D
  candidate ``l`` values becomes ``_two_means_1d``, the exact 1-D 2-means
  (the best split of the sorted values), which is sklearn's partition
  wherever sklearn finds the optimum.
* ``cv2.imread(mask)`` becomes the port's PNG codec. cv2 reads BGR, so
  JAX's ``mask[..., 0]`` is the PNG's blue channel: the codec's channel 2.

Each function reproduces the filesystem contract of the corresponding
reference prepare_data script (cited per function) with vectorized numpy in
place of per-row Python loops. Known reference bugs are fixed and noted:

* 008 swapped its full_ref/full_query accumulators
  (prepare_data/008_clean_parametrization.py:74-75) — fixed here,
* 013 sorted timestamps lexicographically (safe only because RobotCar
  timestamps share a width) — sorted numerically here.
"""

from __future__ import annotations

import math
import os
from typing import Dict, List, Sequence

import numpy as np
from scipy.spatial import cKDTree

from soft_contrastive_learning_torch.data.robotcar.stages import PrepContext, Stage
from soft_contrastive_learning_torch.evaluation.topn import spatial_subsample
from soft_contrastive_learning_torch.utils.io import load_img, save_csv, save_pickle
from soft_contrastive_learning_torch.utils.io import load_table as load_csv
from soft_contrastive_learning_torch.utils.meta import get_xy


def _floats(meta: Dict, key: str) -> np.ndarray:
    return np.asarray(meta[key], dtype=float)


def _filter(meta: Dict, keep: np.ndarray) -> Dict:
    idx = np.flatnonzero(keep) if keep.dtype == bool else np.asarray(keep)
    return {k: [v[i] for i in idx] for k, v in meta.items()}


def _nearest_1d(data: np.ndarray, queries: np.ndarray, k: int):
    """(distances, indices), each (Q, k), of the ``k`` nearest ``data``
    values to each query, nearest first, the lower index first among equal
    distances (sklearn's ``KDTree(data[:, None]).query(queries[:, None], k)``
    but for that tie order). The k nearest of a sorted array lie within k
    places of the query's insertion point."""
    data = np.asarray(data, np.float64)
    queries = np.asarray(queries, np.float64)
    n = len(data)
    if n < k:
        raise ValueError(f"{k} nearest neighbours asked of {n} points")
    order = np.argsort(data, kind="stable")
    sorted_data = data[order]
    width = min(2 * k, n)
    start = np.clip(np.searchsorted(sorted_data, queries) - k, 0, n - width)
    cand = start[:, None] + np.arange(width)[None, :]
    dist = np.abs(sorted_data[cand] - queries[:, None])
    idx = order[cand]
    pick = np.lexsort((idx, dist), axis=-1)[:, :k]
    return np.take_along_axis(dist, pick, 1), np.take_along_axis(idx, pick, 1)


def _radius_neighbors(data: np.ndarray, queries: np.ndarray, r: float,
                      sort_results: bool = False):
    """Per query, the indices of ``data`` rows within ``r`` (Euclidean), and
    with ``sort_results`` their distances: ascending indices, or with
    ``sort_results`` nearest first, the lower index first among equal
    distances (sklearn's ``KDTree.query_radius`` but for that order)."""
    data = np.asarray(data, np.float64)
    hits = cKDTree(data).query_ball_point(np.asarray(queries, np.float64), r)
    idx = [np.asarray(sorted(h), dtype=np.int64) for h in hits]
    if not sort_results:
        return idx
    out_i, out_d = [], []
    for q, i in zip(np.asarray(queries, np.float64), idx):
        diff = data[i] - q
        d = np.sqrt(diff[:, 0] * diff[:, 0] + diff[:, 1] * diff[:, 1])
        o = np.lexsort((i, d))
        out_i.append(i[o])
        out_d.append(d[o])
    return out_i, out_d


def _two_means_1d(values: np.ndarray):
    """Exact 2-means of 1-D values: (labels, centres) of the split of the
    sorted values with the least within-cluster sum of squares, or None
    where they hold one distinct value (sklearn then finds one cluster
    twice, its centres equal)."""
    values = np.asarray(values, np.float64)
    order = np.argsort(values, kind="stable")
    v = values[order]
    n = len(v)
    splits = np.flatnonzero(v[1:] > v[:-1]) + 1  # never between equal values
    if len(splits) == 0:
        return None
    c1, c2 = np.cumsum(v), np.cumsum(v * v)
    left_n, right_n = splits, n - splits
    left_s, right_s = c1[splits - 1], c1[-1] - c1[splits - 1]
    left_q, right_q = c2[splits - 1], c2[-1] - c2[splits - 1]
    sse = (left_q - left_s**2 / left_n) + (right_q - right_s**2 / right_n)
    k = int(splits[np.argmin(sse)])
    labels = np.empty(n, np.int64)
    labels[order[:k]], labels[order[k:]] = 0, 1
    return labels, np.asarray([v[:k].mean(), v[k:].mean()])


def _lin_ip(x1, x2, d1, d2):
    """Inverse-distance 2-point interpolation (reference 002:18-19)."""
    return (x1 * d2 + x2 * d1) / (d1 + d2)


# ------------------------------------------------------------------ 002
def interpolate_image_xy(ctx: PrepContext, date: str) -> None:
    """Time-interpolate INS northing/easting/yaw to image timestamps
    (reference prepare_data/002_interpolate_image_xy.py:22-87)."""
    out_file = os.path.join(ctx.dir("xy"), f"{date}.csv")
    if os.path.exists(out_file):
        return
    imgs_file = os.path.join(ctx.dir(f"img_info_{ctx.max_side}"), f"{date}.csv")
    if not os.path.exists(imgs_file):
        return
    imgs = load_csv(imgs_file)
    ins = load_csv(os.path.join(ctx.ins_root, date, "gps", "ins.csv"))

    ins_ts = np.asarray(ins["timestamp"], dtype=np.int64).reshape(-1, 1)
    img_ts = np.asarray(imgs["t"], dtype=np.int64).reshape(-1, 1)
    northing = _floats(ins, "northing")
    easting = _floats(ins, "easting")
    yaw = _floats(ins, "yaw")
    status = np.asarray(ins["ins_status"])

    d2, i2 = _nearest_1d(ins_ts[:, 0], img_ts[:, 0], 2)  # two nearest INS samples in time
    w = d2[:, ::-1] / np.maximum(d2.sum(axis=1, keepdims=True), 1e-12)
    # matches _lin_ip: weight of sample k is the OTHER sample's time gap
    imgs["northing"] = (northing[i2] * w).sum(axis=1).tolist()
    imgs["easting"] = (easting[i2] * w).sum(axis=1).tolist()
    # Shortest-arc yaw interpolation. The reference lin_ip blends raw yaw
    # values (prepare_data/002_interpolate_image_xy.py:18-19), which averages
    # ACROSS the 0/2pi seam (6.27 and 0.01 blend to ~pi, i.e. backwards);
    # fixed like the other latent seam bugs (PARITY.md).
    y0, y1 = yaw[i2[:, 0]], yaw[i2[:, 1]]
    arc = ((y1 - y0 + math.pi) % (2 * math.pi)) - math.pi
    imgs["yaw"] = ((y0 + w[:, 1] * arc) % (2 * math.pi)).tolist()
    good = (status[i2[:, 0]] == "INS_SOLUTION_GOOD") & (
        status[i2[:, 1]] == "INS_SOLUTION_GOOD"
    )
    imgs["ins_good"] = good.astype(int).tolist()
    imgs["ic1"] = i2[:, 0].tolist()
    imgs["ic2"] = i2[:, 1].tolist()
    imgs["tn1"] = ins_ts[i2[:, 0], 0].tolist()
    imgs["tn2"] = ins_ts[i2[:, 1], 0].tolist()
    save_csv(imgs, out_file)


# ------------------------------------------------------------------ 003
GRID_ORIGIN_E = 619500.0
GRID_ORIGIN_N = 5736480.0
GRID_SHAPE = (1800, 1200)  # (reference prepare_data/003_split_images.py:19-30)


def xy_to_grid(easting: np.ndarray, northing: np.ndarray):
    """World coords -> integer 1 m grid cells anchored at the Oxford origin."""
    e = np.nan_to_num(easting)
    n = np.nan_to_num(northing)
    x = (e - GRID_ORIGIN_E).astype(int)
    y = (GRID_ORIGIN_N - n).astype(int)
    return x, y


def assign_splits(ctx: PrepContext, date: str) -> None:
    """Assign train/test/val/full membership from painted grid masks
    (reference prepare_data/003_split_images.py:33-90)."""
    out_file = os.path.join(ctx.dir("splits"), f"{date}.csv")
    if os.path.exists(out_file):
        return
    xy_file = os.path.join(ctx.dir("xy"), f"{date}.csv")
    if not os.path.exists(xy_file):
        return
    meta = load_csv(xy_file)
    x, y = xy_to_grid(_floats(meta, "easting"), _floats(meta, "northing"))

    for fold, mask_path in ctx.grid_masks.items():
        mask = load_img(mask_path)  # RGB: JAX's BGR channel 0 is channel 2 here
        h, w = mask.shape[0], mask.shape[1]
        inside = (x >= 0) & (y >= 0) & (x < w) & (y < h)
        member = np.zeros(len(x), dtype=int)
        member[inside] = (mask[y[inside], x[inside], 2] > 0).astype(int)
        meta[fold] = member.tolist()

    overlap = sum(np.asarray(meta[f], int) for f in ("train", "test", "val"))
    assert overlap.max() <= 1, "split masks overlap; increase mask separation"
    save_csv(meta, out_file)


# ------------------------------------------------------------------ 004
MERGE_COLS = ("easting", "northing", "folder", "t", "yaw", "date")


def merge_and_clean(ctx: PrepContext) -> None:
    """Concat all dates, drop bad-INS / off-grid / exposure-outlier /
    blacklisted-date rows, write clean_{fold}.csv
    (reference prepare_data/004_merge_and_clean.py:24-117)."""
    split_dir = ctx.dir("splits")
    out_dir = ctx.dir("merged")
    dates = sorted(
        f[:-4] for f in os.listdir(split_dir) if f.endswith(".csv")
    )
    merged: Dict[str, List] = {}
    for date in dates:
        meta = load_csv(os.path.join(split_dir, f"{date}.csv"))
        meta["date"] = [date] * len(meta["t"])
        for k, v in meta.items():
            merged.setdefault(k, []).extend(v)
    save_csv(merged, os.path.join(out_dir, "merged.csv"))

    exposures = _floats(merged, "exposure")
    lo, hi = np.percentile(exposures, 1), np.percentile(exposures, 99)
    valid = (
        (np.asarray(merged["ins_good"], int) == 1)
        & (np.asarray(merged["full"], int) == 1)
        & (exposures > lo)
        & (exposures < hi)
        & ~np.isin(np.asarray(merged["date"]), np.asarray(ctx.bad_dates))
    )
    stats = {
        "total_imgs": len(exposures),
        "valid_ins": int(np.sum(np.asarray(merged["ins_good"], int))),
        "valid_grid": int(np.sum(np.asarray(merged["full"], int))),
        "fully_valid": int(valid.sum()),
    }
    for fold in list(ctx.folds) + ["full"]:
        keep = valid & (np.asarray(merged[fold], int) == 1)
        stats[f"valid_{fold}"] = int(keep.sum())
        out = {c: [v for v, k in zip(merged[c], keep) if k] for c in MERGE_COLS}
        save_csv(out, os.path.join(out_dir, f"clean_{fold}.csv"))
    save_csv(stats, os.path.join(out_dir, "meta.csv"))


# ------------------------------------------------------------------ 005
def _arclength(xy: np.ndarray) -> np.ndarray:
    steps = np.linalg.norm(np.diff(xy, axis=0), axis=1)
    return np.concatenate([[0.0], np.cumsum(steps)])


def create_geodesic_reference(ctx: PrepContext, fold: str) -> None:
    """Cumulative-arclength parametrization of the fold's reference date
    (reference prepare_data/005_parametrize_path.py:28-51)."""
    date = ctx.ref_dates[fold]
    out_file = os.path.join(ctx.dir("parametrized"), f"{fold}_{date}_geodesic.csv")
    if os.path.exists(out_file):
        return
    data = load_csv(os.path.join(ctx.dir("merged"), f"clean_{fold}.csv"))
    ref = _filter(data, np.asarray(data["date"]) == date)
    xy = get_xy(ref)
    ref["l"] = _arclength(xy).tolist()
    save_csv(ref, out_file)


def parametrize_date(
    ctx: PrepContext, fold: str, date: str, continuity: float = 500.0
) -> None:
    """Match one traversal onto the fold's geodesic reference
    (reference prepare_data/005_parametrize_path.py:54-142): radius+yaw-gated
    2-NN interpolation of l with a KMeans(2) start disambiguation and a
    continuity constraint against the expected progress."""
    out_dir = ctx.dir("parametrized")
    out_file = os.path.join(out_dir, f"{fold}_{date}_geodesic.csv")
    if os.path.exists(out_file):
        return
    ref_date = ctx.ref_dates[fold]
    ref = load_csv(os.path.join(out_dir, f"{fold}_{ref_date}_geodesic.csv"))
    data = load_csv(os.path.join(ctx.dir("merged"), f"clean_{fold}.csv"))
    day = _filter(data, np.asarray(data["date"]) == date)
    if not day or len(day.get("t", [])) == 0:
        return

    ref_xy = get_xy(ref)
    ref_l = _floats(ref, "l")
    ref_yaw = _floats(ref, "yaw")
    day_xy = get_xy(day)
    day_yaw = _floats(day, "yaw")
    day_l = _arclength(day_xy)

    neigh_i, neigh_d = _radius_neighbors(ref_xy, day_xy, 100.0, sort_results=True)

    start_threshold = 5.0 if fold == "val" else 40.0
    matched: List[int] = []
    matched_l: List[float] = []
    current_l = 0.0
    latest_valid = 0
    for j in range(len(day_yaw)):
        ni, nd = neigh_i[j], neigh_d[j]
        if len(ni) < 2:
            continue
        # circular difference (the reference's |a-b| % 2pi form is not;
        # same latent seam bug as the sampler's yaw gate, PARITY.md)
        yd = np.abs(day_yaw[j] - ref_yaw[ni]) % (2 * math.pi)
        yaw_ok = np.minimum(yd, 2 * math.pi - yd) < math.pi / 3
        ni, nd = ni[yaw_ok], nd[yaw_ok]
        if len(ni) < 2:
            continue
        cand_l = ref_l[ni]
        if j == 0:
            km = _two_means_1d(cand_l)
            if km is not None and abs(km[1][0] - km[1][1]) > start_threshold:
                closest = int(np.argmin(np.abs(km[1] - current_l)))
                keep = km[0] == closest
            else:
                keep = np.ones(len(ni), bool)
        else:
            expected = current_l + (day_l[j] - day_l[latest_valid])
            keep = np.abs(expected - cand_l) < continuity
        ni, nd = ni[keep], nd[keep]
        if len(ni) < 2:
            continue
        current_l = _lin_ip(ref_l[ni[0]], ref_l[ni[1]], nd[0], nd[1])
        latest_valid = j
        matched.append(j)
        matched_l.append(float(current_l))

    if not matched:
        return
    out = _filter(day, np.asarray(matched))
    out["l"] = matched_l
    save_csv(out, out_file)


# ------------------------------------------------------------------ 006
PARAM_COLS = ("easting", "northing", "folder", "t", "yaw", "date", "l")


def merge_parametrized(ctx: PrepContext, min_rows: int = 100) -> None:
    """Concat per-date geodesic CSVs per fold, dropping dates with fewer than
    ``min_rows`` aligned rows (reference prepare_data/006_merge_parametrized.py:8-41)."""
    in_dir = ctx.dir("parametrized")
    out_dir = ctx.dir("merged_parametrized")
    full: Dict[str, List] = {c: [] for c in PARAM_COLS}
    counts = {}
    for fold in ctx.folds:
        data: Dict[str, List] = {c: [] for c in PARAM_COLS}
        for fname in sorted(os.listdir(in_dir)):
            if not fname.endswith(".csv") or fname.split("_")[0] != fold:
                continue
            date_data = load_csv(os.path.join(in_dir, fname))
            if len(date_data["t"]) < min_rows:
                continue
            for c in PARAM_COLS:
                data[c].extend(date_data[c])
                full[c].extend(date_data[c])
        save_csv(data, os.path.join(out_dir, f"{fold}.csv"))
        counts[fold] = len(data["t"])
    save_csv(full, os.path.join(out_dir, "full.csv"))
    counts["full"] = len(full["t"])
    save_csv(counts, os.path.join(out_dir, "meta.csv"))


# ------------------------------------------------------------------ 007
def set_aside_queries(ctx: PrepContext) -> None:
    """Split each fold into {fold}_ref / {fold}_query by held-out query dates
    (reference prepare_data/007_set_aside_queries.py:8-29)."""
    root = ctx.dir("merged_parametrized")
    counts = {}
    for fold in list(ctx.folds) + ["full"]:
        path = os.path.join(root, f"{fold}.csv")
        if not os.path.exists(path):
            continue
        data = load_csv(path)
        is_query = np.isin(np.asarray(data["date"]), np.asarray(ctx.query_dates))
        save_csv(_filter(data, is_query), os.path.join(root, f"{fold}_query.csv"))
        save_csv(_filter(data, ~is_query), os.path.join(root, f"{fold}_ref.csv"))
        counts[f"{fold}_query"] = int(is_query.sum())
        counts[f"{fold}_ref"] = int((~is_query).sum())
    save_csv(counts, os.path.join(root, "num_per_fold.csv"))


# ------------------------------------------------------------------ 008
def clean_parametrization(ctx: PrepContext, max_error: float = 5.0) -> None:
    """Remove alternate-route rows: bin references by floor(l), take the
    median xy per bin, drop rows farther than ``max_error`` from their bin
    median (reference prepare_data/008_clean_parametrization.py:15-111).
    The reference's swapped full_ref/full_query accumulators are fixed."""
    in_dir = ctx.dir("merged_parametrized")
    out_dir = ctx.dir("clean_merged_parametrized")
    full: Dict[str, List] = {}
    full_ref: Dict[str, List] = {}
    full_query: Dict[str, List] = {}
    meta = {}

    def bin_medians(ref_data) -> np.ndarray:
        l = _floats(ref_data, "l")
        xy = get_xy(ref_data)
        num_bins = math.ceil(l.max()) if len(l) else 0
        bins = np.floor(l).astype(int)
        medians = np.full((max(num_bins, 1) + 1, 2), -1.0)
        for b in np.unique(bins):
            medians[b] = np.median(xy[bins == b], axis=0)
        return medians

    def clean(data, medians):
        l = np.floor(_floats(data, "l")).astype(int)
        l = np.clip(l, 0, len(medians) - 1)
        err = np.linalg.norm(get_xy(data) - medians[l], axis=1)
        return _filter(data, err < max_error), err

    for fold in ctx.folds:
        ref_data = load_csv(os.path.join(in_dir, f"{fold}_ref.csv"))
        query_data = load_csv(os.path.join(in_dir, f"{fold}_query.csv"))
        if len(ref_data.get("t", [])) == 0:
            for suffix in ("_ref", "_query", ""):
                save_csv(ref_data, os.path.join(out_dir, f"{fold}{suffix}.csv"))
            meta[f"{fold}_ref"] = 0
            meta[f"{fold}_query"] = 0
            continue
        medians = bin_medians(ref_data)
        clean_ref, ref_err = clean(ref_data, medians)
        if len(query_data.get("t", [])) > 0:
            clean_query, _ = clean(query_data, medians)
        else:
            clean_query = {k: [] for k in clean_ref}
        save_csv(clean_ref, os.path.join(out_dir, f"{fold}_ref.csv"))
        save_csv(clean_query, os.path.join(out_dir, f"{fold}_query.csv"))
        combined = {
            k: list(clean_ref[k]) + list(clean_query[k]) for k in clean_ref
        }
        save_csv(combined, os.path.join(out_dir, f"{fold}.csv"))
        for k in combined:
            full.setdefault(k, []).extend(combined[k])
            full_ref.setdefault(k, []).extend(clean_ref[k])
            full_query.setdefault(k, []).extend(clean_query[k])
        meta[f"{fold}_ref"] = len(clean_ref["t"])
        meta[f"{fold}_query"] = len(clean_query["t"])
    save_csv(full, os.path.join(out_dir, "full.csv"))
    save_csv(full_ref, os.path.join(out_dir, "full_ref.csv"))
    save_csv(full_query, os.path.join(out_dir, "full_query.csv"))
    save_csv(meta, os.path.join(out_dir, "meta.csv"))


# ------------------------------------------------------------------ 011
def fix_localization_refs(ctx: PrepContext, fold: str, r: float) -> None:
    """Fixed eval reference set: the image nearest (in l) to every r-spaced
    point along the geodesic (reference prepare_data/011_fix_localization_ref.py:22-54)."""
    out_dir = ctx.dir("localization_references")
    out_csv = os.path.join(out_dir, f"{fold}_ref_l_{int(r)}.csv")
    if os.path.exists(out_csv):
        return
    meta = load_csv(
        os.path.join(ctx.dir("clean_merged_parametrized"), f"{fold}_ref.csv")
    )
    if len(meta.get("t", [])) == 0:
        save_csv(meta, out_csv)  # fold dropped upstream: empty artifact
        return
    l = _floats(meta, "l").reshape(-1, 1)
    # max(l), not l[-1]: the concatenated multi-date CSV's last row is the
    # lexicographically-last date's final match, which can end well before
    # the route does (the reference's l[-1] silently truncates the eval
    # reference grid in that case, prepare_data/011:30).
    grid = np.arange(0, math.floor(float(l.max())), step=r).reshape(-1, 1)
    idx = _nearest_1d(l[:, 0], grid[:, 0], 1)[1][:, 0]
    save_csv(_filter(meta, idx), out_csv)


# ------------------------------------------------------------------ 012
def shuffle_epochs(ctx: PrepContext, seed: int = 42) -> None:
    """Per-epoch pre-shuffled CSV copies {set}_{mode}_{epoch:03d}.csv so every
    loss variant sees identical data order (reference prepare_data/012_shuffle.py:10-23).
    Deterministic via the seed (the reference relied on ambient np.random state)."""
    in_dir = ctx.dir("clean_merged_parametrized")
    out_dir = ctx.dir("shuffled")
    rng = np.random.default_rng(seed)
    for mode in ("ref", "query"):
        for fold in ctx.folds:
            meta = load_csv(os.path.join(in_dir, f"{fold}_{mode}.csv"))
            n = len(meta["t"])
            for epoch in range(ctx.max_epochs):
                out_file = os.path.join(
                    out_dir, f"{fold}_{mode}_{epoch:03d}.csv"
                )
                if os.path.exists(out_file):
                    continue
                save_csv(_filter(meta, rng.permutation(n)), out_file)


# ------------------------------------------------------------------ 013
def cluster_linear(ctx: PrepContext, fold: str, mode: str = "ref") -> None:
    """r-spaced subsample along the reference-date traversal -> eval ref set
    (reference prepare_data/013_cluster_linear.py:18-68). Timestamps sorted
    numerically (the reference sorted them as strings)."""
    r = ctx.cluster_r
    out_dir = ctx.dir("clusters")
    out_csv = os.path.join(out_dir, f"{fold}_{mode}_{r}.csv")
    if os.path.exists(out_csv):
        return
    meta = load_csv(
        os.path.join(ctx.dir("shuffled"), f"{fold}_{mode}_000.csv")
    )
    date = ctx.ref_dates[fold]
    if len(meta.get("t", [])) == 0:
        save_csv(meta, out_csv)
        return
    day = _filter(meta, np.asarray(meta["date"]) == date)
    order = np.argsort(np.asarray(day["t"], dtype=np.int64))
    day = _filter(day, order)
    xy = get_xy(day)
    keep = spatial_subsample(xy, r, strict=True)  # 013 uses '>' (see helper)
    out = _filter(day, np.asarray(keep))
    save_csv(out, out_csv)
    save_pickle([xy[keep], day, keep], os.path.join(out_dir, f"{fold}_{mode}_{r}.pickle"))


# ------------------------------------------------------------------ 014
def presample_anchors(ctx: PrepContext, fold: str, mode: str = "ref",
                      seed: int = 42) -> None:
    """Per-epoch anchor index lists: one random shuffled-set image within 1 m
    of each cluster center, shuffled (reference prepare_data/014_presample_anchors.py:17-48)."""
    out_dir = ctx.dir("anchors")
    r = ctx.train_ref_r
    rng = np.random.default_rng(seed)
    cluster_meta = load_csv(
        os.path.join(ctx.dir("clusters"), f"{fold}_{mode}_{ctx.cluster_r}.csv")
    )
    if len(cluster_meta.get("t", [])) == 0:
        for epoch in range(ctx.max_epochs):
            save_csv({"idx": []}, os.path.join(out_dir, f"{fold}_{mode}_{r}_{epoch:03d}.csv"))
        return
    ref_xy = get_xy(cluster_meta)
    for epoch in range(ctx.max_epochs):
        out_file = os.path.join(out_dir, f"{fold}_{mode}_{r}_{epoch:03d}.csv")
        if os.path.exists(out_file):
            continue
        shuffled = load_csv(
            os.path.join(ctx.dir("shuffled"), f"{fold}_{mode}_{epoch:03d}.csv")
        )
        neighbors = _radius_neighbors(get_xy(shuffled), ref_xy, 1.0)
        anchors = [int(rng.choice(cands)) for cands in neighbors if len(cands)]
        rng.shuffle(anchors)
        save_csv({"idx": anchors}, out_file)


# ------------------------------------------------------------------ pipeline
def _dates_with_xy(ctx: PrepContext) -> List[str]:
    d = ctx.dir("xy")
    return sorted(f[:-4] for f in os.listdir(d) if f.endswith(".csv"))


def metadata_stages(ctx: PrepContext) -> List[Stage]:
    """Stages 004-014 (the pure-CSV part; 001-003 need raw inputs and run
    per-date via interpolate_image_xy / assign_splits)."""

    def out(name, files):
        return lambda c: [os.path.join(c.dir(name), f) for f in files]

    stages = [
        Stage("004_merge_and_clean", merge_and_clean,
              out("merged", [f"clean_{f}.csv" for f in list(ctx.folds) + ["full"]])),
        Stage(
            "005_parametrize",
            lambda c: _run_parametrize(c),
            lambda c: [
                os.path.join(
                    c.dir("parametrized"),
                    f"{f}_{c.ref_dates[f]}_geodesic.csv",
                )
                for f in c.folds
            ],
        ),
        Stage("006_merge_parametrized", merge_parametrized,
              out("merged_parametrized", [f"{f}.csv" for f in ctx.folds])),
        Stage("007_set_aside_queries", set_aside_queries,
              out("merged_parametrized",
                  [f"{f}_{m}.csv" for f in ctx.folds for m in ("ref", "query")])),
        Stage("008_clean_parametrization", clean_parametrization,
              out("clean_merged_parametrized", [f"{f}_ref.csv" for f in ctx.folds])),
        Stage(
            "011_fix_localization_refs",
            lambda c: [fix_localization_refs(c, f, c.eval_ref_r) for f in c.folds],
            lambda c: [
                os.path.join(
                    c.dir("localization_references"),
                    f"{f}_ref_l_{int(c.eval_ref_r)}.csv",
                )
                for f in c.folds
            ],
        ),
        Stage("012_shuffle", shuffle_epochs,
              lambda c: [
                  os.path.join(c.dir("shuffled"), f"{f}_{m}_{e:03d}.csv")
                  for f in c.folds for m in ("ref", "query")
                  for e in range(c.max_epochs)
              ]),
        Stage(
            "013_cluster_linear",
            lambda c: [cluster_linear(c, f) for f in c.folds],
            lambda c: [
                os.path.join(c.dir("clusters"), f"{f}_ref_{c.cluster_r}.csv")
                for f in c.folds
            ],
        ),
        Stage(
            "014_presample_anchors",
            lambda c: [presample_anchors(c, f) for f in c.folds],
            lambda c: [
                os.path.join(
                    c.dir("anchors"), f"{f}_ref_{c.train_ref_r}_{e:03d}.csv"
                )
                for f in c.folds for e in range(c.max_epochs)
            ],
        ),
    ]
    return stages


def _run_parametrize(ctx: PrepContext) -> None:
    for fold in ctx.folds:
        create_geodesic_reference(ctx, fold)
        data = load_csv(os.path.join(ctx.dir("merged"), f"clean_{fold}.csv"))
        for date in sorted(set(data["date"])):
            # Two val-area dates drive the wrong direction (reference
            # prepare_data/005_parametrize_path.py:224).
            if fold == "val" and date in (
                "2014-05-14-13-59-05", "2014-05-14-13-53-47"
            ):
                continue
            if date != ctx.ref_dates[fold]:
                parametrize_date(ctx, fold, date)
