"""Synthetic file corpora, written with the port's PNG writer
(``utils/io.py::save_img``) so that a host without OpenCV or PIL can make
them:

- ``write_prep_tree``: a source's sets as the prep pipeline's tree
  (``shuffled/``, ``anchors/``, ``clusters/`` and the images at
  ``{img_root}/{date}_stereo_centre_{folder:02d}/{t}.png``), what
  ``data/pipeline.py::FilesystemSource`` and ``train`` without
  ``--toy_city`` read;
- ``rehearsal_sets`` and ``write_image_set``: the paper-results rehearsal's
  three toy-city sets and their CSV lists (``path``, ``easting``,
  ``northing``, ``yaw``), what ``infer`` reads. Same geometry as
  ``perf/rehearsal_corpus.py``: a reference loop at 0.25 m pose spacing,
  queries on a loop 1.5 m outside it (the same texture world), and a PCA
  fit set in a city of its own; the sizes are the caller's.

Rendering a 180x240 view takes tens of milliseconds, so ``write_image_set``
renders on a pool of processes (spawned: safe beside a CUDA context).
"""

from __future__ import annotations

import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from typing import Dict, Iterable, List, Sequence

import numpy as np

from soft_contrastive_learning_torch.data.toycity import ToyCity
from soft_contrastive_learning_torch.utils.io import mkdir, save_csv, save_img

REF_SPACING = 0.25  # meters between adjacent reference poses
QUERY_OFFSET = 1.5  # radial meters between the query loop and the reference loop


def rehearsal_sets(n_ref: int = 3000, n_query: int = 300, n_pca: int = 4400,
                   img_h: int = 180, img_w: int = 240) -> Dict[str, ToyCity]:
    """``toy_ref``, ``toy_query`` and ``toy_pca`` at the given sizes."""
    ref_radius = n_ref * REF_SPACING / (2 * np.pi)
    return {
        "toy_ref": ToyCity(num_points=n_ref, radius=ref_radius, img_h=img_h, img_w=img_w,
                           seed=9, center=(1000.0, 2000.0)),
        "toy_query": ToyCity(num_points=n_query, radius=ref_radius + QUERY_OFFSET, img_h=img_h,
                             img_w=img_w, seed=9, center=(1000.0, 2000.0)),
        "toy_pca": ToyCity(num_points=n_pca, radius=n_pca * REF_SPACING / (2 * np.pi),
                           img_h=img_h, img_w=img_w, seed=11, center=(20000.0, 5000.0)),
    }


def _render(city: ToyCity, indices: Sequence[int], paths: Sequence[str]) -> int:
    for i, path in zip(indices, paths):
        save_img(city.image(i), path)
    return len(indices)


def write_image_set(city: ToyCity, name: str, img_root: str, csv_root: str,
                    workers: int = 8) -> List[str]:
    """Render every pose of ``city`` to ``{img_root}/{name}/{i:06d}.png`` on
    ``workers`` processes and write ``{csv_root}/{name}.csv``; returns the
    relative paths."""
    mkdir(os.path.join(img_root, name))
    mkdir(csv_root)
    rel = [f"{name}/{i:06d}.png" for i in range(len(city))]
    full = [os.path.join(img_root, p) for p in rel]
    chunks = [range(s, min(s + 64, len(city))) for s in range(0, len(city), 64)]
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=workers, mp_context=ctx) as ex:
        done = sum(ex.map(_render, [city] * len(chunks), [list(c) for c in chunks],
                          [full[c.start : c.stop] for c in chunks]))
    if done != len(city):
        raise RuntimeError(f"{name}: rendered {done} of {len(city)} images")
    save_csv({"path": rel, "easting": [f"{e}" for e in city.easting],
              "northing": [f"{x}" for x in city.northing],
              "yaw": [f"{y}" for y in city.yaw]},
             os.path.join(csv_root, f"{name}.csv"))
    return rel


def write_prep_tree(source, root: str, sets: Iterable[str], anchor_r: int = 1,
                    cluster_r: int = 5, max_anchors: int = 0) -> Dict[str, str]:
    """Write epoch 0 of ``source``'s (a ``ToyCitySource`` or anything with
    its four methods) ``sets`` under ``root`` as the prep pipeline's tree:
    for each set ``shuffled/{set}_000.csv``, ``anchors/{set}_{anchor_r}_000.csv``
    (the first ``max_anchors`` when it is > 0: a shorter epoch) and
    ``clusters/{set}_{cluster_r}.csv``, and every image the shuffled sets
    name, on 8 threads. Returns the four roots under ``FilesystemSource``'s
    argument names."""
    roots = {"img_root": os.path.join(root, "images"),
             "shuffled_root": os.path.join(root, "shuffled"),
             "anchor_root": os.path.join(root, "anchors"),
             "loc_ref_root": os.path.join(root, "clusters")}
    for d in roots.values():
        mkdir(d)
    keys = {}
    for set_name in sets:
        meta = source.epoch_meta(set_name, 0)
        save_csv(meta, os.path.join(roots["shuffled_root"], f"{set_name}_000.csv"))
        anchors = np.asarray(source.anchor_indices(set_name, anchor_r, 0), dtype=int)
        if max_anchors > 0:
            anchors = anchors[:max_anchors]
        save_csv({"idx": [int(i) for i in anchors]},
                 os.path.join(roots["anchor_root"], f"{set_name}_{anchor_r}_000.csv"))
        keys.update(dict.fromkeys(zip(meta["date"], meta["folder"], meta["t"])))
        save_csv(source.cluster_meta(set_name, cluster_r),
                 os.path.join(roots["loc_ref_root"], f"{set_name}_{cluster_r}.csv"))

    def write(key):
        date, folder, t = key
        img_dir = os.path.join(roots["img_root"], f"{date}_stereo_centre_{int(folder):02d}")
        mkdir(img_dir)
        save_img(source.load_image(key), os.path.join(img_dir, f"{t}.png"))

    with ThreadPoolExecutor(max_workers=8) as ex:
        list(ex.map(write, keys))
    return roots
