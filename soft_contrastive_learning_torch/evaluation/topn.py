"""Top-N retrieval evaluation with PCA whitening sweeps, the counterpart of
``soft_contrastive_learning_tpu/evaluation/topn.py`` (``spatial_subsample``,
``top_n_single``, ``get_top_n``): fit a whitening PCA on a held-out feature
dump, sweep descriptor dims D and reference spacings L, retrieve the top-N
references per query, and dump the pickle

    [top_i, top_g_dists, top_f_dists, gt_i, gt_g_dist, ref_idx]

with the JAX package's types (lists, then numpy arrays, then the ``ref_idx``
list), which both packages' ROC compilers read.

On the device: the PCA fit (``pca/whiten.py``), one transform of the ref
and query dumps at the largest D (the whitened columns nest, so each D is a
column slice of it), and retrieval. Up to ``_TILED_THRESHOLD`` refs that is
the dense ``ops/topk.py::topk_l2``; above it ``topk_l2_streamed``, which is
K2 on a CUDA device (the slices reach it contiguous through its wrapper).
The geographic distances stay on the host in float64, as in the JAX
package. With a mesh of more than one rank (``parallel/mesh.py``) the
subsample's refs are padded with rows of 1e9 to a multiple of the rank
count, as JAX pads them, each rank searches its own rows
(``ops/topk.py::topk_l2_sharded``: K2 on a card), and every rank gets the
whole result; each rank runs on the mesh's device.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from soft_contrastive_learning_torch.core.config import resolve_device
from soft_contrastive_learning_torch.ops.topk import topk_l2, topk_l2_sharded, topk_l2_streamed
from soft_contrastive_learning_torch.parallel.mesh import barrier
from soft_contrastive_learning_torch.pca.whiten import fit_pca, fp32_matmuls
from soft_contrastive_learning_torch.utils.io import save_pickle

# Above this many reference rows, retrieval streams the refs through K2
# instead of materializing the (Q, R) distance matrix.
_TILED_THRESHOLD = 200_000

DEFAULT_L = (0.0, 0.3, 1.0, 5.0)
DEFAULT_D = (64, 128, 256, 512, 1024, 2048, 4096)


def spatial_subsample(ref_xy: np.ndarray, spacing: float, strict: bool = False) -> List[int]:
    """Keep a reference whenever it is >= ``spacing`` (> with ``strict``)
    from the last kept one (sequential, not greedy coverage). Index 0 is
    kept once, also at spacing 0."""
    keep = [0]
    sp2 = spacing**2
    for i in range(1, len(ref_xy)):
        d2 = np.sum((ref_xy[i] - ref_xy[keep[-1]]) ** 2)
        if (d2 > sp2) if strict else (d2 >= sp2):
            keep.append(i)
    return keep


def _on_device(x, device) -> torch.Tensor:
    return torch.as_tensor(x).to(device, torch.float32)


def top_n_single(
    ref_features,  # (R, d) already-reduced features: an array or a tensor
    query_features,  # (Q, d)
    ref_xy: np.ndarray,
    query_xy: np.ndarray,
    spacing: float,
    n: int = 25,
    mesh=None,
    ref_idx: Optional[List[int]] = None,
    geo=None,  # optional precomputed (xy_d, gt_local) for this subsample
    device: Optional[str | torch.device] = None,
) -> Optional[list]:
    """One retrieval pass -> the 6-element pickle list, or None when the
    subsample holds fewer than ``n`` refs. Runs on ``device``: default the
    mesh's, else the features' own, and the card for arrays. ``mesh``: the
    search is sharded over its ranks (module docstring)."""
    if ref_idx is None:
        ref_idx = spatial_subsample(ref_xy, spacing)
    if len(ref_idx) < n:
        return None
    if device is None and mesh is not None:
        device = mesh.device
    if device is None:
        device = ref_features.device if torch.is_tensor(ref_features) else "cuda"
    device = resolve_device(device)
    refs = _on_device(ref_features, device)
    queries = _on_device(query_features, device)
    ref_idx_arr = np.asarray(ref_idx)
    if len(ref_idx_arr) != len(refs) or (ref_idx_arr != np.arange(len(refs))).any():
        refs = refs[torch.from_numpy(ref_idx_arr).to(device)]
    with fp32_matmuls():
        if mesh is not None and mesh.size > 1:
            pad = (-len(refs)) % mesh.size
            if pad:
                refs = torch.cat([refs, refs.new_full((pad, refs.shape[1]), 1e9)])
            top_f, top_i = topk_l2_sharded(queries, refs[mesh.rows(len(refs))], n, mesh)
        elif len(refs) > _TILED_THRESHOLD:
            top_f, top_i = topk_l2_streamed(queries, refs, n)
        else:
            top_f, top_i = topk_l2(queries, refs, n)
    top_f = top_f.cpu().numpy()
    top_i = top_i.cpu().numpy()

    # geographic distances of the retrievals and the ground-truth optimum;
    # the (Q, R') matrix depends only on the subsample (callers sweeping
    # dims pass it as geo=)
    if geo is None:
        sub_xy = np.asarray(ref_xy)[ref_idx_arr]
        xy_d = np.linalg.norm(query_xy[:, None, :] - sub_xy[None, :, :], axis=-1)
        gt_local = np.argmin(xy_d, axis=1)
    else:
        xy_d, gt_local = geo
    top_g = np.take_along_axis(xy_d, top_i, axis=1)
    gt_g = xy_d[np.arange(len(query_xy)), gt_local]
    return [
        ref_idx_arr[top_i].tolist(),
        top_g.tolist(),
        top_f,
        ref_idx_arr[gt_local].tolist(),
        gt_g,
        ref_idx,
    ]


def get_top_n(
    pca_features,
    ref_features,
    query_features,
    ref_xy: np.ndarray,
    query_xy: np.ndarray,
    out_root: str,
    name: str,
    n: int = 25,
    spacings: Sequence[float] = DEFAULT_L,
    dims: Sequence[int] = DEFAULT_D,
    mesh=None,
    skip_existing: bool = True,
    device: str | torch.device = "cuda",
) -> Dict[str, str]:
    """The D x L sweep -> {'l{l}_dim{d}': pickle_path}. One PCA fit at the
    largest usable D and one transform of each dump, column-sliced per D.
    ``mesh``: every rank fits and transforms on its device, each search is
    sharded over the ranks (``top_n_single``), and the primary (rank 0)
    writes the pickles; the settings to skip are read by every rank before
    any is written, so that all ranks run the same searches."""
    out_paths: Dict[str, str] = {}
    usable_dims = [d for d in dims if d <= min(pca_features.shape)]
    if not usable_dims:
        return out_paths
    device = mesh.device if mesh is not None else resolve_device(device)
    whitener = fit_pca(pca_features, max(usable_dims), device=device)
    ref_full = whitener.transform(ref_features)
    query_full = whitener.transform(query_features)
    ref_xy, query_xy = np.asarray(ref_xy), np.asarray(query_xy)
    # the subsample and the geographic distances depend only on the spacing
    subsample_cache = {spacing: spatial_subsample(ref_xy, spacing) for spacing in spacings}
    geo_cache = {}
    for spacing, idx in subsample_cache.items():
        xy_d = np.linalg.norm(query_xy[:, None, :] - ref_xy[idx][None, :, :], axis=-1)
        geo_cache[spacing] = (xy_d, np.argmin(xy_d, axis=1))

    def pickle_path(d, spacing):
        return os.path.join(out_root, f"l{spacing}_dim{d}", f"{name}.pickle")

    existing = {(d, s) for d in usable_dims for s in spacings
                if skip_existing and os.path.exists(pickle_path(d, s))}
    barrier(mesh)
    primary = mesh is None or mesh.rank == 0
    for d in usable_dims:
        for spacing in spacings:
            setting = f"l{spacing}_dim{d}"
            out_pickle = pickle_path(d, spacing)
            if (d, spacing) in existing:
                out_paths[setting] = out_pickle
                continue
            result = top_n_single(ref_full[:, :d], query_full[:, :d], ref_xy, query_xy, spacing,
                                  n=n, mesh=mesh, ref_idx=subsample_cache[spacing],
                                  geo=geo_cache[spacing])
            if result is None:
                continue
            if primary:
                os.makedirs(os.path.dirname(out_pickle), exist_ok=True)
                save_pickle(result, out_pickle)
            out_paths[setting] = out_pickle
    return out_paths
