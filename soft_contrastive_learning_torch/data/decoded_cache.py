"""Decoded-uint8 image cache: decode and geometry-normalize once, memmap
after. Own copy of ``soft_contrastive_learning_tpu/data/decoded_cache.py``
(the port imports nothing of the JAX package), with the same file layout, so
that a cache written by either package is read by the other.

Why it exists: the trainer hides each step's image decode behind the card's
work with a thread pool (``data/pipeline.py``). That works only while the
host decodes a batch faster than the card trains on one; the port's PNG
decoder holds the GIL, so 8 threads decode ~1,400 images a second, and a
host-fed step of 50 images waits on it. This module moves the decode off
the hot path: a prep stage (``cli cache``) writes every image of a set,
already geometry-normalized to the model's input
(``utils/cv.py::normalize_geometry``; the source decodes each file, PNG or
JPEG, a JPEG on its ``device``), into a flat uint8 memmap keyed by the
image key; a batch is then assembled by copies
(``CachedDecodedSource.load_images_normalized``, which
``data/pipeline.py::load_images_standard`` takes where a source has it).

Layout under ``cache_dir``::

    decoded_{H}x{W}_{aspect|crop}.u8    raw (N, H, W, 3) uint8, C-order
    decoded_{H}x{W}_{aspect|crop}.json  {"h","w","keep_aspect","keys":[...]}

Stages are idempotent: a sidecar that covers the requested keys already
leaves the cache alone; more keys grow it by their union. The sidecar is
written last, so a crash leaves no torn cache.
"""

from __future__ import annotations

import json
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from soft_contrastive_learning_torch.utils.cv import normalize_geometry

ImageKey = Tuple[str, str, str]  # (date, folder, t)

_SEP = "␟"  # unit-separator, never appears in dates/timestamps


def _key_str(key: ImageKey) -> str:
    return _SEP.join(str(part) for part in key)


def _cache_name(h: int, w: int, keep_aspect: bool) -> str:
    return f"decoded_{h}x{w}_{'aspect' if keep_aspect else 'crop'}"


def _sidecar_path(cache_dir: str, h: int, w: int, keep_aspect: bool) -> str:
    return os.path.join(cache_dir, _cache_name(h, w, keep_aspect) + ".json")


def _data_path(cache_dir: str, h: int, w: int, keep_aspect: bool) -> str:
    return os.path.join(cache_dir, _cache_name(h, w, keep_aspect) + ".u8")


def build_decoded_cache(
    source,
    keys: Sequence[ImageKey],
    h: int,
    w: int,
    keep_aspect: bool,
    cache_dir: str,
    num_workers: int = 8,
    log=print,
) -> str:
    """Write (or extend) the decoded cache for ``keys``; returns the sidecar
    path. Idempotent: an existing cache already covering every requested key
    is left untouched; otherwise it is rebuilt with the union of keys."""
    os.makedirs(cache_dir, exist_ok=True)
    side = _sidecar_path(cache_dir, h, w, keep_aspect)
    data = _data_path(cache_dir, h, w, keep_aspect)

    wanted: List[ImageKey] = []
    seen = set()
    for k in keys:
        ks = _key_str(k)
        if ks not in seen:
            seen.add(ks)
            wanted.append(k)

    old_keys: List[str] = []
    if os.path.exists(side) and os.path.exists(data):
        with open(side) as f:
            meta = json.load(f)
        if meta["h"] == h and meta["w"] == w and meta["keep_aspect"] == keep_aspect:
            old_keys = meta["keys"]
            if seen <= set(old_keys):
                log(f"decoded cache up to date: {side} ({len(old_keys)} images)")
                return side

    # union: keep old rows, append the new ones
    old_set = set(old_keys)
    new_keys = [k for k in wanted if _key_str(k) not in old_set]
    n_old, n_new = len(old_keys), len(new_keys)
    total = n_old + n_new
    if total == 0:
        # an empty key set on a fresh dir: np.memmap refuses a zero-size
        # mapping, so the stage does nothing (readers see no cache and
        # fall back to the decode path)
        log("decoded cache: no keys requested and no existing cache")
        return side
    row_bytes = h * w * 3
    log(f"decoded cache: {n_old} cached, {n_new} to decode -> {data}")

    if n_old:
        with open(data, "r+b") as f:  # grow in place; old rows stay valid
            f.truncate(total * row_bytes)
        mm = np.memmap(data, dtype=np.uint8, mode="r+", shape=(total, h, w, 3))
    else:
        mm = np.memmap(data, dtype=np.uint8, mode="w+", shape=(total, h, w, 3))

    def decode(i_key):
        i, key = i_key
        img = normalize_geometry(source.load_image(key), h, w, keep_aspect)
        mm[n_old + i] = img.astype(np.uint8)

    with ThreadPoolExecutor(max_workers=num_workers) as pool:
        list(pool.map(decode, enumerate(new_keys)))
    mm.flush()
    del mm

    all_keys = old_keys + [_key_str(k) for k in new_keys]
    tmp = side + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"h": h, "w": w, "keep_aspect": keep_aspect, "keys": all_keys}, f)
    os.replace(tmp, side)  # sidecar lands last: a crash leaves no torn cache
    log(f"decoded cache written: {total} images, {total * row_bytes / 1e6:.1f} MB")
    return side


class _OpenCache:
    def __init__(self, cache_dir: str, h: int, w: int, keep_aspect: bool):
        side = _sidecar_path(cache_dir, h, w, keep_aspect)
        with open(side) as f:
            meta = json.load(f)
        self.h, self.w = meta["h"], meta["w"]
        self.keep_aspect = meta["keep_aspect"]
        self.index: Dict[str, int] = {k: i for i, k in enumerate(meta["keys"])}
        self.data = np.memmap(
            _data_path(cache_dir, h, w, keep_aspect), dtype=np.uint8, mode="r",
            shape=(len(self.index), self.h, self.w, 3),
        )


class CachedDecodedSource:
    """Source wrapper serving geometry-normalized uint8 batches straight from
    the memmap; everything else (meta CSVs, anchors, single-image loads for
    plots) delegates to the wrapped source."""

    def __init__(self, inner, cache_dir: str):
        self._inner = inner
        self._cache_dir = cache_dir
        self._open: Dict[Tuple[int, int, bool], Optional[_OpenCache]] = {}

    def _cache_for(self, h: int, w: int, keep_aspect: bool) -> Optional[_OpenCache]:
        geom = (h, w, keep_aspect)
        if geom not in self._open:
            try:
                self._open[geom] = _OpenCache(self._cache_dir, h, w, keep_aspect)
            except FileNotFoundError:
                self._open[geom] = None
        return self._open[geom]

    def load_images_normalized(
        self, keys: Sequence[ImageKey], h: int, w: int, keep_aspect: bool
    ) -> Optional[np.ndarray]:
        """(B, h, w, 3) uint8 batch, or None when no cache exists for this
        geometry OR no key of this batch is cached (callers fall back to
        the thread-pooled decode path: without the all-miss bail-out, an
        uncached set, e.g. the eval query sets when only train_ref/test_ref
        were cached, would decode serially here and lose the pool's
        parallelism). Partially-missing keys are decoded individually."""
        cache = self._cache_for(h, w, keep_aspect)
        if cache is None:
            return None
        rows = [cache.index.get(_key_str(key)) for key in keys]
        if keys and all(r is None for r in rows):
            return None
        out = np.empty((len(keys), h, w, 3), np.uint8)
        for i, (key, row) in enumerate(zip(keys, rows)):
            if row is None:
                out[i] = normalize_geometry(
                    self._inner.load_image(key), h, w, keep_aspect
                ).astype(np.uint8)
            else:
                out[i] = cache.data[row]
        return out

    def __getattr__(self, name):
        return getattr(self._inner, name)


def cache_training_sets(
    source,
    set_names: Iterable[str],
    h: int,
    w: int,
    keep_aspect: bool,
    cache_dir: str,
    cluster_sets: Iterable[Tuple[str, int]] = (),
    num_workers: int = 8,
    log=print,
) -> str:
    """Prep-stage entry: cache the union of every image key the training loop
    can touch: each set's image list (epoch 0's meta; later epochs are
    permutations of the same keys) and the cluster eval reference sets."""
    keys: List[ImageKey] = []
    for set_name in set_names:
        meta = source.epoch_meta(set_name, 0)
        keys.extend(zip(meta["date"], meta["folder"], meta["t"]))
    for set_name, r in cluster_sets:
        meta = source.cluster_meta(set_name, r)
        keys.extend(zip(meta["date"], meta["folder"], meta["t"]))
    return build_decoded_cache(
        source, keys, h, w, keep_aspect, cache_dir, num_workers, log
    )
