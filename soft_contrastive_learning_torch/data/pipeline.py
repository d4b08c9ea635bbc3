"""Host data pipeline: the toy-city source, image loading and batch
assembly. Own copy of ``soft_contrastive_learning_tpu/data/pipeline.py``
(``ToyCitySource``, ``load_images_standard``, ``assemble_batch``; loading
runs on the calling thread) and of ``parallel/mesh.py::pad_to_multiple``.
``FilesystemSource`` (the prep pipeline's CSV/PNG layout) comes with a
later slice.

A city rendered at the model's (height, width) needs no resize, so no
OpenCV; ``utils/cv.py`` raises where a resize would need it.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from soft_contrastive_learning_torch.core.config import TrainConfig
from soft_contrastive_learning_torch.data.toycity import ToyCity
from soft_contrastive_learning_torch.utils.cv import normalize_geometry

ImageKey = Tuple[str, str, str]  # (date, folder, t)


def pad_to_multiple(x: np.ndarray, multiple: int, axis: int = 0) -> np.ndarray:
    """Pad with repeats of row 0 so shape[axis] % multiple == 0, so every
    call runs at the one batch shape."""
    rem = (-x.shape[axis]) % multiple
    if rem == 0:
        return x
    pad = np.take(x, np.zeros(rem, dtype=int), axis=axis)
    return np.concatenate([x, pad], axis=axis)


class ToyCitySource:
    """In-memory source over two ToyCity regions (train/test), with
    deterministic per-epoch shuffles and r-spaced anchors."""

    def __init__(self, train_city: Optional[ToyCity] = None,
                 test_city: Optional[ToyCity] = None, seed: int = 42,
                 num_points: int = 240, img_h: int = 96, img_w: int = 128,
                 radius: float = 120.0):
        self.cities = {
            "train": train_city
            or ToyCity(num_points=num_points, radius=radius, seed=seed,
                       img_h=img_h, img_w=img_w, center=(1000.0, 2000.0)),
            "test": test_city
            or ToyCity(num_points=num_points, radius=radius, seed=seed + 1,
                       img_h=img_h, img_w=img_w, center=(9000.0, 9000.0),
                       date="2020-02-02-00-00-00"),
        }
        self.seed = seed

    def _city(self, set_name: str) -> ToyCity:
        return self.cities["test" if set_name.startswith("test") else "train"]

    def load_image(self, key: ImageKey) -> np.ndarray:
        for city in self.cities.values():
            if key[0] == city.date:
                return city.image_by_key(key)
        raise KeyError(key)

    def epoch_meta(self, set_name: str, epoch: int) -> Dict[str, List[str]]:
        city = self._city(set_name)
        meta = city.meta()
        order = np.random.default_rng(self.seed + 1000 * epoch).permutation(len(city))
        return {k: [v[i] for i in order] for k, v in meta.items()}

    def anchor_indices(self, set_name: str, r: int, epoch: int) -> np.ndarray:
        """Shuffled indices of one image per r-spaced point along the loop."""
        city = self._city(set_name)
        meta = self.epoch_meta(set_name, epoch)
        spacing = 2 * np.pi * city.radius / len(city)
        stride = max(int(round(max(r, 1) / max(spacing, 1e-9))), 1)
        selected = set(range(0, len(city), stride))
        rows = [row for row, orig in enumerate(np.asarray(meta["idx"], dtype=int))
                if orig in selected]
        rng = np.random.default_rng(self.seed + 7 * epoch)
        return rng.permutation(np.asarray(rows, dtype=int))

    def cluster_meta(self, set_name: str, r: int) -> Dict[str, List[str]]:
        """Every ``r``-th pose of the set's city, in loop order: the
        localization eval's reference set."""
        city = self._city(set_name)
        meta = city.meta()
        keep = list(range(0, len(city), max(int(r), 1)))
        return {k: [v[i] for i in keep] for k, v in meta.items()}


def load_images_standard(source, keys: Sequence[ImageKey], cfg: TrainConfig) -> np.ndarray:
    """Load and geometry-normalize images -> (B, H, W, 3) uint8 RGB, the
    (H, W) of ``cfg.model``. NetVLAD models keep aspect via a max-side
    resize; others scale and center-crop."""
    h, w = cfg.model.image_height, cfg.model.image_width
    keep_aspect = cfg.model.vlad_cores > 0

    def one(key):
        return normalize_geometry(source.load_image(key), h, w, keep_aspect=keep_aspect)

    # uint8 on the wire; the model's first op casts to its compute dtype
    return np.stack([one(k) for k in keys]).astype(np.uint8)


def assemble_batch(
    cfg: TrainConfig,
    source,
    meta: Dict[str, List[str]],
    indices: np.ndarray,  # (T, S) from the sampler
    payload: Dict[str, np.ndarray],
    epoch: int,
) -> Dict[str, np.ndarray]:
    keys = [(meta["date"][i], meta["folder"][i], meta["t"][i]) for i in indices.reshape(-1)]
    batch = {"images": load_images_standard(source, keys, cfg),
             "epoch": np.float32(epoch)}
    batch.update(payload)
    return batch
