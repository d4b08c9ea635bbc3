"""Device-resident image pool, the counterpart of
``soft_contrastive_learning_tpu/data/device_pool.py``: the epoch set's
decoded uint8 images live on the card, and the train step gathers its batch
by row index (``index_select``), so per-step host-to-device traffic is the
(B,) indices and the (B, B) geo payload. Keyed by image key, so each
epoch's shuffled meta maps onto the pool with one lookup pass.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from soft_contrastive_learning_torch.data.pipeline import load_images_standard

ImageKey = Tuple[str, str, str]


class DeviceImagePool:
    """(N, H, W, 3) uint8 tensor on ``device`` + key -> row index."""

    def __init__(self, images: np.ndarray, keys: Sequence[ImageKey],
                 device: str | torch.device):
        if images.dtype != np.uint8 or images.ndim != 4:
            raise ValueError(f"pool takes (N, H, W, C) uint8, got {images.dtype} "
                             f"{images.shape}")
        self.array = torch.from_numpy(images).to(device)
        self._row: Dict[ImageKey, int] = {tuple(k): i for i, k in enumerate(keys)}

    def rows_for_keys(self, keys: Sequence[ImageKey]) -> Optional[np.ndarray]:
        """(len(keys),) int64 pool rows, or None if any key is absent."""
        rows = np.empty(len(keys), np.int64)
        for i, k in enumerate(keys):
            r = self._row.get(tuple(k))
            if r is None:
                return None
            rows[i] = r
        return rows

    def rows_for_meta(self, meta: Dict[str, List[str]]) -> Optional[np.ndarray]:
        return self.rows_for_keys(list(zip(meta["date"], meta["folder"], meta["t"])))


def build_pool(
    source,
    meta: Dict[str, List[str]],
    cfg,
    device: str | torch.device,
    max_bytes: int = 4_000_000_000,
    log=print,
    pool=None,
) -> Optional[DeviceImagePool]:
    """Load every image of ``meta`` at the model's input geometry (decoded
    on the thread pool ``pool`` when one is given) and upload it once.
    Returns None (the caller keeps the host feed) when the set exceeds
    ``max_bytes``."""
    keys = list(zip(meta["date"], meta["folder"], meta["t"]))
    h, w = cfg.model.image_height, cfg.model.image_width
    need = len(keys) * h * w * 3
    if need > max_bytes:
        log(f"device image pool skipped: {need / 1e9:.2f} GB exceeds the "
            f"{max_bytes / 1e9:.2f} GB budget")
        return None
    images = np.empty((len(keys), h, w, 3), np.uint8)
    for s in range(0, len(keys), 256):  # a bounded list of decoded images at a time
        chunk = keys[s : s + 256]
        images[s : s + len(chunk)] = load_images_standard(source, chunk, cfg, pool)
    pool = DeviceImagePool(images, keys, device)
    log(f"device image pool resident: {len(keys)} images, {need / 1e6:.1f} MB on {device}")
    return pool
