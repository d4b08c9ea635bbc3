"""Hard-example mining refresh, the counterpart of
``soft_contrastive_learning_tpu/train/mining_manager.py`` on its
synchronous order-only path: embed the mining window on the device, take
the neighbour order there, and hand only the (C, C) order to the host
cache. The async worker and the streaming-PCA branches are not ported (the
order-only path is what wms with ``reduction='none'`` runs).
"""

from __future__ import annotations

import numpy as np

from soft_contrastive_learning_torch.sampling.mining import MiningCache, neighbor_order


class MiningManager:
    def __init__(self, trainer):
        self.t = trainer
        self.cache = MiningCache()
        self.refresh_count = 0

    def refresh(self, epoch: int, step: int, mining_count: int, meta, anchor_indices) -> None:
        """Rolling window of ``mining_cache_size`` images plus the next
        ``mining_step`` anchors. At an epoch's tail the window is extended
        so that every refresh embeds ``cache_size + mining_step`` images,
        as the JAX package does to keep its shapes fixed."""
        cfg = self.t.cfg
        n_meta = len(meta["t"])
        window = np.arange(mining_count * cfg.mining_cache_size,
                           (mining_count + 1) * cfg.mining_cache_size) % n_meta
        upcoming = np.asarray(
            anchor_indices[step : min(step + cfg.mining_step, len(anchor_indices))])
        deficit = cfg.mining_step - len(upcoming)
        if deficit > 0:
            start = (mining_count + 1) * cfg.mining_cache_size
            window = np.concatenate([window, np.arange(start, start + deficit) % n_meta])
        mine_idx = np.concatenate([window, upcoming]).astype(int)
        feats = self.t.extract_features(meta, mine_idx)  # (C, D) fp32 on the device
        order = neighbor_order(feats).cpu().numpy()
        self.cache.refresh(mine_idx, order)
        self.refresh_count += 1
