"""Hard-example mining refresh, the counterpart of
``soft_contrastive_learning_tpu/train/mining_manager.py`` (its synchronous
refresh and ``rand_pairs``; the async worker is not ported).

Without host-side PCA state in play (no ``reduction='pca'``, the loss PCA
absent or initialized) the refresh is order-only: the mining window is
embedded on the device, its neighbour order taken there, and only the
(C, C) order crosses to the host. Otherwise the window's features cross to
the host, as JAX's do:

* ``reduction='pca'``: the raw descriptors (``full_out``) initialize the
  streaming PCA, or update it in chunks of a batch (``update_multi``;
  skipped on a resume segment, whose checkpoint holds that update
  already), and the neighbour order is taken over their whitening;
* an uninitialized loss PCA is initialized from the window: from
  ``loss_dim + 1`` residuals of random pairs (``rand_pairs`` on the
  trainer's main generator, before the segment's seed draw, as JAX draws
  them) for the ``*residual*`` losses, else from the features themselves.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from soft_contrastive_learning_torch.sampling.mining import MiningCache, neighbor_order


def rand_pairs(rng: np.random.Generator, n: int, m: int) -> List[Tuple[int, int]]:
    """``m`` distinct unordered index pairs out of ``n`` items."""
    total = n * (n - 1) // 2
    picks = rng.choice(total, size=min(m, total), replace=False)
    out = []
    for i in picks:
        k = int((1 + np.sqrt(1 + 8 * i)) // 2)
        out.append((k, int(i - k * (k - 1) // 2)))
    return out


class MiningManager:
    def __init__(self, trainer):
        self.t = trainer
        self.cache = MiningCache()
        self.refresh_count = 0

    def refresh(self, epoch: int, step: int, mining_count: int, meta, anchor_indices,
                update_pca: bool = True) -> None:
        """Rolling window of ``mining_cache_size`` images plus the next
        ``mining_step`` anchors. At an epoch's tail the window is extended
        so that every refresh embeds ``cache_size + mining_step`` images,
        as the JAX package does to keep its shapes fixed. ``update_pca``:
        False on a resume segment (the restored PCA holds this window's
        update)."""
        t = self.t
        cfg = t.cfg
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

        full_feats = cfg.model.reduction == "pca"
        # (C, D) fp32 on the device, before any whitening
        dev_feats = t.extract_features(meta, mine_idx, full_feats=full_feats)
        order_only = (not full_feats and t.pca is None
                      and (t.loss_pca is None or t.loss_pca.initialized))
        if not order_only:
            feats = dev_feats.cpu().numpy()
            if t.pca is not None:
                if not t.pca.initialized:
                    t.pca.init(feats)
                elif update_pca:
                    t.pca.update_multi(feats, cfg.images_per_batch)
                feats = t.pca.whiten(feats).astype(np.float32)
                dev_feats = torch.from_numpy(feats).to(t.device)
            if t.loss_pca is not None and not t.loss_pca.initialized:
                if "residual" in cfg.loss.name:
                    pairs = rand_pairs(t.rng, len(mine_idx), cfg.loss.loss_dim + 1)
                    t.loss_pca.init(np.stack([feats[i] - feats[j] for i, j in pairs]))
                else:
                    t.loss_pca.init(feats)
        order = neighbor_order(dev_feats).cpu().numpy()
        self.cache.refresh(mine_idx, order)
        self.refresh_count += 1
