"""Hard-example mining refresh, the counterpart of
``soft_contrastive_learning_tpu/train/mining_manager.py``: the refresh,
``rand_pairs``, and the async worker (``spawn``, ``join``,
``MiningCancelled``) of ``TrainConfig.async_mining``.

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

The async refresh (``spawn``) embeds the window on a worker thread while the
training thread goes on with the previous window; ``MiningCache.refresh``
swaps the new one in under the cache's lock. JAX snapshots the parameters
at the boundary because its step donates them; here ``optimizer.step()``
changes the live weights in place, so the manager keeps one copy of the
model (``_twin``, built once, eval mode, no gradients), into which the live
parameters and buffers are copied at each spawn, on the training thread and
its current stream, before the next step is launched: stream order pins the
copy, and the worker's embeds read the boundary's weights. The worker's
device work goes to the same stream (what moves off the training thread is
the blocking fetch of the order, as in JAX), under ``torch.inference_mode``
(thread-local), and it touches neither the live module nor a process-wide
flag.
"""

from __future__ import annotations

import threading
from typing import List, Tuple

import numpy as np
import torch

from soft_contrastive_learning_torch.models.model import EmbeddingNet
from soft_contrastive_learning_torch.sampling.mining import MiningCache, neighbor_order


class MiningCancelled(Exception):
    """An async refresh aborted on purpose (unwind, epoch end, close): not
    an error; the cache keeps its previous window."""


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
        self.refresh_count = 0  # window swaps (a cancelled refresh swaps none)
        self._thread = None  # the async refresh in flight
        self._error = None
        self._cancel = None  # its cancel event
        self._twin = None  # the boundary weights' copy the worker embeds with

    def refresh(self, epoch: int, step: int, mining_count: int, meta, anchor_indices,
                update_pca: bool = True, params=None, cancel=None) -> None:
        """Rolling window of ``mining_cache_size`` images plus the next
        ``mining_step`` anchors. At an epoch's tail the window is extended
        so that every refresh embeds ``cache_size + mining_step`` images,
        as the JAX package does to keep its shapes fixed. ``update_pca``:
        False on a resume segment (the restored PCA holds this window's
        update). ``params``: the model to embed with (the async worker's
        boundary copy; default the live one). ``cancel``: a
        ``threading.Event`` checked between the embed's chunks and before
        the order's fetch and the swap, which raise ``MiningCancelled``."""
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
        dev_feats = t.extract_features(meta, mine_idx, full_feats=full_feats, params=params,
                                       cancel=cancel)
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
        if cancel is not None and cancel.is_set():
            raise MiningCancelled()  # neither wait for the order nor swap
        order = neighbor_order(dev_feats).cpu().numpy()
        if cancel is not None and cancel.is_set():
            raise MiningCancelled()  # keep the previous window
        self.cache.refresh(mine_idx, order)
        self.refresh_count += 1

    # ------------------------------------------------------------- async
    def _snapshot(self) -> EmbeddingNet:
        """The twin, holding the live weights as they are now: copied on
        this thread's current stream, so any later launch on it, the next
        step's included, comes after the copy."""
        live = self.t.state.model
        if self._twin is None:
            twin = EmbeddingNet(self.t.cfg.model)
            self._twin = twin.to(self.t.device).requires_grad_(False).eval()
        self._twin.load_state_dict(live.state_dict())  # copy_ under no_grad
        return self._twin

    def spawn(self, refresh_fn, epoch: int, step0: int, mining_count: int, meta,
              anchor_indices) -> None:
        """Run ``refresh_fn`` (the trainer's ``_mining_refresh``, looked up
        by the caller so that an override is what runs) on a worker thread
        with the boundary's weights; its error is raised by the next
        ``join``."""
        params = self._snapshot()
        cancel = threading.Event()
        self._cancel = cancel
        device = self.t.device
        if device.type == "cuda":  # the worker's current device: the trainer's
            device = torch.device("cuda", device.index if device.index is not None
                                  else torch.cuda.current_device())

        def work():
            try:
                if device.type == "cuda":
                    torch.cuda.set_device(device)
                with torch.inference_mode(), self.t.timer.span("mining_refresh_async"):
                    refresh_fn(epoch, step0, mining_count, meta, anchor_indices,
                               params=params, cancel=cancel)
            except MiningCancelled:
                pass  # on purpose: the previous window stays
            except BaseException as e:  # raised by the next join()
                self._error = e

        thread = threading.Thread(target=work, name="mining-refresh", daemon=True)
        self._thread = thread
        thread.start()

    def join(self, raise_error: bool = True, cancel: bool = False) -> None:
        """Wait for the refresh in flight (none: no-op) and raise its error
        as ``RuntimeError("async mining refresh failed")``. ``cancel=True``
        (the epoch's end) and ``raise_error=False`` (unwind, close) abort it
        at its next check instead of waiting it out; on unwind an error is
        logged, not raised, so that it does not hide the one unwinding."""
        thread, self._thread = self._thread, None
        if thread is not None:
            if (cancel or not raise_error) and self._cancel is not None:
                self._cancel.set()
            thread.join()
        self._cancel = None
        err, self._error = self._error, None
        if err is not None:
            if raise_error:
                raise RuntimeError("async mining refresh failed") from err
            self.t.log(f"async mining refresh error during unwind: {err}")
