"""Streaming-PCA updates on a worker thread, own copy of
``soft_contrastive_learning_tpu/pca/async_updater.py`` (``AsyncPCAUpdater``,
the same contract; the port imports nothing of the JAX package).

One worker thread applies the updates in the order they were submitted, and
the state a training step is fed is a function of the step's index alone:

* ``feed_states()`` before step ``i`` returns the state with the updates
  ``<= i-2`` applied (lag 2), so the card runs step ``i`` while the worker
  folds in step ``i-1``'s features;
* ``drain()`` waits until every submitted update is applied and floors the
  later feeds at that state. The trainer drains at every checkpoint, eval
  and mining boundary, so that a run resumed from a drained checkpoint is
  fed what the uninterrupted run was fed;
* a worker error is terminal: the queue is dropped and every later call
  raises again; ``close()`` joins the worker even when its drain raises.

The step hands over CUDA tensors. ``submit`` takes them with ``.detach()``
(the queue must not keep a step's autograd graph alive), and the worker
copies them to the host with ``.cpu()`` on its own thread: that copy waits
for the step that makes them, and the wait is the worker's, not the
training loop's. Host arrays are taken as they are.

Snapshots are references, not copies: an update replaces the StreamingPCA's
arrays (``pca/incremental.py``), so keeping the earlier ones is free and
race-free. The history keeps the versions a feed or a drain can still ask
for.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from soft_contrastive_learning_torch.pca.incremental import StreamingPCA

Snapshot = Tuple[Optional[dict], Optional[dict]]


def _host(x: Any) -> np.ndarray:
    """A submitted input as a host array (a tensor is copied from its device)."""
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _snap(pca: Optional[StreamingPCA], loss_pca: Optional[StreamingPCA]) -> Snapshot:
    return (
        pca.state_dict() if pca is not None and pca.initialized else None,
        loss_pca.state_dict() if loss_pca is not None and loss_pca.initialized else None,
    )


class AsyncPCAUpdater:
    """Serialized, deterministic, off-critical-path streaming-PCA updates.

    One instance lives per training segment (mining boundaries mutate the
    PCA objects directly, so the segment tear-down drains and closes it).
    """

    def __init__(
        self,
        pca: Optional[StreamingPCA],
        loss_pca: Optional[StreamingPCA],
    ) -> None:
        self.pca = pca
        self.loss_pca = loss_pca
        self._cond = threading.Condition()
        self._pending: deque = deque()  # (version, pca_in, loss_pca_in)
        self._applied = -1
        self._submitted = 0
        self._floor = -1  # feeds never go below this version (set by drain)
        self._hist: Dict[int, Snapshot] = {-1: _snap(pca, loss_pca)}
        self._err: Optional[BaseException] = None
        self._failed = False  # terminal: set on worker error, never cleared
        self._closed = False
        self._thread = threading.Thread(
            target=self._run, name="pca-updater", daemon=True
        )
        self._thread.start()

    # ------------------------------------------------------------ worker
    def _run(self) -> None:
        while True:
            with self._cond:
                while not self._pending and not self._closed:
                    self._cond.wait()
                if self._closed and not self._pending:
                    return
                version, pca_in, loss_in = self._pending.popleft()
            try:
                # the copy to the host waits for the step that makes these
                # tensors: that wait belongs on this thread, not the
                # training loop's
                if self.pca is not None and pca_in is not None:
                    self.pca.update(_host(pca_in))
                if self.loss_pca is not None and loss_in is not None:
                    self.loss_pca.update(_host(loss_in))
            except BaseException as e:  # terminal: propagate to the trainer
                with self._cond:
                    # The PCA state is now missing update `version`; applying
                    # later updates would snapshot silently-corrupt states, so
                    # fail permanently: discard the queue and stop the worker.
                    self._err = e
                    self._failed = True
                    self._pending.clear()
                    self._cond.notify_all()
                return
            with self._cond:
                self._applied = version
                self._hist[version] = _snap(self.pca, self.loss_pca)
                # A future feed targets max(submitted-2, floor) >= version-1,
                # a future drain targets >= version: versions below
                # version-2 are dead unless they ARE the current floor.
                for old in [
                    k for k in self._hist if k < version - 2 and k != self._floor
                ]:
                    del self._hist[old]
                self._cond.notify_all()

    def _check(self) -> None:
        if self._failed:
            # terminal: every subsequent call keeps raising (a cleared error
            # would let a later drain() KeyError on the missing version)
            raise RuntimeError("streaming-PCA worker failed") from self._err

    # ------------------------------------------------------------ trainer API
    def submit(self, pca_in: Any, loss_pca_in: Any) -> None:
        """Enqueue one step's update inputs (tensors on any device, or host
        arrays); tensors are detached from their graph here."""
        pca_in, loss_pca_in = (x.detach() if torch.is_tensor(x) else x
                               for x in (pca_in, loss_pca_in))
        with self._cond:
            self._check()
            self._pending.append((self._submitted, pca_in, loss_pca_in))
            self._submitted += 1
            self._cond.notify_all()

    def feed_states(self) -> Snapshot:
        """State for the NEXT step's feed: updates ``<= submitted-2`` applied
        (or the drain floor, whichever is newer)."""
        with self._cond:
            target = max(self._submitted - 2, self._floor)
            while self._applied < target and not self._failed:
                self._cond.wait()
            self._check()
            return self._hist[target]

    def drain(self) -> Snapshot:
        """Apply everything submitted, floor future feeds at the result, and
        return it — the state that belongs in a checkpoint."""
        with self._cond:
            target = self._submitted - 1
            while self._applied < target and not self._failed:
                self._cond.wait()
            self._check()
            self._floor = target
            return self._hist[target]

    def close(self) -> None:
        """Drain and stop the worker (PCA objects then hold the final state).
        The worker is stopped and joined even when the drain raises (a failed
        worker must not leak a blocked thread)."""
        try:
            self.drain()
        finally:
            with self._cond:
                self._closed = True
                self._cond.notify_all()
            self._thread.join()
