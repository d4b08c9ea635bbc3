"""The training loop, the counterpart of
``soft_contrastive_learning_tpu/train/trainer.py`` with
``train/segment.py::run_segment``.

Per epoch: the source's shuffled metadata and anchors; the uint8 image set
resident on the device (``data/device_pool.py``) when it is on and fits
``device_pool_max_bytes``; and segments between mining boundaries (the
steps divisible by ``mining_step``). At each boundary the mining cache is
refreshed (``train/mining_manager.py``): synchronously, or with
``async_mining`` on a worker thread while the segment trains on the previous
window, under JAX's gate (``_mining_gate``): not the epoch's first refresh
(its window indexes this epoch's shuffle), not a resume segment, no
streaming PCA, one process. The worker is joined at the next boundary,
cancelled at the epoch's end and on unwind. Each segment samples from a
child generator seeded by a draw from the trainer's generator, so the
sample stream matches the JAX trainer's. Steps stride by
``tuples_per_batch`` over the anchors.

Within a segment nothing is fetched from the card: the host samples batch
i+1 while the card runs step i (the batch's pageable copy to the card waits
for the card's queue, so the host runs at most a step ahead), and the losses (with the PN losses' ``loss_pos``
and ``loss_neg``) are fetched in one transfer at the segment's end, or
before an eval so that the records stay in order, and written as JSONL
(``metrics_local.jsonl``, the records of ``core/logging.py::MetricsWriter``)
with ``global_step`` counted from 1; ``scalar_fetches`` and
``scalar_fetch_s`` count those fetches and their seconds (JAX's
``AsyncScalarLogger`` statistics; the port has no such thread).
With ``steps_per_dispatch`` K > 1 the segment's items run in groups of K
through ``train_step_scan`` (``train/step.py::build_train_step_scan``),
formed as JAX's ``run_segment`` forms them (``_run_segment``): an item that
hosts an eval or a save never sits inside a group, so a checkpoint falls
between dispatches and a resume lands where a K = 1 run's would; every step
gets its own record, so ``metrics_local.jsonl`` is the same file at any K.
Without the device pool (the host-fed path) a ``Prefetcher`` thread samples
the segment's batches in step order and decodes their images on the
trainer's 8-thread pool (``_pool``), up to two batches ahead of the card, as
the JAX trainer does. It runs only inside its segment, after the segment's
refresh, so the batches (and a resume) are the synchronous path's.

Every ``eval_step`` anchors (step 0 included) the eval hooks run
(``train/eval_hooks.py``): the held-out region's loss, then localization on
the held-out and the training region, written to ``metrics_other.jsonl``
and ``metrics_local.jsonl``. They draw from ``eval_rng``, a stream of its
own, so the training draws are the same with or without them. As in the
JAX loop there is no eval at an epoch's end.

With ``reduction='pca'`` or an incremental loss the trainer keeps the
streaming PCAs on the host, ``pca`` (``out_dim`` components of the raw
descriptor) and ``loss_pca`` (``loss_dim`` components of the output),
initialized at the first mining refresh (``train/mining_manager.py``).
Each step is fed their state (``_augment_batch``) and returns their next
updates. With ``async_pca`` one ``AsyncPCAUpdater`` per segment folds them
in on a worker thread and feeds step i the state with the updates up to
i-2 applied; it is drained before every checkpoint and eval and closed at
the segment's end (a mining boundary). Without it each update is applied
on the training loop before the next step. ``extract_features`` whitens
with the PCA (``reduction='pca'``), so that the eval hooks see what JAX's
see.

``timer`` (``core/logging.py::StepTimer``) holds JAX's spans, host clock,
no sync of their own: ``pool_build``, ``mining_refresh`` (a synchronous
refresh), ``mining_refresh_async`` (the worker's), ``host_build`` (a
batch's sampling, and its decode on the host-fed path; a group's stacking),
``data_wait`` (the host-fed path's wait for it), ``dispatch_put`` (its copy
to the card and the PCA feeds; a group's one transfer set), ``train_step``
(the step's launch; a group's K steps), ``pca_update``,
``ckpt_save``, ``eval_loss``, ``eval_localization``, and ``segment_steady``:
each segment's window between a device sync at its start and one at its
end, the in-segment eval and save spans (``EVAL_SAVE_SPANS``) taken out,
counted in steps. ``bench_train.py`` reads them.

Checkpoints (``checkpoints/manager.py``) are written where the JAX loop
writes them: the rolling one inside each eval, before the evals; a part one
every ``save_step`` anchors; one at each epoch's end. Each holds the model,
the optimizer, the step, the dropout generator, the streaming PCAs once
initialized, and ``_extras()``: the generator states and the position
inside the epoch. ``resume_latest`` takes a run up again from one:
at the next epoch after an epoch checkpoint, else inside the segment that
was running, whose child generator is seeded again from the saved pre-draw
state and run forward over the batches already trained. The losses still on
the card when a save fires are fetched and written first, so a resumed run's
``metrics_local.jsonl`` goes on without a gap or a repeat.

``mesh`` (``parallel/mesh.py``): this trainer is one rank of a data-parallel
run, and every rank runs the same loop. Every rank draws the same host
batches from the same seeded generators; ``_to_device`` keeps this rank's
rows of the per-image leaves (``shard_batch``), the steps gather the
output and compute the global loss (``train/step.py``), and
``extract_features`` embeds this rank's share of each chunk and gathers the
rest, so mining and the eval hooks see the whole matrix on every rank. The
device image pool is a full copy on each rank's card. Only the primary
(rank 0, ``launch/multihost.py::is_primary``) writes ``config.json``, the
log, both metrics files, plots and checkpoints, as JAX's writer election;
every rank waits after each save until it is written, and
``resume_latest`` reads the checkpoint on every rank. Async mining stays
off with more than one rank, as in JAX.
"""

from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from soft_contrastive_learning_torch.checkpoints.manager import (
    RunCheckpoints,
    numpy_rng_from_array,
    numpy_rng_to_array,
)
from soft_contrastive_learning_torch.core.config import TrainConfig, resolve_device
from soft_contrastive_learning_torch.core.logging import MetricsWriter, RunLogger, StepTimer
from soft_contrastive_learning_torch.data.device_pool import build_pool
from soft_contrastive_learning_torch.data.pipeline import (
    Prefetcher,
    assemble_batch,
    load_images_standard,
    pad_to_multiple,
)
from soft_contrastive_learning_torch.launch.multihost import is_primary
from soft_contrastive_learning_torch.losses.registry import build_loss
from soft_contrastive_learning_torch.models.model import EmbeddingNet, init_params
from soft_contrastive_learning_torch.parallel.mesh import (
    Mesh,
    barrier,
    shard_batch,
    shard_batch_stacked,
)
from soft_contrastive_learning_torch.pca.async_updater import AsyncPCAUpdater
from soft_contrastive_learning_torch.pca.incremental import StreamingPCA
from soft_contrastive_learning_torch.sampling.tuples import TupleSampler
from soft_contrastive_learning_torch.train.eval_hooks import EvalHooks
from soft_contrastive_learning_torch.train.mining_manager import (  # noqa: F401
    MiningCancelled as _MiningCancelled,  # JAX's trainer exports it under this name
    MiningManager,
)
from soft_contrastive_learning_torch.train.step import (
    build_embed_step,
    build_eval_loss_step,
    build_train_step,
    build_train_step_scan,
    init_train_state,
)
from soft_contrastive_learning_torch.train.schedule import learning_rate
from soft_contrastive_learning_torch.utils.meta import get_xy, get_yaw, image_keys

# the spans that the steady windows and bench_train's with_mining leave out
EVAL_SAVE_SPANS = ("eval_loss", "eval_localization", "ckpt_save")


def _single_process() -> bool:
    """No process group, or one of one: async mining's condition (JAX:
    ``jax.process_count() == 1``); with more, a worker racing the main
    loop would make the collectives' order the scheduler's."""
    dist = torch.distributed
    return not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() == 1


class Trainer:
    """``params``: an initial ``EmbeddingNet`` state_dict (for example
    ``models/weights.py::load_trained_params``); default: a fresh
    ``init_params`` draw from ``cfg.seed``. ``save_plots``: the evals also
    write tolerance-curve PDFs (matplotlib) and triptych PNGs.
    ``mesh``: this rank's mesh of a data-parallel run (module docstring);
    the trainer runs on its device, whatever ``device`` says. On more than
    one rank it turns on ``torch.backends.cudnn.deterministic`` for the
    process: cuDNN's default backward algorithms sum with atomics, and
    ranks that share a card interleave their kernels, so two runs of the
    same steps, and a run resumed from a checkpoint, parted from each other
    by up to 2.6e-5 in the flagship's fp32 parameters after 12 steps
    (``scripts/torch_resume_gap.py``); with the flag they are bit-equal."""

    def __init__(self, cfg: TrainConfig, source, out_dir: Optional[str] = None,
                 device: str | torch.device = "cuda",
                 params: Optional[Mapping[str, torch.Tensor]] = None,
                 save_plots: bool = False, mesh: Optional[Mesh] = None):
        self.cfg = cfg
        self.source = source
        self.mesh = mesh
        # writer election: the state is replicated, so the primary's copy is whole
        self.primary = is_primary()
        self.save_plots = save_plots and self.primary
        self.device = mesh.device if mesh is not None else resolve_device(device)
        if mesh is not None and mesh.size > 1:
            torch.backends.cudnn.deterministic = True
        self.out_dir = out_dir or cfg.out_dir or "."
        os.makedirs(self.out_dir, exist_ok=True)
        if self.primary:
            cfg.save(os.path.join(self.out_dir, "config.json"))
        self.log = RunLogger(self.out_dir if self.primary else None)
        self.timer = StepTimer()
        self.scalar_fetches = 0  # _write_train_metrics' device-to-host fetches
        self.scalar_fetch_s = 0.0
        self.writers = {role: MetricsWriter(self.out_dir, role, enabled=self.primary)
                        for role in ("local", "other")}
        self.ckpts = RunCheckpoints(self.out_dir, max_to_keep=cfg.max_to_keep,
                                    enabled=self.primary)

        model = EmbeddingNet(cfg.model)
        model.load_state_dict(params if params is not None else init_params(cfg.model, cfg.seed))
        self.state = init_train_state(cfg, model.to(self.device))
        loss_fn = build_loss(cfg.loss, cfg.tuples, cfg.tuples_per_batch)
        self.train_step = build_train_step(cfg, loss_fn, mesh=mesh)
        self.train_step_pooled = build_train_step(cfg, loss_fn, image_pool=True, mesh=mesh)
        # the K-step dispatch (steps_per_dispatch > 1), as JAX builds it: not
        # where host state is fed back every step; eval and save items, and
        # stragglers, take the single steps above
        self.train_step_scan = self.train_step_scan_pooled = None
        if cfg.steps_per_dispatch > 1 and not cfg.loss.incremental \
                and cfg.model.reduction != "pca":
            self.train_step_scan = build_train_step_scan(cfg, loss_fn, mesh=mesh)
            self.train_step_scan_pooled = build_train_step_scan(cfg, loss_fn, image_pool=True,
                                                                mesh=mesh)
        self.eval_loss_step = build_eval_loss_step(cfg, model, loss_fn, mesh=mesh)
        self.embed_step = build_embed_step(model, mesh=mesh)
        # None until built; False = unavailable (over the byte budget)
        self._image_pool = None
        self._pool_rows = None  # meta row -> pool row, for the current epoch

        self.mining = MiningManager(self)
        self.mining_cache = self.mining.cache
        self.evals = EvalHooks(self)
        self.pca = (StreamingPCA(cfg.model.out_dim, cfg.forgetting_factor)
                    if cfg.model.reduction == "pca" else None)
        self.loss_pca = (StreamingPCA(cfg.loss.loss_dim, cfg.forgetting_factor)
                         if cfg.loss.incremental else None)
        self._updater = None  # the segment's AsyncPCAUpdater (async_pca)
        self._fed = {}  # name -> (host array, its device copy) of the last feed
        self.rng = np.random.default_rng(cfg.seed)
        # the eval paths draw from a stream of their own, so a run's training
        # draws do not depend on whether or when they fire
        self.eval_rng = np.random.default_rng(cfg.seed + 1)
        self._pool = ThreadPoolExecutor(max_workers=8)  # image decode
        self.global_step = 0
        self.start_epoch = 0
        self._current_epoch = 0
        self._seg_ctx = None  # the running segment's position, for mid-epoch checkpoints
        self._resume_ctx = None  # set by resume_latest for the first epoch
        self.used_images: set = set()

    # ------------------------------------------------------------ helpers
    def _sampler_for(self, meta, rng=None) -> TupleSampler:
        return TupleSampler(self.cfg.tuples, self.cfg.loss, self.cfg.tuple_shape,
                            get_xy(meta), get_yaw(meta), rng=rng if rng is not None else self.rng)

    def _to_device(self, batch: Dict[str, np.ndarray]) -> Dict[str, object]:
        """The host batch on the device: this rank's rows of its images or
        pool indices on a mesh, the rest whole."""
        return {k: float(v) if np.ndim(v) == 0 else torch.from_numpy(v).to(self.device)
                for k, v in shard_batch(batch, self.mesh).items()}

    def _pca_sd(self) -> Optional[dict]:
        return self.pca.state_dict() if self.pca is not None and self.pca.initialized else None

    def _loss_pca_sd(self) -> Optional[dict]:
        return (self.loss_pca.state_dict()
                if self.loss_pca is not None and self.loss_pca.initialized else None)

    def _on_device(self, name: str, array: np.ndarray) -> torch.Tensor:
        """``array`` on the device; the copy of the last feed is kept, so a
        state fed twice (after a drain) crosses once."""
        host, dev = self._fed.get(name, (None, None))
        if host is not array:
            dev = torch.from_numpy(np.asarray(array)).to(self.device)
            self._fed[name] = (array, dev)
        return dev

    def _augment_batch(self, batch: Dict[str, object], snaps=None) -> Dict[str, object]:
        """Attach the streaming PCAs' states to a device batch: ``snaps``,
        the updater's (pca, loss_pca) state dicts for this step, or the
        live objects' (synchronous updates, the evals after a drain)."""
        pca_sd, loss_sd = snaps if snaps is not None else (self._pca_sd(), self._loss_pca_sd())
        if pca_sd is not None:
            batch["pca_components"] = self._on_device("v", pca_sd["v"])
            batch["pca_mean"] = self._on_device("m", pca_sd["m"])
            batch["pca_variance"] = self._on_device("var", pca_sd["var"])
        if loss_sd is not None:
            for key in ("s", "v", "m"):
                batch[f"loss_pca_{key}"] = self._on_device(f"loss_{key}", loss_sd[key])
            batch["loss_pca_seen"] = float(np.float32(loss_sd["seen"]))
        return batch

    def extract_features(self, meta, indices, full_feats: bool = False, params=None,
                         cancel=None) -> torch.Tensor:
        """Embed ``meta`` rows ``indices`` on the device in batches of
        ``images_per_batch`` (the last one padded): (len(indices), D)
        float32 on the device, the raw descriptors (``full_out``) with
        ``full_feats``, else the output; with ``reduction='pca'`` and the
        PCA initialized the output is whitened by it on the host, as the
        JAX trainer does. ``params``: the ``EmbeddingNet`` to embed with
        (the async refresh's copy of the boundary weights; default the
        live model). ``cancel``: an event checked before each chunk, which
        raises ``MiningCancelled``. On a mesh each rank embeds its share of
        each chunk and the chunk's descriptors are gathered: every rank
        returns the whole matrix."""
        embed = self.embed_step if params is None else build_embed_step(params, self.mesh)
        b = self.cfg.images_per_batch
        idx = pad_to_multiple(np.asarray(indices, dtype=int), b)
        pool = self._image_pool or None
        chunks = []
        for start in range(0, len(idx), b):
            if cancel is not None and cancel.is_set():
                raise _MiningCancelled()
            keys = image_keys(meta, idx[start : start + b])
            rows = pool.rows_for_keys(keys) if pool is not None else None
            if rows is not None:  # gather on the device
                rows = torch.from_numpy(shard_batch(rows, self.mesh)).to(self.device)
                images = pool.array.index_select(0, rows)
            else:
                images = torch.from_numpy(load_images_standard(
                    self.source, shard_batch(keys, self.mesh), self.cfg, self._pool)
                ).to(self.device)
            output, full = embed(images)
            chunks.append(full if full_feats else output)
        feats = torch.cat(chunks)[: len(indices)].float()
        if (not full_feats and self.cfg.model.reduction == "pca" and self.pca is not None
                and self.pca.initialized):
            whitened = self.pca.whiten(feats.cpu().numpy()).astype(np.float32)
            feats = torch.from_numpy(whitened).to(self.device)
        return feats

    def _ensure_image_pool(self, meta) -> None:
        """Build (once) and remap (per epoch) the device image pool; leaves
        ``_pool_rows`` None when there is none, and the host feeds images."""
        cfg = self.cfg
        self._pool_rows = None
        if not cfg.device_image_pool or self._image_pool is False:
            return
        if self._image_pool is None:
            with self.timer.span("pool_build"):
                pool = build_pool(self.source, meta, cfg, self.device,
                                  max_bytes=cfg.device_pool_max_bytes, log=self.log,
                                  pool=self._pool)
            self._image_pool = pool if pool is not None else False
            if pool is None:
                return
        rows = self._image_pool.rows_for_meta(meta)
        if rows is None:  # the set changed under us: rebuild once
            self.log("image pool stale (unknown keys); rebuilding")
            self._image_pool = None
            self._ensure_image_pool(meta)
            return
        self._pool_rows = rows

    # ------------------------------------------------------------ training
    def train(self) -> None:
        for epoch in range(self.start_epoch, self.cfg.max_epoch):
            self.log(f"**** EPOCH {epoch} ****")
            self.used_images.clear()
            self.train_one_epoch(epoch, resume_ctx=self._resume_ctx)
            self._resume_ctx = None
            self._current_epoch = epoch + 1  # an epoch checkpoint resumes AFTER it
            self._save("epoch", epoch)
        self.ckpts.wait()

    def _extras(self) -> dict:
        """The host state beside the model and optimizer: the generators and
        the position. Each segment draws from a child generator seeded by a
        draw from ``self.rng``; inside a segment the state BEFORE that draw
        is saved with the segment's first step and the number of batches
        consumed, so that a resume seeds the identical child and runs it
        forward to the exact step. Scope of exactness, as in the JAX
        trainer: the replayed draws are the same bits, so resumed equals
        uninterrupted whenever the hard-example picks are unchanged by the
        rebuilt mining cache: always with hard mining off. The rebuilt cache
        is embedded with the restored (slightly later) weights; where its
        neighbour order differs from the original cache's, hard picks can
        differ. Saving the cache's features would close that and is not
        done (131 MB at the flagship's size)."""
        ctx = self._seg_ctx
        return {
            "sampler_rng": ctx["pre_spawn"] if ctx is not None else numpy_rng_to_array(self.rng),
            "eval_rng": numpy_rng_to_array(self.eval_rng),
            "epoch": int(self._current_epoch),
            "seg_step0": int(ctx["seg_step0"]) if ctx is not None else -1,
            "consumed": int(ctx["consumed"]) if ctx is not None else 0,
            "mining_count": int(ctx["mining_count"]) if ctx is not None else 0,
        }

    def train_one_epoch(self, epoch: int, resume_ctx: Optional[dict] = None) -> None:
        cfg = self.cfg
        self._current_epoch = epoch
        meta = self.source.epoch_meta(cfg.local_ref_set, epoch)
        self._ensure_image_pool(meta)
        anchor_indices = np.asarray(
            self.source.anchor_indices(cfg.local_ref_set, cfg.train_ref_r, epoch), dtype=int)
        steps = np.arange(0, len(anchor_indices), cfg.tuples_per_batch)
        boundary = steps % cfg.mining_step == 0
        mining_count = 0
        seg_start = 0
        # Mid-epoch resume: go straight to the checkpointed segment, drawing no
        # seeds for the skipped ones (self.rng was restored to the state
        # before the draw OF that segment).
        resume_step0 = int(resume_ctx["seg_step0"]) if resume_ctx else -1
        skip = int(resume_ctx["consumed"]) if resume_ctx else 0
        suppress_first = resume_ctx is not None
        if resume_step0 >= 0:
            mining_count = int(resume_ctx["mining_count"])
            # its segment starts at the last boundary at or before that step
            starts = np.flatnonzero(boundary & (steps <= resume_step0))
            seg_start = int(starts[-1]) if len(starts) else 0
            self.log(f"Resuming epoch {epoch} at segment step {int(steps[seg_start])}, "
                     f"skipping {skip} consumed batches")
        while seg_start < len(steps):
            step0 = int(steps[seg_start])
            spawn_args = None  # an async refresh, spawned just before the segment's loop
            if boundary[seg_start]:
                # one refresh in flight at most: land the last one (and raise its error)
                self._join_mining()
                resume_segment = resume_ctx is not None and step0 <= resume_step0
                if self._mining_gate(mining_count, resume_segment):
                    self.log("Caching features for hard negative mining "
                             "(async; training continues on the previous cache).")
                    spawn_args = (epoch, step0, mining_count, meta, anchor_indices)
                else:
                    # on a resume this rebuilds the cache with the restored weights, and
                    # leaves the restored PCA alone: it holds this boundary's update
                    with self.timer.span("mining_refresh"):
                        self.log("Caching features for hard negative mining.")
                        self._mining_refresh(epoch, step0, mining_count, meta, anchor_indices,
                                             update_pca=not resume_segment)
                mining_count += 1
            later = np.flatnonzero(boundary[seg_start + 1 :])
            seg_end = seg_start + 1 + (int(later[0]) if len(later) else len(steps))
            seg_steps = steps[seg_start:seg_end]
            # The segment's generator is seeded by a DRAW, as the JAX trainer
            # does (not Generator.spawn, whose child counter is no part of the
            # bit generator's state and would not survive a checkpoint).
            pre_spawn = numpy_rng_to_array(self.rng)
            seg_rng = np.random.default_rng(int(self.rng.integers(np.iinfo(np.int64).max)))
            sampler = self._sampler_for(meta, rng=seg_rng)
            self._seg_ctx = {
                "pre_spawn": pre_spawn, "seg_step0": int(steps[seg_start]), "consumed": 0,
                "mining_count": mining_count - 1 if boundary[seg_start] else mining_count}
            # the batches already trained: draw their samples again (no image
            # is loaded, no step taken), so that the child generator advances
            # as it did
            offset = min(skip, len(seg_steps))
            for s in map(int, seg_steps[:offset]):
                self._sample(sampler, anchor_indices, s)
            skip = 0
            suppress_first = self._run_segment(epoch, seg_steps, anchor_indices, meta, sampler,
                                               offset, suppress_first, spawn_args)
            seg_start = seg_end
        # the next epoch's first refresh is synchronous on its own shuffle: a
        # window still in flight would be thrown away, so it is cancelled
        self._join_mining(cancel=True)
        self._seg_ctx = None

    def _mining_gate(self, mining_count: int, resume_segment: bool) -> bool:
        """Does this boundary's refresh run async? JAX's conditions
        (``train/trainer.py``): the flag; not the epoch's first refresh,
        whose window indexes this epoch's shuffle; not a resume segment;
        no streaming PCA, whose update order is part of the training; one
        process."""
        return (self.cfg.async_mining and mining_count > 0 and not resume_segment
                and self.pca is None and self.loss_pca is None and _single_process())

    # The mining seams stay methods of the trainer, as in JAX, so that a test
    # or a subclass can override one per instance; the spawn passes
    # self._mining_refresh, so that the worker runs the override.
    def _mining_refresh(self, *args, **kwargs) -> None:
        return self.mining.refresh(*args, **kwargs)

    def _spawn_mining_refresh(self, epoch: int, step0: int, mining_count: int, meta,
                              anchor_indices) -> None:
        self.mining.spawn(self._mining_refresh, epoch, step0, mining_count, meta, anchor_indices)

    def _join_mining(self, raise_error: bool = True, cancel: bool = False) -> None:
        self.mining.join(raise_error=raise_error, cancel=cancel)

    @property
    def _mining_thread(self):
        return self.mining._thread

    @property
    def _mining_error(self):
        return self.mining._error

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _span_total(self, *names) -> float:
        summary = self.timer.summary()
        return sum(summary.get(n, {}).get("total_s", 0.0) for n in names)

    def _sample(self, sampler: TupleSampler, anchor_indices, s: int):
        cfg = self.cfg
        anchors = anchor_indices[s : s + cfg.tuples_per_batch]
        if len(anchors) < cfg.tuples_per_batch:
            anchors = pad_to_multiple(anchors, cfg.tuples_per_batch)
        return sampler.sample(anchors, use_hard=True, cache=self.mining_cache)

    def _run_segment(self, epoch: int, seg_steps, anchor_indices, meta, sampler: TupleSampler,
                     offset: int = 0, suppress_first: bool = False, spawn_args=None) -> bool:
        """The segment's steps from item ``offset`` on. ``suppress_first``
        holds back the first item's eval and part save: after a resume they
        fired at the saved step already. ``spawn_args``: the boundary's
        async refresh, spawned once the segment is set up, inside the timed
        window (the overlap is what it measures); from there every way out
        joins the worker, the unwind's cancelling it. Returns the flag for
        the next segment (False once an item was reached).

        With ``steps_per_dispatch`` K > 1 the items are grouped as JAX's
        ``run_segment`` groups them: after an item's eval and save, a group
        of K forms only when the K-1 items after it exist and host neither
        an eval nor a save; a faulty item ends the group, whose items then
        run singly, and is handled after it; stragglers run singly."""
        cfg = self.cfg
        timer = self.timer
        pool_rows = self._pool_rows
        k_steps = cfg.steps_per_dispatch
        grouped = self.train_step_scan is not None  # built only for K > 1
        updater = None
        if cfg.async_pca and (self.pca is not None or self.loss_pca is not None):
            updater = AsyncPCAUpdater(self.pca, self.loss_pca)
        self._updater = updater
        prefetch = None
        if pool_rows is None:  # host-fed: sample and decode ahead on the producer thread
            def build(j: int):
                with timer.span("host_build"):
                    sample = self._sample(sampler, anchor_indices, int(seg_steps[offset + j]))
                    if sample is None:
                        return None, None
                    return sample, assemble_batch(cfg, self.source, meta, sample.indices,
                                                  sample.payload, epoch, self._pool)

            prefetch = Prefetcher(build, len(seg_steps) - offset)
            batches = iter(prefetch)

        def take(i: int):
            """Item ``i``: (sample, host batch), or None for a faulty batch."""
            if prefetch is not None:
                with timer.span("data_wait"):
                    sample, host_batch = next(batches)
            else:
                with timer.span("host_build"):
                    sample = self._sample(sampler, anchor_indices, int(seg_steps[i]))
                    host_batch = None if sample is None else {
                        "image_idx": pool_rows[sample.indices.reshape(-1)],
                        "epoch": np.float32(epoch), **sample.payload}
            return None if sample is None else (sample, host_batch)

        def boundary(i: int) -> bool:
            """Does item ``i`` host an eval or a save (and so run singly)?"""
            s = int(seg_steps[i])
            return s % cfg.eval_step == 0 or s % cfg.save_step == 0

        records = []  # (global_step, metrics: device losses and the lr)
        done = offset
        # the steady window: from a sync here to one after the loop, the
        # in-segment eval and save spans taken out
        self._sync()
        t0, excluded0 = time.perf_counter(), self._span_total(*EVAL_SAVE_SPANS)
        try:
            if spawn_args is not None:
                self._spawn_mining_refresh(*spawn_args)
            pending = False  # a faulty item ended the last group
            while done < len(seg_steps):
                i = done
                s = int(seg_steps[i])
                self._seg_ctx["consumed"] = i  # items behind us; a resume trains this one
                side_effects, suppress_first = not suppress_first, False
                if side_effects and s % cfg.eval_step == 0:
                    self._write_train_metrics(records)
                    self._run_eval(epoch, s // max(cfg.eval_step, 1))
                if side_effects and s % cfg.save_step == 0:
                    self._write_train_metrics(records)
                    self._save("part", self.global_step)
                item = None if pending else take(i)
                pending = False
                done = i + 1
                if item is None:
                    self.log("Faulty training batch... skipping.")
                    continue
                group = [item]
                if grouped and all(j < len(seg_steps) and not boundary(j)
                                   for j in range(i + 1, i + k_steps)):
                    while len(group) < k_steps:
                        nxt = take(i + len(group))
                        if nxt is None:
                            pending = True  # handled after the group
                            break
                        group.append(nxt)
                if len(group) == k_steps and grouped:
                    self._dispatch_group(epoch, group, records)
                else:
                    for one in group:
                        self._dispatch_single(one, updater, records)
                done = i + len(group)
        except BaseException:
            if updater is not None:  # the original error goes on; the workers' are logged
                try:
                    updater.close()
                except Exception as drain_err:
                    self.log(f"PCA worker error during unwind: {drain_err}")
            self._join_mining(raise_error=False)
            raise
        else:
            if updater is not None:
                updater.close()
        finally:
            self._updater = None
            if prefetch is not None:
                prefetch.close()
        self._seg_ctx["consumed"] = len(seg_steps)
        self._write_train_metrics(records)
        self._sync()
        timer.add("segment_steady",
                  time.perf_counter() - t0 - (self._span_total(*EVAL_SAVE_SPANS) - excluded0),
                  count=done - offset)
        return suppress_first

    def _dispatch_single(self, item, updater, records: list) -> None:
        """One step on one item: its copy to the card (with the PCA feeds),
        the step, its PCA updates and its record."""
        sample, host_batch = item
        with self.timer.span("dispatch_put"):
            snaps = updater.feed_states() if updater is not None else None
            batch = self._augment_batch(self._to_device(host_batch), snaps)
        with self.timer.span("train_step"):
            if self._pool_rows is not None:
                self.state, metrics = self.train_step_pooled(self.state, batch,
                                                             self._image_pool.array)
            else:
                self.state, metrics = self.train_step(self.state, batch)
        self.used_images.update(sample.used_indices)
        self.global_step += 1
        with self.timer.span("pca_update"):
            self._update_pca(metrics.pop("pca_in", None), metrics.pop("loss_pca_in", None))
        records.append((self.global_step, metrics))

    def _dispatch_group(self, epoch: int, items: list, records: list) -> None:
        """K steps in one dispatch (``build_train_step_scan``): the K host
        batches stacked (``host_build``), one transfer set (``dispatch_put``),
        the K steps (``train_step``), then a record per step, in order."""
        with self.timer.span("host_build"):
            stacked = {k: np.stack([batch[k] for _, batch in items]) for k in items[0][1]}
        with self.timer.span("dispatch_put"):
            batch = {k: v if k == "epoch" else
                     torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                     for k, v in shard_batch_stacked(stacked, self.mesh).items()}
        with self.timer.span("train_step"):
            if self._pool_rows is not None:
                self.state, metrics = self.train_step_scan_pooled(self.state, batch,
                                                                  self._image_pool.array)
            else:
                self.state, metrics = self.train_step_scan(self.state, batch)
        lr = learning_rate(self.cfg, float(np.float32(epoch)))  # the single step's float
        for i, (sample, _) in enumerate(items):
            self.used_images.update(sample.used_indices)
            self.global_step += 1
            records.append((self.global_step, {
                **{k: v[i] for k, v in metrics.items() if k != "learning_rate"},
                "learning_rate": lr}))

    def _update_pca(self, pca_in, loss_pca_in) -> None:
        """Fold a step's PCA feeds in: through the segment's updater, or on
        this thread before the next step."""
        if pca_in is None and loss_pca_in is None:
            return
        if self._updater is not None:
            self._updater.submit(pca_in, loss_pca_in)
            return
        if self.pca is not None and pca_in is not None:
            self.pca.update(pca_in.cpu().numpy())
        if self.loss_pca is not None and loss_pca_in is not None:
            self.loss_pca.update(loss_pca_in.cpu().numpy())

    def _save(self, role: str, step: int) -> None:
        """A checkpoint with every update submitted so far applied (written
        by the primary; on a mesh every rank leaves once it is in place)."""
        with self.timer.span("ckpt_save"):
            if self._updater is not None:
                self._updater.drain()
            self.ckpts.save(role, step, self.state, self._extras(), pca=self._pca_sd(),
                            loss_pca=self._loss_pca_sd())
            barrier(self.mesh)

    def _write_train_metrics(self, records: list) -> None:
        """Fetch the pending steps' losses (with the PN losses' ``loss_pos``
        and ``loss_neg``) in one device-to-host transfer, log and write
        them, and empty ``records``; ``scalar_fetches`` and
        ``scalar_fetch_s`` count the transfers and their seconds."""
        if not records:
            return
        keys = ("loss", "loss_pos", "loss_neg") if self.cfg.loss.pn_loss else ("loss",)
        t0 = time.perf_counter()
        values = torch.stack([m[k] for _, m in records for k in keys]).reshape(
            len(records), len(keys)).tolist()
        self.scalar_fetches += 1
        self.scalar_fetch_s += time.perf_counter() - t0
        for (step, metrics), row in zip(records, values):
            losses = dict(zip(keys, row))
            self.log(f"Train batch loss: {losses['loss']}")
            # JAX's record order: loss, learning_rate, then loss_pos, loss_neg
            self.writers["local"].scalars(
                {"loss": losses.pop("loss"), "learning_rate": metrics["learning_rate"], **losses},
                step)
        records.clear()

    def _run_eval(self, epoch: int, eval_ordinal: int) -> None:
        """``eval_ordinal`` counts eval firings (``abs_step // eval_step``)
        and indexes the rolling windows of eval queries."""
        self.log("EVALUATING")
        gs = self.global_step
        self._save("rolling", gs)  # drains: the evals read the live PCA
        with self.timer.span("eval_loss"):
            self.evals.loss_other(epoch, gs, eval_ordinal)
        with self.timer.span("eval_localization"):
            self.evals.localization(epoch, gs, self.cfg.other_ref_set,
                                    self.cfg.other_query_set, "other", eval_ordinal)
            self.evals.localization(epoch, gs, self.cfg.local_ref_set,
                                    self.cfg.local_query_set, "local", eval_ordinal)

    # ------------------------------------------------------------ resume
    def resume_latest(self, role: str = "rolling") -> bool:
        """Take up the newest ``role`` checkpoint of this run directory:
        model, optimizer, step, generators, streaming PCAs and position.
        False when there is none."""
        step = self.ckpts.latest(role)
        if step is None:
            return False
        self.state, pca_sd, loss_pca_sd, extras = self.ckpts.restore(role, step, self.state)
        # a checkpoint written before the first refresh holds no PCA: keep the fresh one
        if pca_sd is not None:
            self.pca = StreamingPCA.from_state_dict(pca_sd)
        if loss_pca_sd is not None:
            self.loss_pca = StreamingPCA.from_state_dict(loss_pca_sd)
        if extras is not None:
            self.rng = numpy_rng_from_array(extras["sampler_rng"])
            self.eval_rng = numpy_rng_from_array(extras["eval_rng"])
            self.start_epoch = self._current_epoch = int(extras["epoch"])
            if int(extras["seg_step0"]) >= 0:
                self._resume_ctx = {key: int(extras[key])
                                    for key in ("seg_step0", "consumed", "mining_count")}
        self.global_step = int(self.state.step)
        self.log(f"Resumed from {role}@{step}")
        return True

    def close(self) -> None:
        self._join_mining(raise_error=False)
        self._pool.shutdown(wait=False)
        self.ckpts.wait()
        self.ckpts.close()
        self.log.close()
