"""The training loop, the counterpart of
``soft_contrastive_learning_tpu/train/trainer.py`` with the single-step path
of ``train/segment.py::run_segment``.

Per epoch: the source's shuffled metadata and anchors; the uint8 image set
resident on the device (``data/device_pool.py``) when it is on and fits
``device_pool_max_bytes``; and segments between mining boundaries (the
steps divisible by ``mining_step``). At each boundary the mining cache is
refreshed synchronously. Each segment samples from a child generator seeded
by a draw from the trainer's generator, so the sample stream matches the
JAX trainer's. Steps stride by ``tuples_per_batch`` over the anchors.

Within a segment nothing waits for the card: the host samples batch i+1
while the card runs step i, and the losses (with the PN losses' ``loss_pos``
and ``loss_neg``) are fetched in one transfer at the segment's end, or
before an eval so that the records stay in order, and written as JSONL
(``metrics_local.jsonl``, the records of ``core/logging.py::MetricsWriter``)
with ``global_step`` counted from 1.
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
"""

from __future__ import annotations

import os
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
from soft_contrastive_learning_torch.core.logging import MetricsWriter, RunLogger
from soft_contrastive_learning_torch.data.device_pool import build_pool
from soft_contrastive_learning_torch.data.pipeline import (
    Prefetcher,
    assemble_batch,
    load_images_standard,
    pad_to_multiple,
)
from soft_contrastive_learning_torch.losses.registry import build_loss
from soft_contrastive_learning_torch.models.model import EmbeddingNet, init_params
from soft_contrastive_learning_torch.pca.async_updater import AsyncPCAUpdater
from soft_contrastive_learning_torch.pca.incremental import StreamingPCA
from soft_contrastive_learning_torch.sampling.tuples import TupleSampler
from soft_contrastive_learning_torch.train.eval_hooks import EvalHooks
from soft_contrastive_learning_torch.train.mining_manager import MiningManager
from soft_contrastive_learning_torch.train.step import (
    build_embed_step,
    build_eval_loss_step,
    build_train_step,
    init_train_state,
)
from soft_contrastive_learning_torch.utils.meta import get_xy, get_yaw, image_keys


class Trainer:
    """``params``: an initial ``EmbeddingNet`` state_dict (for example
    ``models/weights.py::load_trained_params``); default: a fresh
    ``init_params`` draw from ``cfg.seed``. ``save_plots``: the evals also
    write tolerance-curve PDFs (matplotlib) and triptych PNGs (OpenCV)."""

    def __init__(self, cfg: TrainConfig, source, out_dir: Optional[str] = None,
                 device: str | torch.device = "cuda",
                 params: Optional[Mapping[str, torch.Tensor]] = None,
                 save_plots: bool = False):
        self.cfg = cfg
        self.source = source
        self.save_plots = save_plots
        self.device = resolve_device(device)
        self.out_dir = out_dir or cfg.out_dir or "."
        os.makedirs(self.out_dir, exist_ok=True)
        cfg.save(os.path.join(self.out_dir, "config.json"))
        self.log = RunLogger(self.out_dir)
        self.writers = {"local": MetricsWriter(self.out_dir, "local"),
                        "other": MetricsWriter(self.out_dir, "other")}
        self.ckpts = RunCheckpoints(self.out_dir, max_to_keep=cfg.max_to_keep)

        model = EmbeddingNet(cfg.model)
        model.load_state_dict(params if params is not None else init_params(cfg.model, cfg.seed))
        self.state = init_train_state(cfg, model.to(self.device))
        loss_fn = build_loss(cfg.loss, cfg.tuples, cfg.tuples_per_batch)
        self.train_step = build_train_step(cfg, loss_fn)
        self.train_step_pooled = build_train_step(cfg, loss_fn, image_pool=True)
        self.eval_loss_step = build_eval_loss_step(cfg, model, loss_fn)
        self.embed_step = build_embed_step(model)
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
        return {k: float(v) if np.ndim(v) == 0 else torch.from_numpy(v).to(self.device)
                for k, v in batch.items()}

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

    def extract_features(self, meta, indices, full_feats: bool = False) -> torch.Tensor:
        """Embed ``meta`` rows ``indices`` on the device in batches of
        ``images_per_batch`` (the last one padded): (len(indices), D)
        float32 on the device, the raw descriptors (``full_out``) with
        ``full_feats``, else the output; with ``reduction='pca'`` and the
        PCA initialized the output is whitened by it on the host, as the
        JAX trainer does."""
        b = self.cfg.images_per_batch
        idx = pad_to_multiple(np.asarray(indices, dtype=int), b)
        pool = self._image_pool or None
        chunks = []
        for start in range(0, len(idx), b):
            keys = image_keys(meta, idx[start : start + b])
            rows = pool.rows_for_keys(keys) if pool is not None else None
            if rows is not None:  # gather on the device
                images = pool.array.index_select(0, torch.from_numpy(rows).to(self.device))
            else:
                images = torch.from_numpy(
                    load_images_standard(self.source, keys, self.cfg, self._pool)).to(self.device)
            output, full = self.embed_step(images)
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
            pool = build_pool(self.source, meta, cfg, self.device,
                              max_bytes=cfg.device_pool_max_bytes, log=self.log, pool=self._pool)
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
            if boundary[seg_start]:
                # on a resume this rebuilds the cache with the restored weights, and
                # leaves the restored PCA alone: it holds this boundary's update
                self.log("Caching features for hard negative mining.")
                self.mining.refresh(epoch, int(steps[seg_start]), mining_count, meta,
                                    anchor_indices,
                                    update_pca=not (resume_ctx is not None
                                                    and int(steps[seg_start]) <= resume_step0))
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
                                               offset, suppress_first)
            seg_start = seg_end
        self._seg_ctx = None

    def _sample(self, sampler: TupleSampler, anchor_indices, s: int):
        cfg = self.cfg
        anchors = anchor_indices[s : s + cfg.tuples_per_batch]
        if len(anchors) < cfg.tuples_per_batch:
            anchors = pad_to_multiple(anchors, cfg.tuples_per_batch)
        return sampler.sample(anchors, use_hard=True, cache=self.mining_cache)

    def _run_segment(self, epoch: int, seg_steps, anchor_indices, meta, sampler: TupleSampler,
                     offset: int = 0, suppress_first: bool = False) -> bool:
        """The segment's steps from item ``offset`` on. ``suppress_first``
        holds back the first item's eval and part save: after a resume they
        fired at the saved step already. Returns the flag for the next
        segment (False once an item was reached)."""
        cfg = self.cfg
        pool_rows = self._pool_rows
        updater = None
        if cfg.async_pca and (self.pca is not None or self.loss_pca is not None):
            updater = AsyncPCAUpdater(self.pca, self.loss_pca)
        self._updater = updater
        prefetch = None
        if pool_rows is None:  # host-fed: sample and decode ahead on the producer thread
            def build(j: int):
                sample = self._sample(sampler, anchor_indices, int(seg_steps[offset + j]))
                if sample is None:
                    return None, None
                return sample, assemble_batch(cfg, self.source, meta, sample.indices,
                                              sample.payload, epoch, self._pool)

            prefetch = Prefetcher(build, len(seg_steps) - offset)
            batches = iter(prefetch)
        records = []  # (global_step, metrics: device losses and the lr)
        try:
            for i in range(offset, len(seg_steps)):
                s = int(seg_steps[i])
                self._seg_ctx["consumed"] = i  # items behind us; a resume trains this one
                side_effects, suppress_first = not suppress_first, False
                if side_effects and s % cfg.eval_step == 0:
                    self._write_train_metrics(records)
                    self._run_eval(epoch, s // max(cfg.eval_step, 1))
                if side_effects and s % cfg.save_step == 0:
                    self._write_train_metrics(records)
                    self._save("part", self.global_step)
                if prefetch is not None:
                    sample, host_batch = next(batches)
                else:
                    sample = self._sample(sampler, anchor_indices, s)
                if sample is None:
                    self.log("Faulty training batch... skipping.")
                    continue
                snaps = updater.feed_states() if updater is not None else None
                if prefetch is None:
                    batch = self._to_device({"image_idx": pool_rows[sample.indices.reshape(-1)],
                                             "epoch": np.float32(epoch), **sample.payload})
                    self.state, metrics = self.train_step_pooled(
                        self.state, self._augment_batch(batch, snaps), self._image_pool.array)
                else:
                    self.state, metrics = self.train_step(
                        self.state, self._augment_batch(self._to_device(host_batch), snaps))
                self.used_images.update(sample.used_indices)
                self.global_step += 1
                self._update_pca(metrics.pop("pca_in", None), metrics.pop("loss_pca_in", None))
                records.append((self.global_step, metrics))
        except BaseException:
            if updater is not None:  # the original error goes on; the worker's is logged
                try:
                    updater.close()
                except Exception as drain_err:
                    self.log(f"PCA worker error during unwind: {drain_err}")
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
        return suppress_first

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
        """A checkpoint with every update submitted so far applied."""
        if self._updater is not None:
            self._updater.drain()
        self.ckpts.save(role, step, self.state, self._extras(), pca=self._pca_sd(),
                        loss_pca=self._loss_pca_sd())

    def _write_train_metrics(self, records: list) -> None:
        """Fetch the pending steps' losses (with the PN losses' ``loss_pos``
        and ``loss_neg``) in one device-to-host transfer, log and write
        them, and empty ``records``."""
        if not records:
            return
        keys = ("loss", "loss_pos", "loss_neg") if self.cfg.loss.pn_loss else ("loss",)
        values = torch.stack([m[k] for _, m in records for k in keys]).reshape(
            len(records), len(keys)).tolist()
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
        self.evals.loss_other(epoch, gs, eval_ordinal)
        self.evals.localization(epoch, gs, self.cfg.other_ref_set, self.cfg.other_query_set,
                                "other", eval_ordinal)
        self.evals.localization(epoch, gs, self.cfg.local_ref_set, self.cfg.local_query_set,
                                "local", eval_ordinal)

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
        self._pool.shutdown(wait=False)
        self.ckpts.wait()
        self.ckpts.close()
        self.log.close()
