"""The training loop, the counterpart of
``soft_contrastive_learning_tpu/train/trainer.py`` with the single-step path
of ``train/segment.py::run_segment``.

Per epoch: the source's shuffled metadata and anchors; the uint8 image set
resident on the device (``data/device_pool.py``); and segments between
mining boundaries (the steps divisible by ``mining_step``). At each
boundary the mining cache is refreshed synchronously. Each segment samples
from a child generator seeded by a draw from the trainer's generator, so the
sample stream matches the JAX trainer's. Steps stride by
``tuples_per_batch`` over the anchors.

Within a segment nothing waits for the card: the host samples batch i+1
while the card runs step i, and the segment's losses are fetched in one
transfer at its end and written as JSONL (``metrics_local.jsonl``, the
records of ``core/logging.py::MetricsWriter``) with ``global_step`` counted
from 1.

Not in this slice: the eval hooks and checkpoints. Where the JAX loop runs
them (every ``eval_step``/``save_step`` step and at each epoch's end), the
port logs one line naming the slice that brings them.
"""

from __future__ import annotations

import os
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from soft_contrastive_learning_torch.core.config import TrainConfig, resolve_device
from soft_contrastive_learning_torch.core.logging import MetricsWriter, RunLogger
from soft_contrastive_learning_torch.data.device_pool import build_pool
from soft_contrastive_learning_torch.data.pipeline import (
    assemble_batch,
    load_images_standard,
    pad_to_multiple,
)
from soft_contrastive_learning_torch.losses.registry import build_loss
from soft_contrastive_learning_torch.models.model import EmbeddingNet, init_params
from soft_contrastive_learning_torch.sampling.tuples import TupleSampler
from soft_contrastive_learning_torch.train.mining_manager import MiningManager
from soft_contrastive_learning_torch.train.step import (
    build_embed_step,
    build_train_step,
    init_train_state,
)
from soft_contrastive_learning_torch.utils.meta import get_xy, get_yaw, image_keys

EVAL_LATER = ("eval hooks (train/eval_hooks.py: held-out loss, localization) come with "
              "the next slice of the port; skipped at step {}")
SAVE_LATER = ("checkpoints (checkpoints/manager.py) come with a later slice of the "
              "port; no '{}' checkpoint at step {}")


class Trainer:
    """``params``: an initial ``EmbeddingNet`` state_dict (for example
    ``models/weights.py::load_trained_params``); default: a fresh
    ``init_params`` draw from ``cfg.seed``."""

    def __init__(self, cfg: TrainConfig, source, out_dir: Optional[str] = None,
                 device: str | torch.device = "cuda",
                 params: Optional[Mapping[str, torch.Tensor]] = None):
        self.cfg = cfg
        self.source = source
        self.device = resolve_device(device)
        self.out_dir = out_dir or cfg.out_dir or "."
        os.makedirs(self.out_dir, exist_ok=True)
        cfg.save(os.path.join(self.out_dir, "config.json"))
        self.log = RunLogger(self.out_dir)
        self.writer = MetricsWriter(self.out_dir, "local")

        model = EmbeddingNet(cfg.model)
        model.load_state_dict(params if params is not None else init_params(cfg.model, cfg.seed))
        self.state = init_train_state(cfg, model.to(self.device))
        loss_fn = build_loss(cfg.loss, cfg.tuples, cfg.tuples_per_batch)
        self.train_step = build_train_step(cfg, loss_fn)
        self.train_step_pooled = build_train_step(cfg, loss_fn, image_pool=True)
        self.embed_step = build_embed_step(model)
        # None until built; False = unavailable (over the byte budget)
        self._image_pool = None
        self._pool_rows = None  # meta row -> pool row, for the current epoch

        self.mining = MiningManager(self)
        self.mining_cache = self.mining.cache
        self.rng = np.random.default_rng(cfg.seed)
        self.global_step = 0
        self.used_images: set = set()

    # ------------------------------------------------------------ helpers
    def _sampler_for(self, meta, rng=None) -> TupleSampler:
        return TupleSampler(self.cfg.tuples, self.cfg.loss, self.cfg.tuple_shape,
                            get_xy(meta), get_yaw(meta), rng=rng if rng is not None else self.rng)

    def _to_device(self, batch: Dict[str, np.ndarray]) -> Dict[str, object]:
        return {k: float(v) if np.ndim(v) == 0 else torch.from_numpy(v).to(self.device)
                for k, v in batch.items()}

    def extract_features(self, meta, indices) -> torch.Tensor:
        """Embed ``meta`` rows ``indices`` on the device in batches of
        ``images_per_batch`` (the last one padded): (len(indices), D)
        float32, left on the device."""
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
                    load_images_standard(self.source, keys, self.cfg)).to(self.device)
            output, _ = self.embed_step(images)
            chunks.append(output)
        return torch.cat(chunks)[: len(indices)].float()

    def _ensure_image_pool(self, meta) -> None:
        """Build (once) and remap (per epoch) the device image pool; leaves
        ``_pool_rows`` None when there is none, and the host feeds images."""
        cfg = self.cfg
        self._pool_rows = None
        if not cfg.device_image_pool or self._image_pool is False:
            return
        if self._image_pool is None:
            pool = build_pool(self.source, meta, cfg, self.device,
                              max_bytes=cfg.device_pool_max_bytes, log=self.log)
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
        for epoch in range(self.cfg.max_epoch):
            self.log(f"**** EPOCH {epoch} ****")
            self.used_images.clear()
            self.train_one_epoch(epoch)
            self.log(SAVE_LATER.format("epoch", self.global_step))

    def train_one_epoch(self, epoch: int) -> None:
        cfg = self.cfg
        meta = self.source.epoch_meta(cfg.local_ref_set, epoch)
        self._ensure_image_pool(meta)
        anchor_indices = np.asarray(
            self.source.anchor_indices(cfg.local_ref_set, cfg.train_ref_r, epoch), dtype=int)
        steps = np.arange(0, len(anchor_indices), cfg.tuples_per_batch)
        boundary = steps % cfg.mining_step == 0
        mining_count = 0
        seg_start = 0
        while seg_start < len(steps):
            if boundary[seg_start]:
                self.log("Caching features for hard negative mining.")
                self.mining.refresh(epoch, int(steps[seg_start]), mining_count, meta,
                                    anchor_indices)
                mining_count += 1
            later = np.flatnonzero(boundary[seg_start + 1 :])
            seg_end = seg_start + 1 + (int(later[0]) if len(later) else len(steps))
            # the segment's generator is seeded by a draw, as the JAX trainer does
            seg_rng = np.random.default_rng(int(self.rng.integers(np.iinfo(np.int64).max)))
            self._run_segment(epoch, steps[seg_start:seg_end], anchor_indices, meta,
                              self._sampler_for(meta, rng=seg_rng))
            seg_start = seg_end

    def _run_segment(self, epoch: int, seg_steps, anchor_indices, meta,
                     sampler: TupleSampler) -> None:
        cfg = self.cfg
        pool_rows = self._pool_rows
        records = []  # (global_step, device loss, lr)
        for s in map(int, seg_steps):
            if s % cfg.eval_step == 0:
                self.log(EVAL_LATER.format(s))
            if s % cfg.save_step == 0:
                self.log(SAVE_LATER.format("part", self.global_step))
            anchors = anchor_indices[s : s + cfg.tuples_per_batch]
            if len(anchors) < cfg.tuples_per_batch:
                anchors = pad_to_multiple(anchors, cfg.tuples_per_batch)
            sample = sampler.sample(anchors, use_hard=True, cache=self.mining_cache)
            if sample is None:
                self.log("Faulty training batch... skipping.")
                continue
            if pool_rows is not None:
                batch = self._to_device({"image_idx": pool_rows[sample.indices.reshape(-1)],
                                         "epoch": np.float32(epoch), **sample.payload})
                self.state, metrics = self.train_step_pooled(self.state, batch,
                                                             self._image_pool.array)
            else:
                batch = self._to_device(assemble_batch(cfg, self.source, meta, sample.indices,
                                                       sample.payload, epoch))
                self.state, metrics = self.train_step(self.state, batch)
            self.used_images.update(sample.used_indices)
            self.global_step += 1
            records.append((self.global_step, metrics["loss"], metrics["learning_rate"]))
        if records:  # one device-to-host transfer per segment
            losses = torch.stack([loss for _, loss, _ in records]).tolist()
            for (step, _, lr), loss in zip(records, losses):
                self.log(f"Train batch loss: {loss}")
                self.writer.scalars({"loss": loss, "learning_rate": lr}, step)

    def close(self) -> None:
        self.log.close()
