"""The trainer's own loop: ``Trainer.train_one_epoch`` epochs back to back
through the window, on the device image pool fed from the decoded cache,
each epoch with its mining refreshes, its eval hooks and its checkpoint,
as a training run does them. The window opens at an epoch's start (a
device sync) and closes at the first step boundary after ``seconds``,
with a device sync; its rate is the steps' images over its length.

Set-up builds the one trainer that the window drives: the city's decoded
cache (kept under the cell's work directory for the later runs), the
weights from the seed, then epoch 0 up to ``warm_steps`` steps through the
window's own call (``Trainer._dispatch_single``), which warms every shape
(the refresh's, the eval's, the step's) and records what the reference
follows: the first three steps' batches and losses, the first gradient
from Adam's state after step 1, the parameters after step 3, and rows of
the first refresh's descriptors with the miner's neighbour order among
them.

Parameters: ``warm_steps``, ``mining_rows`` (refresh rows compared)."""

from __future__ import annotations

import gc
import math
import shutil
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import nullcontext

from typing import Optional

import numpy as np

from benchmarks.harness import Outcome, SpanLog
from benchmarks.metrics._trace import DeviceProfiler

FOLLOWED = 3  # steps the reference follows


class _WindowClosed(Exception):
    """Raised at a step boundary to end a run of epochs."""


def train_config(config: dict, seed: int):
    from soft_contrastive_learning_torch.core.config import (
        LossConfig, ModelConfig, TrainConfig, TupleConfig)

    return TrainConfig(model=ModelConfig(**config["model"]), tuples=TupleConfig(**config["tuples"]),
                       loss=LossConfig(**config["loss"]), seed=int(seed), **config["train"])


def city_radius(num_points: int) -> float:
    """~8 m between poses, inside the positives' 15 m."""
    return num_points * 8.0 / (2 * np.pi)


class Recorder:
    """Wraps the trainer's per-step call: stops the loop where asked, counts
    the steps, and records what the reference follows."""

    def __init__(self, tr, mining_rows: int, seed: int, spans):
        self.tr = tr
        self.steps = 0
        self.stop_after = None
        self.deadline = None
        self.batches = []  # the first steps' (city indices, epoch)
        self.losses = []
        self.grad1 = None
        self.params3 = None
        self.mining = None  # (city indices, descriptors) of the first refresh's rows
        self.order = None  # those rows' neighbour order among themselves, as the miner keeps it
        self._mining_pos = None  # their positions in the refresh
        self._mining_rows = mining_rows
        self._rng = np.random.default_rng(seed)
        self._in_refresh = False
        self._dispatch = tr._dispatch_single
        self._extract = tr.extract_features
        self._refresh = tr._mining_refresh
        self._keep_order = tr.mining.cache.refresh
        tr._dispatch_single = self.dispatch
        tr.extract_features = self.extract_features
        tr._mining_refresh = self.refresh
        tr.mining.cache.refresh = self.keep_order
        if spans is not None:
            self.dispatch = spans.wrap("step", self.dispatch)
            tr._dispatch_single = self.dispatch
            tr._mining_refresh = spans.wrap("mining_refresh", self.refresh)
            tr._run_eval = spans.wrap("eval", tr._run_eval)
            tr._save = spans.wrap("ckpt_save", tr._save)

    def dispatch(self, item, updater, records) -> None:
        if (self.stop_after is not None and self.steps >= self.stop_after) or (
                self.deadline is not None and time.perf_counter() >= self.deadline):
            raise _WindowClosed()
        n = self.steps
        if n < FOLLOWED:
            sample, host_batch = item
            epoch = int(host_batch["epoch"])
            meta = self.tr.source.epoch_meta(self.tr.cfg.local_ref_set, epoch)
            idx = np.asarray(meta["idx"], dtype=int)[sample.indices.reshape(-1)]
            self.batches.append((idx, epoch))
        self._dispatch(item, updater, records)
        self.steps += 1
        if n < FOLLOWED:
            self.losses.append(records[-1][1]["loss"].detach().clone())
            st = self.tr.state
            if n == 0:
                beta1 = st.optimizer.param_groups[0]["betas"][0]
                self.grad1 = {
                    k: (st.optimizer.state[p]["exp_avg"] / (1 - beta1)).clone()
                    if p in st.optimizer.state else p.detach() * 0
                    for k, p in st.model.named_parameters()}
            if n == FOLLOWED - 1:
                self.params3 = {k: p.detach().clone() for k, p in st.model.named_parameters()}

    def refresh(self, *args, **kwargs):
        self._in_refresh = True
        try:
            return self._refresh(*args, **kwargs)
        finally:
            self._in_refresh = False

    def extract_features(self, meta, indices, *args, **kwargs):
        feats = self._extract(meta, indices, *args, **kwargs)
        if self._in_refresh and self.mining is None:
            rows = np.sort(self._rng.choice(len(indices), self._mining_rows, replace=False))
            idx = np.asarray(meta["idx"], dtype=int)[np.asarray(indices)[rows]]
            self.mining = (idx, feats[rows].detach().clone())
            self._mining_pos = rows
        return feats

    def keep_order(self, indices, order) -> None:
        """The mining cache's refresh: on the first, the compared rows'
        neighbour order restricted to themselves (indices into the rows)."""
        if self.order is None and self._mining_pos is not None:
            at = {int(p): j for j, p in enumerate(self._mining_pos)}
            full = np.asarray(order)
            self.order = [[at[int(c)] for c in full[p] if int(c) in at]
                          for p in self._mining_pos]
        return self._keep_order(indices, order)


def run_epochs(tr, rec: Recorder, first_epoch: int) -> int:
    """Epochs from ``first_epoch`` until the recorder closes the loop;
    returns the next epoch."""
    epoch = first_epoch
    try:
        while True:
            tr.train_one_epoch(epoch)
            epoch += 1
    except _WindowClosed:
        tr._sync()
    return epoch + 1


def build(cell, spans=None):
    """Set-up: the city's decoded cache, the weights from the seed, the
    trainer, and epoch 0 up to ``warm_steps`` steps. Returns (trainer,
    recorder, config, initial weights, the next epoch)."""
    from benchmarks.weights import make_params
    from soft_contrastive_learning_torch.data.decoded_cache import (
        CachedDecodedSource, cache_training_sets)
    from soft_contrastive_learning_torch.data.pipeline import ToyCitySource
    from soft_contrastive_learning_torch.train.trainer import Trainer

    c = cell.config
    cfg = train_config(c, cell.seed)
    city = c["city"]
    src = ToyCitySource(num_points=city["train_poses"], radius=city_radius(city["train_poses"]),
                        img_h=cfg.model.image_height, img_w=cfg.model.image_width,
                        seed=city["seed"])
    cache_dir = cell.work_dir / f"toycity_{city['train_poses']}_{city['seed']}"
    cache_training_sets(src, ["train_ref", "test_ref"], cfg.model.image_height,
                        cfg.model.image_width, keep_aspect=cfg.model.vlad_cores > 0,
                        cache_dir=str(cache_dir),
                        cluster_sets=[("train_ref", cfg.eval_ref_r), ("test_ref", cfg.eval_ref_r)],
                        log=lambda *a: None)
    src = CachedDecodedSource(src, str(cache_dir))
    run_dir = cell.work_dir / "run"
    shutil.rmtree(run_dir, ignore_errors=True)
    params0 = make_params(cell.seed, cell.device, cfg.model.vlad_cores)
    tr = Trainer(cfg, src, out_dir=str(run_dir), device=cell.device, params=params0)
    rec = Recorder(tr, int(cell.params["mining_rows"]), cell.seed, spans)
    try:
        rec.stop_after = int(cell.params["warm_steps"])
        epoch = run_epochs(tr, rec, 0)
        if len(rec.losses) < FOLLOWED or rec.mining is None or rec.order is None:
            raise RuntimeError("set-up did not reach the steps the reference follows")
    except BaseException:
        tr.close()
        raise
    return tr, rec, cfg, params0, epoch


def release(cell, tr, rec):
    """Close the trainer and free its state; returns the program's record
    (losses, first gradient, parameters after the followed steps, refresh
    rows), the followed batches and the refresh rows' city indices."""
    import torch

    tr.close()
    prog = {"losses": [float(v) for v in rec.losses], "grad1": rec.grad1,
            "params3": rec.params3, "mining": rec.mining[1], "order": rec.order}
    out = prog, rec.batches, rec.mining[0]
    rec.tr = None
    gc.collect()
    if cell.device.type == "cuda":
        torch.cuda.empty_cache()
    shutil.rmtree(cell.work_dir / "run", ignore_errors=True)
    return out


def run(cell) -> Outcome:
    import torch

    spans = SpanLog() if cell.trace else None
    tr, rec, cfg, params0, epoch = build(cell, spans)
    try:
        cuda = cell.device.type == "cuda"
        if cuda:
            torch.cuda.reset_peak_memory_stats(cell.device)
        refreshes0 = tr.timer.summary().get("mining_refresh", {})
        steps0 = rec.steps
        rec.stop_after = None
        if spans is not None:
            spans.spans.clear()
        prof = DeviceProfiler() if cell.trace and cell.device.type == "cuda" else nullcontext()
        with prof:
            t0_wall = time.time()
            t0 = time.perf_counter()
            rec.deadline = t0 + cell.seconds
            run_epochs(tr, rec, epoch)
            window_s = time.perf_counter() - t0
        setup_s = t0_wall - cell.started
        steps = rec.steps - steps0
        refreshes1 = tr.timer.summary().get("mining_refresh", {})
        peak = int(torch.cuda.max_memory_allocated(cell.device)) if cuda else 0
        if spans is not None:  # the window's share in the loop's parts besides its steps
            print("window %.3f s; spans: %s" % (window_s, {
                n: round(spans.total_s(n), 4) for n in ("step", "mining_refresh", "eval",
                                                        "ckpt_save")}), file=sys.stderr)
    finally:
        prog, batches, mining_idx = release(cell, tr, rec)
    del tr, rec
    steps_in, lrs, mining_images = reference_inputs(cfg, cell.config["city"], batches,
                                                    mining_idx, cell.device)
    ref = reference_record(cfg, params0, steps_in, lrs, mining_images)
    limits = cell.params["limits"]
    detail: dict = {}
    numbers = gaps(params0, prog, ref, detail)
    checks = [(name, value, limits[name]) for name, value in numbers.items() if name in limits]
    print(f"followed steps: {numbers} {detail}", file=sys.stderr)
    images = steps * cfg.images_per_batch
    refresh_n = refreshes1.get("count", 0) - refreshes0.get("count", 0)
    return Outcome(
        correct=all(v <= lim for _, v, lim in checks) and steps > 0,
        attempted=steps, failed=0,
        e2e={"train_img_per_s": images / window_s, "setup_s": setup_s},
        checks=checks,
        readings={"kind": "train", "spans": spans, "trace": getattr(prof, "trace", None),
                  "steps": steps, "window_s": window_s, "images": images,
                  "refreshes": refresh_n,
                  "refresh_s": refreshes1.get("total_s", 0.0) - refreshes0.get("total_s", 0.0),
                  "refresh_images": refresh_n * (cfg.mining_cache_size + cfg.mining_step),
                  "batch": cfg.images_per_batch, "config": cell.config},
        memory_peak_bytes=peak, trace=getattr(prof, "trace", None))


def learning_rate(cfg, epoch: int) -> float:
    """The epoch-decay schedule: max(base * f^floor(epoch / freq), min)."""
    return max(cfg.base_lr * cfg.lr_down_factor ** math.floor(epoch / cfg.lr_down_frequency),
               cfg.minimal_lr)


def reference_inputs(cfg, city_cfg: dict, batches, mining_idx, device):
    """The reference's own views and metric distances of the followed
    batches' images (city indices), and its views of the refresh rows."""
    import torch

    from benchmarks.reference.toycity import City

    n = city_cfg["train_poses"]
    city = City(n, city_radius(n), cfg.model.image_height, cfg.model.image_width,
                city_cfg["seed"])
    order = [int(i) for idx, _ in batches for i in idx] + [int(i) for i in mining_idx]
    with ThreadPoolExecutor(8) as pool:
        images = torch.from_numpy(np.stack(list(pool.map(city.image, order)))).to(device)
    steps, lrs, at = [], [], 0
    for idx, epoch in batches:
        xy = city.xy(np.asarray(idx))
        geo = np.sqrt(np.maximum(((xy[:, None] - xy[None]) ** 2).sum(-1), 0.0))
        steps.append((images[at : at + len(idx)],
                      torch.from_numpy(geo.astype(np.float32)).to(device)))
        lrs.append(learning_rate(cfg, epoch))
        at += len(idx)
    return steps, lrs, images[at:]


def reference_record(cfg, params0, steps, lrs, mining_images, fp8: bool = False,
                     half: bool = False, negate: bool = False) -> dict:
    """The reference's losses, first gradient, parameters after the followed
    steps, refresh descriptors and their neighbour order, in fp32 (``fp8``:
    the control; ``half``: the fault of a loss over the first half of the
    batch; ``negate``: the fault of each update applied the other way)."""
    import torch

    from benchmarks.reference.model import descriptor_fp32, full_fp32
    from benchmarks.reference.train import adam_steps, own_order

    losses, grad1, params3 = adam_steps(params0, steps, lrs, cfg.loss.alpha, cfg.loss.beta,
                                        fp8, half, negate)
    with torch.no_grad(), full_fp32():
        mining = descriptor_fp32(params0, mining_images, fp8)
    return {"losses": losses, "grad1": grad1, "params3": params3, "mining": mining,
            "order": own_order(mining)}


def gaps(params0, prog: dict, ref: dict, detail: Optional[dict] = None) -> dict:
    """The numbers compared, over the leaves that the reference's gradient
    moves: the worst step's relative loss gap; the median leaf's gap of the
    first gradient's norm (the worst leaf's swings with the MS mining's
    choices near its thresholds: ``PERF.md``); the worst leaf's gap of the
    change after the followed steps; the median leaf's share of settled
    elements changed the other way (``sign_gaps``; the worst leaf's is a
    share of a few elements in the smallest leaves); the largest distance
    between a refresh row's descriptors; and how far the miner's neighbour
    order among those rows strays from the reference's (``order_gap``). A
    leaf's gap is measured against the larger of its and the median leaf's
    reference norm."""
    from benchmarks.reference.train import leaf_gaps, moving_leaves, order_gap, sign_gaps

    keep = moving_leaves(ref["grad1"])
    losses = [abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"])]
    grad = leaf_gaps(prog["grad1"], ref["grad1"], keep)
    prog_change = {k: prog["params3"][k] - params0[k] for k in keep}
    ref_change = {k: ref["params3"][k] - params0[k] for k in keep}
    change = leaf_gaps(prog_change, ref_change, keep)
    sign = sign_gaps(prog_change, ref_change, keep)
    mining_gap = float((prog["mining"].double() - ref["mining"].double()).norm(dim=1).max())
    out = {"loss_gap": max(losses), "grad_median_gap": float(np.median(list(grad.values()))),
           "change_gap": max(change.values()),
           "sign_median_gap": float(np.median(list(sign.values()))),
           "mining_gap": mining_gap, "order_gap": order_gap(prog["order"], ref["mining"])}
    if detail is not None:  # where the numbers come from: each step, the worst leaves
        detail.update(loss_gaps=losses,
                      grad_leaves=sorted(grad.items(), key=lambda kv: -kv[1])[:4],
                      change_leaves=sorted(change.items(), key=lambda kv: -kv[1])[:4],
                      sign_leaves=sorted(sign.items(), key=lambda kv: -kv[1])[:4])
    return out


def control_readings(cell) -> dict:
    """One seed's readings of the numbers compared, at the cell's size: the
    program's (set-up's followed steps, no window), the control's (the
    reference through float8 in the program's place) and the faults' (the
    reference with the loss over the first half of the batch; with each
    update applied the other way; with the miner's order reversed), each
    against the fp32 reference."""
    tr, rec, cfg, params0, _ = build(cell)
    prog, batches, mining_idx = release(cell, tr, rec)
    del tr, rec
    steps_in, lrs, mining_images = reference_inputs(cfg, cell.config["city"], batches,
                                                    mining_idx, cell.device)
    ref = reference_record(cfg, params0, steps_in, lrs, mining_images)
    fp8 = reference_record(cfg, params0, steps_in, lrs, mining_images, fp8=True)
    half = reference_record(cfg, params0, steps_in, lrs, mining_images, half=True)
    negated = reference_record(cfg, params0, steps_in, lrs, mining_images, negate=True)
    reversed_order = dict(ref, order=[row[::-1] for row in ref["order"]])
    out = {}
    for name, rec in (("program", prog), ("control_fp8", fp8), ("fault_half_batch", half),
                      ("fault_negated_update", negated),
                      ("fault_reversed_order", reversed_order)):
        detail: dict = {}
        out[name] = dict(gaps(params0, rec, ref, detail), detail=detail)
    return out
