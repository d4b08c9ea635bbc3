"""End-to-end train-loop throughput benchmark, the port's counterpart of
``soft_contrastive_learning_tpu/bench_train.py`` (the same configuration,
protocol and JSON keys).

It measures what ``benchmark.py`` (the embed forward) does not: the training
loop as it runs, sampler, image source (the decoded-uint8 cache or the
decode), the device image pool, the step and the mining refresh, at the
flagship's configuration on a toy city. One JSON line:

* ``sustained_step_ms``: the trainer's ``segment_steady`` windows (a device
  sync at each segment's start and end, in-segment eval and save taken out)
  per step; a synchronous refresh falls between windows;
* ``with_mining_step_ms`` / ``with_mining_imgs_per_sec``: the timed epoch's
  wall per step with only eval and save taken out, the refresh included;
* ``device_step_ms``: ``scan_iters`` eager steps on one resident batch
  between two CUDA events, one sync (JAX: a ``lax.scan`` of them in one
  call). The model's and the optimizer's state are saved before those
  steps and restored after, so that the timed epochs start from the state
  JAX's would (its scan leaves ``tr.state`` alone);
* ``device_busy_frac``: device_step_ms / sustained_step_ms.

Sync against async mining (``async_mining``): compare the with_mining pair,
which charges both for the refresh; the sustained window holds an async
refresh's embeds (the overlap is the feature) and not a synchronous one.
``scalar_fetches`` / ``scalar_fetch_s`` count the trainer's fetches of the
train losses during the timed epoch (``Trainer.scalar_fetches``).

``steps_per_dispatch`` K groups the epochs' steps K to a dispatch
(``train/step.py::build_train_step_scan``); ``detail.steps_per_dispatch``
reports it.

    python -m soft_contrastive_learning_torch.bench_train [--async_mining] [--no_cache] \
        [--steps_per_dispatch K]
"""

from __future__ import annotations

import copy
import json
import os
import shutil
import tempfile
import time
from typing import Optional

import numpy as np
import torch


def flagship_toy_config(tuples_per_batch: int, num_points: int, steps_per_dispatch: int = 1,
                        async_mining: bool = False):
    """The flagship's model, loss and tuples (180x240, NetVLAD-64, bf16
    convs, wms, 2 tuples of 1+12+12 = 50 images a step) at toy-city
    cadences; the eval hooks fire once an epoch, at step 0."""
    from soft_contrastive_learning_torch.core.config import (
        LossConfig, ModelConfig, TrainConfig, TupleConfig)

    return TrainConfig(
        model=ModelConfig(), tuples=TupleConfig(), loss=LossConfig(name="wms"),
        tuples_per_batch=tuples_per_batch, max_epoch=1, mining_step=250,
        mining_cache_size=min(1000, num_points), eval_step=10**8, save_step=10**8,
        num_eval_queries=10, eval_ref_r=5, train_ref_r=1,
        steps_per_dispatch=steps_per_dispatch, async_mining=async_mining, seed=7)


def _snapshot(state):
    return (copy.deepcopy(state.model.state_dict()), copy.deepcopy(state.optimizer.state_dict()),
            state.step, None if state.rng is None else state.rng.get_state())


def _restore(state, saved) -> None:
    model_sd, opt_sd, step, rng = saved
    state.model.load_state_dict(model_sd)
    state.optimizer.load_state_dict(opt_sd)
    state.step = step
    if rng is not None:
        state.rng.set_state(rng)


def _device_step_s(tr, batch, iters: int) -> float:
    """Seconds per step of ``iters`` eager steps on one resident batch: CUDA
    events and one sync on the card, the host's clock on the CPU."""
    def steps():
        for _ in range(iters):
            tr.train_step(tr.state, dict(batch))

    saved = _snapshot(tr.state)
    steps()  # warm-up: cuDNN's algorithm choice, the kernels' first launches
    if tr.device.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        steps()
        end.record()
        end.synchronize()
        seconds = start.elapsed_time(end) / 1e3
    else:
        t0 = time.perf_counter()
        steps()
        seconds = time.perf_counter() - t0
    _restore(tr.state, saved)
    return seconds / iters


def run(tuples_per_batch: int = 2, num_points: int = 600, use_cache: bool = True,
        scan_iters: int = 50, out_dir: Optional[str] = None, cfg=None,
        steps_per_dispatch: int = 1, async_mining: bool = False,
        device: str = "cuda") -> dict:
    """Build the toy city (and its decoded cache), then: the device step
    time, a warm epoch, and a timed epoch through the trainer. ``cfg``
    overrides the flagship configuration (the CPU tests' small shapes).
    ``out_dir`` keeps the decoded cache between runs (default: a directory
    per ``num_points`` under the temporary directory, since two cities of
    different sizes share image keys); the run directory in it is
    cleared."""
    from soft_contrastive_learning_torch.core.config import resolve_device
    from soft_contrastive_learning_torch.core.logging import StepTimer
    from soft_contrastive_learning_torch.data.decoded_cache import (
        CachedDecodedSource, cache_training_sets)
    from soft_contrastive_learning_torch.data.pipeline import ToyCitySource, assemble_batch
    from soft_contrastive_learning_torch.train.trainer import EVAL_SAVE_SPANS, Trainer

    dev = resolve_device(device)
    if cfg is None:
        cfg = flagship_toy_config(tuples_per_batch, num_points, steps_per_dispatch, async_mining)
    # ~8 m between poses keeps the positives within the 15 m radius
    src = ToyCitySource(num_points=num_points, radius=num_points * 8.0 / (2 * np.pi), seed=3,
                        img_h=cfg.model.image_height, img_w=cfg.model.image_width)
    tmp = out_dir or os.path.join(tempfile.gettempdir(), f"scl_trainbench_{num_points}")
    shutil.rmtree(os.path.join(tmp, "run"), ignore_errors=True)
    cache_s = 0.0
    if use_cache:
        t0 = time.perf_counter()
        cache_dir = os.path.join(tmp, "decoded_cache")
        cache_training_sets(
            src, ["train_ref", "test_ref"], cfg.model.image_height, cfg.model.image_width,
            keep_aspect=cfg.model.vlad_cores > 0, cache_dir=cache_dir,
            cluster_sets=[("train_ref", cfg.eval_ref_r), ("test_ref", cfg.eval_ref_r)])
        src = CachedDecodedSource(src, cache_dir)
        cache_s = time.perf_counter() - t0

    tr = Trainer(cfg, src, out_dir=os.path.join(tmp, "run"), device=dev)
    try:
        # ---- the device's step: K steps on one resident batch ----
        meta = src.epoch_meta(cfg.local_ref_set, 0)
        sampler = tr._sampler_for(meta, rng=np.random.default_rng(0))
        anchors = src.anchor_indices(cfg.local_ref_set, cfg.train_ref_r, 0)
        sample = sampler.sample(np.asarray(anchors[:cfg.tuples_per_batch], dtype=int),
                                use_hard=False, cache=tr.mining_cache)
        assert sample is not None
        batch = assemble_batch(cfg, src, meta, sample.indices, sample.payload, 0)
        device_step_s = _device_step_s(tr, tr._augment_batch(tr._to_device(batch)), scan_iters)

        # ---- a warm epoch (pool build, cuDNN's choices), then a fresh timer ----
        tr.train_one_epoch(0)
        tr._sync()
        warm_steps = tr.state.step
        tr.timer = StepTimer()
        warm_fetches, warm_fetch_s = tr.scalar_fetches, tr.scalar_fetch_s

        # ---- the timed epoch ----
        t0 = time.perf_counter()
        tr.train_one_epoch(1)
        tr._sync()
        wall_s = time.perf_counter() - t0
        n_steps = tr.state.step - warm_steps

        spans = tr.timer.summary()
        one_off = tr._span_total("mining_refresh", *EVAL_SAVE_SPANS)
        imgs_per_step = cfg.images_per_batch
        steady = spans.get("segment_steady")
        if steady and steady["count"]:
            sustained_step_s = steady["total_s"] / steady["count"]
        else:
            sustained_step_s = (wall_s - one_off) / max(n_steps, 1)
        # the refresh included: what async mining moves
        with_mining_step_s = (wall_s - tr._span_total(*EVAL_SAVE_SPANS)) / max(n_steps, 1)
        result = {
            "metric": "train_loop_throughput",
            "value": round(imgs_per_step / sustained_step_s, 1),
            "unit": "images/sec/chip",
            "detail": {
                "backend": dev.type,
                "device_name": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                                else "cpu"),
                "tuples_per_batch": cfg.tuples_per_batch,
                "steps_per_dispatch": cfg.steps_per_dispatch,
                "async_mining": cfg.async_mining,
                "device_image_pool": tr._image_pool not in (None, False),
                "images_per_step": imgs_per_step,
                "steps": n_steps,
                "decoded_cache": use_cache,
                "cache_build_s": round(cache_s, 2),
                "epoch_wall_s": round(wall_s, 2),
                "one_off_s": round(one_off, 2),
                "wall_derived_step_ms": round((wall_s - one_off) / max(n_steps, 1) * 1e3, 3),
                "sustained_step_ms": round(sustained_step_s * 1e3, 3),
                "with_mining_step_ms": round(with_mining_step_s * 1e3, 3),
                "with_mining_imgs_per_sec": round(imgs_per_step / with_mining_step_s, 1),
                "device_step_ms": round(device_step_s * 1e3, 3),
                "device_busy_frac": round(device_step_s / sustained_step_s, 4),
                "spans": {k: round(v["total_s"], 2) for k, v in spans.items()},
                "scalar_fetches": tr.scalar_fetches - warm_fetches,
                "scalar_fetch_s": round(tr.scalar_fetch_s - warm_fetch_s, 2),
            },
        }
    finally:
        tr.close()
    return result


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--tuples_per_batch", type=int, default=2)
    ap.add_argument("--num_points", type=int, default=600)
    ap.add_argument("--no_cache", action="store_true")
    ap.add_argument("--scan_iters", type=int, default=50)
    ap.add_argument("--steps_per_dispatch", type=int, default=1)
    ap.add_argument("--async_mining", action="store_true")
    ap.add_argument("--out_dir", default="")
    ap.add_argument("--device", default="cuda", help="torch device; 'cpu' only when asked")
    args = ap.parse_args(argv)
    res = run(tuples_per_batch=args.tuples_per_batch, num_points=args.num_points,
              use_cache=not args.no_cache, scan_iters=args.scan_iters,
              out_dir=args.out_dir or None, steps_per_dispatch=args.steps_per_dispatch,
              async_mining=args.async_mining, device=args.device)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
