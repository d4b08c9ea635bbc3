"""The port's train-loop benchmark (``bench_train.py``, ``cli bench
--train``) on the CPU: JAX's ``tests/test_bench_train.py`` contract (the
metric line, the span-derived sustained and with-mining numbers, the
async_mining passthrough) at its tiny configuration, with async mining off
and on; the JSON keys of JAX's line; the CLI's passthrough and refusals."""

import json

import numpy as np
import pytest
import torch

from soft_contrastive_learning_torch import bench_train, cli
from soft_contrastive_learning_torch.core.config import (
    LossConfig, ModelConfig, TrainConfig, TupleConfig)

torch.set_num_threads(1)  # tier-1 runs several workers on one host

# the keys of JAX's bench_train.run line (its ``detail``); the port adds the
# card's name beside ``backend``
JAX_DETAIL_KEYS = {
    "backend", "tuples_per_batch", "steps_per_dispatch", "async_mining", "device_image_pool",
    "images_per_step", "steps", "decoded_cache", "cache_build_s", "epoch_wall_s", "one_off_s",
    "wall_derived_step_ms", "sustained_step_ms", "with_mining_step_ms",
    "with_mining_imgs_per_sec", "device_step_ms", "device_busy_frac", "spans",
    "scalar_fetches", "scalar_fetch_s"}


def _tiny_cfg(async_mining: bool) -> TrainConfig:
    return TrainConfig(
        model=ModelConfig(vlad_cores=4, reduction="none", image_height=48, image_width=64,
                          compute_dtype="float32"),
        tuples=TupleConfig(positives_per_tuple=2, negatives_per_tuple=2,
                           hard_positives_per_tuple=1, hard_negatives_per_tuple=1),
        loss=LossConfig(name="wms"), tuples_per_batch=1, max_epoch=1,
        mining_step=8,  # 16 anchors: 2 segments an epoch
        mining_cache_size=8, eval_step=10**8, save_step=10**8, num_eval_queries=4,
        eval_ref_r=4, train_ref_r=1, async_mining=async_mining, seed=7)


@pytest.mark.parametrize("async_mining", [False, True])
def test_bench_train_smoke(tmp_path, async_mining):
    res = bench_train.run(tuples_per_batch=1, num_points=16, use_cache=True, scan_iters=2,
                          out_dir=str(tmp_path), cfg=_tiny_cfg(async_mining), device="cpu")
    assert res["metric"] == "train_loop_throughput"
    assert res["unit"] == "images/sec/chip"
    assert res["value"] > 0
    d = res["detail"]
    assert set(d) == JAX_DETAIL_KEYS | {"device_name"}
    assert (d["backend"], d["device_name"]) == ("cpu", "cpu")
    assert d["async_mining"] is async_mining
    assert d["steps"] == 16
    assert d["images_per_step"] == 5  # 1 tuple x (1 + 2 + 2)
    assert d["device_image_pool"] is True and d["decoded_cache"] is True
    for k in ("sustained_step_ms", "with_mining_step_ms", "device_step_ms",
              "device_busy_frac", "with_mining_imgs_per_sec"):
        assert np.isfinite(d[k]) and d[k] > 0, (k, d[k])
    # with_mining charges the refresh; it can never beat the steady windows
    # by more than measurement noise
    assert d["with_mining_step_ms"] >= d["sustained_step_ms"] * 0.9
    spans = d["spans"]
    assert "segment_steady" in spans and "mining_refresh" in spans
    # 2 epochs x 2 segments: each epoch's first boundary sync, its second async
    assert ("mining_refresh_async" in spans) is async_mining
    assert "dispatch_put" in spans and "train_step" in spans
    assert d["scalar_fetches"] >= 1 and d["scalar_fetch_s"] >= 0.0
    # the decoded cache was written for both regions under out_dir
    assert sorted(p.name for p in (tmp_path / "decoded_cache").iterdir()) == [
        "decoded_48x64_aspect.json", "decoded_48x64_aspect.u8"]


def test_the_device_steps_leave_the_state_as_they_found_it(tmp_path):
    """The K timed steps train on one batch and are undone: the model, the
    optimizer and the step count are the ones before them (JAX's scan
    leaves ``tr.state`` alone)."""
    from soft_contrastive_learning_torch.data.pipeline import ToyCitySource, assemble_batch
    from soft_contrastive_learning_torch.train.trainer import Trainer

    cfg = _tiny_cfg(False)
    src = ToyCitySource(num_points=16, radius=16 * 8.0 / (2 * np.pi), seed=3, img_h=48,
                        img_w=64)
    tr = Trainer(cfg, src, out_dir=str(tmp_path), device="cpu")
    tr.state.step = 3
    before = {k: v.clone() for k, v in tr.state.model.state_dict().items()}
    meta = src.epoch_meta("train_ref", 0)
    sample = tr._sampler_for(meta, rng=np.random.default_rng(0)).sample(
        np.asarray([0]), use_hard=False, cache=tr.mining_cache)
    batch = tr._to_device(assemble_batch(cfg, src, meta, sample.indices, sample.payload, 0))
    assert bench_train._device_step_s(tr, batch, 2) > 0
    after = tr.state.model.state_dict()
    assert all(torch.equal(after[k], v) for k, v in before.items())
    assert tr.state.step == 3 and not tr.state.optimizer.state
    tr.close()


def test_cli_bench_train_passes_its_flags(monkeypatch, capsys):
    seen = {}

    def fake_run(**kw):
        seen.update(kw)
        return {"metric": "train_loop_throughput", "value": 1.0, "unit": "images/sec/chip",
                "detail": {}}

    monkeypatch.setattr(bench_train, "run", fake_run)
    assert cli.main(["bench", "--train", "--tuples_per_batch", "1", "--num_points", "40",
                     "--no_cache", "--async_mining", "--device", "cpu"]) == 0
    assert seen == dict(tuples_per_batch=1, num_points=40, use_cache=False, steps_per_dispatch=1,
                        async_mining=True, device="cpu")
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["value"] == 1.0


def test_cli_bench_refuses_steps_per_dispatch(monkeypatch, capsys):
    """--steps_per_dispatch is a flag of the train-loop benchmark: refused
    without --train, with the reason; with it, K reaches the benchmark
    (JAX's ``bench_train.py`` flag), whose configuration takes it."""
    with pytest.raises(SystemExit, match="steps_per_dispatch.*pass --train"):
        cli.main(["bench", "--steps_per_dispatch", "2", "--device", "cpu"])
    seen = {}

    def fake_run(**kw):
        seen.update(kw)
        return {"metric": "train_loop_throughput", "value": 1.0, "unit": "images/sec/chip",
                "detail": {"steps_per_dispatch": kw["steps_per_dispatch"]}}

    monkeypatch.setattr(bench_train, "run", fake_run)
    assert cli.main(["bench", "--train", "--steps_per_dispatch", "16", "--device", "cpu"]) == 0
    assert seen["steps_per_dispatch"] == 16
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["detail"]["steps_per_dispatch"] == 16
    assert bench_train.flagship_toy_config(2, 600, steps_per_dispatch=16).steps_per_dispatch == 16


def test_the_flagship_configuration_is_jax_s():
    from soft_contrastive_learning_tpu import bench_train as jax_bench_train

    for k in (1, 16):  # 16: JAX's recommended K (docs/TRAINBENCH.md)
        ours = json.loads(bench_train.flagship_toy_config(2, 600, k, async_mining=True).to_json())
        theirs = json.loads(
            jax_bench_train.flagship_toy_config(2, 600, k, async_mining=True).to_json())
        for key in ("tuples_per_batch", "max_epoch", "mining_step", "mining_cache_size",
                    "eval_step", "save_step", "num_eval_queries", "eval_ref_r", "train_ref_r",
                    "steps_per_dispatch", "async_mining", "seed", "base_lr"):
            assert ours[key] == theirs[key], key
        assert ours["steps_per_dispatch"] == k
    for key in ("image_height", "image_width", "vlad_cores", "compute_dtype", "reduction"):
        assert ours["model"][key] == theirs["model"][key], key
    assert ours["loss"]["name"] == theirs["loss"]["name"] == "wms"
    assert ours["loss"]["fused_wms"] is theirs["loss"]["fused_wms"] is False
    assert ours["tuples"] == {k: v for k, v in theirs["tuples"].items() if k in ours["tuples"]}
