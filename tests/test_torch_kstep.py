"""The port's K-step dispatch (``steps_per_dispatch``) on the CPU, alone and
against the JAX package's.

The step: ``tests/test_device_pool.py``'s tiny configuration (32x32,
NetVLAD-4, fp32, one tuple of 1+2+2, wms), the JAX init carried across by
``params_from_flax``, the same numpy batches. The trainer: the toy city at
32x32 with hard mining, K = 2, evals and part saves inside the segments.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from soft_contrastive_learning_tpu.core import config as jcfg
from soft_contrastive_learning_tpu.data.pipeline import ToyCitySource as JaxToyCitySource
from soft_contrastive_learning_tpu.losses.registry import build_loss as jax_build_loss
from soft_contrastive_learning_tpu.models.model import create_model, init_params
from soft_contrastive_learning_tpu.train import step as jstep
from soft_contrastive_learning_tpu.train.trainer import Trainer as JaxTrainer
from soft_contrastive_learning_torch.core import config as tcfg
from soft_contrastive_learning_torch.data.pipeline import ToyCitySource
from soft_contrastive_learning_torch.losses.registry import build_loss
from soft_contrastive_learning_torch.models.model import EmbeddingNet
from soft_contrastive_learning_torch.models.weights import params_from_flax
from soft_contrastive_learning_torch.train.step import (
    build_train_step,
    build_train_step_scan,
    init_train_state,
)
from soft_contrastive_learning_torch.train.trainer import Trainer

torch.set_num_threads(1)  # tier-1 runs several workers on one host

K = 3


def _step_cfgs(loss="wms", **kw):
    j = jcfg.TrainConfig(
        model=jcfg.ModelConfig(vlad_cores=4, reduction="none", image_height=32, image_width=32,
                               compute_dtype="float32", use_pallas=False),
        tuples=jcfg.TupleConfig(positives_per_tuple=2, negatives_per_tuple=2),
        loss=jcfg.LossConfig(name=loss), tuples_per_batch=1, seed=0, steps_per_dispatch=K,
        **kw)
    t = tcfg.TrainConfig(
        model=tcfg.ModelConfig(vlad_cores=4, reduction="none", image_height=32, image_width=32,
                               compute_dtype="float32"),
        tuples=tcfg.TupleConfig(positives_per_tuple=2, negatives_per_tuple=2),
        loss=tcfg.LossConfig(name=loss), tuples_per_batch=1, seed=0, steps_per_dispatch=K,
        **kw)
    return j, t


def _pool(b):
    return np.random.default_rng(3).integers(0, 256, (b * K + 1, 32, 32, 3)).astype(np.uint8)


def _batch(i, b, loss="wms"):
    """JAX's ``mk_batch``: rows i..i+b of the pool; a PN loss's payload is
    the tuple's pairwise squared distances."""
    rng = np.random.default_rng(i)
    batch = {"image_idx": np.arange(i, i + b, dtype=np.int32), "epoch": np.float32(i // 2)}
    if loss == "wms":
        batch["geo_dist_matrix"] = np.abs(rng.random((b, b))).astype(np.float32) * 30
    else:
        pts = rng.uniform(0.0, 20.0, (1, 3, 2))
        batch["pairwise_sq_geo_dists"] = np.sum(
            (pts[:, :, None] - pts[:, None, :]) ** 2, axis=-1).astype(np.float32)
    return batch


def _flat(tree):
    return {k: np.asarray(v) for k, v in
            traverse_util.flatten_dict(jax.device_get(tree), sep="/").items()}


@pytest.fixture(scope="module")
def jax_init():
    cfg, _ = _step_cfgs()
    return _flat(init_params(cfg.model, jax.random.key(0)))


def _port_state(cfg, init):
    model = EmbeddingNet(cfg.model)
    model.load_state_dict(params_from_flax(init, cfg.model))
    return init_train_state(cfg, model)


def _port_singles(cfg, init, batches, pooled=True):
    state = _port_state(cfg, init)
    step = build_train_step(cfg, build_loss(cfg.loss, cfg.tuples, 1), image_pool=pooled)
    pool = torch.from_numpy(_pool(cfg.images_per_batch))
    metrics = []
    for b in batches:
        batch = {k: float(v) if k == "epoch" else torch.from_numpy(v) for k, v in b.items()}
        if not pooled:
            batch["images"] = pool[batch.pop("image_idx").long()]
        state, m = step(state, batch, pool if pooled else None)
        metrics.append(m)
    return state, metrics


def _port_scan(cfg, init, batches, pooled=True):
    state = _port_state(cfg, init)
    scan = build_train_step_scan(cfg, build_loss(cfg.loss, cfg.tuples, 1), image_pool=pooled)
    pool = torch.from_numpy(_pool(cfg.images_per_batch))
    stacked = {k: np.stack([b[k] for b in batches]) for k in batches[0]}
    stacked = {k: v if k == "epoch" else torch.from_numpy(v) for k, v in stacked.items()}
    if not pooled:
        stacked["images"] = pool[stacked.pop("image_idx").long()]
    return scan(state, stacked, pool if pooled else None)


@pytest.mark.parametrize("optimizer", ["momentum", "adam"])
def test_kstep_matches_jax_build_train_step_scan(jax_init, optimizer):
    """Port K = 3 against JAX's ``build_train_step_scan`` K = 3 (its
    ``lax.scan``), from the same weights on the same batches: losses within
    1e-5 relative; learning rates and the step count equal; parameters
    within rtol 1e-5 and atol 1e-7, the tolerance of JAX's own
    scan-against-singles test. With SGD-momentum that holds everywhere.
    Adam moves a weight by about lr whatever its gradient's size, so where a
    gradient is near zero the frameworks' rounding moves it by visibly
    different fractions of lr (``tests/test_torch_train_step.py``): there
    every weight is held within 0.25 lr, and at most 1e-5 of the weights
    may fall outside the tolerance above (46 of 14.7 million do)."""
    jc, tc = _step_cfgs(optimizer=optimizer)
    b = tc.images_per_batch
    batches = [_batch(i, b) for i in range(K)]
    model = create_model(jc.model)
    fused = jstep.build_train_step_scan(
        jc, model, jax_build_loss(jc.loss, jc.tuples, 1), image_pool=True)
    params = traverse_util.unflatten_dict({tuple(k.split("/")): jnp.asarray(v)
                                           for k, v in jax_init.items()})
    stacked = {k: np.stack([bt[k] for bt in batches]) for k in batches[0]}
    js, jm = fused(jstep.init_train_state(jc, params), stacked, _pool(b))

    state, metrics = _port_scan(tc, jax_init, batches)
    assert state.step == int(js.step) == K
    assert metrics["loss"].shape == metrics["learning_rate"].shape == (K,)
    np.testing.assert_allclose(metrics["loss"].numpy(), np.asarray(jm["loss"]), rtol=1e-5, atol=0)
    np.testing.assert_allclose(metrics["learning_rate"].numpy(), np.asarray(jm["learning_rate"]),
                               rtol=1e-7)
    want = params_from_flax(_flat(js.params), tc.model)
    outside, total = 0, 0
    for name, got in state.model.state_dict().items():
        err = (got - want[name]).abs()
        if optimizer == "momentum":
            np.testing.assert_allclose(got.numpy(), want[name].numpy(), rtol=1e-5, atol=1e-7,
                                       err_msg=name)
        else:
            assert err.max().item() <= 0.25 * tc.base_lr, name
        outside += int((err > 1e-7 + 1e-5 * want[name].abs()).sum())
        total += err.numel()
    assert outside <= 1e-5 * total


@pytest.mark.parametrize("variant", ["pooled", "host", "pn"])
def test_kstep_equals_single_steps_bit_for_bit(jax_init, variant):
    """The port's K = 3 against its K = 1 on the same batches: the device
    pool's variant, the host-fed one, and a PN loss (two updates a step):
    every loss, learning rate and parameter, and Adam's state, equal."""
    loss = "pairwise_distance_neg_eigenvalue" if variant == "pn" else "wms"
    _, cfg = _step_cfgs(loss)
    batches = [_batch(i, cfg.images_per_batch, loss) for i in range(K)]
    pooled = variant != "host"
    single, per_step = _port_singles(cfg, jax_init, batches, pooled)
    grouped, stacked = _port_scan(cfg, jax_init, batches, pooled)
    keys = ("loss", "loss_pos", "loss_neg") if variant == "pn" else ("loss",)
    assert set(stacked) == {*keys, "learning_rate"}
    for key in keys:
        assert torch.equal(stacked[key], torch.stack([m[key] for m in per_step])), key
    assert stacked["learning_rate"].tolist() == [m["learning_rate"] for m in per_step]
    assert stacked["learning_rate"].tolist() == [5e-6, 5e-6, 2.5e-6]
    assert grouped.step == single.step == K
    a, c = single.model.state_dict(), grouped.model.state_dict()
    assert all(torch.equal(a[k], c[k]) for k in a)
    sa, sc = single.optimizer.state_dict()["state"], grouped.optimizer.state_dict()["state"]
    assert all(torch.equal(sa[i][k], sc[i][k]) for i in sa for k in sa[i])
    assert torch.equal(single.rng.get_state(), grouped.rng.get_state())


@pytest.mark.parametrize("change", [dict(loss="incremental_det"), dict(reduction="pca")])
def test_kstep_refuses_host_state_feedback(change):
    """As JAX's: no K-step for an incremental loss or ``reduction='pca'``
    (the trainer runs their steps singly)."""
    _, cfg = _step_cfgs(change.get("loss", "wms"))
    if "reduction" in change:
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, reduction="pca",
                                                                 out_dim=8))
    with pytest.raises(AssertionError, match="no per-step host state feedback"):
        build_train_step_scan(cfg, build_loss(cfg.loss, cfg.tuples, 1))


# ---------------------------------------------------------------- the trainer
TRAINER = dict(tuples_per_batch=1, max_epoch=1, base_lr=5e-6, mining_step=8,
               mining_cache_size=10, eval_step=5, save_step=7, num_eval_queries=2, eval_ref_r=4,
               seed=0)
TUPLES = dict(positives_per_tuple=2, negatives_per_tuple=2, hard_positives_per_tuple=1,
              hard_negatives_per_tuple=1)
SOURCE = dict(num_points=24, radius=30.0, img_h=32, img_w=32, seed=3)
FAULTY_STEP = 11  # inside a group: it ends the group, whose item then runs singly
ATTRS = ("train_step", "train_step_pooled", "train_step_scan", "train_step_scan_pooled")


def _trainer_cfg(mod, **kw):
    model = dict(vlad_cores=4, image_height=32, image_width=32, compute_dtype="float32")
    if mod is jcfg:
        model["use_pallas"] = False
    return mod.TrainConfig(model=mod.ModelConfig(**model), tuples=mod.TupleConfig(**TUPLES),
                           loss=mod.LossConfig(name="wms"), **{**TRAINER, **kw})


class _FaultySampler:
    """A segment's sampler whose batch at anchor ``faulty`` comes back None
    (drawn all the same, so that the stream goes on as it would)."""

    def __init__(self, sampler, faulty):
        self._sampler, self._faulty = sampler, faulty

    def sample(self, anchors, *args, **kwargs):
        out = self._sampler.sample(anchors, *args, **kwargs)
        return None if int(anchors[0]) == self._faulty else out


def _record_dispatches(tr, source):
    """Wrap the trainer's step callables: each call recorded as (kind,
    global step before it); the segment samplers made faulty at
    ``FAULTY_STEP``."""
    calls = []
    for attr in ATTRS:
        fn = getattr(tr, attr)
        if fn is not None:
            kind = "group" if "scan" in attr else "single"

            def wrapped(*args, fn=fn, kind=kind):
                calls.append((kind, tr.global_step))
                return fn(*args)

            setattr(tr, attr, wrapped)
    faulty = int(source.anchor_indices("train_ref", 1, 0)[FAULTY_STEP])
    make = tr._sampler_for
    tr._sampler_for = lambda meta, rng=None: _FaultySampler(make(meta, rng=rng), faulty)
    return calls


@pytest.mark.parametrize("pool", [True, False])
def test_trainer_dispatches_as_the_jax_trainer(tmp_path, pool):
    """A port Trainer and a JAX Trainer at K = 2 on the same config issue
    the same sequence of group and single dispatches: segments of 8 items,
    evals every 5 anchors and saves every 7 (the items that host them run
    singly or lead a group, never sit inside one), and a faulty batch at
    step 11 that ends a group. The evals and checkpoint writes are stubbed
    on both (they decide nothing here)."""
    got = {}
    for name, mod, trainer, source in (
            ("jax", jcfg, JaxTrainer, JaxToyCitySource(**SOURCE)),
            ("port", tcfg, Trainer, ToyCitySource(**SOURCE))):
        cfg = _trainer_cfg(mod, steps_per_dispatch=2, device_image_pool=pool)
        kw = {} if name == "jax" else {"device": "cpu"}
        tr = trainer(cfg, source, out_dir=str(tmp_path / name), **kw)
        calls = _record_dispatches(tr, source)
        tr._run_eval = lambda *a, **k: None
        tr.ckpts.save = lambda *a, **k: None
        tr.train()
        tr.close()
        got[name] = (calls, tr.global_step)
    calls, steps = got["port"]
    assert got["jax"] == got["port"]
    assert steps == 23  # one of the 24 batches is faulty
    assert calls[:6] == [("group", 0), ("group", 2), ("single", 4), ("group", 5),
                         ("single", 7), ("group", 8)]
    assert ("single", 10) in calls and ("group", 11) in calls  # 10 alone, 11 faulty, 12-13
    assert sum(kind == "group" for kind, _ in calls) >= 7


def _skip_saves(tr, keep=()):
    """Record the trainer's checkpoint writes as (role, step) in
    ``tr.saves`` and write only those in ``keep``: a checkpoint of the full
    VGG16 widths and Adam's moments takes ~190 MB of disk."""
    tr.saves, save = [], tr.ckpts.save

    def recording(role, step, *args, **kwargs):
        tr.saves.append((role, int(step)))
        if (role, int(step)) in keep:
            save(role, step, *args, **kwargs)

    tr.ckpts.save = recording


def _run_trainer(tmp_path, name, k, pool=True, resume=False, keep=(), **kw):
    cfg = _trainer_cfg(tcfg, steps_per_dispatch=k, device_image_pool=pool, **kw)
    tr = Trainer(cfg, ToyCitySource(**SOURCE), out_dir=str(tmp_path / name), device="cpu")
    if resume:
        assert tr.resume_latest("part")
    _skip_saves(tr, keep)
    calls = []
    for attr in ("train_step_scan", "train_step_scan_pooled"):
        fn = getattr(tr, attr)
        if fn is not None:
            setattr(tr, attr, lambda *a, fn=fn: (calls.append(1), fn(*a))[1])
    tr.train()
    tr.close()
    records = [{k: v for k, v in r.items() if k != "t"} for r in tr.writers["local"].read_all()]
    return tr, records, len(calls)


@pytest.mark.parametrize("pool", [True, False])
def test_trainer_k2_equals_k1_bit_for_bit(tmp_path, pool):
    """The port's trainer at K = 2 against K = 1, on the pooled and the
    host-fed path, evals (3 firings) and part saves included: every loss,
    every record of ``metrics_local.jsonl`` (the wall-clock field aside),
    every checkpoint write (role and step; the files are not written),
    every parameter and Adam's state equal."""
    one, rec1, groups1 = _run_trainer(tmp_path, "k1", 1, pool, eval_step=10, save_step=12)
    two, rec2, groups2 = _run_trainer(tmp_path, "k2", 2, pool, eval_step=10, save_step=12)
    assert groups1 == 0 and groups2 >= 8
    assert one.global_step == two.global_step == 24
    assert rec1 == rec2
    assert one.saves == two.saves == [("rolling", 0), ("part", 0), ("rolling", 10),
                                      ("part", 12), ("rolling", 20), ("epoch", 0)]
    assert len([r for r in rec2 if r["tag"] == "loss"]) == 24
    assert {r["step"] for r in rec2 if r["tag"] == "%<10m@Top1"} == {0, 10, 20}
    a, c = one.state.model.state_dict(), two.state.model.state_dict()
    assert all(torch.equal(a[k], c[k]) for k in a)
    sa, sc = one.state.optimizer.state_dict()["state"], two.state.optimizer.state_dict()["state"]
    assert all(torch.equal(sa[i][k], sc[i][k]) for i in sa for k in sa[i])
    assert two.used_images == one.used_images


def test_resumed_k2_run_equals_the_uninterrupted_one(tmp_path):
    """A K = 2 run stopped at its part checkpoint of step 16 (a mining
    boundary, so the rebuilt cache is the original's) and taken up by a
    fresh trainer ends with the uninterrupted run's parameters, bit for
    bit, and writes the same losses for steps 17-24. Only that checkpoint
    is written."""
    import shutil

    full, records, _ = _run_trainer(tmp_path, "full", 2, keep=[("part", 16)], eval_step=10**6,
                                    save_step=16)
    assert full.saves == [("rolling", 0), ("part", 0), ("part", 16), ("epoch", 0)]
    part = tmp_path / "full" / "checkpoints" / "part" / "16"
    assert part.exists()
    (tmp_path / "resumed" / "checkpoints" / "part").mkdir(parents=True)
    shutil.move(part, tmp_path / "resumed" / "checkpoints" / "part" / "16")
    resumed, resumed_records, groups = _run_trainer(tmp_path, "resumed", 2, resume=True,
                                                    eval_step=10**6, save_step=16)
    assert resumed.global_step == 24 and groups == 4
    a, c = full.state.model.state_dict(), resumed.state.model.state_dict()
    assert all(torch.equal(a[k], c[k]) for k in a)
    losses = [r for r in records if r["tag"] == "loss" and r["step"] > 16]
    assert [r for r in resumed_records if r["tag"] == "loss"] == losses


def test_async_mining_composes_with_the_kstep(tmp_path):
    """As JAX's ``tests/test_async_mining.py::
    test_async_mining_with_fused_dispatch``: async mining at K = 3, the
    worker's embeds between the groups: a refresh spawned at every boundary
    but the epoch's first (anchors 6, 12, 18), two groups of 3 in each
    segment of 6, 24 finite losses, no worker left."""
    cfg = _trainer_cfg(tcfg, steps_per_dispatch=3, async_mining=True, mining_step=6,
                       eval_step=10**9, save_step=10**9)
    tr = Trainer(cfg, ToyCitySource(**SOURCE), out_dir=str(tmp_path), device="cpu")
    _skip_saves(tr)
    spawned, groups = [], []
    spawn, scan = tr._spawn_mining_refresh, tr.train_step_scan_pooled
    tr._spawn_mining_refresh = lambda *a: (spawned.append(a[1]), spawn(*a))[1]
    tr.train_step_scan_pooled = lambda *a: (groups.append(tr.global_step), scan(*a))[1]
    tr.train_one_epoch(0)
    tr.close()
    assert spawned == [6, 12, 18]
    assert groups == [0, 3, 6, 9, 12, 15, 18, 21]
    assert tr._mining_thread is None and tr._mining_error is None
    losses = [r["value"] for r in tr.writers["local"].read_all() if r["tag"] == "loss"]
    assert len(losses) == 24 and np.isfinite(losses).all()


@pytest.mark.parametrize("change", [
    dict(loss="incremental_det", loss_dim=4), dict(reduction="pca", out_dim=4)])
def test_host_feedback_configs_run_singly_at_k4(tmp_path, change):
    """An incremental loss and ``reduction='pca'`` at K = 4 build no K-step
    and train as K = 1 does, bit for bit (the epoch's 24 steps)."""
    runs = []
    for k in (1, 4):
        cfg = _trainer_cfg(tcfg, steps_per_dispatch=k, eval_step=10**6,
                           save_step=10**6, mining_step=4)
        if "loss" in change:
            cfg = dataclasses.replace(cfg, loss=tcfg.LossConfig(name=change["loss"],
                                                                loss_dim=change["loss_dim"]))
        else:
            cfg = dataclasses.replace(cfg, model=dataclasses.replace(
                cfg.model, reduction="pca", out_dim=change["out_dim"]))
        tr = Trainer(cfg, ToyCitySource(**SOURCE), out_dir=str(tmp_path / str(k)), device="cpu")
        assert tr.train_step_scan is None and tr.train_step_scan_pooled is None
        _skip_saves(tr)
        tr.train()
        tr.close()
        runs.append((tr, [r["value"] for r in tr.writers["local"].read_all()
                          if r["tag"] == "loss"]))
    (one, l1), (four, l4) = runs
    assert len(l1) == 24 and l1 == l4
    a, c = one.state.model.state_dict(), four.state.model.state_dict()
    assert all(torch.equal(a[k], c[k]) for k in a)


# ---------------------------------------------------------------- CLI, dryrun
def test_cli_train_takes_steps_per_dispatch(tmp_path, monkeypatch):
    """``cli train --steps_per_dispatch 2`` (JAX's flag) reaches the
    trainer's configuration and trains the toy city (its checkpoint writes
    skipped: ~190 MB each)."""
    import json

    from soft_contrastive_learning_torch.checkpoints.manager import RunCheckpoints

    from soft_contrastive_learning_torch.cli import build_parser, config_from_args, main

    args = build_parser().parse_args(["train", "--steps_per_dispatch", "3"])
    assert config_from_args(args).steps_per_dispatch == 3
    monkeypatch.setattr(RunCheckpoints, "save", lambda *a, **k: None)
    argv = ["train", "--toy_city", "--device", "cpu", "--out_root", str(tmp_path),
            "--out_folder", "run", "--image_height", "32", "--image_width", "32",
            "--vlad_cores", "4", "--compute_dtype", "float32", "--positives_per_tuple", "1",
            "--negatives_per_tuple", "1", "--hard_positives_per_tuple", "1",
            "--hard_negatives_per_tuple", "1", "--max_epoch", "1", "--mining_step", "8",
            "--mining_cache_size", "8", "--train_ref_r", "40", "--eval_step", "1000000",
            "--loss", "wms", "--steps_per_dispatch", "2"]
    assert main(argv) == 0
    assert json.loads((tmp_path / "run" / "config.json").read_text())["steps_per_dispatch"] == 2
    from soft_contrastive_learning_torch.core.logging import MetricsWriter

    losses = [r for r in MetricsWriter(str(tmp_path / "run"), "local").read_all()
              if r["tag"] == "loss"]
    assert [r["step"] for r in losses] == list(range(1, 13))


def test_dryrun_trains_at_jax_s_k():
    """The dryrun's trainer runs JAX's ``steps_per_dispatch=2``."""
    from soft_contrastive_learning_torch import dryrun

    for n in (1, 2, 8):
        assert dryrun.trainer_config(n).steps_per_dispatch == 2
