"""Checkpoints of the port and exact resume, on the CPU.

The manager alone (a two-layer stand-in for the train state), then the
toy-city trainer: 32x40 images, NetVLAD-8, fp32, one tuple of 1+3+3, 24
anchors, ``mining_step=8`` over a cache of 10, a part checkpoint every 4 or
5 anchors and the rolling one every 6 (the evals themselves stubbed: they
draw from their own generator). A run is stopped by keeping only one of its
part checkpoints and taken up again by a new ``Trainer``. Last, a JAX ``TrainState`` handed over
as numpy arrays takes the same next step in both packages.
"""

import dataclasses
import json
import os
import shutil
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from soft_contrastive_learning_tpu.core import config as jcfg
from soft_contrastive_learning_tpu.data.pipeline import ToyCitySource as JaxToyCitySource
from soft_contrastive_learning_tpu.train.trainer import Trainer as JaxTrainer
from soft_contrastive_learning_torch import cli
from soft_contrastive_learning_torch.checkpoints import manager
from soft_contrastive_learning_torch.checkpoints.manager import (
    RunCheckpoints,
    load_run_params,
    numpy_rng_from_array,
    numpy_rng_to_array,
    warm_start_params,
)
from soft_contrastive_learning_torch.core import config as tcfg
from soft_contrastive_learning_torch.data.pipeline import ToyCitySource
from soft_contrastive_learning_torch.losses.registry import build_loss
from soft_contrastive_learning_torch.models.weights import params_from_flax, train_state_from_flax
from soft_contrastive_learning_torch.train.step import build_train_step
from soft_contrastive_learning_torch.train.trainer import Trainer

torch.set_num_threads(1)  # tier-1 runs several workers on one host

MODEL = dict(vlad_cores=8, image_height=32, image_width=40, compute_dtype="float32")
TRAIN = dict(tuples_per_batch=1, max_epoch=1, base_lr=1e-4, mining_step=8, mining_cache_size=10,
             eval_step=6, save_step=5, num_eval_queries=4, eval_ref_r=4, seed=0)
SOURCE = dict(num_points=24, radius=30.0, img_h=32, img_w=40, seed=3)


def _cfg(hard, **over):
    tuples = tcfg.TupleConfig(positives_per_tuple=3, negatives_per_tuple=3,
                              hard_positives_per_tuple=hard, hard_negatives_per_tuple=hard)
    return tcfg.TrainConfig(model=tcfg.ModelConfig(**MODEL), tuples=tuples,
                            loss=tcfg.LossConfig(name="wms"), **{**TRAIN, **over})


# ---------------------------------------------------------------- the manager

def _toy_state(step=0):
    model = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.Linear(4, 2))
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    model(torch.ones(5, 3)).sum().backward()
    opt.step()
    return SimpleNamespace(model=model, optimizer=opt, step=step)


def test_rng_round_trip():
    gen = np.random.default_rng(7)
    gen.integers(10, size=5)
    buf = numpy_rng_to_array(gen)
    assert buf.dtype == np.uint8 and buf.shape == (512,)
    again = numpy_rng_from_array(torch.from_numpy(buf))  # as a checkpoint hands it back
    assert again.bit_generator.state == gen.bit_generator.state
    assert again.integers(1 << 30, size=8).tolist() == gen.integers(1 << 30, size=8).tolist()


def test_rolling_keeps_max_to_keep_and_the_others_keep_all(tmp_path):
    ckpts = RunCheckpoints(str(tmp_path), max_to_keep=2)
    state = _toy_state()
    for step in (3, 7, 11, 20):
        for role in RunCheckpoints.ROLES:
            ckpts.save(role, step, state, {"epoch": 0})
    listing = {role: sorted(os.listdir(tmp_path / "checkpoints" / role), key=int)
               for role in RunCheckpoints.ROLES}
    assert listing == {"rolling": ["11", "20"], "epoch": ["3", "7", "11", "20"],
                       "part": ["3", "7", "11", "20"]}
    assert [ckpts.latest(role) for role in RunCheckpoints.ROLES] == [20, 20, 20]
    with pytest.raises(ValueError, match="unknown checkpoint role"):
        ckpts.latest("hourly")
    ckpts.wait()
    ckpts.close()


def test_save_and_restore_round_trip_bit_for_bit(tmp_path):
    ckpts = RunCheckpoints(str(tmp_path))
    state = _toy_state(step=41)
    extras = {"sampler_rng": numpy_rng_to_array(np.random.default_rng(1)), "epoch": 2,
              "seg_step0": -1, "consumed": np.int32(0)}
    ckpts.save("part", 41, state, extras)
    raw = torch.load(tmp_path / "checkpoints" / "part" / "41" / "state.pt", weights_only=True)
    assert sorted(raw) == ["extras", "model", "optimizer", "step"] and raw["step"] == 41
    fresh = _toy_state()
    fresh, pca, loss_pca, got = ckpts.restore("part", 41, fresh)
    assert pca is None and loss_pca is None
    assert fresh.step == 41 and got["epoch"] == 2 and got["consumed"] == 0
    assert torch.equal(got["sampler_rng"], torch.from_numpy(extras["sampler_rng"]))
    for a, b in zip(fresh.model.parameters(), state.model.parameters()):
        assert torch.equal(a, b)
    want = state.optimizer.state_dict()["state"]
    for i, entry in fresh.optimizer.state_dict()["state"].items():
        assert all(torch.equal(entry[k], want[i][k]) for k in ("step", "exp_avg", "exp_avg_sq"))


def test_disabled_manager_creates_nothing(tmp_path):
    run = tmp_path / "run"
    ckpts = RunCheckpoints(str(run), enabled=False)
    ckpts.save("rolling", 1, _toy_state())
    assert ckpts.latest("rolling") is None and ckpts.latest("part") is None
    assert not run.exists()


def test_a_killed_write_leaves_no_state_file(tmp_path, monkeypatch):
    ckpts = RunCheckpoints(str(tmp_path))
    state = _toy_state()
    ckpts.save("part", 5, state)
    good = (tmp_path / "checkpoints" / "part" / "5" / "state.pt").read_bytes()

    def dies_half_way(payload, path):
        with open(path, "wb") as f:
            f.write(b"half a file")
        raise KeyboardInterrupt

    monkeypatch.setattr(manager.torch, "save", dies_half_way)
    for step in (5, 9):
        with pytest.raises(KeyboardInterrupt):
            ckpts.save("part", step, state)
    # the finished checkpoint is untouched, the new step holds no file at all
    assert (tmp_path / "checkpoints" / "part" / "5" / "state.pt").read_bytes() == good
    assert os.listdir(tmp_path / "checkpoints" / "part" / "5") == ["state.pt"]
    assert os.listdir(tmp_path / "checkpoints" / "part" / "9") == []
    assert ckpts.latest("part") == 5


def test_warm_start_copies_the_named_scopes_only():
    fresh = {"vgg16.a.weight": torch.zeros(2), "netvlad.c": torch.zeros(2), "head.w": torch.zeros(2)}
    donor = {"vgg16.a.weight": torch.ones(2), "head.w": torch.ones(2)}
    merged, copied = warm_start_params(fresh, donor)
    assert copied == ["vgg16"]
    assert merged["vgg16.a.weight"].sum() == 2 and merged["head.w"].sum() == 0


# ---------------------------------------------------------------- resume

def _run(cfg, out_dir, resume_role=None):
    """A trainer run to its end with the evals stubbed; records the tuple
    of image indices of every sample drawn, replays after a resume included."""
    tr = Trainer(cfg, ToyCitySource(**SOURCE), out_dir=str(out_dir), device="cpu")
    tr.evals.loss_other = lambda *a, **k: None
    tr.evals.localization = lambda *a, **k: None
    drawn, sample = [], tr._sample

    def recording(*args):
        out = sample(*args)
        drawn.append(tuple(out.indices.reshape(-1).tolist()))
        return out

    tr._sample = recording
    resumed = None
    if resume_role is not None:
        assert tr.resume_latest(resume_role)
        resumed = dict(step=tr.global_step, ctx=tr._resume_ctx, start_epoch=tr.start_epoch)
    tr.train()
    tr.close()
    return tr, drawn, resumed


def _stopped_copy(run_dir, out_dir, step):
    """What a run killed after its part checkpoint of ``step`` leaves."""
    os.makedirs(out_dir / "checkpoints" / "part")
    shutil.copytree(run_dir / "checkpoints" / "part" / str(step),
                    out_dir / "checkpoints" / "part" / str(step))
    return out_dir


def _records(tr, after=0):
    return [(r["step"], r["tag"], r["value"]) for r in tr.writers["local"].read_all()
            if r["step"] > after]


# The stopped run keeps one part checkpoint. Mid-segment (step 10, two batches
# into the segment of steps 8-15) the mining cache is rebuilt with the weights
# of step 10 where the original was embedded at step 8: with hard mining the
# resumed run equals the uninterrupted one as long as the rebuilt cache orders
# its neighbours as the original did (the JAX trainer's scope of exactness),
# which this untrained network's near-coincident embeddings only do at a small
# learning rate. At a refresh (step 8) the rebuilt cache is the original, and
# hard mining changes nothing.
CASES = {
    "hard_off_mid_segment": dict(hard=0, save_step=5, resume_at=10, base_lr=1e-4, exact=True,
                                 ctx={"seg_step0": 8, "consumed": 2, "mining_count": 1}),
    "hard_on_at_refresh": dict(hard=1, save_step=4, resume_at=8, base_lr=1e-4, exact=True,
                               ctx={"seg_step0": 8, "consumed": 0, "mining_count": 1}),
    "hard_on_mid_segment": dict(hard=1, save_step=5, resume_at=10, base_lr=1e-7, exact=False,
                                ctx={"seg_step0": 8, "consumed": 2, "mining_count": 1}),
}


@pytest.fixture(scope="module", params=list(CASES))
def runs(request, tmp_path_factory):
    case = CASES[request.param]
    root = tmp_path_factory.mktemp(request.param)
    cfg = _cfg(case["hard"], save_step=case["save_step"], base_lr=case["base_lr"])
    whole = _run(cfg, root / "a")
    stopped = _stopped_copy(root / "a", root / "b", case["resume_at"])
    saved_at = os.path.getmtime(
        stopped / "checkpoints" / "part" / str(case["resume_at"]) / "state.pt")
    resumed = _run(cfg, stopped, resume_role="part")
    yield case, root, whole, resumed, saved_at
    shutil.rmtree(root, ignore_errors=True)


def test_checkpoints_are_written_where_the_jax_loop_writes_them(runs):
    """Part every ``save_step`` anchors from 0, the rolling one at every eval
    with only the newest kept, one at the epoch's end."""
    case, root, (tr, _, _), _, _ = runs
    listing = {role: sorted(os.listdir(root / "a" / "checkpoints" / role), key=int)
               for role in RunCheckpoints.ROLES}
    assert listing == {"rolling": ["18"], "epoch": ["0"],
                       "part": [str(s) for s in range(0, 24, case["save_step"])]}
    extras = tr.ckpts.load("part", case["resume_at"])["extras"]
    assert {k: extras[k] for k in case["ctx"]} == case["ctx"] and extras["epoch"] == 0
    assert tr.ckpts.load("epoch", 0)["extras"]["seg_step0"] == -1


def test_mid_epoch_resume_consumes_the_same_batches(runs):
    """The resumed run seeds the segment's generator again from the saved
    pre-draw state, replays the batches already trained in it and goes on:
    the uninterrupted run's samples from the segment's start (step 8) on."""
    case, _, (tr_a, drawn_a, _), (tr_b, drawn_b, resumed), _ = runs
    assert resumed == dict(step=case["resume_at"], start_epoch=0, ctx=case["ctx"])
    assert len(drawn_a) == 24 and drawn_b == drawn_a[8:]
    assert tr_b.global_step == tr_a.global_step == tr_b.state.step == 24
    assert tr_b.mining.refresh_count == 2  # segments of steps 8 and 16, rebuilt and fresh


def test_mid_epoch_resume_equals_the_uninterrupted_run(runs):
    """Parameters and Adam moments bit-equal; with hard mining and a cache
    rebuilt from later weights, parameters within 1e-6."""
    case, _, (tr_a, _, _), (tr_b, _, _), _ = runs
    a, b = tr_a.state.model.state_dict(), tr_b.state.model.state_dict()
    oa = tr_a.state.optimizer.state_dict()["state"]
    ob = tr_b.state.optimizer.state_dict()["state"]
    assert a.keys() == b.keys() and oa.keys() == ob.keys()
    if case["exact"]:
        assert all(torch.equal(a[k], b[k]) for k in a)
        assert all(torch.equal(oa[i][k], ob[i][k]) for i in oa
                   for k in ("step", "exp_avg", "exp_avg_sq"))
    else:
        assert max((a[k] - b[k]).abs().max().item() for k in a) <= 1e-6


def test_resumed_metrics_continue_without_gap_or_repeat(runs):
    """``metrics_local.jsonl`` of the resumed run: the steps after the saved
    one, once each, with the uninterrupted run's values."""
    case, _, (tr_a, _, _), (tr_b, _, _), _ = runs
    got = _records(tr_b)
    assert [s for s, tag, _ in got if tag == "loss"] == list(range(case["resume_at"] + 1, 25))
    if case["exact"]:
        assert got == _records(tr_a, after=case["resume_at"])


def test_resume_holds_back_the_save_that_fired_at_the_saved_step(runs):
    case, root, _, _, saved_at = runs
    part = root / "b" / "checkpoints" / "part"
    assert sorted(os.listdir(part), key=int) == [
        str(s) for s in range(case["resume_at"], 24, case["save_step"])]
    assert os.path.getmtime(part / str(case["resume_at"]) / "state.pt") == saved_at


def test_resume_from_an_epoch_checkpoint_starts_at_the_next_epoch(runs):
    """And from the rolling one (the default role) inside its segment."""
    _, root, (tr_a, _, _), _, _ = runs
    tr = Trainer(tr_a.cfg, ToyCitySource(**SOURCE), out_dir=str(root / "a"), device="cpu")
    assert tr.resume_latest("epoch")
    assert (tr.start_epoch, tr._resume_ctx, tr.global_step) == (1, None, 24)
    assert tr.rng.bit_generator.state == tr_a.rng.bit_generator.state
    assert tr.eval_rng.bit_generator.state == tr_a.eval_rng.bit_generator.state
    tr.train()  # max_epoch = 1: nothing is left
    assert tr.global_step == 24
    assert tr.resume_latest()
    assert (tr.start_epoch, tr.global_step) == (0, 18)
    assert tr._resume_ctx == {"seg_step0": 16, "consumed": 2, "mining_count": 2}
    tr.close()
    fresh = Trainer(tr_a.cfg, ToyCitySource(**SOURCE), out_dir=str(root / "none"), device="cpu")
    assert not fresh.resume_latest("part")
    fresh.close()


def test_load_run_params_takes_the_newest_written_role(runs, tmp_path):
    case, root, (tr_a, _, _), _, _ = runs
    run = root / "a"
    last_part = max(range(0, 24, case["save_step"]))
    # epoch/0 holds the end of the run but has the lowest number: the pick is
    # by the time of writing
    for age, (role, step) in enumerate((("epoch", 0), ("rolling", 18), ("part", last_part))):
        os.utime(run / "checkpoints" / role / str(step), (2e9 - age, 2e9 - age))
    model_cfg, params = load_run_params(str(run))
    final = tr_a.state.model.state_dict()
    assert model_cfg == tr_a.cfg.model
    assert all(torch.equal(params[k], final[k]) for k in final)
    _, part = load_run_params(str(run), role="part")
    assert any(not torch.equal(part[k], final[k]) for k in final)
    # the CLI's --checkpoint <run_dir>
    got_cfg, got = cli._load_model_params(tcfg.ModelConfig(), str(run), default_artifact=True)
    assert got_cfg == model_cfg and all(torch.equal(got[k], final[k]) for k in final)
    with pytest.raises(SystemExit, match="training-run directory"):
        cli._load_model_params(tcfg.ModelConfig(), str(run / "config.json"), False)

    stale = tmp_path / "stale"
    stale.mkdir()
    os.symlink(run / "checkpoints", stale / "checkpoints")
    changed = json.loads((run / "config.json").read_text())
    changed["model"]["vlad_cores"] = 16
    (stale / "config.json").write_text(json.dumps(changed))
    with pytest.raises(ValueError, match=r"stale architecture\?.*shape/dtype-mismatch=\['netvlad"):
        load_run_params(str(stale))
    with pytest.raises(FileNotFoundError, match="no config.json"):
        load_run_params(str(tmp_path))
    (tmp_path / "config.json").write_text((run / "config.json").read_text())
    with pytest.raises(FileNotFoundError, match="no checkpoints under"):
        load_run_params(str(tmp_path))
    assert not (tmp_path / "checkpoints").exists()


def test_cli_resume_without_a_checkpoint_starts_fresh(tmp_path):
    argv = ["train", "--toy_city", "--loss", "wms", "--device", "cpu", "--max_epoch", "0",
            "--vlad_cores", "8", "--image_height", "32", "--image_width", "40",
            "--compute_dtype", "float32", "--out_root", str(tmp_path), "--max_to_keep", "3"]
    assert cli.main(argv + ["--resume", "--out_folder", "run"]) == 0
    log = (tmp_path / "run" / "train_log.txt").read_text()
    assert "--resume requested but no checkpoint found; starting fresh" in log
    assert tcfg.TrainConfig.load(str(tmp_path / "run" / "config.json")).max_to_keep == 3
    # --resume reuses the folder; a fresh run without --out_folder gets a suffix
    assert cli.main(argv + ["--resume", "--out_folder", "run"]) == 0
    assert cli.main(argv) == 0 and cli.main(argv) == 0
    names = sorted(p.name for p in tmp_path.iterdir())
    assert len(names) == 3 and names[2] == "run" and names[1] == names[0] + "_000"


# ---------------------------------------------------------------- JAX -> port

def _flat(tree):
    return {k: np.asarray(v) for k, v in
            traverse_util.flatten_dict(jax.device_get(tree), sep="/").items()}


@pytest.mark.parametrize("optimizer", ["adam", "momentum"])
def test_a_jax_train_state_takes_the_same_next_step_in_the_port(tmp_path, optimizer):
    """The JAX trainer takes 4 steps on the toy city; its params, optax
    moments and step go over as numpy arrays; both packages then step on
    one numpy-made batch. Updates as fractions of the learning rate, as
    ``tests/test_torch_train_step.py`` compares them: with the moments
    carried over, Adam's next update agrees to 1e-3 of lr on every weight
    whose sqrt(nu) exceeds 100x Adam's eps (measured: 3e-4) and to 0.1 of lr
    on all (measured: 0.025; where the gradients so far were near zero,
    m / (sqrt(v) + eps) turns the two backward passes' rounding into a
    visible part of a step); SGD's per tensor to 1e-2 of the update's norm plus the
    fp32 grain of the weights. Losses to 1e-5 relative."""
    lr = 1e-4
    tuples = dict(positives_per_tuple=3, negatives_per_tuple=3, hard_positives_per_tuple=1,
                  hard_negatives_per_tuple=1)
    train = {**TRAIN, "optimizer": optimizer, "base_lr": lr}
    cfg_j = jcfg.TrainConfig(
        model=jcfg.ModelConfig(use_pallas=False, **MODEL), tuples=jcfg.TupleConfig(**tuples),
        loss=jcfg.LossConfig(name="wms"), **train)
    cfg_t = tcfg.TrainConfig(model=tcfg.ModelConfig(**MODEL), tuples=tcfg.TupleConfig(**tuples),
                             loss=tcfg.LossConfig(name="wms"), **train)
    source = JaxToyCitySource(**SOURCE)
    anchors = source.anchor_indices
    source.anchor_indices = lambda *a, **k: anchors(*a, **k)[:4]
    tr = JaxTrainer(cfg_j, source, out_dir=str(tmp_path / "jax"))
    tr._run_eval = lambda *a, **k: None
    tr.ckpts.save = lambda *a, **k: None
    tr.train()
    assert tr.global_step == 4
    inner = tr.state.opt_state.inner_state[0]
    moments = (dict(mu=_flat(inner.mu), nu=_flat(inner.nu), count=int(inner.count))
               if optimizer == "adam" else dict(trace=_flat(inner.trace)))
    before = _flat(tr.state.params)
    state = train_state_from_flax(cfg_t, before, int(tr.state.step), **moments)
    assert state.step == 4
    if optimizer == "adam":
        entry = state.optimizer.state_dict()["state"][0]
        assert entry["step"].item() == 4 and entry["exp_avg"].abs().sum() > 0

    rng = np.random.default_rng(5)
    images = rng.integers(0, 256, (7, 32, 40, 3), dtype=np.uint8)
    geo = rng.uniform(0.0, 40.0, (7, 7)).astype(np.float32)
    geo = (geo + geo.T) / 2
    np.fill_diagonal(geo, 0.0)
    jax_state, jax_metrics = tr.train_step(
        tr.state, {"images": jnp.asarray(images), "geo_dist_matrix": jnp.asarray(geo),
                   "epoch": jnp.float32(0.0)})
    want = params_from_flax(_flat(jax_state.params), cfg_t.model)
    tr.close()
    step = build_train_step(cfg_t, build_loss(cfg_t.loss, cfg_t.tuples, 1))
    state, metrics = step(state, {"images": torch.from_numpy(images),
                                  "geo_dist_matrix": torch.from_numpy(geo), "epoch": 0.0})
    assert state.step == 5
    assert metrics["loss"].item() == pytest.approx(float(jax_metrics["loss"]), rel=1e-5)
    p0 = params_from_flax(before, cfg_t.model)
    nu_hat = params_from_flax(moments["nu"], cfg_t.model) if optimizer == "adam" else None
    eps32 = torch.finfo(torch.float32).eps
    for name, p in state.model.state_dict().items():
        d_want = (want[name] - p0[name]) / lr
        err = ((p - p0[name]) / lr - d_want).abs()
        assert d_want.abs().max() > 0, name
        if optimizer == "adam":
            big = nu_hat[name].sqrt() > 1e-6
            assert err.max().item() <= 0.1, (name, err.max().item())
            assert not big.any() or err[big].max().item() <= 1e-3, name
        else:
            grain = 4 * eps32 * p0[name].abs().max().item() / lr * err.numel() ** 0.5
            assert err.norm().item() <= 1e-2 * d_want.norm().item() + grain, name


def test_pn_resume_equals_the_uninterrupted_run(tmp_path):
    """A PN loss (two Adam updates a step) stopped after its part
    checkpoint of step 5 and taken up again: parameters, Adam's moments and
    its count (2 per step: 24 after 12 steps) bit-equal to the
    uninterrupted run's, and ``metrics_local.jsonl`` (with ``loss_pos`` and
    ``loss_neg``) going on with its values. Hard mining off, every other
    anchor: 12 steps."""
    cfg = dataclasses.replace(_cfg(0, save_step=5, eval_step=100, train_ref_r=16),
                              loss=tcfg.LossConfig(name="pairwise_distance_neg_eigenvalue"))
    whole, _, _ = _run(cfg, tmp_path / "a")
    resumed, _, ctx = _run(cfg, _stopped_copy(tmp_path / "a", tmp_path / "b", 5),
                           resume_role="part")
    assert ctx["step"] == 5 and whole.global_step == resumed.global_step == 12
    a, b = whole.state.model.state_dict(), resumed.state.model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    oa = whole.state.optimizer.state_dict()["state"]
    ob = resumed.state.optimizer.state_dict()["state"]
    assert {int(s["step"]) for s in oa.values()} == {24}
    assert all(torch.equal(oa[i][k], ob[i][k]) for i in oa
               for k in ("step", "exp_avg", "exp_avg_sq"))
    got = _records(resumed)
    assert got == _records(whole, after=5)
    assert {tag for _, tag, _ in got} == {"loss", "learning_rate", "loss_pos", "loss_neg"}
    assert [s for s, tag, _ in got if tag == "loss_neg"] == list(range(6, 13))


# ---------------------------------------------------------------- resume with the heads

def _resume_pair(cfg, root, step):
    """The uninterrupted run and the one stopped after its part checkpoint
    of ``step`` and taken up again, with their directories removed (each
    checkpoint holds the full VGG16 and Adam's moments, ~180 MB)."""
    try:
        whole, _, _ = _run(cfg, root / "a")
        resumed, _, ctx = _run(cfg, _stopped_copy(root / "a", root / "b", step),
                               resume_role="part")
        saved = resumed.ckpts.load("part", step)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    assert ctx["step"] == step and whole.global_step == resumed.global_step == 24
    a, b = whole.state.model.state_dict(), resumed.state.model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    oa = whole.state.optimizer.state_dict()["state"]
    ob = resumed.state.optimizer.state_dict()["state"]
    assert all(torch.equal(oa[i][k], ob[i][k]) for i in oa
               for k in ("step", "exp_avg", "exp_avg_sq"))
    assert _records(resumed) == _records(whole, after=step)
    return whole, resumed, saved


@pytest.mark.parametrize("async_pca", [True, False])
def test_pca_resume_equals_the_uninterrupted_run(tmp_path, async_pca):
    """``reduction='pca'`` with ``incremental_residual_mm``, stopped after
    the part checkpoint of step 10 (mid-segment, the updater drained there)
    and taken up again: parameters, Adam's moments, the losses and both
    streaming PCAs (every array and count) bit-equal to the uninterrupted
    run's. Hard mining off (the cache rebuilt at step 10's weights, and
    whitened by step 10's PCA, changes no tuple)."""
    model = tcfg.ModelConfig(**MODEL, reduction="pca", out_dim=8)
    cfg = dataclasses.replace(_cfg(0, save_step=10, eval_step=100), model=model,
                              async_pca=async_pca,
                              loss=tcfg.LossConfig(name="incremental_residual_mm", loss_dim=4))
    whole, resumed, saved = _resume_pair(cfg, tmp_path / "runs", 10)
    assert saved["pca"]["true_seen"] > 0 and saved["loss_pca"]["true_seen"] > 0
    for got, want in ((resumed.pca, whole.pca), (resumed.loss_pca, whole.loss_pca)):
        sa, sb = got.state_dict(), want.state_dict()
        assert all(np.array_equal(np.asarray(sa[k]), np.asarray(sb[k])) for k in sa), sa.keys()


def test_two_fc_resume_restores_the_dropout_generator(tmp_path):
    """``2fc`` draws dropout masks from the train state's generator, which
    the checkpoint carries: the run resumed at step 10 is the
    uninterrupted run, bit for bit; a resume that lost the generator's
    state would draw other masks."""
    # NetVLAD-2: a 1,024-wide descriptor keeps the 4,096-wide hidden layer small
    model = tcfg.ModelConfig(**{**MODEL, "vlad_cores": 2}, reduction="2fc", out_dim=16)
    cfg = dataclasses.replace(_cfg(0, save_step=10, eval_step=100), model=model)
    whole, resumed, saved = _resume_pair(cfg, tmp_path / "runs", 10)
    assert torch.equal(whole.state.rng.get_state(), resumed.state.rng.get_state())
    assert not torch.equal(saved["rng"], torch.Generator().manual_seed(cfg.seed).get_state())


def test_a_checkpoint_from_before_the_pca_restores_with_none(tmp_path):
    """A payload without ``pca``/``loss_pca`` (written before the first
    refresh) leaves the trainer's fresh, uninitialized PCAs."""
    model = tcfg.ModelConfig(**MODEL, reduction="pca", out_dim=8)
    cfg = dataclasses.replace(_cfg(0), model=model,
                              loss=tcfg.LossConfig(name="incremental_mm", loss_dim=4))
    tr = Trainer(cfg, ToyCitySource(**SOURCE), out_dir=str(tmp_path), device="cpu")
    tr.ckpts.save("part", 0, tr.state, tr._extras(), pca=tr._pca_sd(), loss_pca=tr._loss_pca_sd())
    assert "pca" not in tr.ckpts.load("part", 0)
    assert tr.resume_latest("part")
    assert tr.pca is not None and not tr.pca.initialized and not tr.loss_pca.initialized
    tr.close()


def test_a_jax_run_s_streaming_pcas_go_over_as_they_are(tmp_path):
    """A JAX run handed over: its parameters through
    ``train_state_from_flax``, its ``pca`` and ``loss_pca`` state dicts
    (numpy) as they are into a checkpoint of the port's, which a fresh
    Trainer takes up; the Trainer's PCAs then hold every array and count of
    JAX's, and the step is fed JAX's components, mean, variance and loss
    PCA."""
    from soft_contrastive_learning_tpu.models.model import init_params as jax_init_params
    from soft_contrastive_learning_tpu.pca.incremental import StreamingPCA as JaxPCA

    model = dict(MODEL, reduction="pca", out_dim=6, vlad_cores=2)
    rng = np.random.default_rng(9)
    pcas = []
    for dim, width in ((6, 2 * 512), (3, 6)):
        pca = JaxPCA(dim, 0.4)
        pca.init(rng.standard_normal((12, width)).astype(np.float32))
        pca.update(rng.standard_normal((5, width)).astype(np.float32))
        pcas.append(pca.state_dict())
    params = _flat(jax_init_params(jcfg.ModelConfig(use_pallas=False, **model),
                                   jax.random.key(0)))
    cfg = dataclasses.replace(_cfg(0), model=tcfg.ModelConfig(**model),
                              loss=tcfg.LossConfig(name="incremental_mm", loss_dim=3))
    state = train_state_from_flax(cfg, params, 3)
    tr = Trainer(cfg, ToyCitySource(**SOURCE), out_dir=str(tmp_path), device="cpu")
    tr.ckpts.save("part", 3, state, tr._extras(), pca=pcas[0], loss_pca=pcas[1])
    assert tr.resume_latest("part") and tr.global_step == 3
    for got, want in ((tr.pca, pcas[0]), (tr.loss_pca, pcas[1])):
        sd = got.state_dict()
        assert sd.keys() == want.keys()
        assert all(np.array_equal(np.asarray(sd[k]), np.asarray(want[k])) for k in want)
    fed = tr._augment_batch({})
    for key, (sd, name) in {"pca_components": (0, "v"), "pca_mean": (0, "m"),
                            "pca_variance": (0, "var"), "loss_pca_s": (1, "s"),
                            "loss_pca_v": (1, "v"), "loss_pca_m": (1, "m")}.items():
        assert np.array_equal(fed[key].numpy(), pcas[sd][name]), key
    assert fed["loss_pca_seen"] == float(np.float32(pcas[1]["seen"]))
    weights = tr.state.model.state_dict()
    assert all(torch.equal(weights[k], v) for k, v in params_from_flax(params, cfg.model).items())
    tr.close()
