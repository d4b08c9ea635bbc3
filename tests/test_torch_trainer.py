"""The port's toy-city trainer on the CPU, alone and against the JAX trainer.

Geometry of ``tests/test_train_e2e.py``: 64x80 images, NetVLAD-8, fp32,
one tuple of 1+3+3, 24 anchors, ``mining_step=6`` with a cache of 10. Both
trainers start from the same weights (the JAX init through
``params_from_flax``) and the same seed. The JAX sampler's KD-tree is
wrapped, in this file only, in a shim whose ``query_radius`` returns sorted
neighbour arrays, as the port's ``cKDTree.query_ball_point(...,
return_sorted=True)`` does, so the two samplers draw the same tuples.
"""

import json

import jax
import numpy as np
import pytest
import torch
from flax import traverse_util
from sklearn.neighbors import KDTree

import soft_contrastive_learning_tpu.sampling.tuples as jax_tuples
from soft_contrastive_learning_tpu.core import config as jcfg
from soft_contrastive_learning_tpu.data.pipeline import ToyCitySource as JaxToyCitySource
from soft_contrastive_learning_tpu.train.trainer import Trainer as JaxTrainer
from soft_contrastive_learning_torch.core import config as tcfg
from soft_contrastive_learning_torch.data.pipeline import ToyCitySource
from soft_contrastive_learning_torch.models.weights import params_from_flax
from soft_contrastive_learning_torch.ops.kernels.netvlad import netvlad_aggregate_cuda
from soft_contrastive_learning_torch.train.trainer import Trainer

torch.set_num_threads(1)  # tier-1 runs several workers on one host

# base_lr is the reference's 5e-6: at 1e-4 Adam's per-weight steps amplify
# the frameworks' rounding until the mining order, and with it the tuples,
# part ways after the second refresh
TRAIN = dict(tuples_per_batch=1, max_epoch=1, base_lr=5e-6, mining_step=6,
             mining_cache_size=10, eval_step=8, save_step=8, num_eval_queries=4, eval_ref_r=4,
             seed=0)
TUPLES = dict(positives_per_tuple=3, negatives_per_tuple=3, hard_positives_per_tuple=1,
              hard_negatives_per_tuple=1)
SOURCE = dict(num_points=24, radius=30.0, img_h=64, img_w=80, seed=3)


class SortedKDTree:
    """sklearn's KDTree with sorted ``query_radius`` results."""

    def __init__(self, xy):
        self._tree = KDTree(xy)

    def query_radius(self, x, r):
        found = self._tree.query_radius(x, r=r)
        out = np.empty(len(found), dtype=object)
        out[:] = [np.sort(a) for a in found]
        return out


def _port_cfg():
    return tcfg.TrainConfig(
        model=tcfg.ModelConfig(vlad_cores=8, image_height=64, image_width=80,
                               compute_dtype="float32"),
        tuples=tcfg.TupleConfig(**TUPLES), loss=tcfg.LossConfig(name="wms"), **TRAIN)


def _losses(records):
    return np.array([r["value"] for r in records if r["tag"] == "loss"])


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """One JAX epoch (eval and checkpoint writes stubbed: they draw from
    their own rng and leave the training stream alone)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_tuples, "KDTree", SortedKDTree)
    try:
        cfg = jcfg.TrainConfig(
            model=jcfg.ModelConfig(vlad_cores=8, image_height=64, image_width=80,
                                   compute_dtype="float32", use_pallas=False),
            tuples=jcfg.TupleConfig(**TUPLES), loss=jcfg.LossConfig(name="wms"), **TRAIN)
        tr = JaxTrainer(cfg, JaxToyCitySource(**SOURCE),
                        out_dir=str(tmp_path_factory.mktemp("jax")))
        init = {k: np.asarray(v) for k, v in
                traverse_util.flatten_dict(jax.device_get(tr.state.params), sep="/").items()}
        tr._run_eval = lambda *a, **k: None
        tr.ckpts.save = lambda *a, **k: None
        tr.train()
        losses = _losses(tr.writers["local"].read_all())
        tr.close()
    finally:
        mp.undo()
    return init, losses, tr.global_step


@pytest.fixture(scope="module")
def port_run(jax_run, tmp_path_factory):
    init = params_from_flax(jax_run[0], _port_cfg().model)
    before = netvlad_aggregate_cuda.launches
    tr = Trainer(_port_cfg(), ToyCitySource(**SOURCE),
                 out_dir=str(tmp_path_factory.mktemp("port")), device="cpu",
                 params={k: v.clone() for k, v in init.items()})
    tr.train()
    tr.close()
    return tr, init, netvlad_aggregate_cuda.launches - before


def test_epoch_geometry(port_run):
    """24 anchors at 1 tuple per step; refreshes at steps 0, 6, 12, 18."""
    tr, _, launches = port_run
    n_anchors = len(ToyCitySource(**SOURCE).anchor_indices("train_ref", 1, 0))
    assert tr.global_step == n_anchors // tr.cfg.tuples_per_batch == 24
    assert tr.mining.refresh_count == 4
    assert tr.state.step == 24
    assert launches == 0  # no kernel launch on CPU tensors
    assert tr.used_images and max(tr.used_images) < 24


def test_losses_are_finite_and_params_moved(port_run):
    tr, init, _ = port_run
    losses = _losses(tr.writers["local"].read_all())
    assert losses.shape == (24,) and np.isfinite(losses).all()
    state = tr.state.model.state_dict()
    moved = {k: (state[k] - init[k]).abs().max().item() for k in init}
    assert all(v > 0 for v in moved.values()), [k for k, v in moved.items() if v == 0]


def test_jsonl_records(port_run):
    """The JAX MetricsWriter's records: one loss and one learning_rate per
    step, steps counted from 1 (the evals' scalars share the file)."""
    recs = port_run[0].writers["local"].read_all()
    assert {tuple(sorted(r)) for r in recs} == {("step", "t", "tag", "value")}
    assert [r["step"] for r in recs if r["tag"] == "loss"] == list(range(1, 25))
    lrs = [r["value"] for r in recs if r["tag"] == "learning_rate"]
    assert lrs == [pytest.approx(5e-6)] * 24


def test_loss_sequence_matches_the_jax_trainer(jax_run, port_run):
    """Same weights, same seed, hence the same tuples: up to the first
    refresh after step 0 (steps 1-6) the per-step losses agree to 1e-6
    relative; over the whole epoch, four refreshes included, to 1e-4. The
    two frameworks sum convolutions and products in other orders (fp32,
    ~1e-7 a step), and Adam moves every weight by ~lr whatever its
    gradient's size, so the weights drift apart a little more each step. A
    different tuple would move a loss by ~1e-2."""
    _, want, jax_steps = jax_run
    got = _losses(port_run[0].writers["local"].read_all())
    assert jax_steps == port_run[0].global_step == 24
    np.testing.assert_allclose(got[:6], want[:6], rtol=1e-6, atol=0)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=0)


def test_cli_train_flags_are_jax_flags_with_jax_defaults():
    import argparse

    from soft_contrastive_learning_tpu.cli import _add_train_flags as jax_train_flags
    from soft_contrastive_learning_torch.cli import build_parser

    jax_parser = argparse.ArgumentParser()
    jax_train_flags(jax_parser)
    jax_defaults = {a.dest: a.default for a in jax_parser._actions}
    sub = next(a for a in build_parser()._actions if isinstance(a, argparse._SubParsersAction))
    ours = {a.dest: a.default for a in sub.choices["train"]._actions if a.dest != "help"}
    assert ours.pop("device") == "cuda"  # the port's own flag, as for serve
    # the port's own flag: LossConfig.fused_wms (K3), which scl-tpu sets in code only
    assert ours.pop("fused_wms") is False
    assert set(ours) <= set(jax_defaults)
    assert {k: jax_defaults[k] for k in ours} == ours
    # the loss zoo's flags, and the reduction heads' and streaming PCAs'
    assert {"loss", "margin_1", "margin_2", "lam", "msmining", "loss_dim"} <= set(ours)
    assert {"reduction", "out_dim", "vlad_cores", "L", "f"} <= set(ours)


def test_cli_train_runs_a_toy_city_epoch_on_the_cpu(tmp_path):
    from soft_contrastive_learning_torch.cli import main
    from soft_contrastive_learning_torch.core.logging import MetricsWriter

    argv = ["train", "--toy_city", "--device", "cpu", "--out_root",  # --loss: its default, wrd
            str(tmp_path), "--out_folder", "run", "--image_height", "32", "--image_width", "32",
            "--vlad_cores", "8", "--compute_dtype", "float32", "--positives_per_tuple", "1",
            "--negatives_per_tuple", "1", "--hard_positives_per_tuple", "1",
            "--hard_negatives_per_tuple", "1", "--max_epoch", "1", "--mining_step", "4",
            "--mining_cache_size", "8", "--train_ref_r", "40", "--num_eval_queries", "2",
            "--eval_ref_r", "20",
            "--device_image_pool", "false"]  # the host-fed step and embed
    assert main(argv) == 0
    recs = MetricsWriter(str(tmp_path / "run"), "local").read_all()
    losses = _losses(recs)
    # one anchor per 40 m of the 120-pose loop: 24 anchors, 2 tuples a step
    assert len(losses) == 12 and np.isfinite(losses).all()
    assert json.loads((tmp_path / "run" / "config.json").read_text())["loss"]["name"] == "wrd"
    # the eval hooks fired before the first step: held-out loss and localization
    other = MetricsWriter(str(tmp_path / "run"), "other").read_all()
    assert {r["step"] for r in other} == {0} and "loss" in {r["tag"] for r in other}
