"""The port's in-training eval hooks against the JAX trainer's on the CPU.

Both trainers run one epoch of the same small toy city (the geometry of
``tests/test_torch_trainer.py``: 64x80 images, NetVLAD-8, fp32, one tuple of
1+3+3, 24 anchors) from the same weights and seed, with the eval hooks on:
``eval_step=12`` fires them at anchors 0 and 12, each time over 4 queries
and every 4th reference pose. The JAX sampler's KD-tree is wrapped in the
sorted shim of ``tests/test_torch_sampler.py`` so both draw the same tuples;
the JAX checkpoint writes are stubbed (the port has none yet).
"""

import jax
import numpy as np
import pytest
import torch
from flax import traverse_util
from sklearn.neighbors import KDTree

import soft_contrastive_learning_tpu.sampling.tuples as jax_tuples
from soft_contrastive_learning_tpu.core import config as jcfg
from soft_contrastive_learning_tpu.data.pipeline import ToyCitySource as JaxToyCitySource
from soft_contrastive_learning_tpu.evaluation import metrics as jax_metrics
from soft_contrastive_learning_tpu.train.trainer import Trainer as JaxTrainer
from soft_contrastive_learning_torch.core import config as tcfg
from soft_contrastive_learning_torch.data.pipeline import ToyCitySource
from soft_contrastive_learning_torch.evaluation import metrics
from soft_contrastive_learning_torch.models.weights import params_from_flax
from soft_contrastive_learning_torch.train.trainer import Trainer

torch.set_num_threads(1)  # tier-1 runs several workers on one host

TRAIN = dict(tuples_per_batch=1, max_epoch=1, base_lr=5e-6, mining_step=6,
             mining_cache_size=10, eval_step=12, save_step=12, num_eval_queries=4,
             eval_ref_r=4, seed=0)
TUPLES = dict(positives_per_tuple=3, negatives_per_tuple=3, hard_positives_per_tuple=1,
              hard_negatives_per_tuple=1)
SOURCE = dict(num_points=24, radius=30.0, img_h=64, img_w=80, seed=3)
LOCALIZATION_TAGS = {f"{r}m-auc@Top1" for r in (50, 25, 10)} | {f"%<{r}m@Top1"
                                                                 for r in (50, 25, 10)}


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


def _by_tag(records):
    """{tag: [(step, value), ...]} in file order."""
    out = {}
    for r in records:
        out.setdefault(r["tag"], []).append((r["step"], r["value"]))
    return out


class _Windows:
    """Records what the hooks ask of a trainer: the rows they embed and
    the anchors they sample, per call."""

    def __init__(self, trainer):
        self.embedded, self.sampled = [], []
        extract, sampler_for = trainer.extract_features, trainer._sampler_for

        def extract_features(meta, indices, *a, **k):
            self.embedded.append(list(np.asarray(meta["t"])[np.asarray(indices, dtype=int)]))
            return extract(meta, indices, *a, **k)

        def _sampler_for(meta, rng=None):
            sampler = sampler_for(meta, rng=rng)
            if rng is trainer.eval_rng:
                sample = sampler.sample

                def recording_sample(anchors, **k):
                    self.sampled.append([meta["t"][i] for i in anchors])
                    return sample(anchors, **k)

                sampler.sample = recording_sample
            return sampler

        trainer.extract_features = extract_features
        trainer._sampler_for = _sampler_for


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
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
        tr.ckpts.save = lambda *a, **k: None
        windows = _Windows(tr)
        tr.train()
        records = {role: tr.writers[role].read_all() for role in ("local", "other")}
        tr.close()
    finally:
        mp.undo()
    return init, records, windows


def _port_train(init, out_dir, hooks=True):
    tr = Trainer(_port_cfg(), ToyCitySource(**SOURCE), out_dir=out_dir, device="cpu",
                 params={k: v.clone() for k, v in init.items()})
    windows = _Windows(tr)
    if not hooks:
        tr._run_eval = lambda *a, **k: None
    tr.train()
    tr.close()
    return tr, windows


@pytest.fixture(scope="module")
def port_run(jax_run, tmp_path_factory):
    init = params_from_flax(jax_run[0], _port_cfg().model)
    tr, windows = _port_train(init, str(tmp_path_factory.mktemp("port")))
    return tr, {role: tr.writers[role].read_all() for role in ("local", "other")}, windows, init


def test_hooks_fire_where_the_jax_loop_fires_them(jax_run, port_run):
    """Anchors 0 and 12 of 24, at one tuple a step: before steps 1 and 13,
    so the scalars carry global_step 0 and 12, in both packages."""
    for records in (jax_run[1], port_run[1]):
        other, local = _by_tag(records["other"]), _by_tag(records["local"])
        assert set(other) == {"loss"} | LOCALIZATION_TAGS
        assert set(local) == {"loss", "learning_rate"} | LOCALIZATION_TAGS
        for tag in LOCALIZATION_TAGS:
            assert [s for s, _ in other[tag]] == [s for s, _ in local[tag]] == [0, 12]
        assert [s for s, _ in other["loss"]] == [0, 12]
    # the port's records are in step order: the eval at step 12 comes after
    # the twelfth train loss in the file
    steps = [r["step"] for r in port_run[1]["local"]]
    assert steps == sorted(steps)


def test_same_windows_per_eval_ordinal(jax_run, port_run):
    """The held-out loss samples the same anchors and the localization
    embeds the same reference and query rows, firing by firing."""
    want, got = jax_run[2], port_run[2]
    assert got.sampled == want.sampled and len(got.sampled) == 2 * 4
    # mining refreshes and evals, in the order they ran
    assert got.embedded == want.embedded
    assert got.sampled[:4] != got.sampled[4:]  # ordinal 1 is another window


def test_localization_scalars_are_the_jax_trainer_s(jax_run, port_run):
    """Exactly equal: with the same retrieved ids the scalars are the same
    float64 numpy arithmetic on the same coordinates."""
    for role in ("other", "local"):
        want, got = _by_tag(jax_run[1][role]), _by_tag(port_run[1][role])
        for tag in LOCALIZATION_TAGS:
            assert got[tag] == want[tag], (role, tag)
    values = [v for tag in LOCALIZATION_TAGS
              for _, v in _by_tag(port_run[1]["other"])[tag]]
    assert np.isfinite(values).all() and max(values) > 0


def test_held_out_loss_matches(jax_run, port_run):
    """Mean of four eval batches in fp32 on the two frameworks, the second
    after 12 Adam steps at lr 5e-6: 2e-5 relative."""
    want = [v for _, v in _by_tag(jax_run[1]["other"])["loss"]]
    got = [v for _, v in _by_tag(port_run[1]["other"])["loss"]]
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=0)
    assert got[0] != got[1]


def test_eval_rng_is_its_own_stream(port_run, tmp_path):
    """With the hooks stubbed the training losses are the same bits: the
    hooks draw from ``eval_rng`` and leave the sampler's stream alone."""
    tr, records, _, init = port_run
    bare, _ = _port_train(init, str(tmp_path), hooks=False)
    assert bare.writers["other"].read_all() == []
    assert _by_tag(bare.writers["local"].read_all())["loss"] == _by_tag(records["local"])["loss"]
    assert tr.eval_rng.bit_generator.state != np.random.default_rng(1).bit_generator.state


def test_metrics_copy_matches_the_jax_module():
    rng = np.random.default_rng(0)
    q, r = rng.uniform(0, 100, (7, 2)), rng.uniform(0, 100, (9, 2))
    idx = rng.integers(0, 9, (7, 5))
    opt = np.linalg.norm(q[:, None] - r[None], axis=-1).min(1)
    got_s, got_c = metrics.localization_summary(q, r, idx, opt)
    want_s, want_c = jax_metrics.localization_summary(q, r, idx, opt)
    assert got_s == want_s and got_c.keys() == want_c.keys()
    for rad in want_c:
        for key in want_c[rad]:
            np.testing.assert_array_equal(got_c[rad][key], want_c[rad][key])


def test_cluster_meta_and_test_sets_match_the_jax_source():
    want, got = JaxToyCitySource(**SOURCE), ToyCitySource(**SOURCE)
    for set_name in ("train_ref", "test_ref"):
        assert got.cluster_meta(set_name, 4) == want.cluster_meta(set_name, 4)
        assert len(got.cluster_meta(set_name, 4)["t"]) == 6
    assert got.epoch_meta("test_query", 1) == want.epoch_meta("test_query", 1)
    key = tuple(got.epoch_meta("test_query", 0)[k][0] for k in ("date", "folder", "t"))
    np.testing.assert_array_equal(got.load_image(key), want.load_image(key))


def test_save_plots_writes_the_curves(port_run, tmp_path):
    """One localization call with ``save_plots``: a PDF per radius; the
    triptychs need OpenCV, which this host has."""
    pytest.importorskip("matplotlib")
    pytest.importorskip("cv2")
    tr = Trainer(_port_cfg(), ToyCitySource(**SOURCE), out_dir=str(tmp_path), device="cpu",
                 params=port_run[3], save_plots=True)
    scalars = tr.evals.localization(0, 0, "test_ref", "test_query", "other", 0)
    tr.close()
    assert set(scalars) == LOCALIZATION_TAGS
    assert sorted(p.name for p in tmp_path.glob("*.pdf")) == [
        "other_00_0_10.pdf", "other_00_0_25.pdf", "other_00_0_50.pdf"]
    assert len(list((tmp_path / "other_00_0_examples").glob("*.png"))) == 4


@pytest.mark.parametrize("loss", ["quadruplet", "pairwise_distance_neg_eigenvalue"])
def test_held_out_loss_runs_the_configured_loss(jax_run, loss, tmp_path, monkeypatch):
    """The held-out loss of a quadruplet loss (the eval sampler draws
    (1, 3, 2, 1) tuples) and of a PN loss (whose record adds ``loss_pos``
    and ``loss_neg``, as JAX's eval step returns them), from the same
    weights as the JAX trainer's hook: the same tags, values within 2e-5
    relative (as above) plus 1e-6. The neg part is the smallest eigenvalue
    of a nearly rank-one Gram (an untrained net's descriptors nearly
    coincide): -2e-4 here, and an fp32 eigensolve errs by ~eps times the
    Gram's trace (4 for four unit descriptors), 5e-7, whatever the
    eigenvalue's size (measured 2.7e-7)."""
    monkeypatch.setattr(jax_tuples, "KDTree", SortedKDTree)
    jax_cfg = jcfg.TrainConfig(
        model=jcfg.ModelConfig(vlad_cores=8, image_height=64, image_width=80,
                               compute_dtype="float32", use_pallas=False),
        tuples=jcfg.TupleConfig(**TUPLES), loss=jcfg.LossConfig(name=loss), **TRAIN)
    jtr = JaxTrainer(jax_cfg, JaxToyCitySource(**SOURCE), out_dir=str(tmp_path / "jax"))
    jtr.state = jtr.state._replace(params=jax.device_put(
        traverse_util.unflatten_dict(jax_run[0], sep="/")))
    jtr.evals.loss_other(0, 0, 0)
    cfg = tcfg.TrainConfig(**{**_port_cfg().__dict__, "loss": tcfg.LossConfig(name=loss)})
    tr = Trainer(cfg, ToyCitySource(**SOURCE), out_dir=str(tmp_path / "port"), device="cpu",
                 params=params_from_flax(jax_run[0], cfg.model))
    shapes = []
    sampler_for = tr._sampler_for
    tr._sampler_for = lambda meta, rng=None: shapes.append(
        sampler_for(meta, rng).tuple_shape) or sampler_for(meta, rng)
    tr.evals.loss_other(0, 0, 0)
    want, got = _by_tag(jtr.writers["other"].read_all()), _by_tag(tr.writers["other"].read_all())
    jtr.close()
    tr.close()
    assert shapes == [cfg.tuple_shape] == [(1, 3, 2, 1) if loss == "quadruplet" else (1, 3, 3)]
    assert got.keys() == want.keys() == (
        {"loss"} if loss == "quadruplet" else {"loss", "loss_pos", "loss_neg"})
    for tag in want:
        np.testing.assert_allclose([v for _, v in got[tag]], [v for _, v in want[tag]],
                                   rtol=2e-5, atol=1e-6)
