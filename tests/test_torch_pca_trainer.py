"""A toy-city epoch with the streaming PCAs in play, the port's trainer
against the JAX trainer on the CPU: ``reduction='pca'`` (the projection of
the raw descriptor by the streaming PCA, ``out_dim`` 8) and the
``incremental_residual_mm`` loss on its output (the loss PCA, ``loss_dim``
4), with the updates on a worker thread (``async_pca``, lag-2 feeds) and on
the training loop (each step's update before the next step).

Geometry of ``test_torch_trainer.py``: 64x80 images, NetVLAD-8, fp32, one
tuple of 1+3+3, 24 anchors, ``mining_step=6`` over a cache of 10 (so each
refresh embeds 16 images: the PCA is initialized from them and updated in
chunks of a batch), the same weights and seed on both sides, hard mining
off; both drain their updater where the JAX loop does (the evals at steps
0, 8 and 16, and the part saves; the evals' work and the writes are
stubbed on both sides).

Such a run is sensitive in both packages. A PCA update keeps the top 8 of
~16 singular values, where the 8th and 9th may lie close, and whitening
divides by the kept variances, so the smallest difference in a descriptor
can swap a component: two port runs whose weights differ by one ulp part
after the first fed update as the port and JAX do (2e-6 at steps 1-2, 7e-5
at step 3, ~1e-2 from step 8 on). And the loss on whitened residuals
passes the descriptors' last-bit differences on to the weights: fed the
same PCA states, two such port runs still part by up to 6e-2 over the
epoch. So the schedule is compared exactly (the version of each PCA that
every step is fed: its ``seen`` and ``true_seen`` counts, functions of the
update sequence alone), and the numbers with the feedback cut: the port is
fed, at each step, the state the JAX run fed its step (its own PCAs go on
updating from its own features), and its losses are held to the first
step's 1e-5 and, over the epoch, to the floor that a one-ulp nudge of the
weights gives the same fed run.
"""

import jax
import numpy as np
import pytest
import torch
from flax import traverse_util

import soft_contrastive_learning_tpu.sampling.tuples as jax_tuples
from soft_contrastive_learning_tpu.core import config as jcfg
from soft_contrastive_learning_tpu.data.pipeline import ToyCitySource as JaxToyCitySource
from soft_contrastive_learning_tpu.train.trainer import Trainer as JaxTrainer
from soft_contrastive_learning_torch.core import config as tcfg
from soft_contrastive_learning_torch.data.pipeline import ToyCitySource
from soft_contrastive_learning_torch.models.weights import params_from_flax
from soft_contrastive_learning_torch.train.trainer import Trainer
from test_torch_trainer import SOURCE, SortedKDTree, _losses

torch.set_num_threads(1)  # tier-1 runs several workers on one host

TRAIN = dict(tuples_per_batch=1, max_epoch=1, base_lr=5e-6, mining_step=6,
             mining_cache_size=10, eval_step=8, save_step=8, num_eval_queries=4, eval_ref_r=4,
             seed=0)
TUPLES = dict(positives_per_tuple=3, negatives_per_tuple=3, hard_positives_per_tuple=0,
              hard_negatives_per_tuple=0)
MODEL = dict(vlad_cores=8, reduction="pca", out_dim=8, image_height=64, image_width=80,
             compute_dtype="float32")
LOSS = dict(name="incremental_residual_mm", loss_dim=4)


def _cfg(pkg, async_pca):
    model = dict(MODEL, use_pallas=False) if pkg is jcfg else MODEL
    return pkg.TrainConfig(model=pkg.ModelConfig(**model), tuples=pkg.TupleConfig(**TUPLES),
                           loss=pkg.LossConfig(**LOSS), async_pca=async_pca, **TRAIN)


def _pca_state(pca):
    sd = pca.state_dict()
    return {k: np.asarray(sd[k]) for k in ("s", "v", "m", "var", "seen", "true_seen")}


FEED_KEYS = ("pca_components", "pca_mean", "pca_variance", "loss_pca_s", "loss_pca_v",
             "loss_pca_m", "loss_pca_seen")


def _recording(tr, schedule, feeds=None, replace=None):
    """Wrap a trainer's ``_augment_batch``: record the versions each step is
    fed (``schedule``: the pca's and the loss pca's seen and true_seen) and
    the fed arrays (``feeds``); with ``replace``, feed step i the i-th of
    those arrays instead (the port fed the JAX run's states)."""
    augment = tr._augment_batch

    def counts(sd):
        return None if sd is None else (float(sd["seen"]), float(sd["true_seen"]))

    def recorded(batch, snaps=None):
        live = snaps if snaps is not None else (tr._pca_sd(), tr._loss_pca_sd())
        schedule.append(tuple(counts(sd) for sd in live))
        out = augment(batch, snaps)
        if feeds is not None:
            feeds.append({k: np.asarray(out[k]) for k in FEED_KEYS})
        if replace is not None:
            fed = replace[len(schedule) - 1]
            out.update({k: float(v) if np.ndim(v) == 0 else torch.from_numpy(v)
                        for k, v in fed.items()})
        return out

    tr._augment_batch = recorded


def _jax_run(async_pca, tmp):
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_tuples, "KDTree", SortedKDTree)
    try:
        tr = JaxTrainer(_cfg(jcfg, async_pca), JaxToyCitySource(**SOURCE), out_dir=str(tmp))
        init = {k: np.asarray(v) for k, v in
                traverse_util.flatten_dict(jax.device_get(tr.state.params), sep="/").items()}

        def drain_only(*a, **k):  # the eval's drain without its work
            if tr._updater is not None:
                tr._updater.drain()

        tr._run_eval = drain_only
        tr.ckpts.save = lambda *a, **k: None
        schedule, feeds = [], []
        _recording(tr, schedule, feeds)
        tr.train()
        losses = _losses(tr.writers["local"].read_all())
        tr.close()
    finally:
        mp.undo()
    return init, losses, schedule, feeds, _pca_state(tr.pca), _pca_state(tr.loss_pca)


def _port_run(async_pca, init, tmp, replace=None):
    cfg = _cfg(tcfg, async_pca)
    tr = Trainer(cfg, ToyCitySource(**SOURCE), out_dir=str(tmp), device="cpu",
                 params=params_from_flax(init, cfg.model))
    tr.evals.loss_other = lambda *a, **k: None
    tr.evals.localization = lambda *a, **k: None
    tr.ckpts.save = lambda *a, **k: None  # as JAX's: the trainer still drains before it
    schedule = []
    _recording(tr, schedule, replace=replace)
    tr.train()
    tr.close()
    return tr, _losses(tr.writers["local"].read_all()), schedule


def _nudged(init):
    """The weights one ulp up: the floor of what rounding alone can move."""
    return {k: (v * np.float32(1 + 2**-23)).astype(v.dtype) for k, v in init.items()}


@pytest.fixture(scope="module", params=[True, False], ids=["async", "sync"])
def runs(request, tmp_path_factory):
    """The JAX run, the port's run fed JAX's states, and the same from the
    weights nudged by one ulp."""
    jax_side = _jax_run(request.param, tmp_path_factory.mktemp("jax"))
    fed = _port_run(request.param, jax_side[0], tmp_path_factory.mktemp("fed"),
                    replace=jax_side[3])
    nudged = _port_run(request.param, _nudged(jax_side[0]), tmp_path_factory.mktemp("nudged"),
                       replace=jax_side[3])
    return request.param, jax_side, fed, nudged


def test_the_epoch_runs_with_both_pcas(runs):
    _, _, (tr, losses, _), _ = runs
    assert tr.global_step == 24 and tr.mining.refresh_count == 4
    assert losses.shape == (24,) and np.isfinite(losses).all()
    # initialized from the first window (16 images), then 24 step updates
    # and three windows of 16 in chunks of 7 (three chunks each)
    assert tr.pca.true_seen == 16 + 24 * 7 + 3 * 16
    assert tr.loss_pca.true_seen == 5 + 24 * 6  # 5 = loss_dim + 1 residual pairs


def test_every_step_is_fed_the_version_jax_feeds(runs):
    """Lag 2 (async) or lag 1 (sync), the drains' floors, the refreshes'
    initializations and updates: the counts of the pca and the loss pca
    that the port would feed each step (its own, before the JAX states
    replace them) equal the JAX run's."""
    async_pca, (_, _, want, _, _, _), (_, _, got), _ = runs
    assert len(want) == 24 and got == want
    # async: steps 1 and 2 are fed the refresh's initialization alone
    first_update = 2 if async_pca else 1
    assert len({want[i] for i in range(first_update)}) == 1
    assert want[first_update] != want[0]


def test_loss_sequence_fed_jax_s_states_matches_the_jax_trainer(runs):
    """The first step (the same weights and feed) within 1e-5 relative;
    over the epoch, four refreshes included, the largest relative error
    within 2x the largest of the nudged run against the port's and the mean
    within 2x its mean (measured: async 2.2e-2 against 6.2e-2 and 3.7e-3
    against 7.4e-3, sync 1.9e-2 against 4.4e-2 and 3.5e-3 against 7.2e-3)."""
    _, (_, want, _, _, _, _), (_, got, _), (_, nudged, _) = runs
    err = np.abs(got - want) / np.abs(want)
    floor = np.abs(got - nudged) / np.abs(nudged)
    assert np.isfinite(got).all() and err[0] <= 1e-5
    assert err.max() <= 2 * floor.max() and err.mean() <= 2 * floor.mean()


def test_final_pca_counts_match_the_jax_trainer(runs):
    """The epoch's end: both PCAs' counts equal JAX's; their arrays the
    shapes and dtypes of JAX's (their values part as the runs do)."""
    _, (_, _, _, _, want_pca, want_loss), (tr, _, _), _ = runs
    for got, want in ((_pca_state(tr.pca), want_pca), (_pca_state(tr.loss_pca), want_loss)):
        assert got["seen"] == want["seen"] and got["true_seen"] == want["true_seen"]
        for key in ("s", "v", "m", "var"):
            assert got[key].shape == want[key].shape and got[key].dtype == want[key].dtype
