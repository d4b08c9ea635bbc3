"""The port's async mining refresh (``TrainConfig(async_mining=True)``) on
the CPU, alone and against the JAX trainer.

Geometry of ``tests/test_async_mining.py`` and ``tests/test_torch_trainer.py``:
the 24-pose toy city at 64x80, NetVLAD-8 in fp32, one tuple of 1+3+3 a
step, ``mining_step=6`` over a cache of 10, so the boundaries are steps 0,
6, 12 and 18 and the first of them stays synchronous. Against JAX the two
trainers start from the same weights with the same seed, at the reference
lr 5e-6. A free-running async run depends on when each window lands, so
the comparison forces every refresh to land before the next step (a hook
that joins right after the spawn, in both packages). JAX's segment starts
its batch producer before it spawns the refresh; for that comparison the
producer is started at its first batch instead (``LazyPrefetcher``, this
file only), so that both packages sample each segment from the new window.
The JAX sampler's KD-tree returns sorted neighbours, as the port's does
(``SortedKDTree``, as in ``tests/test_torch_trainer.py``).
"""

import queue
import threading

import jax
import numpy as np
import pytest
import torch
from flax import traverse_util
from sklearn.neighbors import KDTree

import soft_contrastive_learning_tpu.sampling.tuples as jax_tuples
import soft_contrastive_learning_tpu.train.segment as jax_segment
from soft_contrastive_learning_tpu.core import config as jcfg
from soft_contrastive_learning_tpu.data.pipeline import Prefetcher as JaxPrefetcher
from soft_contrastive_learning_tpu.data.pipeline import ToyCitySource as JaxToyCitySource
from soft_contrastive_learning_tpu.train.trainer import Trainer as JaxTrainer
from soft_contrastive_learning_torch.core import config as tcfg
from soft_contrastive_learning_torch.data.pipeline import ToyCitySource
from soft_contrastive_learning_torch.models.weights import params_from_flax
from soft_contrastive_learning_torch.train.trainer import Trainer, _MiningCancelled

torch.set_num_threads(1)  # tier-1 runs several workers on one host

TRAIN = dict(tuples_per_batch=1, max_epoch=1, base_lr=5e-6, mining_step=6,
             mining_cache_size=10, eval_step=10**9, save_step=10**9, num_eval_queries=4,
             eval_ref_r=4, async_mining=True, seed=0)
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


class LazyPrefetcher(JaxPrefetcher):
    """JAX's Prefetcher with its producer started at the first batch asked
    for, not at construction."""

    def __init__(self, build_fn, num_items, depth=2):
        self._q = queue.Queue(maxsize=depth)
        self._num, self._build, self._err = num_items, build_fn, None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def __iter__(self):
        self._thread.start()
        yield from super().__iter__()

    def close(self):
        if self._thread.ident is None:  # never started
            self._stop.set()
            return
        super().close()


def _port_cfg(**kw):
    model = dict(vlad_cores=8, image_height=64, image_width=80, compute_dtype="float32")
    model.update(kw.pop("model", {}))
    loss = dict(name="wms")
    loss.update(kw.pop("loss", {}))
    return tcfg.TrainConfig(model=tcfg.ModelConfig(**model), tuples=tcfg.TupleConfig(**TUPLES),
                            loss=tcfg.LossConfig(**loss), **{**TRAIN, **kw})


def _losses(records):
    return np.array([r["value"] for r in records if r["tag"] == "loss"])


def _spy(tr, forced: bool):
    """Record the steps refreshed and spawned; with ``forced`` each spawned
    refresh is joined before the trainer goes on."""
    refreshed, spawned = [], []
    refresh, spawn = tr._mining_refresh, tr._spawn_mining_refresh

    def spy_refresh(epoch, step, count, meta, anchors, **kw):
        refreshed.append(step)
        return refresh(epoch, step, count, meta, anchors, **kw)

    def spy_spawn(epoch, step0, count, meta, anchors):
        spawned.append(step0)
        spawn(epoch, step0, count, meta, anchors)
        if forced:
            tr._join_mining()

    tr._mining_refresh, tr._spawn_mining_refresh = spy_refresh, spy_spawn
    return refreshed, spawned


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """One JAX async epoch with forced landing (eval and checkpoint writes
    stubbed: they leave the training stream alone); then, from its final
    weights, a synchronous refresh at boundary 6."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_tuples, "KDTree", SortedKDTree)
    mp.setattr(jax_segment, "Prefetcher", LazyPrefetcher)
    try:
        cfg = jcfg.TrainConfig(
            model=jcfg.ModelConfig(vlad_cores=8, image_height=64, image_width=80,
                                   compute_dtype="float32", use_pallas=False),
            tuples=jcfg.TupleConfig(**TUPLES), loss=jcfg.LossConfig(name="wms"), **TRAIN)
        source = JaxToyCitySource(**SOURCE)
        tr = JaxTrainer(cfg, source, out_dir=str(tmp_path_factory.mktemp("jax")))
        init = {k: np.asarray(v) for k, v in
                traverse_util.flatten_dict(jax.device_get(tr.state.params), sep="/").items()}
        tr._run_eval = lambda *a, **k: None
        tr.ckpts.save = lambda *a, **k: None
        refreshed, spawned = _spy(tr, forced=True)
        tr.train()
        losses = _losses(tr.writers["local"].read_all())
        final = {k: np.asarray(v) for k, v in
                 traverse_util.flatten_dict(jax.device_get(tr.state.params), sep="/").items()}
        meta = source.epoch_meta(cfg.local_ref_set, 0)
        anchors = np.asarray(source.anchor_indices(cfg.local_ref_set, cfg.train_ref_r, 0), int)
        tr._ensure_image_pool(meta)
        tr.mining.refresh(0, 6, 1, meta, anchors)
        window = (np.asarray(tr.mining_cache._indices), np.asarray(tr.mining_cache._order))
        tr.close()
    finally:
        mp.undo()
    return dict(init=init, losses=losses, refreshed=refreshed, spawned=spawned, final=final,
                window=window)


@pytest.fixture(scope="module")
def forced_run(jax_run, tmp_path_factory):
    """The port's epoch from JAX's initial weights, forced landing."""
    init = params_from_flax(jax_run["init"], _port_cfg().model)
    tr = Trainer(_port_cfg(), ToyCitySource(**SOURCE), device="cpu",
                 out_dir=str(tmp_path_factory.mktemp("forced")), params=init)
    tr._run_eval = lambda *a, **k: None
    refreshed, spawned = _spy(tr, forced=True)
    tr.train()
    tr.close()
    return dict(tr=tr, refreshed=refreshed, spawned=spawned)


@pytest.fixture(scope="module")
def free_run(tmp_path_factory):
    """A free-running async epoch (a fresh init), every call of the live
    module's ``train()`` recorded with its thread."""
    tr = Trainer(_port_cfg(), ToyCitySource(**SOURCE), device="cpu",
                 out_dir=str(tmp_path_factory.mktemp("free")))
    calls = []
    live = tr.state.model
    train = live.train

    def recording_train(mode=True):
        calls.append((threading.current_thread().name, mode))
        return train(mode)

    live.train = recording_train
    refreshed, spawned = _spy(tr, forced=False)
    tr.train()
    tr.close()
    return dict(tr=tr, refreshed=refreshed, spawned=spawned, calls=calls)


def test_async_mining_trains_and_refreshes(jax_run, free_run):
    """The first boundary is synchronous (its window indexes this epoch's
    shuffle), every later one spawned, as in JAX; the epoch ends with every
    loss finite, the cache full and no worker left."""
    tr = free_run["tr"]
    assert free_run["refreshed"] == jax_run["refreshed"] == [0, 6, 12, 18]
    assert free_run["spawned"] == jax_run["spawned"] == [6, 12, 18]
    assert tr._mining_thread is None and tr._mining_error is None
    assert not [t for t in threading.enumerate() if t.name == "mining-refresh"]
    assert tr.mining_cache.ready and tr.global_step == 24
    losses = _losses(tr.writers["local"].read_all())
    assert losses.shape == (24,) and np.isfinite(losses).all()
    spans = tr.timer.summary()
    assert spans["mining_refresh"]["count"] == 1 and spans["mining_refresh_async"]["count"] == 3
    assert spans["segment_steady"]["count"] == 24


def test_the_live_module_s_training_flag_is_left_alone(free_run):
    """No refresh, sync or async, switches the live module to eval mode, and
    the worker never calls its ``train()``: the worker embeds with its own
    copy of the boundary's weights, in that copy's eval mode."""
    calls = free_run["calls"]
    assert calls and {mode for _, mode in calls} == {True}
    assert not [name for name, _ in calls if name == "mining-refresh"]
    tr = free_run["tr"]
    assert tr.state.model.training and not tr.mining._twin.training
    assert not any(p.requires_grad for p in tr.mining._twin.parameters())


def test_forced_landing_matches_the_jax_trainer(jax_run, forced_run):
    """Each refresh joined right after its spawn: the same steps refreshed
    and spawned, and the loss records JAX's within test_torch_trainer.py's
    tolerances (1e-6 relative up to the first async window, 1e-4 over the
    epoch)."""
    tr = forced_run["tr"]
    assert forced_run["refreshed"] == jax_run["refreshed"]
    assert forced_run["spawned"] == jax_run["spawned"]
    got = _losses(tr.writers["local"].read_all())
    want = jax_run["losses"]
    assert got.shape == want.shape == (24,)
    np.testing.assert_allclose(got[:6], want[:6], rtol=1e-6, atol=0)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=0)


def test_the_cache_order_equals_jax_s_from_the_same_weights(jax_run, tmp_path):
    """JAX's trained weights carried over: the port's refresh at boundary 6
    holds JAX's window and neighbour order."""
    cfg = _port_cfg()
    tr = Trainer(cfg, ToyCitySource(**SOURCE), device="cpu", out_dir=str(tmp_path),
                 params=params_from_flax(jax_run["final"], cfg.model))
    meta = tr.source.epoch_meta(cfg.local_ref_set, 0)
    anchors = np.asarray(tr.source.anchor_indices(cfg.local_ref_set, cfg.train_ref_r, 0), int)
    tr._ensure_image_pool(meta)
    tr._mining_refresh(0, 6, 1, meta, anchors)
    np.testing.assert_array_equal(tr.mining_cache._indices, jax_run["window"][0])
    np.testing.assert_array_equal(tr.mining_cache._order, jax_run["window"][1])
    tr.close()


@pytest.fixture
def small_trainer(tmp_path):
    cfg = _port_cfg(base_lr=1e-4)
    tr = Trainer(cfg, ToyCitySource(**SOURCE), device="cpu", out_dir=str(tmp_path))
    meta = tr.source.epoch_meta(cfg.local_ref_set, 0)
    anchors = np.asarray(tr.source.anchor_indices(cfg.local_ref_set, cfg.train_ref_r, 0), int)
    tr._ensure_image_pool(meta)
    yield tr, meta, anchors
    tr.close()


def test_async_refresh_matches_sync_content(small_trainer):
    """From the same boundary weights an async refresh's window and order
    are a sync refresh's, bit for bit; a step taken after the spawn does
    not reach the worker's embeds (they read the boundary's copy)."""
    tr, meta, anchors = small_trainer
    tr._mining_refresh(0, 6, 1, meta, anchors)
    want = (tr.mining_cache._indices.copy(), tr.mining_cache._order.copy())
    tr.mining_cache.refresh(np.zeros(1, dtype=int), np.zeros((1, 1), dtype=int))
    refresh = tr._mining_refresh
    started, go = threading.Event(), threading.Event()

    def held(*a, **kw):  # the worker waits until the live weights have moved
        started.set()
        go.wait(timeout=30)
        return refresh(*a, **kw)

    tr._mining_refresh = held
    tr._spawn_mining_refresh(0, 6, 1, meta, anchors)
    assert started.wait(timeout=30)
    with torch.no_grad():
        for p in tr.state.model.parameters():
            p.add_(1.0)  # what an optimizer step does to the live weights, in place
    go.set()
    tr._join_mining()
    np.testing.assert_array_equal(tr.mining_cache._indices, want[0])
    np.testing.assert_array_equal(tr.mining_cache._order, want[1])
    assert tr.mining.refresh_count == 2


class _SetAfter(threading.Event):
    """An event that reads as set from its ``n``-th check on."""

    def __init__(self, n):
        super().__init__()
        self.n, self.checks = n, 0

    def is_set(self):
        self.checks += 1
        return self.checks >= self.n


@pytest.mark.parametrize("n", [1, 2, 4], ids=["first_chunk", "second_chunk", "before_fetch"])
def test_cancel_keeps_the_previous_window(small_trainer, n):
    """A cancel seen before a chunk of the embed (16 images in chunks of 7:
    three checks) or before the order's fetch raises MiningCancelled, and the
    cache keeps the window it had."""
    tr, meta, anchors = small_trainer
    tr._mining_refresh(0, 0, 0, meta, anchors)
    before = (tr.mining_cache._indices.copy(), tr.mining_cache._order.copy())
    cancel = _SetAfter(n)
    with pytest.raises(_MiningCancelled):
        tr._mining_refresh(0, 6, 1, meta, anchors, cancel=cancel)
    assert cancel.checks == n
    np.testing.assert_array_equal(tr.mining_cache._indices, before[0])
    np.testing.assert_array_equal(tr.mining_cache._order, before[1])
    assert tr.mining.refresh_count == 1


def test_async_worker_error_surfaces(tmp_path):
    """A worker's error is raised at the next join; on unwind it is logged,
    not raised, and its slot cleared; a worker parked on the cancel event is
    aborted by the unwind's join, which does not hang."""
    tr = Trainer(_port_cfg(), ToyCitySource(**SOURCE), device="cpu", out_dir=str(tmp_path))

    def boom(*a, **kw):
        raise ValueError("synthetic refresh failure")

    tr._mining_refresh = boom
    tr._spawn_mining_refresh(0, 6, 1, {}, np.asarray([0]))
    with pytest.raises(RuntimeError, match="async mining refresh failed") as info:
        tr._join_mining()
    assert isinstance(info.value.__cause__, ValueError)
    tr._spawn_mining_refresh(0, 6, 1, {}, np.asarray([0]))
    tr._join_mining(raise_error=False)
    assert tr._mining_error is None and tr._mining_thread is None
    assert "error during unwind: synthetic refresh failure" in (
        tmp_path / "train_log.txt").read_text()

    started = threading.Event()

    def slow(*a, cancel=None, **kw):
        started.set()
        assert cancel is not None
        cancel.wait(timeout=30)
        raise _MiningCancelled()

    tr._mining_refresh = slow
    tr._spawn_mining_refresh(0, 6, 1, {}, np.asarray([0]))
    assert started.wait(timeout=10)
    t0 = __import__("time").perf_counter()
    tr._join_mining(raise_error=False)
    assert __import__("time").perf_counter() - t0 < 10
    assert tr._mining_error is None and tr._mining_thread is None
    tr.close()


def test_an_error_in_the_segment_joins_the_worker(tmp_path):
    """A step that fails while a refresh is in flight: the step's error goes
    on, the worker is cancelled and joined, none is left."""
    tr = Trainer(_port_cfg(), ToyCitySource(**SOURCE), device="cpu", out_dir=str(tmp_path))
    tr._run_eval = lambda *a, **k: None
    step = tr.train_step_pooled

    def failing(state, batch, pool):
        if tr.global_step == 8:  # in the second segment, its refresh spawned
            raise ValueError("synthetic step failure")
        return step(state, batch, pool)

    tr.train_step_pooled = failing
    with pytest.raises(ValueError, match="synthetic step failure"):
        tr.train_one_epoch(0)
    assert tr._mining_thread is None and tr._mining_error is None
    assert not [t for t in threading.enumerate() if t.name == "mining-refresh"]
    tr.close()


@pytest.mark.parametrize("case", ["pca", "incremental", "world_size_2", "async_off"])
def test_the_gate_keeps_these_synchronous(tmp_path, monkeypatch, case):
    """``reduction='pca'``, an incremental loss, a process group of more
    than one, and ``async_mining=False`` refresh at every boundary
    synchronously (JAX's gate); the refreshes and the step are stubbed, so
    the epoch is the boundaries' logic alone."""
    kw = {"pca": dict(model=dict(reduction="pca", out_dim=16)),
          "incremental": dict(loss=dict(name="incremental_mm", loss_dim=8)),
          "world_size_2": {}, "async_off": dict(async_mining=False)}[case]
    tr = Trainer(_port_cfg(**kw), ToyCitySource(**SOURCE), device="cpu", out_dir=str(tmp_path))
    spawned, refreshed = [], []
    tr._spawn_mining_refresh = lambda *a, **k: spawned.append(a)
    tr._mining_refresh = lambda *a, **k: refreshed.append(a)
    tr._run_eval = lambda *a, **k: None
    tr.ckpts.save = lambda *a, **k: None
    tr._augment_batch = lambda batch, snaps=None: batch
    tr.train_step_pooled = lambda state, batch, pool: (
        state, {"loss": torch.zeros(()), "learning_rate": 1e-4})
    if case == "world_size_2":
        monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
        monkeypatch.setattr(torch.distributed, "get_world_size", lambda *a: 2)
    tr.train_one_epoch(0)
    assert spawned == [] and [a[1] for a in refreshed] == [0, 6, 12, 18]
    tr.close()


def test_launch_counts_and_the_tf32_flag_hold_under_threads():
    """The two pieces of process-wide state that the worker and the
    training thread share, hammered by more threads than cores with a short
    switch interval: no launch count is lost (``_build.count_launch``), and
    ``fp32_matmuls`` blocks that overlap on several threads keep TF32 off
    inside every block and give the caller's setting back after the last."""
    import os
    import sys

    from soft_contrastive_learning_torch.ops.kernels import _build
    from soft_contrastive_learning_torch.pca.whiten import fp32_matmuls

    def wrapper():
        pass

    wrapper.launches = 0
    threads_n, per_thread = 2 * (os.cpu_count() or 4), 500
    seen_on = []
    interval = sys.getswitchinterval()
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        sys.setswitchinterval(1e-6)

        def work():
            for _ in range(per_thread):
                _build.count_launch(wrapper)
                with fp32_matmuls():
                    if torch.backends.cuda.matmul.allow_tf32:
                        seen_on.append(1)

        threads = [threading.Thread(target=work) for _ in range(threads_n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        assert wrapper.launches == threads_n * per_thread
        assert not seen_on and torch.backends.cuda.matmul.allow_tf32
    finally:
        sys.setswitchinterval(interval)
        torch.backends.cuda.matmul.allow_tf32 = prev
