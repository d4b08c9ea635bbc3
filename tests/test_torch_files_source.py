"""Training from the prep pipeline's files: the port's ``FilesystemSource``,
decode pool, ``Prefetcher`` and host-fed trainer against the JAX package's,
on the CPU.

The tree is the one ``tests/test_robotcar_prep.py`` builds: its
``prep_ctx`` fixture (imported, not edited: two synthetic RobotCar dates as
raw Bayer tars, INS and grid masks) and the prep stages 001-014 run on it
by the JAX package, which write the CSVs and the downsized 160x240 PNGs
(OpenCV's encoder). Both sources must give the same meta, anchors, cluster
references and pixels (exact). The port's trainer on the host feed, its
batches built ahead by the Prefetcher, must draw the batches of its
synchronous (device-pool) path and give its losses bit for bit, and its
losses must equal the JAX trainer's from the same weights: 1e-6 relative
on the first step, 1e-5 over the short epoch (the two frameworks sum in
other orders, ~1e-7 a step).
"""

import os

import jax
import numpy as np
import pytest
import torch
from flax import traverse_util
from sklearn.neighbors import KDTree

import soft_contrastive_learning_tpu.sampling.tuples as jax_tuples
from soft_contrastive_learning_torch.core import config as tcfg
from soft_contrastive_learning_torch.data.pipeline import (
    FilesystemSource,
    Prefetcher,
    load_images_standard,
)
from soft_contrastive_learning_torch.models.weights import params_from_flax
from soft_contrastive_learning_torch.train.trainer import Trainer
from soft_contrastive_learning_tpu.core import config as jcfg
from soft_contrastive_learning_tpu.data import pipeline as jpipeline
from soft_contrastive_learning_tpu.data.robotcar import prep
from soft_contrastive_learning_tpu.data.robotcar.downsize import downsize_images
from soft_contrastive_learning_tpu.data.robotcar.stages import run_all
from soft_contrastive_learning_tpu.train.trainer import Trainer as JaxTrainer
from test_robotcar_prep import DATE_QUERY, DATE_REF, prep_ctx  # noqa: F401 (a fixture)

torch.set_num_threads(1)  # tier-1 runs several workers on one host

SETS = ("train_ref", "train_query", "test_ref", "test_query")


@pytest.fixture(scope="module")
def tree(prep_ctx):  # noqa: F811
    """The prep stages 001-014 on the fixture's raw dates; the roots
    ``FilesystemSource`` takes."""
    ctx = prep_ctx
    for date in (DATE_REF, DATE_QUERY):
        downsize_images(ctx, date)
        prep.interpolate_image_xy(ctx, date)
        prep.assign_splits(ctx, date)
    run_all(prep.metadata_stages(ctx), ctx, log=lambda s: None)
    return dict(img_root=ctx.img_root, shuffled_root=ctx.dir("shuffled"),
                anchor_root=ctx.dir("anchors"), loc_ref_root=ctx.dir("clusters"))


def _sources(tree):
    return FilesystemSource(**tree), jpipeline.FilesystemSource(**tree)


@pytest.mark.parametrize("set_name", SETS)
@pytest.mark.parametrize("epoch", [0, 1])
def test_meta_and_anchors_equal_jax(tree, set_name, epoch):
    port, jax_src = _sources(tree)
    meta = port.epoch_meta(set_name, epoch)
    assert meta == jax_src.epoch_meta(set_name, epoch) and len(meta["t"]) > 10
    if set_name.endswith("_ref"):
        got = port.anchor_indices(set_name, 1, epoch)
        assert got.dtype == int and len(got) > 0
        np.testing.assert_array_equal(got, jax_src.anchor_indices(set_name, 1, epoch))


@pytest.mark.parametrize("set_name", ["train_ref", "test_ref"])
def test_cluster_references_equal_jax(tree, set_name):
    port, jax_src = _sources(tree)
    assert port.cluster_meta(set_name, 5) == jax_src.cluster_meta(set_name, 5)


@pytest.mark.parametrize("set_name", ["train_ref", "train_query"])
def test_pixels_equal_jax(tree, set_name):
    """The port's PNG decoder on OpenCV-encoded files: the JAX package's
    (cv2) pixels, and the same path."""
    port, jax_src = _sources(tree)
    meta = port.epoch_meta(set_name, 0)
    keys = list(zip(meta["date"], meta["folder"], meta["t"]))[:40]
    for key in keys:
        assert port.image_path(key) == jax_src.image_path(key)
        got = port.load_image(key)
        assert got.shape == (160, 240, 3)
        np.testing.assert_array_equal(got, jax_src.load_image(key))


def test_load_images_standard_with_a_pool_equals_jax(tree):
    """Decoded on 8 threads or on the caller's, resized to a 48x64 model
    (cv2 in both packages): the same uint8 batch as the JAX package's."""
    from concurrent.futures import ThreadPoolExecutor

    port, jax_src = _sources(tree)
    meta = port.epoch_meta("train_ref", 0)
    keys = list(zip(meta["date"], meta["folder"], meta["t"]))[:24]
    cfg = tcfg.TrainConfig(model=tcfg.ModelConfig(vlad_cores=4, image_height=48, image_width=64))
    jax_cfg = jcfg.TrainConfig(model=jcfg.ModelConfig(vlad_cores=4, image_height=48,
                                                      image_width=64))
    with ThreadPoolExecutor(max_workers=8) as pool:
        got = load_images_standard(port, keys, cfg, pool)
        want = jpipeline.load_images_standard(jax_src, keys, jax_cfg, pool)
    assert got.dtype == np.uint8 and got.shape == (24, 48, 64, 3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(load_images_standard(port, keys, cfg), got)


def test_prefetcher_keeps_order_raises_and_closes():
    built = []
    items = list(Prefetcher(lambda i: built.append(i) or i * i, 7))
    assert items == [i * i for i in range(7)] and built == list(range(7))

    def broken(i):
        if i == 2:
            raise KeyError("no image 2")
        return i

    got = []
    with pytest.raises(KeyError, match="no image 2"):
        for item in Prefetcher(broken, 5):
            got.append(item)
    assert got == [0, 1]
    # a consumer that leaves early: close() stops the producer
    early = Prefetcher(lambda i: i, 1000, depth=2)
    assert next(iter(early)) == 0
    early.close()
    assert not early._thread.is_alive()


class SortedKDTree:
    """sklearn's KDTree with sorted ``query_radius`` results, as the port's
    cKDTree returns them, so that both samplers draw the same tuples."""

    def __init__(self, xy):
        self._tree = KDTree(xy)

    def query_radius(self, x, r):
        found = self._tree.query_radius(x, r=r)
        out = np.empty(len(found), dtype=object)
        out[:] = [np.sort(a) for a in found]
        return out


class FirstAnchors:
    """A source whose epochs stop after their first ``n`` anchors."""

    def __init__(self, source, n):
        self._source, self._n = source, n

    def __getattr__(self, name):
        return getattr(self._source, name)

    def anchor_indices(self, *args):
        return self._source.anchor_indices(*args)[: self._n]


TRAIN = dict(tuples_per_batch=1, max_epoch=1, base_lr=5e-6, mining_step=2,
             mining_cache_size=4, eval_step=1000, save_step=1000, num_eval_queries=2, seed=0)
TUPLES = dict(positives_per_tuple=2, negatives_per_tuple=2, hard_positives_per_tuple=0,
              hard_negatives_per_tuple=0)
STEPS = 6


def _losses(tr):
    return np.array([r["value"] for r in tr.writers["local"].read_all() if r["tag"] == "loss"])


@pytest.fixture(scope="module")
def jax_run(tree, tmp_path_factory):
    """A 6-step JAX epoch from the tree (eval and checkpoint writes stubbed:
    they draw from their own rng and leave the training stream alone)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_tuples, "KDTree", SortedKDTree)
    try:
        cfg = jcfg.TrainConfig(
            model=jcfg.ModelConfig(vlad_cores=4, image_height=48, image_width=64,
                                   compute_dtype="float32", use_pallas=False),
            tuples=jcfg.TupleConfig(**TUPLES), loss=jcfg.LossConfig(name="wms"), **TRAIN)
        tr = JaxTrainer(cfg, FirstAnchors(jpipeline.FilesystemSource(**tree), STEPS),
                        out_dir=str(tmp_path_factory.mktemp("jax")))
        init = {k: np.asarray(v) for k, v in
                traverse_util.flatten_dict(jax.device_get(tr.state.params), sep="/").items()}
        tr._run_eval = lambda *a, **k: None
        tr.ckpts.save = lambda *a, **k: None
        tr.train()
        losses = _losses(tr)
        tr.close()
    finally:
        mp.undo()
    return init, losses


def _port_run(tree, tmp_path, init, pool):
    cfg = tcfg.TrainConfig(
        model=tcfg.ModelConfig(vlad_cores=4, image_height=48, image_width=64,
                               compute_dtype="float32"),
        tuples=tcfg.TupleConfig(**TUPLES), loss=tcfg.LossConfig(name="wms"),
        device_image_pool=pool, **TRAIN)
    params = params_from_flax(init, cfg.model)
    tr = Trainer(cfg, FirstAnchors(FilesystemSource(**tree), STEPS), out_dir=str(tmp_path),
                 device="cpu", params=params)
    drawn, sample = [], tr._sample

    def recording_sample(*args):
        out = sample(*args)
        drawn.append(None if out is None else tuple(out.indices.reshape(-1).tolist()))
        return out

    tr._sample = recording_sample
    tr._run_eval = lambda *a, **k: None
    tr.train()
    tr.close()
    return tr, drawn, _losses(tr)


@pytest.fixture(scope="module")
def port_runs(tree, jax_run, tmp_path_factory):
    return {pool: _port_run(tree, tmp_path_factory.mktemp(f"port_{pool}"), jax_run[0], pool)
            for pool in (False, True)}


def test_host_fed_epoch_is_the_synchronous_one(port_runs):
    """The host feed (decode pool + Prefetcher) and the device pool (the
    samples drawn on the main thread) draw the same batches, in order, and
    give the same losses bit for bit."""
    (host, host_drawn, host_losses), (pooled, pooled_drawn, pooled_losses) = (
        port_runs[False], port_runs[True])
    assert host._pool_rows is None and pooled._pool_rows is not None
    assert host.global_step == pooled.global_step == STEPS
    assert len(host_drawn) == STEPS and host_drawn == pooled_drawn
    np.testing.assert_array_equal(host_losses, pooled_losses)


def test_file_fed_losses_equal_the_jax_trainer(jax_run, port_runs):
    _, want = jax_run
    got = port_runs[False][2]
    assert len(want) == len(got) == STEPS and np.isfinite(got).all()
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6, atol=0)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


def test_cli_trains_from_the_tree(tree, tmp_path):
    """``train`` without ``--toy_city`` reads the tree from its four root
    flags: the whole first epoch at a 32x48 model, 8 tuples a step."""
    from soft_contrastive_learning_torch.cli import main
    from soft_contrastive_learning_torch.core.logging import MetricsWriter

    argv = ["train", "--loss", "wms", "--device", "cpu", "--out_root", str(tmp_path),
            "--out_folder", "run", "--image_height", "32", "--image_width", "48",
            "--vlad_cores", "4", "--compute_dtype", "float32", "--positives_per_tuple", "1",
            "--negatives_per_tuple", "1", "--hard_positives_per_tuple", "0",
            "--hard_negatives_per_tuple", "0", "--max_epoch", "1", "--mining_step", "40",
            "--mining_cache_size", "8", "--tuples_per_batch", "8", "--num_eval_queries", "2",
            "--device_image_pool", "False", "--eval_step", "100000", "--save_step", "100000"]
    argv += [f"--{k}={v}" for k, v in tree.items()]
    assert main(argv) == 0
    losses = [r["value"] for r in MetricsWriter(str(tmp_path / "run"), "local").read_all()
              if r["tag"] == "loss"]
    n_anchors = len(FilesystemSource(**tree).anchor_indices("train_ref", 1, 0))
    assert len(losses) == -(-n_anchors // 8) and np.isfinite(losses).all()
    assert os.path.exists(tmp_path / "run" / "config.json")


def test_a_toy_city_written_as_a_prep_tree_trains_as_the_toy_city(tmp_path):
    """``data/corpus.py::write_prep_tree`` (what chip_smoke.py's file-fed
    phase writes): the tree's source gives the toy city's meta, anchors,
    clusters and pixels, and an epoch from it on the host feed gives the
    losses of the same epoch on the toy city's device pool, bit for bit."""
    from soft_contrastive_learning_torch.data.corpus import write_prep_tree
    from soft_contrastive_learning_torch.data.pipeline import ToyCitySource

    toy = ToyCitySource(num_points=24, radius=30.0, img_h=32, img_w=40, seed=3)
    roots = write_prep_tree(toy, str(tmp_path / "prep"), SETS, cluster_r=4, max_anchors=12)
    files = FilesystemSource(**roots)
    for set_name in SETS:
        assert files.epoch_meta(set_name, 0) == toy.epoch_meta(set_name, 0)
        assert files.cluster_meta(set_name, 4) == toy.cluster_meta(set_name, 4)
        np.testing.assert_array_equal(files.anchor_indices(set_name, 1, 0),
                                      toy.anchor_indices(set_name, 1, 0)[:12])
    meta = toy.epoch_meta("test_query", 0)
    for key in list(zip(meta["date"], meta["folder"], meta["t"]))[:5]:
        np.testing.assert_array_equal(files.load_image(key), toy.load_image(key))
    losses = {}
    for label, source, pool in (("files", files, False), ("toy", FirstAnchors(toy, 12), True)):
        cfg = tcfg.TrainConfig(
            model=tcfg.ModelConfig(vlad_cores=4, image_height=32, image_width=40,
                                   compute_dtype="float32"),
            tuples=tcfg.TupleConfig(positives_per_tuple=2, negatives_per_tuple=2,
                                    hard_positives_per_tuple=1, hard_negatives_per_tuple=1),
            loss=tcfg.LossConfig(name="wms"), tuples_per_batch=1, max_epoch=1, mining_step=4,
            mining_cache_size=6, eval_step=6, save_step=1000, num_eval_queries=2, eval_ref_r=4,
            device_image_pool=pool, seed=0)
        tr = Trainer(cfg, source, out_dir=str(tmp_path / label), device="cpu")
        tr.train()
        tr.close()
        losses[label] = _losses(tr)
    assert len(losses["files"]) == 12 and np.isfinite(losses["files"]).all()
    np.testing.assert_array_equal(losses["files"], losses["toy"])
