"""The port's decoded-uint8 cache (``data/decoded_cache.py``) on the CPU,
against JAX's ``data/decoded_cache.py``: the same bytes and sidecar for
the same toy city, each package reading the other's cache, idempotent
writes that grow by union, and batches equal to the decode path's."""

import filecmp
import os

import numpy as np
import pytest

from soft_contrastive_learning_tpu.data import decoded_cache as jdc
from soft_contrastive_learning_tpu.data.pipeline import ToyCitySource as JaxToyCitySource
from soft_contrastive_learning_torch.core.config import LossConfig, ModelConfig, TrainConfig
from soft_contrastive_learning_torch.data import decoded_cache as tdc
from soft_contrastive_learning_torch.data.pipeline import ToyCitySource, load_images_standard

CITY = dict(num_points=24, radius=30.0, img_h=32, img_w=40, seed=3)
H, W = 32, 40


def _quiet(*_):
    pass


def _keys(meta, n=None):
    ks = list(zip(meta["date"], meta["folder"], meta["t"]))
    return ks if n is None else ks[:n]


def _cfg():
    return TrainConfig(model=ModelConfig(vlad_cores=8, image_height=H, image_width=W),
                       loss=LossConfig(name="wms"))


@pytest.fixture
def src():
    return ToyCitySource(**CITY)


def _write_both(tmp_path, sets=("train_ref", "test_ref"), cluster_sets=(("train_ref", 4),)):
    ours, theirs = str(tmp_path / "port"), str(tmp_path / "jax")
    tdc.cache_training_sets(ToyCitySource(**CITY), list(sets), H, W, True, ours,
                            cluster_sets=list(cluster_sets), log=_quiet)
    jdc.cache_training_sets(JaxToyCitySource(**CITY), list(sets), H, W, True, theirs,
                            cluster_sets=list(cluster_sets), log=_quiet)
    return ours, theirs


def test_the_files_equal_jax_s(tmp_path):
    """The .u8 rows and the JSON sidecar are JAX's byte for byte."""
    ours, theirs = _write_both(tmp_path)
    names = sorted(os.listdir(theirs))
    assert names == ["decoded_32x40_aspect.json", "decoded_32x40_aspect.u8"]
    assert sorted(os.listdir(ours)) == names
    for name in names:
        assert filecmp.cmp(os.path.join(ours, name), os.path.join(theirs, name), shallow=False)


def test_each_package_reads_the_other_s_cache(tmp_path):
    ours, theirs = _write_both(tmp_path)
    keys = _keys(ToyCitySource(**CITY).epoch_meta("test_ref", 0))
    want = load_images_standard(ToyCitySource(**CITY), keys, _cfg())
    got_port = tdc.CachedDecodedSource(ToyCitySource(**CITY), theirs).load_images_normalized(
        keys, H, W, True)
    got_jax = jdc.CachedDecodedSource(JaxToyCitySource(**CITY), ours).load_images_normalized(
        keys, H, W, True)
    np.testing.assert_array_equal(got_port, want)
    np.testing.assert_array_equal(got_jax, want)


def test_cached_batches_equal_the_decode_path(tmp_path, src):
    """Through ``load_images_standard``: all cached; half cached (the rest
    decoded one by one); none cached (the decode pool's path)."""
    meta = src.epoch_meta("train_ref", 0)
    keys = _keys(meta)
    cache_dir = str(tmp_path / "cache")
    tdc.build_decoded_cache(src, keys[:8], H, W, True, cache_dir, log=_quiet)
    cached = tdc.CachedDecodedSource(src, cache_dir)
    for chunk in (keys[:8], keys[4:12], keys[12:20]):
        np.testing.assert_array_equal(load_images_standard(cached, chunk, _cfg()),
                                      load_images_standard(src, chunk, _cfg()))
    assert cached.load_images_normalized(keys[12:20], H, W, True) is None  # all miss
    assert cached.load_images_normalized(keys[:2], 64, 80, True) is None  # no such cache
    assert cached.load_images_normalized(keys[:2], H, W, False) is None


def test_idempotent_and_grows_by_union(tmp_path, src):
    keys = _keys(src.epoch_meta("train_ref", 0))
    cache_dir = str(tmp_path / "cache")
    side = tdc.build_decoded_cache(src, keys[:4], H, W, True, cache_dir, log=_quiet)
    mtime = os.path.getmtime(side)
    tdc.build_decoded_cache(src, keys[:4], H, W, True, cache_dir, log=_quiet)
    assert os.path.getmtime(side) == mtime  # covered: untouched
    tdc.build_decoded_cache(src, keys[2:8], H, W, True, cache_dir, log=_quiet)
    # the union, the old rows first, as JAX's writes it
    theirs = str(tmp_path / "jax")
    jsrc = JaxToyCitySource(**CITY)
    jdc.build_decoded_cache(jsrc, keys[:4], H, W, True, theirs, log=_quiet)
    jdc.build_decoded_cache(jsrc, keys[2:8], H, W, True, theirs, log=_quiet)
    for name in os.listdir(theirs):
        assert filecmp.cmp(os.path.join(cache_dir, name), os.path.join(theirs, name),
                           shallow=False)
    got = tdc.CachedDecodedSource(src, cache_dir).load_images_normalized(keys[:8], H, W, True)
    np.testing.assert_array_equal(got, load_images_standard(src, keys[:8], _cfg()))


def test_training_sets_and_cluster_sets_are_covered(tmp_path, src):
    cache_dir = str(tmp_path / "cache")
    tdc.cache_training_sets(src, ["train_ref", "test_ref"], H, W, True, cache_dir,
                            cluster_sets=[("train_ref", 4)], log=_quiet)
    cached = tdc.CachedDecodedSource(src, cache_dir)
    cm = src.cluster_meta("train_ref", 4)
    got = cached.load_images_normalized(_keys(cm), H, W, True)
    assert got is not None and len(got) == len(cm["t"])


def test_empty_keys_write_nothing_and_the_source_delegates(tmp_path, src):
    cache_dir = str(tmp_path / "cache")
    side = tdc.build_decoded_cache(src, [], H, W, True, cache_dir, log=_quiet)
    assert not os.path.exists(side)
    cached = tdc.CachedDecodedSource(src, cache_dir)
    assert cached.load_images_normalized(_keys(src.epoch_meta("train_ref", 0), 2), H, W,
                                         True) is None
    assert cached.epoch_meta("train_ref", 1) == src.epoch_meta("train_ref", 1)
    np.testing.assert_array_equal(cached.anchor_indices("train_ref", 1, 0),
                                  src.anchor_indices("train_ref", 1, 0))


def test_cli_cache_writes_jax_s_cache(tmp_path):
    """``cli cache --toy_city`` writes what JAX's ``cache`` command writes."""
    from soft_contrastive_learning_tpu import cli as jax_cli
    from soft_contrastive_learning_torch.cli import main

    args = ["cache", "--toy_city", "--image_height", "24", "--image_width", "32",
            "--sets", "test_ref", "--cluster_sets", "test_ref:40", "--num_workers", "2"]
    assert main(args + ["--cache_dir", str(tmp_path / "port")]) == 0
    assert jax_cli.main(args + ["--cache_dir", str(tmp_path / "jax")]) == 0
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) and len(names) == 2
    for name in names:
        assert filecmp.cmp(tmp_path / "port" / name, tmp_path / "jax" / name, shallow=False)


def test_a_training_run_reads_the_cache(tmp_path, monkeypatch):
    """``train --decoded_cache_root``: the host-fed run's batches come from
    the memmap; the source renders only the held-out city for the evals.
    The cache is written for ``train --toy_city``'s city (120 poses on a
    150 m loop): ``cache --toy_city`` writes, as JAX's does, the source's
    default city, whose keys name other images."""
    from soft_contrastive_learning_torch import cli
    from soft_contrastive_learning_torch.core.logging import MetricsWriter

    size = ["--image_height", "32", "--image_width", "32"]
    tdc.cache_training_sets(ToyCitySource(num_points=120, radius=150.0, img_h=32, img_w=32),
                            ["train_ref"], 32, 32, True, str(tmp_path / "dc"), log=_quiet)
    decoded = []
    load = ToyCitySource.load_image
    monkeypatch.setattr(ToyCitySource, "load_image",
                        lambda self, key: (decoded.append(key), load(self, key))[1])
    argv = ["train", "--toy_city", "--device", "cpu", "--out_root", str(tmp_path),
            "--out_folder", "run", *size, "--vlad_cores", "8", "--compute_dtype", "float32",
            "--positives_per_tuple", "1", "--negatives_per_tuple", "1",
            "--hard_positives_per_tuple", "1", "--hard_negatives_per_tuple", "1",
            "--max_epoch", "1", "--mining_step", "4", "--mining_cache_size", "8",
            "--train_ref_r", "40", "--num_eval_queries", "2", "--eval_ref_r", "20",
            "--eval_step", "1000", "--loss", "wms", "--device_image_pool", "false",
            "--decoded_cache_root", str(tmp_path / "dc")]
    assert cli.main(argv) == 0
    losses = [r["value"] for r in MetricsWriter(str(tmp_path / "run"), "local").read_all()
              if r["tag"] == "loss"]
    assert len(losses) == 12 and np.isfinite(losses).all()
    test_city = ToyCitySource(num_points=120, radius=150.0).cities["test"].date
    assert decoded and {key[0] for key in decoded} == {test_city}
