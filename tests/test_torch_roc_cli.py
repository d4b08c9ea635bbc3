"""The paper's pipeline through the port's command line on the CPU, and
the ROC compiler and experiment registry against the JAX package's.

``infer`` (three toy-city sets rendered to PNG, a small fp32 model from a
training-run directory) -> ``topn`` -> ``roc`` in process with ``--device
cpu``; each package's ROC compiler reads the other's top-N pickles (the
six fields keep the JAX types), and the curves are equal (exact). The
``infer``/``topn``/``roc`` flags are the JAX CLI's with its defaults, plus
``--device`` (default ``cuda``) on the two that run on a device.
"""

import argparse
import os

import numpy as np
import pytest
import torch

import soft_contrastive_learning_tpu.cli as jax_cli
from soft_contrastive_learning_torch import cli
from soft_contrastive_learning_torch.checkpoints.manager import RunCheckpoints
from soft_contrastive_learning_torch.core.config import ModelConfig, TrainConfig
from soft_contrastive_learning_torch.data.corpus import rehearsal_sets, write_image_set
from soft_contrastive_learning_torch.evaluation import roc as troc
from soft_contrastive_learning_torch.models.model import EmbeddingNet, init_params
from soft_contrastive_learning_torch.train.step import init_train_state
from soft_contrastive_learning_torch.utils import experiments as texp
from soft_contrastive_learning_torch.utils.io import load_pickle
from soft_contrastive_learning_tpu.evaluation import roc as jroc
from soft_contrastive_learning_tpu.evaluation import topn as jtopn
from soft_contrastive_learning_tpu.utils import experiments as jexp

torch.set_num_threads(1)  # tier-1 runs several workers on one host


@pytest.fixture(scope="module")
def pipeline(tmp_path_factory):
    """A run directory holding a NetVLAD-8 model at 32x40 (its config
    overrides the CLI's flags), the rehearsal's three sets cut to 200 refs,
    20 queries and 80 PCA images at 32x40, then infer and topn through the
    port's CLI."""
    root = tmp_path_factory.mktemp("pipeline")
    cfg = TrainConfig(model=ModelConfig(vlad_cores=8, image_height=32, image_width=40,
                                        compute_dtype="float32"))
    run = root / "run"
    run.mkdir()
    cfg.save(str(run / "config.json"))
    model = EmbeddingNet(cfg.model)
    model.load_state_dict(init_params(cfg.model, 0))
    RunCheckpoints(str(run)).save("epoch", 0, init_train_state(cfg, model))
    sets = rehearsal_sets(n_ref=200, n_query=20, n_pca=80, img_h=32, img_w=40)
    for name, city in sets.items():
        write_image_set(city, name, str(root / "imgs"), str(root / "lists"), workers=2)
    for name in sets:
        assert cli.main(["infer", "--set", name, "--csv_root", str(root / "lists"),
                         "--img_root", str(root / "imgs"), "--checkpoint", str(run),
                         "--out_root", str(root / "lv"), "--out_name", "wms",
                         "--images_per_pass", "16", "--device", "cpu"]) == 0
    assert cli.main(["topn", "--pca_lv_pickle", str(root / "lv" / "toy_pca_wms.pickle"),
                     "--ref_lv_pickle", str(root / "lv" / "toy_ref_wms.pickle"),
                     "--query_lv_pickle", str(root / "lv" / "toy_query_wms.pickle"),
                     "--ref_csv", str(root / "lists" / "toy_ref.csv"),
                     "--query_csv", str(root / "lists" / "toy_query.csv"),
                     "--out_root", str(root / "top_n"), "--dims", "16,32,64", "--N", "10",
                     "--device", "cpu"]) == 0
    return root, sets


def test_infer_dumps_one_row_per_image(pipeline):
    root, sets = pipeline
    for name, city in sets.items():
        feats = load_pickle(str(root / "lv" / f"{name}_wms.pickle"))
        assert feats.shape == (len(city), 8 * 512) and feats.dtype == np.float32
        np.testing.assert_allclose(np.linalg.norm(feats, axis=1), 1.0, atol=1e-5)


def test_topn_writes_every_setting_in_the_jax_layout(pipeline):
    from soft_contrastive_learning_torch.utils.io import load_csv
    from soft_contrastive_learning_torch.utils.meta import get_xy

    root, _ = pipeline
    ref_xy = get_xy(load_csv(str(root / "lists" / "toy_ref.csv")))
    settings = sorted(os.listdir(root / "top_n"))
    assert settings == sorted(f"l{s}_dim{d}" for s in (0.0, 0.3, 1.0, 5.0) for d in (16, 32, 64))
    for setting in settings:
        got = load_pickle(str(root / "top_n" / setting / "toy_query_wms.pickle"))
        assert [type(x).__name__ for x in got] == ["list", "list", "ndarray", "list",
                                                   "ndarray", "list"]
        assert got[2].shape == (20, 10) and got[2].dtype == np.float32
        spacing = float(setting[1:].split("_")[0])
        assert got[5] == jtopn.spatial_subsample(ref_xy, spacing)


@pytest.mark.parametrize("setting", ["l0.0_dim32", "l5.0_dim64"])
def test_each_roc_reads_the_other_package_s_pickles(pipeline, tmp_path, setting):
    root, _ = pipeline
    port_pickle = str(root / "top_n" / setting / "toy_query_wms.pickle")
    for a, b in ((troc, jroc), (jroc, troc)):
        top1, gt = a.load_top1_dists(port_pickle)
        jtop1, jgt = b.load_top1_dists(port_pickle)
        np.testing.assert_array_equal(top1, jtop1)
        np.testing.assert_array_equal(gt, jgt)
        for x, y in zip(a.correctly_localized_curve(top1), b.correctly_localized_curve(top1)):
            np.testing.assert_array_equal(x, y)
    # the JAX sweep over the same dumps: its pickle, read by the port
    from soft_contrastive_learning_torch.utils.io import load_csv
    from soft_contrastive_learning_torch.utils.meta import get_xy

    lv, lists = root / "lv", root / "lists"
    spacing, d = float(setting[1:].split("_")[0]), int(setting.split("dim")[1])
    paths = jtopn.get_top_n(
        *(load_pickle(str(lv / f"toy_{s}_wms.pickle")) for s in ("pca", "ref", "query")),
        get_xy(load_csv(str(lists / "toy_ref.csv"))),
        get_xy(load_csv(str(lists / "toy_query.csv"))),
        str(tmp_path / "jax"), "toy_query_wms", n=10, spacings=(spacing,), dims=(d,))
    jax_result = load_pickle(paths[setting])
    top1, gt = troc.load_top1_dists(paths[setting])
    np.testing.assert_array_equal(top1, np.asarray(jax_result[1])[:, 0])
    np.testing.assert_array_equal(gt, troc.load_top1_dists(port_pickle)[1])


def test_cli_roc_and_jax_compile_roc_draw_the_port_s_sweep(pipeline, tmp_path):
    root, _ = pipeline
    assert cli.main(["roc", "--top_n_root", str(root / "top_n"), "--out_root",
                     str(tmp_path / "port"), "--queries", "toy_query", "--d", "32"]) == 0
    assert (tmp_path / "port" / "l00_dim32_roc.pdf").stat().st_size > 0
    queries = (("toy_query", "toy", 0),)
    out = jroc.compile_roc(str(root / "top_n"), str(tmp_path / "jax"), setting="l0.0_dim32",
                           queries=queries)
    assert out and os.path.getsize(out) > 0
    assert cli.main(["roc", "--top_n_root", str(root / "top_n"), "--out_root",
                     str(tmp_path / "none"), "--queries", "other_query"]) == 1


def test_compile_roc_grows_past_five_conditions(pipeline, tmp_path):
    root, _ = pipeline
    queries = tuple((f"q{i}", f"Q{i}", 0) for i in range(6)) + (("toy_query", "toy", 0),)
    out = troc.compile_roc(str(root / "top_n"), str(tmp_path), setting="l0.0_dim32",
                           queries=queries)
    assert out and os.path.getsize(out) > 0
    assert troc.compile_roc(str(root / "top_n"), str(tmp_path), setting="l9_dim9") is None


def test_compile_roc_without_matplotlib_says_so(monkeypatch, tmp_path):
    import sys

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(RuntimeError, match="matplotlib"):
        troc.compile_roc(str(tmp_path), str(tmp_path / "figs"))


def test_roc_defaults_equal_jax():
    assert troc.DEFAULT_QUERIES == jroc.DEFAULT_QUERIES
    assert [vars(s) for s in troc.DEFAULT_SERIES] == [vars(s) for s in jroc.DEFAULT_SERIES]


class _Parser(Exception):
    pass


def _jax_subparser(monkeypatch, command):
    """The JAX CLI builds its parser inside main(): stop it at parse_args."""
    def grab(self, args=None, namespace=None):
        raise _Parser(self)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
    try:
        jax_cli.main([command])
    except _Parser as e:
        parser = e.args[0]
    monkeypatch.undo()
    sub = next(a for a in parser._actions if isinstance(a, argparse._SubParsersAction))
    return sub.choices[command]


@pytest.mark.parametrize("command", ["infer", "topn", "roc"])
def test_cli_flags_are_jax_flags_with_jax_defaults(monkeypatch, command):
    jax_flags = {a.dest: (a.default, a.required) for a in
                 _jax_subparser(monkeypatch, command)._actions if a.dest != "help"}
    sub = next(a for a in cli.build_parser()._actions if isinstance(a, argparse._SubParsersAction))
    ours = {a.dest: (a.default, a.required) for a in sub.choices[command]._actions
            if a.dest != "help"}
    if command != "roc":
        assert ours.pop("device") == ("cuda", False)  # the port's own flag
    assert ours == jax_flags


def test_experiments_registry_equals_jax(tmp_path):
    reg = str(tmp_path / "experiments.json")
    assert texp.get_checkpoints("obm", reg) == []
    texp.register_checkpoint("obm", "/runs/al0.8_be15_lowms_000/epoch-checkpoint-2", reg)
    texp.register_checkpoint("obm", "/runs/triplet_000/epoch-checkpoint-1", reg)
    texp.register_checkpoint("obm", "/runs/triplet_000/epoch-checkpoint-1", reg)  # dedup
    assert texp.load_registry(reg) == jexp.load_registry(reg)
    assert len(jexp.get_checkpoints("obm", reg)) == 2
    for path in jexp.get_checkpoints("obm", reg):
        assert texp.checkpoint_code_name(path) == jexp.checkpoint_code_name(path)
    assert texp.checkpoint_code_name("/runs/al0.8_be15_lowms_000/epoch-checkpoint-2") == \
        "al08_be15_lowms_000_e2"
