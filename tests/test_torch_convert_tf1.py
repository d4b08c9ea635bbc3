"""``--checkpoint`` in the PyTorch port against the JAX package.

The port's TF1 converter (``models/convert_tf1.py``, its own numpy copy) and
warm start are held to JAX's ``convert_checkpoint`` + ``warm_start_params``
on synthetic TF1-named arrays, built as
``tests/test_launch_and_convert.py::test_convert_tf1_roundtrip`` builds
them: the same variables map to the same paths, the same scopes are copied,
and the parameters are equal after ``params_from_flax`` (the same arrays
cast the same way: exact). Then both CLIs' ``serve`` and ``train`` are given
the committed flagship npz, a TF1 export and an npz that matches no variable,
and must come to the same outcome: loaded, warm-started, refused.
"""

import contextlib
import io

import jax
import numpy as np
import pytest
import torch

from soft_contrastive_learning_tpu import cli as jax_cli
from soft_contrastive_learning_tpu.checkpoints.manager import (
    warm_start_params as jax_warm_start_params,
)
from soft_contrastive_learning_tpu.core.config import ModelConfig as JaxModelConfig
from soft_contrastive_learning_tpu.models import convert_tf1 as jax_convert
from soft_contrastive_learning_tpu.models.model import init_params as jax_init_params
from soft_contrastive_learning_torch import cli
from soft_contrastive_learning_torch.core.config import ModelConfig
from soft_contrastive_learning_torch.models import convert_tf1
from soft_contrastive_learning_torch.models.model import init_params
from soft_contrastive_learning_torch.models.weights import (
    TRAINED_PARAMS_PATH,
    load_trained_params,
    params_from_flax,
)

torch.set_num_threads(1)  # tier-1 runs several workers on one host

VGG = [(1, 1, 3, 64), (1, 2, 64, 64), (2, 1, 64, 128), (2, 2, 128, 128),
       (3, 1, 128, 256), (3, 2, 256, 256), (3, 3, 256, 256),
       (4, 1, 256, 512), (4, 2, 512, 512), (4, 3, 512, 512),
       (5, 1, 512, 512), (5, 2, 512, 512), (5, 3, 512, 512)]


def _tf1_vars(rng, k, netvlad=True):
    """TF1-named variables as the reference exports them: the scope, the
    matconvnet conv names, (1, 1, 1, D, K) centers, an optimizer slot and
    the global step (both skipped)."""
    tf_vars = {"vgg16_netvlad_pca/average_rgb": rng.standard_normal(3).astype(np.float32)}
    for b, i, cin, cout in VGG:
        tf_vars[f"vgg16_netvlad_pca/conv{b}_{i}/kernel"] = (
            rng.standard_normal((3, 3, cin, cout)).astype(np.float32) * 0.01)
        tf_vars[f"vgg16_netvlad_pca/conv{b}_{i}/bias"] = (
            rng.standard_normal(cout).astype(np.float32) * 0.01)
    if netvlad:
        tf_vars["vgg16_netvlad_pca/assignment/kernel"] = (
            rng.standard_normal((1, 1, 512, k)).astype(np.float32))
        tf_vars["vgg16_netvlad_pca/cluster_centers"] = (
            rng.standard_normal((1, 1, 1, 512, k)).astype(np.float32))
    tf_vars["vgg16_netvlad_pca/conv1_1/kernel/Adam"] = np.zeros((3, 3, 3, 64), np.float32)
    tf_vars["Variable"] = np.asarray(7)
    return tf_vars


def _port_load(cfg, path, default_artifact, seed=0):
    """The port's loader: (outcome, params) with outcome 'loaded',
    'warm-started <scopes>' or 'refused'."""
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            _, params = cli._load_model_params(cfg, path, default_artifact, seed)
    except SystemExit as e:
        assert "ZERO variables" in str(e)
        return "refused", None
    return _outcome(out.getvalue()), params


def _outcome(text):
    if "loaded flagship artifact" in text:
        return "loaded"
    assert "warm-started" in text, text
    return "warm-started " + text.split("warm-started ", 1)[1].split(" from ")[0]


@pytest.mark.parametrize("with_netvlad", [True, False])
def test_conversion_and_warm_start_match_jax(tmp_path, with_netvlad):
    k = 4
    tf_vars = _tf1_vars(np.random.default_rng(0), k, netvlad=with_netvlad)
    npz = str(tmp_path / "tf1.npz")
    np.savez(npz, **tf_vars)

    jax_tree, jax_mapping = jax_convert.convert_checkpoint(npz)
    tree, mapping = convert_tf1.convert_checkpoint(npz)
    assert mapping == jax_mapping
    assert "Variable" not in mapping and not any("Adam" in n for n in mapping)
    jax_flat = convert_tf1.flatten(jax_tree)
    flat = convert_tf1.flatten(tree)
    assert flat.keys() == jax_flat.keys()
    assert all(np.array_equal(flat[key], jax_flat[key]) for key in flat)

    jcfg = JaxModelConfig(vlad_cores=k, reduction="none", compute_dtype="float32",
                          use_pallas=False)
    merged, jax_copied = jax_warm_start_params(jax_init_params(jcfg, jax.random.key(0)), jax_tree)
    outcome, params = _port_load(ModelConfig(vlad_cores=k), npz, default_artifact=False, seed=3)
    assert outcome == f"warm-started {list(jax_copied)}"
    want = params_from_flax(
        {key: np.asarray(v) for key, v in convert_tf1.flatten(merged).items()},
        ModelConfig(vlad_cores=k))
    fresh = init_params(ModelConfig(vlad_cores=k), 3)
    for name, value in params.items():
        scope = name.split(".")[0]
        if scope in jax_copied:  # the donor's arrays, cast as JAX casts them
            assert torch.equal(value, want[name]), name
        else:  # not in the export: the port's own fresh init from the seed
            assert torch.equal(value, fresh[name]), name


@pytest.mark.parametrize("reduction,vlad_cores", [("2fc", 4), ("spp", 4), ("none", 0)])
def test_a_tf1_export_warm_starts_a_head_configuration(tmp_path, reduction, vlad_cores):
    """The scopes JAX's ``warm_start_params`` copies into a head
    configuration (no NetVLAD with 'spp' or ``vlad_cores=0``), the donor's
    arrays there, the dense head the port's fresh init."""
    tf_vars = _tf1_vars(np.random.default_rng(1), 4)
    npz = str(tmp_path / "tf1.npz")
    np.savez(npz, **tf_vars)
    common = dict(vlad_cores=vlad_cores, reduction=reduction, out_dim=8, image_height=64,
                  image_width=80)
    jax_tree, _ = jax_convert.convert_checkpoint(npz)
    _, jax_copied = jax_warm_start_params(
        jax_init_params(JaxModelConfig(compute_dtype="float32", use_pallas=False, **common),
                        jax.random.key(0)), jax_tree)
    cfg = ModelConfig(**common)
    outcome, params = _port_load(cfg, npz, default_artifact=False, seed=3)
    assert outcome == f"warm-started {list(jax_copied)}"
    fresh = init_params(cfg, 3)
    assert params.keys() == fresh.keys()
    for name, value in params.items():
        if name.split(".")[0] not in jax_copied:
            assert torch.equal(value, fresh[name]), name


def test_raw_tf_checkpoint_is_refused_with_jax_s_message():
    with pytest.raises(RuntimeError, match="export the checkpoint to .npz first"):
        convert_tf1.load_tf1_variables("/nonexistent/model.ckpt-1000")


def _run_port(monkeypatch, command, path, tmp_path):
    """The port's CLI up to the object that would take the parameters:
    (outcome, params)."""
    import soft_contrastive_learning_torch.serving as serving
    import soft_contrastive_learning_torch.train.trainer as trainer

    class Taken(Exception):
        pass

    def take(*args, params=None, **kwargs):
        raise Taken(params if params is not None else args[1])

    monkeypatch.setattr(serving, "DescriptorService", take)
    monkeypatch.setattr(trainer, "Trainer", take)
    argv = [command, "--checkpoint", path, "--device", "cpu"]
    if command == "train":
        argv += ["--toy_city", "--loss", "wms", "--out_root", str(tmp_path)]
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            cli.main(argv)
    except SystemExit as e:
        assert "ZERO variables" in str(e)
        return "refused", None
    except Taken as taken:
        return _outcome(out.getvalue()), taken.args[0]
    raise AssertionError("the CLI neither refused nor reached its model")


@pytest.fixture(scope="module")
def exports(tmp_path_factory):
    """The committed flagship npz, a TF1 export at the flagship's 64 clusters
    and an npz that matches no variable."""
    root = tmp_path_factory.mktemp("exports")
    tf1 = str(root / "tf1.npz")
    np.savez(tf1, **_tf1_vars(np.random.default_rng(1), 64))
    nothing = str(root / "nothing.npz")
    np.savez(nothing, **{"some/other/model": np.zeros(3, np.float32)})
    return {"flagship": str(TRAINED_PARAMS_PATH), "tf1": tf1, "nothing": nothing}


@pytest.mark.parametrize("command", ["serve", "train"])
@pytest.mark.parametrize("which,expect", [("flagship", "loaded"),
                                          ("tf1", "warm-started ['vgg16', 'netvlad']"),
                                          ("nothing", "refused")])
def test_both_clis_come_to_the_same_outcome(monkeypatch, tmp_path, exports, command, which,
                                            expect):
    """The port's serve and train take each file as JAX's infer/serve loader
    does (``soft_contrastive_learning_tpu/cli.py::_load_model_params``), with
    the same parameters where it loads. JAX's train converts a TF1 export into
    the same donor; given the flagship npz or an unmatched file it warms
    nothing and trains from a fresh init (it refuses nothing): the port's
    train follows the infer/serve loader there instead."""
    path = exports[which]
    outcome, params = _run_port(monkeypatch, command, path, tmp_path)
    assert outcome == expect
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            _, jax_params = jax_cli._load_model_params(JaxModelConfig(), path)
        jax_outcome = _outcome(out.getvalue())
    except SystemExit as e:
        assert "ZERO variables" in str(e)
        jax_outcome, jax_params = "refused", None
    assert jax_outcome == expect
    if which == "flagship":
        assert all(torch.equal(params[key], value) for key, value in load_trained_params().items())
    if params is not None:
        want = params_from_flax({key: np.asarray(v) for key, v in
                                 convert_tf1.flatten(jax_params).items()})
        assert params.keys() == want.keys()
        assert all(torch.equal(params[key], want[key]) for key in want)

    if command == "train" and which == "tf1":
        import soft_contrastive_learning_tpu.train.trainer as jax_trainer

        class Taken(Exception):
            pass

        def take(*args, warm_start_donor=None, **kwargs):
            raise Taken(warm_start_donor)

        monkeypatch.setattr(jax_trainer, "Trainer", take)
        with pytest.raises(Taken) as taken:
            jax_cli.main(["train", "--toy_city", "--loss", "wms", "--checkpoint", path,
                          "--out_root", str(tmp_path)])
        donor = convert_tf1.flatten(taken.value.args[0])
        got = {name: value for name, value in params.items()}
        want = params_from_flax(donor)
        assert all(torch.equal(got[key], want[key]) for key in want)
