"""The port's flagship module (the shipped serving configuration) and its
benchmark, on the CPU, against the JAX package's flagship.py."""

import json

import numpy as np
import pytest
import torch

from soft_contrastive_learning_tpu import flagship as jax_flagship
from soft_contrastive_learning_tpu.core.config import ModelConfig as JaxModelConfig
from soft_contrastive_learning_torch import benchmark, flagship
from soft_contrastive_learning_torch.core.config import ModelConfig
from soft_contrastive_learning_torch.models.weights import load_trained_params

torch.set_num_threads(1)  # tier-1 runs several workers on one host


def _small(compute_dtype="float32"):
    return ModelConfig(image_height=48, image_width=64, compute_dtype=compute_dtype)


def test_constants_are_jaxs():
    assert flagship.SERVING_BATCH == jax_flagship.SERVING_BATCH
    assert flagship.BF16_CONFIRM_BATCH == jax_flagship.BF16_CONFIRM_BATCH
    assert flagship.INT8_COSINE_THRESHOLD == jax_flagship.INT8_COSINE_THRESHOLD
    cfg, jcfg = flagship.flagship_model_config(), jax_flagship.flagship_model_config()
    assert (cfg.vlad_cores, cfg.reduction, cfg.compute_dtype, cfg.image_height,
            cfg.image_width, cfg.descriptor_dim) == (
        jcfg.vlad_cores, jcfg.reduction, jcfg.compute_dtype, jcfg.image_height,
        jcfg.image_width, jcfg.descriptor_dim)


@pytest.mark.parametrize("n", [8, 3])
def test_calibration_images_are_jaxs_bit_for_bit(n):
    cfg, jcfg = flagship.flagship_model_config(), jax_flagship.flagship_model_config()
    got, want = flagship.calibration_images(cfg, n), jax_flagship.calibration_images(jcfg, n)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_flagship_params_are_the_trained_artifact():
    params, provenance = flagship.flagship_params(flagship.flagship_model_config())
    assert provenance == "trained"
    want = load_trained_params()
    assert all(torch.equal(params[k], want[k]) for k in want)


def test_descriptor_cosine_is_jaxs():
    rng = np.random.default_rng(1)
    a, b = rng.standard_normal((2, 5, 40))
    assert flagship.descriptor_cosine(a, b) == pytest.approx(
        jax_flagship.descriptor_cosine(a, b), abs=1e-15)


def test_int8_gate_passes_on_the_trained_weights_as_jaxs_does():
    """The gate on the trained flagship weights at 48x64 in fp32 on the CPU:
    it passes in both packages, with cosines within 1e-4 of each other (JAX's
    gate jits its stack, where XLA's contracted dequant can round an int8
    tie the other way and the flip carries through the later layers;
    tests/test_torch_quant.py counts them) and the same scales."""
    cfg = _small()
    params = load_trained_params(cfg=cfg)
    calib = flagship.calibration_images(cfg, n=2)
    q_embed, scales, cos = flagship.int8_gate(cfg, params, calib, device="cpu")
    jcfg = JaxModelConfig(image_height=48, image_width=64, compute_dtype="float32",
                          use_pallas=False)
    _, jax_scales, jax_cos = jax_flagship.int8_gate(
        jcfg, jax_flagship.load_trained_params(jcfg), calib)
    assert cos > flagship.INT8_COSINE_THRESHOLD
    assert abs(cos - jax_cos) <= 1e-4, (cos, jax_cos)
    assert scales == pytest.approx(jax_scales, rel=1e-5)
    assert q_embed(calib).shape == (2, cfg.descriptor_dim)


def test_int8_gate_fails_on_nan_cosine(monkeypatch):
    """NaN descriptors must FAIL the gate, not certify: ``not (cos > t)``."""
    cfg = ModelConfig(vlad_cores=8, image_height=32, image_width=32, compute_dtype="float32")
    from soft_contrastive_learning_torch.models.model import init_params

    params = init_params(cfg, 0)
    monkeypatch.setattr(flagship, "descriptor_cosine", lambda a, b: float("nan"))
    with pytest.raises(RuntimeError, match="quality gate failed"):
        flagship.int8_gate(cfg, params, flagship.calibration_images(cfg, n=2), device="cpu")


def test_serving_forward_on_the_cpu_is_the_bf16_float_path():
    """``serving_forward(device="cpu")``: the bf16 float path at the
    flagship's width, the trained weights; equal to EmbeddingNet's forward."""
    from soft_contrastive_learning_torch.models.model import EmbeddingNet

    embed_fn, params, detail = flagship.serving_forward(device="cpu")
    assert detail == {"params": "trained", "precision": "bf16"}
    x = torch.from_numpy(flagship.calibration_images(flagship.flagship_model_config(), n=1))
    got = embed_fn(x)
    model = EmbeddingNet(flagship.flagship_model_config())
    model.load_state_dict(params)
    with torch.inference_mode():
        want = model.eval()(x)[0]
    assert got.shape == (1, 32768)
    assert torch.equal(got, want)


def test_serving_forward_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        flagship.serving_forward()


def test_benchmark_protocol_on_the_cpu(monkeypatch, capsys):
    """``--device cpu`` runs the tiny bf16 configuration and prints one JSON
    line with JAX's keys, no rate (a CPU run gives none), ``vs_baseline``
    null; here at 32x32 with a small NetVLAD so that it is quick."""
    from soft_contrastive_learning_torch.models.model import init_params

    cfg = ModelConfig(vlad_cores=8, image_height=32, image_width=32)
    monkeypatch.setattr(flagship, "flagship_model_config", lambda: cfg)
    monkeypatch.setattr(flagship, "flagship_params", lambda c: (init_params(c, 0), "seed0"))
    benchmark.main(["--device", "cpu"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    out = json.loads(line)
    assert set(out) == {"metric", "value", "unit", "vs_baseline", "detail"}
    assert out["metric"] == "vgg16_netvlad_embed_throughput"
    assert out["value"] is None and out["vs_baseline"] is None
    assert out["detail"]["backend"] == "cpu" and out["detail"]["precision"] == "bf16"
    assert out["detail"]["configs"][0]["batch_size"] == 8


def test_benchmark_int8_config_runs_the_gate_first(monkeypatch):
    """The int8 configuration raises when its gate fails (here: a NaN
    cosine); an unknown precision raises."""
    from soft_contrastive_learning_torch.models.model import init_params

    cfg = ModelConfig(vlad_cores=8, image_height=32, image_width=32, compute_dtype="float32")
    params = init_params(cfg, 0)
    monkeypatch.setattr(flagship, "descriptor_cosine", lambda a, b: float("nan"))
    with pytest.raises(RuntimeError, match="quality gate failed"):
        benchmark.measure_config("int8", 2, 1, "cpu", cfg, params, "seed0")
    with pytest.raises(ValueError, match="unknown precision"):
        benchmark.measure_config("fp8", 2, 1, "cpu", cfg, params, "seed0")


def _tiny_flagship(monkeypatch):
    from soft_contrastive_learning_torch.models.model import init_params

    cfg = ModelConfig(vlad_cores=8, image_height=32, image_width=32, compute_dtype="float32")
    monkeypatch.setattr(flagship, "flagship_model_config", lambda: cfg)
    monkeypatch.setattr(flagship, "flagship_params", lambda c: (init_params(c, 0), "seed0"))


def test_benchmark_records_a_failed_gate_and_measures_the_rest(monkeypatch):
    """A missed int8 gate is recorded in ``detail["skipped"]`` and the bf16
    configuration is still measured, as JAX's benchmark records it."""
    _tiny_flagship(monkeypatch)
    monkeypatch.setattr(flagship, "descriptor_cosine", lambda a, b: float("nan"))
    out = benchmark.run(device="cpu", configs=[("int8-ptq", 2, 1), ("bf16", 2, 1)])
    assert [c["precision"] for c in out["detail"]["configs"]] == ["bf16"]
    assert len(out["detail"]["skipped"]) == 1
    assert "quality gate failed" in out["detail"]["skipped"][0]


def test_benchmark_fails_when_the_int8_kernel_fails(monkeypatch):
    """A kernel that fails to build or launch stops the benchmark: the bf16
    rate does not stand in for the int8 configuration's."""
    from soft_contrastive_learning_torch.models import quant

    def broken(*args, **kwargs):
        raise RuntimeError("Q1 int8_conv: launch failed")

    _tiny_flagship(monkeypatch)
    monkeypatch.setattr(quant, "int8_conv", broken)
    with pytest.raises(RuntimeError, match="Q1 int8_conv: launch failed"):
        benchmark.run(device="cpu", configs=[("int8-ptq", 2, 1), ("bf16", 2, 1)])


def test_save_trained_params_round_trips_through_jax_s_loader(tmp_path):
    """The port's ``save_trained_params`` writes JAX's float16 artifact: JAX's
    ``load_trained_params`` reads every leaf back as the float16 rounding
    of the port's parameter, bit for bit, and the port's loader reads the
    same values; the file's arrays equal those JAX's own exporter writes
    for the same parameters."""
    import jax

    from soft_contrastive_learning_torch.models.model import init_params
    from soft_contrastive_learning_torch.models.weights import flax_from_params

    cfg = flagship.flagship_model_config()
    params = init_params(cfg, 7)
    path = str(tmp_path / "trained.npz")
    flagship.save_trained_params(params, path)
    flat = flax_from_params(params)
    loaded = jax_flagship.load_trained_params(jax_flagship.flagship_model_config(), path)
    got = {"/".join(str(p.key) for p in kp): np.asarray(leaf)
           for kp, leaf in jax.tree_util.tree_flatten_with_path(loaded)[0]}
    assert set(got) == set(flat)
    for key, value in flat.items():
        assert got[key].dtype == np.float32
        np.testing.assert_array_equal(got[key], value.astype(np.float16).astype(np.float32))
    port = load_trained_params(path, cfg)
    assert all(torch.equal(port[k], params[k].to(torch.float16).float()) for k in params)
    jax_path = str(tmp_path / "jax.npz")
    jax_flagship.save_trained_params(loaded, jax_path)
    with np.load(path) as ours, np.load(jax_path) as theirs:
        assert set(ours.files) == set(theirs.files)
        assert all(ours[k].dtype == np.float16 and np.array_equal(ours[k], theirs[k])
                   for k in ours.files)


def test_save_trained_params_refuses_nonfinite_and_overflowing_leaves(tmp_path):
    """As JAX's (``tests/test_flagship.py``): a NaN/Inf leaf, or a value
    that overflows float16, fails at export with JAX's message, and no file
    is written."""
    from soft_contrastive_learning_torch.models.model import init_params

    params = init_params(flagship.flagship_model_config(), 0)
    first = next(iter(params))
    for value, match in ((float("inf"), "non-finite"), (float("nan"), "non-finite"),
                         (70000.0, "overflows float16")):
        bad = dict(params)
        bad[first] = params[first].clone()
        bad[first].view(-1)[0] = value
        path = tmp_path / "x.npz"
        with pytest.raises(ValueError, match=match):
            flagship.save_trained_params(bad, str(path))
        assert not path.exists()
