"""The int8-PTQ conv stack of the port (models/quant.py, Q1's plain version)
against the JAX package's models/quant.py on the CPU, on the same numpy
inputs and weights (a flax init carried across by params_from_flax).

JAX runs as its own tests run it: compute_dtype float32, use_pallas False,
``quantized_embed`` called eagerly; the per-layer comparison jits each layer
as ``QuantizedEmbedder`` jits the stack. Tolerances:
- scales: 1e-5 relative (two fp32 conv stacks summing in other orders);
- weights: int8 for int8, scales equal;
- per layer, both fed JAX's int8 input and JAX's scales: the int8 maps
  equal, or 1 apart on at most 1e-4 of the elements: the port (and Q1)
  round the dequant's multiply and add apart, as JAX's code is written, and
  XLA's CPU backend contracts them into one FMA under jit, which can round
  an fp32 tie the other way. Found: 0 of the 5.2M elements of the 12 int8
  maps at 48x64, 1 of 20.8M at 96x128 (conv2_1). conv5_3's fp32 map within
  four fp32 roundings of the product and the sum, |got - want| <=
  2^-21 (|acc m| + |y|) (acc m = y - bias): under jit XLA contracts and
  reorders the dequant (929 of 36,864 elements differ at 48x64, where the
  port's value is the correctly rounded product and JAX's 2 ulp from it);
- whole descriptors against JAX's eager ``quantized_embed`` (no contraction):
  row cosine >= 0.99999 and the same top-5 ids. (Against the jitted stack
  one flipped int8 tie at conv2_1 carries through ten requantizations to a
  row cosine of 0.99993 at 96x128.)
"""

import argparse
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soft_contrastive_learning_tpu.core.config import ModelConfig as JaxModelConfig
from soft_contrastive_learning_tpu.models import quant as jq
from soft_contrastive_learning_tpu.models.model import init_params as jax_init_params
from soft_contrastive_learning_tpu.models.vgg16 import _VGG_BLOCKS
from soft_contrastive_learning_torch.core.config import ModelConfig
from soft_contrastive_learning_torch.models import quant as tq
from soft_contrastive_learning_torch.models.model import init_params
from soft_contrastive_learning_torch.models.weights import params_from_flax
from soft_contrastive_learning_torch.ops.kernels.int8_conv import (
    int8_conv_plain,
    int8_pool,
    int8_stem,
    requant_plain,
    stem_columns,
    stem_weight,
)

torch.set_num_threads(1)  # tier-1 runs several workers on one host


def _flat(params):
    from flax import traverse_util

    return {k: np.asarray(v) for k, v in traverse_util.flatten_dict(params, sep="/").items()}


def _setup(reduction="none", vlad=8, hw=(48, 64), n=6, channels=3, seed=0):
    common = dict(vlad_cores=vlad, reduction=reduction, image_height=hw[0], image_width=hw[1],
                  compute_dtype="float32", out_dim=16)
    jcfg = JaxModelConfig(use_pallas=False, **common)
    cfg = ModelConfig(**common)
    jparams = jax_init_params(jcfg, jax.random.key(0))
    params = params_from_flax(_flat(jparams), cfg)
    x = np.random.default_rng(seed).random((n, hw[0], hw[1], channels), np.float32) * 255.0
    return jcfg, cfg, jparams, params, x


@pytest.fixture(scope="module")
def flagship_like():
    jcfg, cfg, jparams, params, x = _setup()
    return jcfg, cfg, jparams, params, x, jq.calibrate_scales(jparams, jnp.asarray(x))


def test_conv_names_match_jax():
    assert tq.CONV_NAMES == jq.CONV_NAMES


def test_calibrated_scales_match_jax(flagship_like):
    _, _, _, params, x, want = flagship_like
    got = tq.calibrate_scales(params, x)
    assert set(got) == set(want)
    for name in want:
        assert abs(got[name] - want[name]) <= 1e-5 * want[name], name


def test_dead_layer_scale_is_one(flagship_like):
    """An all-zero input makes every activation of a zero-bias init zero: the
    scale of a dead layer is 1.0 in both packages."""
    _, _, jparams, params, x, _ = flagship_like
    zeros = np.zeros_like(x[:2])
    avg = params["vgg16.average_rgb"].numpy()
    assert not avg.any()  # the init's average_rgb is zero: the input itself is dead
    got, want = tq.calibrate_scales(params, zeros), jq.calibrate_scales(jparams, zeros)
    assert got["block1/conv1_1"] == want["block1/conv1_1"] == 1.0
    assert got == pytest.approx(want, rel=1e-5)


def test_scales_json_loads_in_either_package(flagship_like, tmp_path):
    scales = flagship_like[-1]
    ours, theirs = tmp_path / "ours.json", tmp_path / "theirs.json"
    tq.save_scales(scales, str(ours))
    jq.save_scales(scales, str(theirs))
    assert ours.read_text() == theirs.read_text()  # indent 1, sorted keys
    assert jq.load_scales(str(ours)) == tq.load_scales(str(theirs)) == scales


def test_quantize_weight_matches_jax():
    rng = np.random.default_rng(3)
    k = rng.standard_normal((3, 3, 16, 8)).astype(np.float32) * 0.1  # HWIO
    k[..., 5] = 0.0  # an all-zero output channel: scale 1.0, no NaN
    want_k8, want_s = jq._quantize_weight(jnp.asarray(k))
    got_k8, got_s = tq._quantize_weight(torch.from_numpy(k).permute(3, 2, 0, 1))
    assert got_k8.dtype == torch.int8 and got_k8.shape == (8, 3, 3, 16)
    np.testing.assert_array_equal(got_k8.numpy(), np.asarray(want_k8).transpose(3, 0, 1, 2))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    assert got_s[5] == 1.0 and not got_k8[5].any()


def _jax_layers(jparams, scales, images):
    """JAX's quantized_conv_stack unrolled (its own code, per layer under
    jit): per conv, the int8 input, the layer's output (int8 after the
    requant, or fp32 for conv5_3) and, at a block boundary, the pooled int8."""
    vgg = jparams["vgg16"]

    @jax.jit
    def layer(a8, kernel, bias, s_in, inv_next, relu, block_end):
        k8, sk = jq._quantize_weight(kernel.astype(jnp.float32))
        y32 = jax.lax.conv_general_dilated(a8, k8, (1, 1), "SAME",
                                           dimension_numbers=("NHWC", "HWIO", "NHWC"),
                                           preferred_element_type=jnp.int32)
        y = y32.astype(jnp.float32) * (s_in * sk) + bias.astype(jnp.float32)
        y = jnp.where(relu, jax.nn.relu(y), y)
        y = jnp.where(block_end, jax.nn.relu(y), y)
        return y, jnp.clip(jnp.round(y * inv_next), -127, 127).astype(jnp.int8)

    pool = jax.jit(lambda y8: jax.lax.reduce_window(y8, jnp.int8(-128), jax.lax.max,
                                                    (1, 2, 2, 1), (1, 2, 2, 1), "VALID"))
    a = jnp.asarray(images, jnp.float32) - vgg["average_rgb"].astype(jnp.float32)
    a8 = jq._requant(a, scales[jq.CONV_NAMES[0]])
    out, idx = [], 0
    for bi, specs in enumerate(_VGG_BLOCKS):
        for si, (name, _, relu) in enumerate(specs):
            last = idx == len(jq.CONV_NAMES) - 1
            block_end = si == len(specs) - 1 and not last
            # JAX's weakly typed s_in and 1 / s_next: these fp32 values
            s_in = np.float32(scales[jq.CONV_NAMES[idx]])
            inv_next = np.float32(1.0 / (1.0 if last else scales[jq.CONV_NAMES[idx + 1]]))
            y, y8 = layer(a8, vgg[f"block{bi + 1}"][name]["kernel"],
                          vgg[f"block{bi + 1}"][name]["bias"], s_in, inv_next, bool(relu),
                          block_end)
            pooled = pool(y8) if block_end else None
            out.append((np.asarray(a8), np.asarray(y if last else y8),
                        None if pooled is None else np.asarray(pooled)))
            a8 = pooled if block_end else y8
            idx += 1
    return out


@pytest.mark.parametrize("hw", [(48, 64), (96, 128)])
def test_every_layer_matches_jax_fed_jaxs_input(flagship_like, hw):
    """Both stacks with JAX's scales: the port's plain conv + epilogue (Q1's
    arithmetic) fed the int8 input JAX computed for that layer gives JAX's
    int8 map, and its int8 pool JAX's pooled map; conv5_3's fp32 map within
    four roundings of the dequant (XLA's contraction and reordering)."""
    if hw == (48, 64):
        _, _, jparams, params, x, scales = flagship_like
    else:
        _, _, jparams, params, x = _setup(hw=hw, n=8)
        scales = jq.calibrate_scales(jparams, jnp.asarray(x))
    stack = tq.QuantizedConvStack(params, scales, device="cpu")
    layers = _jax_layers(jparams, scales, x)
    # JAX's own stack ends where the unrolled one does
    np.testing.assert_array_equal(
        layers[-1][1], np.asarray(jax.jit(lambda im: jq.quantized_conv_stack(
            jparams["vgg16"], scales, im))(jnp.asarray(x))))
    off_by_one = total = 0
    for i, ((a8, want, pooled), layer) in enumerate(zip(layers, stack.layers)):
        xin = torch.from_numpy(a8.copy())
        got = int8_conv_plain(stem_columns(xin) if i == 0 else xin, layer["weight"],
                              layer["mult"], layer["bias"], layer["inv_next"], layer["relu"],
                              layer["out_f32"]).numpy()
        assert got.shape == want.shape and got.dtype == want.dtype, i
        if layer["out_f32"]:
            y = got.astype(np.float64)
            product = np.abs(y - layer["bias"].double().numpy())
            assert (np.abs(y - want) <= 2.0**-21 * (product + np.abs(y))).all()
            continue
        diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
        assert diff.max() <= 1, (tq.CONV_NAMES[i], diff.max())
        off_by_one += int(diff.sum())
        total += diff.size
        if pooled is not None:
            np.testing.assert_array_equal(int8_pool(torch.from_numpy(want.copy())).numpy(),
                                          pooled)
    assert off_by_one <= 1e-4 * total, (off_by_one, total)


def _jax_stem_eager(jparams, scales, images):
    """JAX's input requant and first int8 layer (conv1_1 with its ReLU and
    conv1_2's requant), op by op as ``quantized_conv_stack`` writes them,
    eagerly: no jit, so no contraction of the dequant's multiply and add."""
    vgg = jparams["vgg16"]
    a = jnp.asarray(images).astype(jnp.float32) - vgg["average_rgb"].astype(jnp.float32)
    a8 = jq._requant(a, scales[jq.CONV_NAMES[0]])
    k8, sk = jq._quantize_weight(vgg["block1"]["conv1_1"]["kernel"].astype(jnp.float32))
    y32 = jax.lax.conv_general_dilated(a8, k8, (1, 1), "SAME",
                                       dimension_numbers=("NHWC", "HWIO", "NHWC"),
                                       preferred_element_type=jnp.int32)
    y = y32.astype(jnp.float32) * (scales[jq.CONV_NAMES[0]] * sk) + \
        vgg["block1"]["conv1_1"]["bias"].astype(jnp.float32)
    return np.asarray(a8), np.asarray(jq._requant(jax.nn.relu(y), scales[jq.CONV_NAMES[1]]))


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
@pytest.mark.parametrize("hw", [(11, 15), (13, 21), (45, 60)])
def test_int8_stem_plain_route_is_jaxs_requant_and_first_layer(flagship_like, dtype, hw):
    """``int8_stem`` on CPU tensors (its plain route: requant, the packed
    columns, the 1x1 conv and epilogue) gives exactly the int8 map of JAX's
    input requant and conv1_1, from uint8 and from fp32 pixels; its requant
    alone is JAX's ``_requant`` of the centred images."""
    _, _, jparams, params, _, scales = flagship_like
    rng = np.random.default_rng(hw[0] * hw[1])
    if dtype == "uint8":
        x = rng.integers(0, 256, (2, *hw, 3), dtype=np.uint8)
    else:
        x = rng.random((2, *hw, 3), np.float32) * 255.0
    params = dict(params)  # a trained-like centring (the init's average_rgb is zero)
    params["vgg16.average_rgb"] = torch.tensor([123.68, 116.779, 103.939])
    jparams = jax.tree_util.tree_map(lambda v: v, jparams)
    jparams["vgg16"] = dict(jparams["vgg16"], average_rgb=jnp.asarray([123.68, 116.779, 103.939]))
    want_a8, want = _jax_stem_eager(jparams, scales, x)
    stack = tq.QuantizedConvStack(params, scales, device="cpu")
    stem = stack.layers[0]
    got_a8 = requant_plain(torch.from_numpy(x).float() - stack.average_rgb, stack.inv_in)
    np.testing.assert_array_equal(got_a8.numpy(), want_a8)
    got = int8_stem(torch.from_numpy(x), stack.average_rgb, stack.inv_in, stem["weight"],
                    stem["mult"], stem["bias"], stem["inv_next"], stem["relu"])
    assert got.dtype == torch.int8 and got.shape == (2, *hw, 64)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want != 0).any()


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_whole_stack_equals_jaxs_eager_stack(flagship_like, dtype):
    """The port's conv stack (``int8_stem``, then ``int8_conv`` and
    ``int8_pool`` on the CPU) gives JAX's eager ``quantized_conv_stack``
    conv5_3 map bit for bit, from uint8 and from fp32 pixels."""
    _, _, jparams, params, x, scales = flagship_like
    if dtype == "uint8":
        x = np.random.default_rng(7).integers(0, 256, x.shape, dtype=np.uint8)
    want = np.asarray(jq.quantized_conv_stack(jparams["vgg16"], scales, jnp.asarray(x)))
    got = tq.QuantizedConvStack(params, scales, device="cpu")(x).numpy()
    np.testing.assert_array_equal(got, want)


def _top5(queries, index):
    d = ((queries[:, None, :] - index[None, :, :]) ** 2).sum(-1)
    return np.argsort(d, axis=1, kind="stable")[:, :5]


@pytest.mark.parametrize("reduction,vlad,hw,channels", [
    ("none", 8, (48, 64), 3),
    ("1fc", 8, (48, 64), 3),
    ("spp", 0, (96, 128), 3),  # a conv5_3 map of at least 4x4 for the level-3 pyramid
    ("none", 0, (48, 64), 3),  # vlad_cores=0: the flattened map
    ("none", 8, (48, 64), 1),  # gray input, promoted to RGB
])
def test_quantized_embed_matches_jax(reduction, vlad, hw, channels):
    jcfg, cfg, jparams, params, x = _setup(reduction, vlad, hw, n=8, channels=channels)
    scales = jq.calibrate_scales(jparams, jnp.asarray(x))
    want_out, want_full = jq.quantized_embed(jcfg, jparams, scales, jnp.asarray(x))
    got_out, got_full = tq.quantized_embed(cfg, params, scales, x)
    for got, want in ((got_out, want_out), (got_full, want_full)):
        got, want = got.numpy().astype(np.float64), np.asarray(want, np.float64)
        assert got.shape == want.shape
        cos = (got * want).sum(1) / (np.linalg.norm(got, axis=1) * np.linalg.norm(want, axis=1))
        assert cos.min() >= 0.99999, cos
    index = np.asarray(want_out, np.float64)
    np.testing.assert_array_equal(_top5(got_out.numpy().astype(np.float64), index),
                                  _top5(index, index))


def test_quantized_embedder_quantizes_once_and_matches_the_function(flagship_like):
    _, cfg, _, params, x, scales = flagship_like
    emb = tq.QuantizedEmbedder(cfg, params, scales=scales, device="cpu")
    assert emb.stack.layers[3]["weight"].dtype == torch.int8
    assert emb.stack.layers[3]["weight"].shape == (128, 3, 3, 128)  # K-major (F, 3, 3, C)
    assert emb.stack.layers[0]["weight"].shape == (64, 1, 1, 32)  # the stem's columns
    out, full = tq.quantized_embed(cfg, params, scales, x)
    assert torch.equal(emb(x), out) and torch.equal(emb.full(x), full)
    assert torch.equal(emb.stack(x), tq.quantized_conv_stack(params, scales, x))
    calibrated = tq.QuantizedEmbedder(cfg, params, x, device="cpu")
    assert calibrated.scales == pytest.approx(scales, rel=1e-5)


@pytest.mark.parametrize("shape", [(2, 7, 9, 3), (1, 11, 15, 1), (3, 4, 5, 2)])
def test_stem_columns_make_the_3x3_conv_a_1x1_conv(shape):
    """The stem's packed columns by ``stem_weight`` give the plain 3x3 conv
    of the raw channels, and hold each tap's channels in (r, s, c) order."""
    rng = np.random.default_rng(sum(shape))
    x = torch.from_numpy(rng.integers(-127, 128, shape, dtype=np.int8))
    b, h, w, c = shape
    wt = torch.from_numpy(rng.integers(-127, 128, (16, 3, 3, c), dtype=np.int8))
    mult = torch.from_numpy(rng.uniform(1e-4, 1e-3, 16).astype(np.float32))
    bias = torch.from_numpy(rng.normal(0, 0.1, 16).astype(np.float32))
    cols = stem_columns(x)
    padded = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))
    for tap in range(9):
        r, s = divmod(tap, 3)
        assert torch.equal(cols[..., tap * c : (tap + 1) * c], padded[:, r : r + h, s : s + w])
    assert not cols[..., 9 * c :].any()
    args = (mult, bias, 50.0, True, False)
    assert torch.equal(int8_conv_plain(cols, stem_weight(wt), *args),
                       int8_conv_plain(x, wt, *args))


def test_packed_stem_is_refused():
    """No longer refused: the packed stem is ported (tests/test_torch_packed_stem.py),
    and the config and the int8 stack take it."""
    cfg = ModelConfig(packed_stem=True)
    assert cfg.packed_stem
    params = init_params(ModelConfig(vlad_cores=4), 0)
    stack = tq.QuantizedConvStack(params, {name: 1.0 for name in tq.CONV_NAMES}, "cpu",
                                  packed_stem=cfg.packed_stem)
    assert len(stack.packed) == 3


def _jax_subparser_defaults(monkeypatch, command):
    """{dest: default} of a subcommand of the JAX CLI, whose parser is built
    inside ``main``: its ``parse_args`` is stopped and the parser kept."""
    from soft_contrastive_learning_tpu import cli as jax_cli

    class Stop(Exception):
        pass

    kept = {}

    def stop(self, *args, **kwargs):
        kept["parser"] = self
        raise Stop

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", stop)
    with pytest.raises(Stop):
        jax_cli.main([command])
    monkeypatch.undo()
    sub = next(a for a in kept["parser"]._actions if isinstance(a, argparse._SubParsersAction))
    return {a.dest: a.default for a in sub.choices[command]._actions if a.dest != "help"}


def _our_subparser_defaults(command):
    from soft_contrastive_learning_torch.cli import build_parser

    sub = next(a for a in build_parser()._actions if isinstance(a, argparse._SubParsersAction))
    return {a.dest: a.default for a in sub.choices[command]._actions if a.dest != "help"}


@pytest.mark.parametrize("command,own", [("quant", {"device": "cuda"}),
                                         ("bench", {"device": "cuda", "iters": 0}),
                                         ("serve", {"device": "cuda"})])
def test_cli_flags_are_jax_flags_with_jax_defaults(monkeypatch, command, own):
    ours = _our_subparser_defaults(command)
    for key, default in own.items():  # the port's own flags
        assert ours.pop(key) == default
    assert ours == _jax_subparser_defaults(monkeypatch, command)


def test_cli_quant_refuses_random_weights_and_writes_jaxs_scales(tmp_path, capsys):
    """``quant`` without --checkpoint refuses unless --allow_random; with the
    trained artifact it writes the scales JAX calibrates from the same
    images, two PNGs and a JPEG that the port decodes to JAX's pixels; a
    truncated JPEG beside them is refused by the decoder, with its reason."""
    import cv2

    from soft_contrastive_learning_tpu import flagship as jax_flagship
    from soft_contrastive_learning_tpu.utils.io import load_img as jax_load_img
    from soft_contrastive_learning_torch.cli import main
    from soft_contrastive_learning_torch.models.weights import TRAINED_PARAMS_PATH
    from soft_contrastive_learning_torch.utils.io import save_img

    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    rng = np.random.default_rng(5)
    imgs = rng.integers(0, 256, (3, 180, 240, 3), dtype=np.uint8)
    for i, im in enumerate(imgs[:2]):
        save_img(im, str(img_dir / f"{i}.png"))
    cv2.imwrite(str(img_dir / "2.jpg"), imgs[2][:, :, ::-1], [cv2.IMWRITE_JPEG_QUALITY, 90])
    imgs[2] = jax_load_img(str(img_dir / "2.jpg"))
    out = tmp_path / "scales.json"
    argv = ["quant", "--image_dir", str(img_dir), "--out", str(out), "--device", "cpu"]
    assert main(argv) == 1 and not out.exists()
    assert "--allow_random" in capsys.readouterr().out
    assert main(argv + ["--checkpoint", str(TRAINED_PARAMS_PATH)]) == 0
    got = json.loads(out.read_text())
    jcfg = JaxModelConfig(compute_dtype="float32", use_pallas=False)
    want = jq.calibrate_scales(jax_flagship.load_trained_params(jcfg),
                               jnp.asarray(imgs.astype(np.float32)))
    assert set(got) == set(want)
    assert all(abs(got[k] - want[k]) <= 1e-5 * want[k] for k in want)
    (img_dir / "3.jpg").write_bytes((img_dir / "2.jpg").read_bytes()[:600])
    with pytest.raises(ValueError, match="3.jpg: JPEG.*truncated"):
        main(argv + ["--checkpoint", str(TRAINED_PARAMS_PATH)])


def test_cli_bench_train_is_refused(monkeypatch):
    """``bench --train`` runs the train-loop benchmark
    (``tests/test_torch_bench_train.py``), --steps_per_dispatch K included
    (it reaches the benchmark). It is refused where it cannot run: without
    a card, on its default CUDA device (no silent CPU fallback), at any K."""
    from soft_contrastive_learning_torch import bench_train
    from soft_contrastive_learning_torch.cli import main

    if not torch.cuda.is_available():
        for extra in ([], ["--steps_per_dispatch", "4"]):
            with pytest.raises(RuntimeError, match="CUDA"):
                main(["bench", "--train", *extra])
    seen = {}
    monkeypatch.setattr(bench_train, "run", lambda **kw: seen.update(kw) or {"value": 0.0})
    assert main(["bench", "--train", "--steps_per_dispatch", "4", "--device", "cpu"]) == 0
    assert seen["steps_per_dispatch"] == 4 and seen["device"] == "cpu"


@pytest.mark.parametrize("flags", [["--tuples_per_batch", "4"], ["--num_points", "50"],
                                   ["--no_cache"], ["--steps_per_dispatch", "2"],
                                   ["--async_mining"]])
def test_cli_bench_refuses_the_train_loop_flags(flags):
    """The train-loop benchmark's flags, --steps_per_dispatch among them,
    are refused without --train (the embed benchmark reads none of them)."""
    from soft_contrastive_learning_torch.cli import main

    with pytest.raises(SystemExit, match=f"bench {flags[0]}.*: .*pass --train"):
        main(["bench", *flags, "--device", "cpu"])


def test_serve_quant_scales_without_a_card_raises(tmp_path):
    """No silent CPU fallback: ``serve --quant_scales`` on the default CUDA
    device raises where there is no card."""
    from soft_contrastive_learning_torch.cli import build_parser, build_server

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    scales = tmp_path / "scales.json"
    tq.save_scales({name: 1.0 for name in tq.CONV_NAMES}, str(scales))
    args = build_parser().parse_args(["serve", "--quant_scales", str(scales), "--port", "0"])
    with pytest.raises(RuntimeError, match="CUDA"):
        build_server(args)
