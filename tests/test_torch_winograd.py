"""The port's Winograd F(2x2, 3x3) convolution against the JAX package on
the CPU: the fp32 reference, the plain version of the fused kernel (K4)
against the Pallas kernel in interpret mode, ``WinogradConvFn``'s gradients,
the model's Winograd configuration and one train step of it.

Inputs are numpy arrays from a seed, handed to both frameworks; JAX takes
the HWIO kernel ``k`` and the port its OIHW transpose.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

import test_torch_train_step as step_harness
from soft_contrastive_learning_tpu.core import config as jcfg
from soft_contrastive_learning_tpu.models.model import create_model, init_params
from soft_contrastive_learning_tpu.ops import winograd as jax_winograd
from soft_contrastive_learning_tpu.ops.pallas.winograd_kernel import (
    winograd_conv as jax_winograd_op,
    winograd_conv_pallas,
)
from soft_contrastive_learning_torch.core import config as tcfg
from soft_contrastive_learning_torch.models.model import EmbeddingNet
from soft_contrastive_learning_torch.models.weights import params_from_flax
from soft_contrastive_learning_torch.ops import winograd
from soft_contrastive_learning_torch.ops.kernels.winograd import (
    WinogradConvFn,
    direct_conv,
    winograd_conv_cuda,
)

torch.set_num_threads(1)  # tier-1 runs several workers on one host

# the shapes of tests/test_winograd.py::test_pallas_kernel_matches_direct_bf16
KERNEL_SHAPES = [(2, 8, 8, 128, 128), (2, 11, 15, 256, 128), (4, 22, 30, 128, 256),
                 (2, 45, 60, 128, 64)]


def _inputs(shape, seed, k_scale=0.05):
    b, h, w, c, f = shape
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    k = (rng.standard_normal((3, 3, c, f)) * k_scale).astype(np.float32)
    bias = rng.standard_normal((f,)).astype(np.float32)
    return x, k, bias


def _oihw(k):
    return torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1)))


def test_transform_matrices_are_the_jax_module_s():
    for name in ("G", "BT", "AT"):
        np.testing.assert_array_equal(np.asarray(getattr(winograd, name), np.float32),
                                      getattr(jax_winograd, name))


def test_weight_transform_matches_jax_and_is_position_major():
    """(16, C, F) is the JAX (4, 4, C, F) with the positions flattened, 4a+b.
    The port takes every three-term sum left to right, rows first, which is
    the order of the JAX einsum on the CPU: the same bits, so U rounds to
    the same bf16 values in both packages."""
    _, k, _ = _inputs((1, 4, 4, 6, 10), 0, k_scale=1.0)
    got = winograd.weight_transform(_oihw(k))
    want = np.asarray(jax_winograd.weight_transform(jnp.asarray(k))).reshape(16, 6, 10)
    assert got.shape == (16, 6, 10) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got[0].numpy(), k[0, 0])  # G[0] picks row/column 0
    np.testing.assert_array_equal(got[15].numpy(), k[2, 2])
    with pytest.raises(ValueError, match="OIHW"):
        winograd.weight_transform(torch.zeros(3, 3, 6, 10))


@pytest.mark.parametrize("hw", [(8, 8), (11, 15), (22, 30), (9, 9)])
def test_fp32_reference_matches_jax_and_the_direct_conv(hw):
    """The shapes of tests/test_winograd.py:47, its tolerance (atol 2e-4)
    against lax.conv; against the JAX reference, the same fp32 arithmetic
    summed in another order: 1e-5."""
    x, k, bias = _inputs((2, *hw, 8, 16), 1, k_scale=0.1)
    got = winograd.winograd_conv(torch.from_numpy(x), _oihw(k), torch.from_numpy(bias)).numpy()
    want = np.asarray(jax_winograd.winograd_conv(jnp.asarray(x), jnp.asarray(k),
                                                 jnp.asarray(bias)))
    direct = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(k), (1, 1), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))) + bias
    assert got.shape == direct.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got, direct, atol=2e-4, rtol=0)
    no_bias = winograd.winograd_conv(torch.from_numpy(x), _oihw(k)).numpy()
    np.testing.assert_allclose(no_bias + bias, got, atol=1e-6, rtol=0)


@pytest.fixture(scope="module", params=KERNEL_SHAPES, ids=lambda s: "x".join(map(str, s)))
def pallas_case(request):
    """One shape through the Pallas kernel in interpret mode, ReLU off and
    on, fp32 output."""
    x, k, bias = _inputs(request.param, 2)
    refs = {relu: np.asarray(winograd_conv_pallas(
        jnp.asarray(x), jnp.asarray(k), jnp.asarray(bias), relu=relu,
        out_dtype=jnp.float32, interpret=True)) for relu in (False, True)}
    return x, k, bias, refs


@pytest.mark.parametrize("relu", [False, True])
def test_plain_version_matches_the_pallas_kernel(pallas_case, relu):
    """Same roundings (x, U and every add of the input transform in bf16),
    another order of the fp32 sums: max-abs <= 1e-4 of the largest output."""
    x, k, bias, refs = pallas_case
    got = winograd.winograd_conv_plain(torch.from_numpy(x), _oihw(k), torch.from_numpy(bias),
                                       relu=relu, out_dtype=torch.float32).numpy()
    ref = refs[relu]
    assert got.shape == ref.shape and got.dtype == np.float32
    assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()
    if relu:
        assert got.min() >= 0.0 and (got == 0.0).any()


def test_rounding_points_are_pinned(pallas_case):
    """The same arithmetic with the input transform taken in fp32 and
    rounded to bf16 once misses the Pallas kernel by far more than the
    gate, as does leaving U in fp32: the gate sees where the kernel rounds."""
    x, k, bias, refs = pallas_case
    b, h, w, c = x.shape
    ref = refs[False]
    gate = 1e-4 * np.abs(ref).max()
    xt, weight = torch.from_numpy(x), _oihw(k)

    def finish(v, u):
        m = winograd._products(v, u, (b, -(-h // 2), -(-w // 2), c))
        return (winograd._output_transform(m)[:, :h, :w] + torch.from_numpy(bias)).numpy()

    d, _, _ = winograd._tiles(xt.to(torch.bfloat16))
    u16 = winograd.weight_transform(weight).to(torch.bfloat16)
    d32 = [[t.float() for t in row] for row in d]
    once = [t.to(torch.bfloat16) for t in winograd._input_transform(d32)]
    assert np.abs(finish(once, u16) - ref).max() > 10 * gate
    per_add = winograd._input_transform(d)
    assert np.abs(finish(per_add, winograd.weight_transform(weight)) - ref).max() > 10 * gate
    assert np.abs(finish(per_add, u16) - ref).max() <= gate


def test_plain_version_casts_last_and_defaults_to_the_input_dtype():
    x, k, bias = _inputs((1, 6, 6, 128, 64), 3)
    args = (_oihw(k), torch.from_numpy(bias))
    y32 = winograd.winograd_conv_plain(torch.from_numpy(x), *args, relu=True)
    y16 = winograd.winograd_conv_plain(torch.from_numpy(x).bfloat16(), *args, relu=True)
    assert y32.dtype == torch.float32 and y16.dtype == torch.bfloat16
    # x is rounded to bf16 either way, so only the last cast differs
    assert torch.equal(y32.bfloat16(), y16)


def test_wrapper_takes_the_plain_version_on_the_cpu_and_counts_no_launch():
    x, k, bias = _inputs((1, 6, 6, 128, 64), 4)
    xt, weight, bt = torch.from_numpy(x), _oihw(k), torch.from_numpy(bias)
    before = winograd_conv_cuda.launches
    got = winograd_conv_cuda(xt, weight, bt, relu=True)
    assert torch.equal(got, winograd.winograd_conv_plain(xt, weight, bt, relu=True))
    assert winograd_conv_cuda.launches == before
    with pytest.raises(RuntimeError, match="WinogradConvFn"):
        winograd_conv_cuda(xt, weight.requires_grad_(), bt)
    with pytest.raises(ValueError, match="NHWC"):
        winograd.winograd_conv_plain(xt[0], weight.detach(), bt)


def test_function_gradients_match_jax_grad_through_the_custom_vjp():
    """tests/test_winograd.py:91-116 on both sides: bf16 x, sum of squares
    of the ReLU output. Both backwards are the direct bf16 conv's with the
    cotangent from the Winograd forward; the frameworks round the bf16
    convs differently: 0.05 of each gradient's largest entry, the JAX
    test's own tolerance."""
    x, k, bias = _inputs((1, 8, 8, 128, 128), 5)
    xj = jnp.asarray(x).astype(jnp.bfloat16)

    def loss(kk, bb):
        return jnp.sum(jax_winograd_op(xj, kk, bb, True).astype(jnp.float32) ** 2)

    want_k, want_b = jax.grad(loss, argnums=(0, 1))(jnp.asarray(k), jnp.asarray(bias))
    xt = torch.from_numpy(x).bfloat16()
    weight, bt = _oihw(k).requires_grad_(), torch.from_numpy(bias).requires_grad_()
    y = WinogradConvFn.apply(xt, weight, bt, True)
    assert y.dtype == torch.bfloat16
    got_w, got_b = torch.autograd.grad((y.float() ** 2).sum(), (weight, bt))
    assert got_w.dtype == got_b.dtype == torch.float32
    want_w = np.asarray(want_k, np.float32).transpose(3, 2, 0, 1)
    for got, want in ((got_w.numpy(), want_w), (got_b.numpy(), np.asarray(want_b, np.float32))):
        assert np.abs(got - want).max() / max(np.abs(want).max(), 1e-3) < 0.05


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_function_backward_is_the_direct_conv_s(dtype, relu):
    """For one cotangent the Function returns the direct conv's gradients
    at the saved inputs: the same cuDNN/CPU backward on the same operands,
    so fp32 agrees to 1e-5 of each gradient's largest entry and bf16 to one
    bf16 step of it (2^-7); gradients come back in the inputs' dtypes."""
    x, k, bias = _inputs((2, 7, 9, 128, 64), 6)
    g = torch.from_numpy(np.random.default_rng(7).standard_normal((2, 7, 9, 64))
                         .astype(np.float32)).to(dtype)

    def grads(fn):
        ins = [torch.from_numpy(x).to(dtype).requires_grad_(), _oihw(k).requires_grad_(),
               torch.from_numpy(bias).requires_grad_()]
        return torch.autograd.grad(fn(*ins, relu), ins, g)

    got, want = grads(WinogradConvFn.apply), grads(direct_conv)
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    for a, r in zip(got, want):
        assert a.dtype == r.dtype and a.shape == r.shape
        assert (a.float() - r.float()).abs().max() <= tol * r.float().abs().max()
    assert got[0].dtype == dtype and got[1].dtype == torch.float32


def _model_cfgs(winograd_on):
    kw = dict(vlad_cores=4, image_height=32, image_width=32, compute_dtype="float32")
    return (jcfg.ModelConfig(use_pallas=False, winograd=winograd_on, **kw),
            tcfg.ModelConfig(winograd=winograd_on, **kw))


def test_model_winograd_configuration_matches_the_jax_model():
    """tests/test_winograd.py:119-140 across the frameworks: the same
    parameter tree serves both configurations; with ``winograd=True`` 10 of
    the 13 convs run the bf16-transform arithmetic in both packages, so the
    unit-norm descriptors agree to 1e-3 (cosine > 0.9999); between the
    port's two configurations the JAX test's own bound holds (0.05,
    cosine > 0.999)."""
    jax_cfg, port_cfg = _model_cfgs(True)
    params = init_params(jax_cfg, jax.random.key(0))
    flat = {k: np.asarray(v) for k, v in
            traverse_util.flatten_dict(jax.device_get(params), sep="/").items()}
    images = np.random.default_rng(8).random((2, 32, 32, 3)).astype(np.float32) * 255.0
    want, _ = create_model(jax_cfg).apply({"params": params}, jnp.asarray(images))
    want = np.asarray(want)

    outs = {}
    for on in (True, False):
        cfg = _model_cfgs(on)[1]
        model = EmbeddingNet(cfg)
        assert model.vgg16.winograd is on
        model.load_state_dict(params_from_flax(flat, cfg))  # one tree for both
        with torch.no_grad():
            outs[on] = model.eval()(torch.from_numpy(images))[0].numpy()
    assert np.abs(outs[True] - want).max() < 1e-3
    assert (outs[True] * want).sum(-1).min() > 0.9999
    assert np.abs(outs[True] - outs[False]).max() < 0.05
    assert (outs[True] * outs[False]).sum(-1).min() > 0.999
    assert not np.array_equal(outs[True], outs[False])


def test_only_convs_with_128_aligned_inputs_take_the_winograd_path(monkeypatch):
    """conv2_2 to conv5_3 (input channels 128, 256, 512): 10 of the 13, with
    the block spec's ReLU flag; conv1_1, conv1_2 and conv2_1 stay direct."""
    from soft_contrastive_learning_torch.models import vgg16

    calls = []

    class Recording:
        @staticmethod
        def apply(x, weight, bias, relu):
            calls.append((weight.shape[1], weight.shape[0], relu, x.is_contiguous()))
            return WinogradConvFn.apply(x, weight, bias, relu)

    monkeypatch.setattr(vgg16, "WinogradConvFn", Recording)
    model = EmbeddingNet(_model_cfgs(True)[1]).eval()
    with torch.no_grad():
        model(torch.zeros((1, 32, 32, 3)))
    relus = [relu for _, cout, relu in sum(vgg16.VGG_BLOCKS, ())][3:]
    assert [(c[0], c[1]) for c in calls] == [(128, 128), (128, 256), (256, 256), (256, 256),
                                             (256, 512), (512, 512), (512, 512), (512, 512),
                                             (512, 512), (512, 512)]
    assert [c[2] for c in calls] == relus
    assert all(c[3] for c in calls)  # NHWC-contiguous views, no copy


NUDGE_SEEDS = range(9, 15)


@pytest.fixture(scope="module")
def winograd_step_runs():
    """tests/test_torch_train_step.py's harness with ``winograd=True`` on
    both sides: two Adam steps on one batch; and the port's first step six
    times more on images moved by 1e-7 relative, for the noise floor."""
    mp = pytest.MonkeyPatch()
    base, batch = step_harness._cfgs, step_harness._batch

    def cfgs(optimizer):
        j, t = base(optimizer)
        return (dataclasses.replace(j, model=dataclasses.replace(j.model, winograd=True)),
                dataclasses.replace(t, model=dataclasses.replace(t.model, winograd=True)))

    def nudged_batch(seed):
        images, geo = batch()
        noise = np.random.default_rng(seed).standard_normal(images.shape)
        return (images * (1 + 1e-7 * noise)).astype(np.float32), geo

    mp.setattr(step_harness, "_cfgs", cfgs)
    try:
        jax_side = step_harness._jax_run("adam")
        port_side = step_harness._port_run("adam", jax_side[0])
        mp.setattr(step_harness, "EPOCHS", (0.0,))
        nudged = []
        for seed in NUDGE_SEEDS:
            mp.setattr(step_harness, "_batch", lambda seed=seed: nudged_batch(seed))
            nudged.append(step_harness._port_run("adam", jax_side[0]))
    finally:
        mp.undo()
    return jax_side, port_side, nudged


def _off(a, b, keys):
    """How far gradient ``a`` is from ``b`` over the leaves ``keys``:
    1 - cosine, and the relative difference of the norms."""
    a, b = (torch.cat([t[k].reshape(-1) for k in keys]) for t in (a, b))
    return (1 - torch.dot(a, b) / (a.norm() * b.norm())).item(), abs((a.norm() / b.norm()).item() - 1)


def test_winograd_train_step_matches_the_jax_step(winograd_step_runs):
    """The forwards share their roundings and the backwards are the direct
    fp32 conv's, yet gradients cannot agree to a fixed small tolerance. A
    difference in the last bits of an activation (the frameworks sum in other
    orders) can round it to the neighbouring bf16 value at the next Winograd
    layer, a change of 2^-8, and on B = 5 images the mining thresholds and
    ReLU masks turn such changes into large gradient changes. That noise
    floor is measured, not assumed: the port's own gradient on images moved
    by 1e-7 relative, over six seeds, turns by 1 - cosine = 0.033 to 0.046
    over the whole tree, about 0.05 in conv3_2 to conv5_2, 0.007 in
    conv5_3's weight and 1.4e-5 in the NetVLAD centres below the last
    Winograd layer.

    The bound is set from those readings. For the whole gradient and for
    every leaf on its own, the port is no further from JAX than 1.5 times
    the furthest of its six nudged selves in 1 - cosine (read: at most 1.07
    times, whole tree 0.0419 against 0.0455), and than twice the furthest in
    norm (read: at most 1.27 times). A backward that is wrong in one layer
    turns that layer's leaf and every leaf above it well past its floor.
    Besides: the first loss to 1e-4 relative (read: 5e-6; the nudged runs'
    too) and the second, after an Adam step that moves every weight by
    ~lr, to 1e-3; the first Adam update within 0.2 of lr on average (read:
    0.097; unrelated updates would differ by ~1 of lr)."""
    (init, jax_grads, want_losses, jax_after), (losses, grads, after), nudged = \
        winograd_step_runs
    np.testing.assert_allclose(losses[0], want_losses[0], rtol=1e-4, atol=0)
    np.testing.assert_allclose(losses[1], want_losses[1], rtol=1e-3, atol=0)
    cfg = step_harness._cfgs("adam")[1]
    want = params_from_flax(jax_grads, cfg.model)
    assert grads[0].keys() == want.keys()
    for n_losses, _, _ in nudged:
        np.testing.assert_allclose(n_losses[0], losses[0], rtol=1e-4, atol=0)
    for keys in [list(want)] + [[k] for k in want]:
        turn, norm = _off(grads[0], want, keys)
        floor = [_off(grads[0], n_grads[0], keys) for _, n_grads, _ in nudged]
        assert turn <= 1.5 * max(t for t, _ in floor), (keys, turn, floor)
        assert norm <= 2.0 * max(n for _, n in floor), (keys, norm, floor)
    p0 = params_from_flax(init, cfg.model)
    moved = params_from_flax(jax_after[0], cfg.model)
    err = torch.cat([((after[0][k] - p0[k]) - (moved[k] - p0[k])).abs().reshape(-1)
                     for k in p0]) / step_harness.LR
    assert err.mean().item() <= 0.2 and err.max().item() <= 2.0 * (1 + 1e-3)


def test_winograd_step_differs_from_the_standard_step(winograd_step_runs):
    """The configuration is really on: the bf16 roundings move the loss off
    the standard fp32 step's, by less than 1e-2 relative."""
    _, (losses, _, _), _ = winograd_step_runs
    standard, _, _ = step_harness._port_run("adam", winograd_step_runs[0][0])
    assert losses[0] != standard[0]
    assert abs(losses[0] - standard[0]) <= 1e-2 * abs(standard[0])
