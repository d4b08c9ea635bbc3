"""K1 (NetVLAD aggregation) in the PyTorch port against the JAX package.

The port's plain version is held to JAX's ``vlad_aggregate`` and to the
Pallas kernel in interpret mode on the same numpy inputs; the closed-form
backward ``vlad_aggregate_backward`` to autograd of ``vlad_aggregate`` and to
``jax.vjp`` of ``vlad_aggregate_fused`` (JAX's ``_fused_bwd``), and
``VladAggregateFn``'s gradients, which on CPU tensors are that closed form,
to the same. The kernels themselves are held to the plain versions in
``test_torch_cuda.py``, on a CUDA card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soft_contrastive_learning_tpu.models.netvlad import NetVLAD as JaxNetVLAD
from soft_contrastive_learning_tpu.models.netvlad import vlad_aggregate as jax_vlad_aggregate
from soft_contrastive_learning_tpu.ops.pallas.netvlad_kernel import (
    vlad_aggregate_fused,
    vlad_aggregate_pallas,
)
from soft_contrastive_learning_torch.models.netvlad import NetVLAD, vlad_aggregate
from soft_contrastive_learning_torch.ops.kernels.netvlad import (
    VladAggregateFn,
    netvlad_aggregate_cuda,
    netvlad_backward_cuda,
    vlad_aggregate_backward,
    vlad_aggregate_fused as torch_vlad_aggregate_fused,
)

torch.set_num_threads(1)  # tier-1 runs several workers on one host

# fp32 throughout; the two sides sum in different orders, so the unit-norm
# outputs differ by a few ulps (~1e-7), well inside 1e-6.
ATOL = 1e-6


def _inputs(seed, b, n, d, k):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, n, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=-1, keepdims=True)
    logits = (3.0 * rng.standard_normal((b, n, k))).astype(np.float32)
    centers = (rng.standard_normal((d, k)) / np.sqrt(d)).astype(np.float32)
    return x, logits, centers


@pytest.mark.parametrize("b,n,d,k", [(2, 6, 16, 4), (3, 20, 32, 8), (1, 12, 64, 64)])
def test_plain_matches_jax_and_pallas(b, n, d, k):
    x, logits, centers = _inputs(0, b, n, d, k)
    got = vlad_aggregate(torch.from_numpy(x), torch.from_numpy(logits),
                         torch.from_numpy(centers)).numpy()
    want = np.asarray(jax_vlad_aggregate(jnp.asarray(x), jnp.asarray(logits),
                                         jnp.asarray(centers)))
    pallas = np.asarray(vlad_aggregate_pallas(jnp.asarray(x), jnp.asarray(logits),
                                              jnp.asarray(centers), interpret=True))
    assert got.shape == (b, d * k)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, pallas, atol=ATOL, rtol=0)


def test_d_major_layout():
    """Descriptor index d*K + k: a single cluster's mass lands at stride K."""
    x, logits, centers = _inputs(1, 1, 5, 8, 4)
    logits[..., 1:] = -1e9  # every position assigned to cluster 0
    v = vlad_aggregate(torch.from_numpy(x), torch.from_numpy(logits),
                       torch.from_numpy(centers)).numpy().reshape(8, 4)
    assert np.abs(v[:, 0]).sum() > 0
    np.testing.assert_allclose(v[:, 1:], 0.0, atol=1e-7)


def test_wrapper_on_cpu_is_the_plain_version():
    x, logits, centers = _inputs(2, 2, 6, 16, 4)
    args = [torch.from_numpy(a) for a in (x, logits, centers)]
    before = netvlad_aggregate_cuda.launches
    torch.testing.assert_close(netvlad_aggregate_cuda(*args), vlad_aggregate(*args),
                               atol=0, rtol=0)
    assert netvlad_aggregate_cuda.launches == before  # no kernel launch on the CPU


def test_wrapper_refuses_other_devices():
    x = torch.empty((1, 4, 8), device="meta")
    with pytest.raises(ValueError):
        netvlad_aggregate_cuda(x, torch.empty((1, 4, 4), device="meta"),
                               torch.empty((8, 4), device="meta"))


def test_module_matches_flax_netvlad():
    """The 1x1 assignment conv + aggregation with the same parameters."""
    rng = np.random.default_rng(3)
    fmap = rng.standard_normal((2, 3, 4, 512)).astype(np.float32)
    fmap /= np.linalg.norm(fmap, axis=-1, keepdims=True)
    kernel = (rng.standard_normal((1, 1, 512, 8)) / np.sqrt(512)).astype(np.float32)
    centers = (rng.standard_normal((512, 8)) / np.sqrt(512)).astype(np.float32)
    want = JaxNetVLAD(num_clusters=8, compute_dtype=jnp.float32).apply(
        {"params": {"assignment": {"kernel": kernel}, "cluster_centers": centers}}, fmap)
    mod = NetVLAD(num_clusters=8, compute_dtype=torch.float32)
    mod.load_state_dict({"assignment.weight": torch.from_numpy(kernel).permute(3, 2, 0, 1),
                         "cluster_centers": torch.from_numpy(centers)})
    with torch.no_grad():
        got = mod(torch.from_numpy(fmap)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=0)



@pytest.mark.parametrize("logit_dtype", ["float32", "bfloat16"])
def test_function_gradients_match_jax_fused_vjp(logit_dtype):
    """``VladAggregateFn`` against ``jax.vjp`` of ``vlad_aggregate_fused``
    (the Pallas forward in interpret mode, the XLA formulation's VJP): the
    same split on both sides. fp32 gradients agree to 1e-5 of their largest
    entry (summation order through two normalizations); a bf16 logits
    gradient is the fp32 one rounded to bf16 on each side, so entries may
    differ by one bf16 ulp (2^-8 relative), held to 2^-7."""
    x, logits, centers = _inputs(4, 2, 12, 64, 8)
    g = np.random.default_rng(5).standard_normal((2, 64 * 8)).astype(np.float32)
    jl = jnp.asarray(logits).astype(logit_dtype)
    _, vjp = jax.vjp(vlad_aggregate_fused, jnp.asarray(x), jl, jnp.asarray(centers))
    want = [np.asarray(w.astype(jnp.float32)) for w in vjp(jnp.asarray(g))]
    ins = [torch.from_numpy(x).requires_grad_(),
           torch.from_numpy(logits).to(getattr(torch, logit_dtype)).requires_grad_(),
           torch.from_numpy(centers).requires_grad_()]
    got = torch.autograd.grad(VladAggregateFn.apply(*ins), ins, torch.from_numpy(g))
    assert got[1].dtype == ins[1].dtype
    for name, a, w in zip(("features", "logits", "centers"), got, want):
        a = a.float().numpy()
        if name == "logits" and logit_dtype == "bfloat16":
            np.testing.assert_allclose(a, w, rtol=2**-7, atol=1e-6 * np.abs(w).max())
        else:
            np.testing.assert_allclose(a, w, rtol=0, atol=1e-5 * np.abs(w).max())


def _module_grads_float64(fmap, weight, centers):
    """The module's gradients from the plain formula in float64 (autograd)."""
    b, h, w, d = fmap.shape
    x = fmap.double().reshape(b, h * w, d)
    weight = weight.double().clone().requires_grad_()
    centers = centers.double().clone().requires_grad_()
    a = torch.softmax(x @ weight.reshape(-1, d).T, dim=-1)
    v = torch.einsum("bnk,bnd->bkd", a, x) + a.sum(dim=1)[:, :, None] * centers.T[None]
    v = v / torch.sqrt((v * v).sum(dim=-1, keepdim=True) + 1e-12)
    v = v.transpose(1, 2).reshape(b, -1)
    out = v / torch.sqrt((v * v).sum(dim=-1, keepdim=True) + 1e-12)
    return torch.autograd.grad(out.square().sum() + out.sum(), [weight, centers])


def test_module_backward_goes_through_the_function():
    """With use_kernels the module's graph runs VladAggregateFn's backward
    (on the CPU the closed form, ``vlad_aggregate_backward``); without, plain
    autograd. The parameters come from the test's numpy seed. Both sides are
    held to the same gradients in float64: within 5e-6 of each gradient's
    largest entry. Measured over 300 seeds of these shapes at 1 thread, 100
    at 4 and 60 at 8: the fp32 sides lie at most 2.2e-6 (assignment weight)
    and 3.7e-7 (centers) from float64, and 1.2e-6 from each other."""
    rng = np.random.default_rng(6)
    fmap = torch.from_numpy(rng.standard_normal((2, 3, 4, 512)).astype(np.float32))
    state = {
        "assignment.weight": torch.from_numpy(
            (rng.standard_normal((8, 512, 1, 1)) / np.sqrt(512)).astype(np.float32)),
        "cluster_centers": torch.from_numpy(
            (rng.standard_normal((512, 8)) / np.sqrt(512)).astype(np.float32)),
    }
    want = _module_grads_float64(fmap, state["assignment.weight"], state["cluster_centers"])
    for use_kernels in (True, False):
        mod = NetVLAD(num_clusters=8, compute_dtype=torch.float32, use_kernels=use_kernels)
        mod.load_state_dict(state)
        out = mod(fmap)
        assert out.grad_fn is not None
        assert ("VladAggregateFn" in type(out.grad_fn).__name__) == use_kernels
        got = torch.autograd.grad(out.square().sum() + out.sum(),
                                  [mod.assignment.weight, mod.cluster_centers])
        for a, w in zip(got, want):
            torch.testing.assert_close(a.double(), w, atol=5e-6 * w.abs().max().item(), rtol=0)


def test_bare_wrapper_refuses_to_cut_the_graph():
    """The check's logic on the CPU: with grad mode on and an input that
    requires grad, the bare wrapper raises; under no_grad, or inside the
    Function's forward (where autograd turns grad mode off), it runs."""
    x, logits, centers = (torch.from_numpy(a) for a in _inputs(7, 1, 4, 8, 4))
    c = centers.clone().requires_grad_()
    with pytest.raises(RuntimeError, match="VladAggregateFn"):
        netvlad_aggregate_cuda(x, logits, c)
    with torch.no_grad():
        netvlad_aggregate_cuda(x, logits, c)
    VladAggregateFn.apply(x, logits, c).sum().backward()
    assert c.grad is not None


@pytest.mark.parametrize("logit_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,n,d,k", [(2, 12, 64, 8), (3, 20, 32, 4), (1, 7, 16, 8), (4, 5, 8, 4)])
def test_closed_form_backward_matches_autograd_and_jax(b, n, d, k, logit_dtype):
    """``vlad_aggregate_backward`` (the closed form K1's backward kernel
    implements) against torch autograd of ``vlad_aggregate`` and against
    ``jax.vjp`` of ``vlad_aggregate_fused`` (the Pallas forward in interpret
    mode, JAX's ``_fused_bwd``). fp32 gradients: within 1e-6 of their
    largest entry against autograd (the same fp32 arithmetic in another
    order, measured <= 2e-7) and 1e-5 against JAX (another framework's
    summation order through two normalizations, as above). A bf16 logits
    gradient is the fp32 one rounded to bf16 on each side, so entries may
    differ by one bf16 ulp (2^-8 relative), held to 2^-7."""
    x, logits, centers = _inputs(8 + b + n, b, n, d, k)
    g = np.random.default_rng(9).standard_normal((b, d * k)).astype(np.float32)
    dtype = getattr(torch, logit_dtype)
    args = (torch.from_numpy(x), torch.from_numpy(logits).to(dtype), torch.from_numpy(centers))
    got = vlad_aggregate_backward(*args, torch.from_numpy(g))
    assert [t.dtype for t in got] == [torch.float32, dtype, torch.float32]
    ins = [t.clone().requires_grad_() for t in args]
    autograd = torch.autograd.grad(vlad_aggregate(*ins), ins, torch.from_numpy(g))
    jl = jnp.asarray(logits).astype(logit_dtype)
    _, vjp = jax.vjp(vlad_aggregate_fused, jnp.asarray(x), jl, jnp.asarray(centers))
    jax_grads = [np.asarray(w.astype(jnp.float32)) for w in vjp(jnp.asarray(g))]
    for name, a, ref, jref in zip(("features", "logits", "centers"), got, autograd, jax_grads):
        a, ref = a.float().numpy(), ref.float().numpy()
        assert a.shape == ref.shape == jref.shape
        if name == "logits" and logit_dtype == "bfloat16":
            np.testing.assert_allclose(a, ref, rtol=2**-7, atol=1e-6 * np.abs(ref).max())
            np.testing.assert_allclose(a, jref, rtol=2**-7, atol=1e-6 * np.abs(jref).max())
        else:
            np.testing.assert_allclose(a, ref, rtol=0, atol=1e-6 * np.abs(ref).max())
            np.testing.assert_allclose(a, jref, rtol=0, atol=1e-5 * np.abs(jref).max())


@pytest.mark.parametrize("logit_dtype", [torch.float32, torch.bfloat16])
def test_function_backward_on_cpu_is_the_closed_form(logit_dtype):
    """On CPU tensors ``VladAggregateFn`` runs ``vlad_aggregate`` forward and
    ``vlad_aggregate_backward`` backward, the same bits, and launches no
    kernel; gradients that are not asked for come back as None."""
    x, logits, centers = _inputs(10, 3, 9, 16, 8)
    g = torch.from_numpy(np.random.default_rng(11).standard_normal((3, 16 * 8)).astype(np.float32))
    args = (torch.from_numpy(x), torch.from_numpy(logits).to(logit_dtype),
            torch.from_numpy(centers))
    before = (netvlad_aggregate_cuda.launches, netvlad_backward_cuda.launches)
    ins = [t.clone().requires_grad_() for t in args]
    out = VladAggregateFn.apply(*ins)
    torch.testing.assert_close(out, vlad_aggregate(*args), atol=0, rtol=0)
    got = torch.autograd.grad(out, ins, g)
    for a, want in zip(got, vlad_aggregate_backward(*args, g)):
        torch.testing.assert_close(a, want, atol=0, rtol=0)
    only_centers = [args[0], args[1], args[2].clone().requires_grad_()]
    out = VladAggregateFn.apply(*only_centers)
    assert out.grad_fn.next_functions[0][0] is None and out.grad_fn.next_functions[1][0] is None
    torch.testing.assert_close(torch.autograd.grad(out, only_centers[2], g)[0],
                               vlad_aggregate_backward(*args, g)[2], atol=0, rtol=0)
    assert (netvlad_aggregate_cuda.launches, netvlad_backward_cuda.launches) == before


def test_fused_entry_takes_the_function_only_where_a_graph_is_recorded():
    """``vlad_aggregate_fused``: the bare forward (no residual, no graph)
    under no_grad or when nothing requires grad; ``VladAggregateFn`` when
    autograd records a graph."""
    x, logits, centers = (torch.from_numpy(a) for a in _inputs(12, 2, 6, 16, 4))
    assert torch_vlad_aggregate_fused(x, logits, centers).grad_fn is None
    c = centers.clone().requires_grad_()
    with torch.no_grad():
        assert torch_vlad_aggregate_fused(x, logits, c).grad_fn is None
    out = torch_vlad_aggregate_fused(x, logits, c)
    assert "VladAggregateFn" in type(out.grad_fn).__name__
    torch.testing.assert_close(out, vlad_aggregate(x, logits, centers), atol=0, rtol=0)
