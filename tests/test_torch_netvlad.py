"""K1 (NetVLAD aggregation) in the PyTorch port against the JAX package.

The port's plain version is held to JAX's ``vlad_aggregate`` and to the
Pallas kernel in interpret mode on the same numpy inputs. The kernel itself
is held to the plain version in ``test_torch_cuda.py``, on a CUDA card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soft_contrastive_learning_tpu.models.netvlad import NetVLAD as JaxNetVLAD
from soft_contrastive_learning_tpu.models.netvlad import vlad_aggregate as jax_vlad_aggregate
from soft_contrastive_learning_tpu.ops.pallas.netvlad_kernel import vlad_aggregate_pallas
from soft_contrastive_learning_torch.models.netvlad import NetVLAD, vlad_aggregate
from soft_contrastive_learning_torch.ops.kernels.netvlad import netvlad_aggregate_cuda

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

