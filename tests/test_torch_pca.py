"""The port's streaming PCA (``pca/incremental.py``), its worker-thread
updater (``pca/async_updater.py``) and the mining refresh's ``rand_pairs``
against the JAX package's on the CPU. Both run the same float64 numpy
arithmetic on the host, so every array is held bit for bit
(``np.array_equal``), and the updater's feeds and drains hand out the same
versions over the same update sequence.
"""

import threading

import numpy as np
import pytest
import torch

from soft_contrastive_learning_tpu.pca import async_updater as jax_async
from soft_contrastive_learning_tpu.pca import incremental as jax_inc
from soft_contrastive_learning_tpu.train.mining_manager import rand_pairs as jax_rand_pairs
from soft_contrastive_learning_torch.pca import async_updater as port_async
from soft_contrastive_learning_torch.pca import incremental as port_inc
from soft_contrastive_learning_torch.train.mining_manager import rand_pairs

D, OUT = 48, 8


def _blocks(seed, sizes, d=D):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((n, d)).astype(np.float32) for n in sizes]


def _assert_same_state(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys()
    for key in sa:
        assert np.array_equal(np.asarray(sa[key]), np.asarray(sb[key])), key
        assert np.asarray(sa[key]).dtype == np.asarray(sb[key]).dtype, key


@pytest.mark.parametrize("first", [5, 20])  # fewer rows than out_dim, and more
def test_streaming_pca_is_jax_s_bit_for_bit(first):
    """init, update, update_multi (ragged last chunk) and whiten."""
    jp, tp = jax_inc.StreamingPCA(OUT, 0.4), port_inc.StreamingPCA(OUT, 0.4)
    init, upd, multi = _blocks(0, (first, 7, 23))
    jp.init(init)
    tp.init(init)
    _assert_same_state(jp, tp)
    jp.update(upd)
    tp.update(upd)
    _assert_same_state(jp, tp)
    jp.update_multi(multi, 10)
    tp.update_multi(multi, 10)
    _assert_same_state(jp, tp)
    assert np.array_equal(jp.whiten(upd), tp.whiten(upd))
    restored = port_inc.StreamingPCA.from_state_dict(jp.state_dict())
    _assert_same_state(jp, restored)


def test_skl_functions_are_jax_s():
    x, y = _blocks(1, (9, 6))
    want = jax_inc.skl_init(x, 12)  # out_dim above the rank: zero-padded
    got = port_inc.skl_init(x, 12)
    for w, g in zip(want, got):
        assert np.array_equal(w, g)
    want = jax_inc.single_skl_increment(y, *want[:5], 0.7)
    got = port_inc.single_skl_increment(y, *got[:5], 0.7)
    for w, g in zip(want, got):
        assert np.array_equal(w, g)


def test_update_before_init_initializes():
    jp, tp = jax_inc.StreamingPCA(OUT), port_inc.StreamingPCA(OUT)
    (x,) = _blocks(2, (11,))
    jp.update(x)
    tp.update(x)
    assert tp.initialized
    _assert_same_state(jp, tp)


@pytest.mark.parametrize("n,m", [(50, 513), (10, 45), (10, 100), (2, 1)])
def test_rand_pairs_is_jax_s(n, m):
    want = jax_rand_pairs(np.random.default_rng(3), n, m)
    got = rand_pairs(np.random.default_rng(3), n, m)
    assert got == want
    assert len(set(got)) == len(got) == min(m, n * (n - 1) // 2)
    assert all(0 <= j < i < n for i, j in got)


def _updaters(seed_blocks):
    """A JAX and a port updater over equal initialized PCAs (pca and loss_pca)."""
    out = []
    for mod, inc in ((jax_async, jax_inc), (port_async, port_inc)):
        pca, loss_pca = inc.StreamingPCA(OUT), inc.StreamingPCA(4)
        pca.init(seed_blocks[0])
        loss_pca.init(seed_blocks[1][:, :16])
        out.append((mod.AsyncPCAUpdater(pca, loss_pca), pca, loss_pca))
    return out


def _sd_equal(a, b):
    if a is None or b is None:
        return a is b
    return all(np.array_equal(np.asarray(a[k]), np.asarray(b[k])) for k in a)


def test_async_feeds_and_drains_are_jax_s():
    """Lag-2 feeds and the drain floor over the same submissions: the port
    is handed tensors (detached there, copied to the host by its worker),
    JAX numpy arrays; every fed and drained state is the same."""
    blocks = _blocks(4, (12, 12) + (6,) * 8)
    (ju, jp, jl), (tu, tp, tl) = _updaters(blocks)
    try:
        fed = []
        for i, x in enumerate(blocks[2:]):
            if i == 5:
                fed.append((ju.drain(), tu.drain()))
            fed.append((ju.feed_states(), tu.feed_states()))
            ju.submit(x, x[:, :16])
            grad = torch.from_numpy(x).requires_grad_()
            tu.submit(grad * 1.0, (grad * 1.0)[:, :16])
        fed.append((ju.drain(), tu.drain()))
    finally:
        ju.close()
        tu.close()
    for want, got in fed:
        assert all(_sd_equal(w, g) for w, g in zip(want, got))
    _assert_same_state(jp, tp)
    _assert_same_state(jl, tl)
    # lag 2: the first two feeds are the initial state, the third has one update
    assert fed[0][1][0]["seen"] == fed[1][1][0]["seen"] == 12.0
    assert fed[2][1][0]["seen"] == 12.0 * 0.4 + 6


def test_a_worker_error_is_terminal_in_both():
    """An update that raises: the drain that waits for it, then every feed,
    drain, submit and close raise in both packages, and the worker is
    joined."""
    blocks = _blocks(5, (12, 12))
    results = []
    for updater, pca, _ in _updaters(blocks):
        updater.submit(np.zeros((3, D + 1), np.float32), None)  # wrong width
        errors = []
        for call in (updater.drain, updater.feed_states, updater.drain):
            with pytest.raises(RuntimeError, match="streaming-PCA worker failed"):
                call()
            errors.append(True)
        with pytest.raises(RuntimeError):
            updater.submit(blocks[0], None)
        with pytest.raises(RuntimeError):
            updater.close()
        assert not updater._thread.is_alive()
        results.append((errors, pca.state_dict()["seen"]))
    assert results[0] == results[1]


def test_submit_keeps_no_graph():
    """The queue holds detached tensors: a step's graph is not kept alive."""
    (x, y) = _blocks(6, (12, 12))
    pca = port_inc.StreamingPCA(OUT)
    pca.init(x)
    updater = port_async.AsyncPCAUpdater(pca, None)
    gate = threading.Event()
    real_update = pca.update

    def held_update(feats):
        gate.wait(10)
        real_update(feats)

    pca.update = held_update
    try:
        updater.submit(y, None)  # the worker takes this one and waits on the gate
        w = torch.from_numpy(y).requires_grad_()
        updater.submit(w * 2.0, None)
        with updater._cond:
            queued = [item[1] for item in updater._pending]
        assert any(torch.is_tensor(t) for t in queued)
        assert not any(torch.is_tensor(t) and t.requires_grad for t in queued)
    finally:
        gate.set()
        updater.close()
    assert pca.true_seen == 36.0
