"""The port's train step against JAX ``build_train_step`` on the CPU.

A small model with the full VGG16 widths (the weight loader needs them),
32x32 images, NetVLAD-8, fp32, one tuple of 1+2+2 (B = 5). Both sides
start from the JAX init (``init_params``) converted by
``params_from_flax`` and take two steps on the same batch, the second at
epoch 1 (half the learning rate).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from soft_contrastive_learning_tpu.core import config as jcfg
from soft_contrastive_learning_tpu.losses.registry import build_loss as jax_build_loss
from soft_contrastive_learning_tpu.models.model import create_model, init_params
from soft_contrastive_learning_tpu.train import step as jstep
from soft_contrastive_learning_tpu.train.schedule import learning_rate as jax_learning_rate
from soft_contrastive_learning_torch.core import config as tcfg
from soft_contrastive_learning_torch.losses.registry import build_loss
from soft_contrastive_learning_torch.models.model import EmbeddingNet
from soft_contrastive_learning_torch.models.model import init_params as init_port_params
from soft_contrastive_learning_torch.models.weights import params_from_flax
from soft_contrastive_learning_torch.train.schedule import learning_rate
from soft_contrastive_learning_torch.train.step import (
    build_eval_loss_step,
    build_train_step,
    init_train_state,
)

torch.set_num_threads(1)  # tier-1 runs several workers on one host

TUPLES = dict(positives_per_tuple=2, negatives_per_tuple=2, hard_positives_per_tuple=1,
              hard_negatives_per_tuple=1)
LR = 1e-4
EPOCHS = (0.0, 1.0)


def _cfgs(optimizer):
    j = jcfg.TrainConfig(
        model=jcfg.ModelConfig(vlad_cores=8, image_height=32, image_width=32,
                               compute_dtype="float32", use_pallas=False),
        tuples=jcfg.TupleConfig(**TUPLES), loss=jcfg.LossConfig(name="wms"),
        tuples_per_batch=1, base_lr=LR, optimizer=optimizer)
    t = tcfg.TrainConfig(
        model=tcfg.ModelConfig(vlad_cores=8, image_height=32, image_width=32,
                               compute_dtype="float32"),
        tuples=tcfg.TupleConfig(**TUPLES), loss=tcfg.LossConfig(name="wms"),
        tuples_per_batch=1, base_lr=LR, optimizer=optimizer)
    return j, t


def _batch():
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (5, 32, 32, 3), dtype=np.uint8)
    geo = rng.uniform(0.0, 40.0, (5, 5)).astype(np.float32)  # both sides of d_beta = 15
    geo = (geo + geo.T) / 2
    np.fill_diagonal(geo, 0.0)
    return images, geo


def _flat(tree):
    return {k: np.asarray(v) for k, v in
            traverse_util.flatten_dict(jax.device_get(tree), sep="/").items()}


def _jax_run(optimizer):
    cfg, _ = _cfgs(optimizer)
    model = create_model(cfg.model)
    params = init_params(cfg.model, jax.random.key(0))
    loss_fn = jax_build_loss(cfg.loss, cfg.tuples, cfg.tuples_per_batch)
    images, geo = _batch()

    def batch_at(epoch):
        return {"images": jnp.asarray(images), "geo_dist_matrix": jnp.asarray(geo),
                "epoch": jnp.float32(epoch)}

    def loss_of(p):
        out, _ = jstep._forward(model, cfg, p, batch_at(0.0), True)
        return jstep._loss_from_output(cfg, loss_fn, out, batch_at(0.0)).total

    grads = _flat(jax.grad(loss_of)(params))
    init = _flat(params)
    state = jstep.init_train_state(cfg, params)
    step = jstep.build_train_step(cfg, model, loss_fn)
    losses, after = [], []
    for epoch in EPOCHS:
        state, metrics = step(state, batch_at(epoch))
        losses.append(float(metrics["loss"]))
        after.append(_flat(state.params))
    return init, grads, losses, after


def _port_model(init):
    _, cfg = _cfgs("adam")
    model = EmbeddingNet(cfg.model)
    model.load_state_dict(params_from_flax(init, cfg.model))
    return model


def _port_run(optimizer, init, pooled=False):
    _, cfg = _cfgs(optimizer)
    state = init_train_state(cfg, _port_model(init))
    step = build_train_step(cfg, build_loss(cfg.loss, cfg.tuples, 1), image_pool=pooled)
    images, geo = _batch()
    pool = None
    if pooled:  # the batch's images sit at rows 3..7 of a larger pool
        noise = np.random.default_rng(1).integers(0, 256, (3, 32, 32, 3), dtype=np.uint8)
        pool = torch.from_numpy(np.concatenate([noise, images]))
    losses, grads, after = [], [], []
    for epoch in EPOCHS:
        batch = {"geo_dist_matrix": torch.from_numpy(geo), "epoch": epoch}
        if pooled:
            batch["image_idx"] = torch.arange(3, 8)
        else:
            batch["images"] = torch.from_numpy(images)
        state, metrics = step(state, batch, pool)
        assert metrics["learning_rate"] == learning_rate(cfg, epoch)
        losses.append(metrics["loss"].item())
        grads.append({k: p.grad.clone() for k, p in state.model.named_parameters()})
        after.append({k: v.clone() for k, v in state.model.state_dict().items()})
    assert state.step == len(EPOCHS)
    return losses, grads, after


@pytest.fixture(scope="module", params=["adam", "momentum"])
def runs(request):
    jax_side = _jax_run(request.param)
    return request.param, jax_side, _port_run(request.param, jax_side[0])


def test_losses_match(runs):
    """Both steps' losses in fp32: 1e-5 relative (summation order)."""
    _, (_, _, want, _), (got, _, _) = runs
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


def test_first_step_gradients_match(runs):
    """Every parameter's gradient within 1e-4 of that tensor's largest
    gradient entry: 13 fp32 conv layers back, summed in other orders."""
    _, (init, jax_grads, _, _), (_, grads, _) = runs
    _, cfg = _cfgs("adam")
    want = params_from_flax(jax_grads, cfg.model)
    for name, g in grads[0].items():
        scale = want[name].abs().max().item()
        assert scale > 0, name
        err = (g - want[name]).abs().max().item()
        assert err <= 1e-4 * scale, (name, err, scale)


def test_params_after_two_steps_match(runs):
    """Updates compared as fractions of the learning rate.

    Adam's first steps move every weight by about lr whatever its
    gradient's size (g / (|g| + 1e-8)), so where a gradient is near zero the
    two frameworks' rounding gives visibly different updates. After step 1,
    every weight whose gradient exceeds 100x Adam's eps moves by the same
    fraction of lr to 1e-3, and every weight to 0.25. Step 2 feeds those
    differences back through the gradient and Adam's moments: over the
    whole model, the mean difference stays under 5e-4 of lr and at most 5%
    of the weights differ by more than 1e-3 of lr.

    SGD's update is lr times the gradient: each tensor's update agrees to
    1e-2 of its norm, plus 4 ulps of its largest weight per entry (the fp32
    sum of a weight and an update ~1e-4 of its size rounds at that grain). The
    loosest tensor is ``average_rgb``, whose gradient sums every pixel's
    with heavy cancellation and rounds to ~3e-3 relative."""
    optimizer, (init, jax_grads, _, jax_after), (_, _, after) = runs
    _, cfg = _cfgs("adam")
    p0 = params_from_flax(init, cfg.model)
    g0 = params_from_flax(jax_grads, cfg.model)
    eps32 = torch.finfo(torch.float32).eps
    for step, (want_flat, got) in enumerate(zip(jax_after, after)):
        want = params_from_flax(want_flat, cfg.model)
        errs = []
        for name in p0:
            d_want = (want[name] - p0[name]) / LR
            err = ((got[name] - p0[name]) / LR - d_want).abs()
            errs.append(err.reshape(-1))
            if optimizer == "momentum":
                grain = 4 * eps32 * p0[name].abs().max().item() / LR * err.numel() ** 0.5
                assert err.norm().item() <= 1e-2 * d_want.norm().item() + grain, name
            elif step == 0:
                big = g0[name].abs() > 1e-6
                assert err[big].max().item() <= 1e-3 and err.max().item() <= 0.25, name
        if optimizer == "adam" and step == 1:
            err = torch.cat(errs)
            assert err.mean().item() <= 5e-4
            assert (err > 1e-3).float().mean().item() <= 0.05


def test_pooled_variant_matches_host_variant(runs):
    """The same images gathered from the device pool give the same step,
    bit for bit."""
    optimizer, (init, _, _, _), (losses, _, after) = runs
    p_losses, _, p_after = _port_run(optimizer, init, pooled=True)
    assert p_losses == losses
    for a, b in zip(after[-1].values(), p_after[-1].values()):
        assert torch.equal(a, b)


def test_eval_loss_step_is_the_training_loss_without_an_update():
    _, cfg = _cfgs("adam")
    init = _flat(init_params(_cfgs("adam")[0].model, jax.random.key(0)))
    model = _port_model(init)
    images, geo = _batch()
    batch = {"images": torch.from_numpy(images), "geo_dist_matrix": torch.from_numpy(geo)}
    before = {k: v.clone() for k, v in model.state_dict().items()}
    got = build_eval_loss_step(cfg, model, build_loss(cfg.loss, cfg.tuples, 1))(batch)["loss"]
    state = init_train_state(cfg, _port_model(init))
    step = build_train_step(cfg, build_loss(cfg.loss, cfg.tuples, 1))
    _, metrics = step(state, dict(batch, epoch=0.0))
    assert got.item() == metrics["loss"].item()
    assert all(torch.equal(v, model.state_dict()[k]) for k, v in before.items())


@pytest.mark.parametrize("freq", [1.0, 2.0])
def test_learning_rate_matches_jax_across_epochs(freq):
    j, t = _cfgs("adam")
    j = jcfg.TrainConfig(base_lr=5e-6, lr_down_frequency=freq)
    t = tcfg.TrainConfig(base_lr=5e-6, lr_down_frequency=freq)
    for epoch in range(0, 45):
        want = float(jax_learning_rate(j, jnp.float32(epoch)))
        assert learning_rate(t, float(epoch)) == pytest.approx(want, rel=1e-6)
    assert learning_rate(t, 1000.0) == t.minimal_lr


def test_init_params_draws_like_flax():
    """The port's fresh init has flax's distributions (not its numbers):
    each tensor's std within 10% of the JAX init's (the sample spread of the
    smallest, 1,728 entries, is ~2%), kernels truncated at 2 sigma, zeros
    where flax puts zeros."""
    j, t = _cfgs("adam")
    want = params_from_flax(_flat(init_params(j.model, jax.random.key(0))), t.model)
    got = init_port_params(t.model, 0)
    assert got.keys() == want.keys()
    for name, w in want.items():
        g = got[name]
        assert g.shape == w.shape and g.dtype == w.dtype
        if not w.any():
            assert not g.any(), name
            continue
        assert g.std().item() == pytest.approx(w.std().item(), rel=0.1), name
        if name.endswith("weight"):  # lecun_normal: truncated at 2 sigma
            sigma = g[0].numel() ** -0.5 / 0.87962566103423978
            assert g.abs().max().item() <= 2 * sigma * (1 + 1e-6), name
    assert not torch.equal(init_port_params(t.model, 1)["netvlad.cluster_centers"],
                           got["netvlad.cluster_centers"])


def test_split_batch_matches_jax():
    from soft_contrastive_learning_tpu.losses.registry import split_batch as jax_split_batch
    from soft_contrastive_learning_torch.losses.registry import split_batch

    emb = np.arange(2 * 25 * 3, dtype=np.float32).reshape(50, 3)
    got = split_batch(torch.from_numpy(emb), 2, (1, 12, 12))
    want = jax_split_batch(jnp.asarray(emb), 2, (1, 12, 12))
    for name in ("anchor", "positives", "negatives", "embeddings"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)))


# ---------------------------------------------------------------- the loss zoo

# a tuple's geometry as the sampler draws it: positives inside max_pos_radius,
# negatives outside min_neg_radius (metres from the anchor)
ZOO_XY = np.array([[0.0, 0.0], [5.0, 2.0], [-3.0, 9.0], [21.0, -4.0], [-30.0, 25.0]])


def _zoo_cfgs(loss):
    j, t = _cfgs("adam")
    return (jcfg.TrainConfig(**{**j.__dict__, "loss": jcfg.LossConfig(name=loss)}),
            tcfg.TrainConfig(**{**t.__dict__, "loss": tcfg.LossConfig(name=loss)}))


def _zoo_payload(cfg):
    from soft_contrastive_learning_tpu.sampling.tuples import TupleSampler as JaxTupleSampler

    sampler = JaxTupleSampler(cfg.tuples, cfg.loss, cfg.tuple_shape, ZOO_XY, np.zeros(5))
    return {k: np.asarray(v, np.float32)[None] for k, v in sampler._payload_one(np.arange(5)).items()}


def _zoo_jax_run(loss):
    cfg, _ = _zoo_cfgs(loss)
    model = create_model(cfg.model)
    params = init_params(cfg.model, jax.random.key(0))
    images, _ = _batch()
    payload = {k: jnp.asarray(v) for k, v in _zoo_payload(cfg).items()}
    init = _flat(params)  # the step donates its state
    state = jstep.init_train_state(cfg, params)
    step = jstep.build_train_step(cfg, model, jax_build_loss(cfg.loss, cfg.tuples, 1))
    metrics, after = [], []
    for epoch in EPOCHS:
        state, m = step(state, {"images": jnp.asarray(images), "epoch": jnp.float32(epoch),
                                **payload})
        metrics.append({k: float(v) for k, v in m.items() if k.startswith("loss")})
        after.append(_flat(state.params))
    count = int(jax.tree_util.tree_leaves(state.opt_state.inner_state)[0])
    return init, metrics, after, count


def _zoo_port_run(loss, init):
    _, cfg = _zoo_cfgs(loss)
    state = init_train_state(cfg, _port_model(init))
    step = build_train_step(cfg, build_loss(cfg.loss, cfg.tuples, 1))
    images, _ = _batch()
    payload = {k: torch.from_numpy(v) for k, v in _zoo_payload(_zoo_cfgs(loss)[0]).items()}
    metrics, after = [], []
    for epoch in EPOCHS:
        state, m = step(state, {"images": torch.from_numpy(images), "epoch": epoch, **payload})
        metrics.append({k: v.item() for k, v in m.items() if k.startswith("loss")})
        after.append({k: v.clone() for k, v in state.model.state_dict().items()})
    counts = {int(s["step"]) for s in state.optimizer.state.values()}
    return metrics, after, counts, state.step


def _nudged(init):
    """The weights one ulp up: the floor of what rounding alone can move."""
    return {k: (v * np.float32(1 + 2**-23)).astype(v.dtype) for k, v in init.items()}


@pytest.fixture(scope="module", params=["pairwise_distance_neg_eigenvalue", "wrd"])
def zoo_runs(request):
    """The JAX run, the port's from the same weights, and the port's from
    the weights nudged by one ulp (for the PN loss only)."""
    jax_side = _zoo_jax_run(request.param)
    nudged = None
    if "eigenvalue" in request.param:
        nudged = _zoo_port_run(request.param, _nudged(jax_side[0]))
    return request.param, jax_side, _zoo_port_run(request.param, jax_side[0]), nudged


def test_zoo_step_losses_match(zoo_runs):
    """``loss`` and, for the PN loss, ``loss_pos`` and ``loss_neg`` (each at
    the weights its update starts from) of both steps. wrd: 1e-5 relative
    (on this untrained model's nearly coincident descriptors its products
    are below fp32's grain of the margin, so the loss is the margin and the
    parameters carry the check). PN: within 1e-5 relative plus 5x the
    distance between the port's run and its run from weights nudged by one
    ulp (measured: at most 2.6x). Its neg part is the smallest eigenvalue of
    a nearly rank-one Gram, whose eigenvector is ill-determined, so rounding
    alone moves the second update by 4e-3 of lr on average."""
    loss, (_, want, _, _), (got, _, _, _), nudged = zoo_runs
    keys = {"loss", "loss_pos", "loss_neg"} if nudged is not None else {"loss"}
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.keys() == w.keys() == keys
        for k in keys:
            floor = 0.0 if nudged is None else 5 * abs(g[k] - nudged[0][i][k])
            assert abs(g[k] - w[k]) <= 1e-5 * abs(w[k]) + floor, (i, k, g[k], w[k])
        if nudged is not None:
            assert g["loss"] == np.float32(g["loss_pos"]) + np.float32(g["loss_neg"])


def test_zoo_step_counts_two_adam_updates_per_pn_step(zoo_runs):
    """The PN step takes two updates that share Adam's state: its count is
    4 after two steps on both sides (optax's count), the step counter 2."""
    loss, (_, _, _, want_count), (_, _, counts, step), _ = zoo_runs
    per_step = 2 if "eigenvalue" in loss else 1
    assert counts == {want_count} == {per_step * len(EPOCHS)} and step == len(EPOCHS)


def _update_errors(p0, after, other):
    return torch.cat([(((after[n] - p0[n]) - (other[n] - p0[n])) / LR).abs().reshape(-1)
                      for n in p0])


def test_zoo_params_after_two_steps_match(zoo_runs):
    """Updates as fractions of lr after each step (two updates each for the
    PN loss), as ``test_params_after_two_steps_match`` holds Adam's: the
    mean difference under 5e-4 of lr and at most 5% of the weights apart by
    more than 1e-3 of lr. For the PN loss, whose second update rounding
    alone moves (above), the bounds are at least 5x the nudged run's mean
    and 2x its share (measured: 4.5x and 2.6x the mean, 1.2x the share)."""
    _, (init, _, jax_after, _), (_, after, _, _), nudged = zoo_runs
    _, cfg = _cfgs("adam")
    p0 = params_from_flax(init, cfg.model)
    for i, (want_flat, got) in enumerate(zip(jax_after, after)):
        err = _update_errors(p0, got, params_from_flax(want_flat, cfg.model))
        mean_bound, share_bound = 5e-4, 0.05
        if nudged is not None:
            floor = _update_errors(p0, got, nudged[1][i])
            mean_bound = max(mean_bound, 5 * floor.mean().item())
            share_bound = max(share_bound, 2 * (floor > 1e-3).float().mean().item())
        assert err.mean().item() <= mean_bound
        assert (err > 1e-3).float().mean().item() <= share_bound


# ---------------------------------------------------------------- heads and PCA feeds

# (reduction, loss, loss_dim): the dense head with wms, the PCA projection
# with an incremental loss on its output, and the 4,096-wide loss PCA of the
# raw descriptor with a det variant (finite at loss_dim 4)
HEAD_CASES = (("1fc", "wms", 8), ("pca", "incremental_residual_mm", 8),
              ("none", "incremental_residual_det", 4))
HEAD_OUT = 16


def _head_cfgs(reduction, loss, loss_dim):
    j, t = _cfgs("adam")
    jm = jcfg.ModelConfig(**{**j.model.__dict__, "reduction": reduction, "out_dim": HEAD_OUT})
    tm = tcfg.ModelConfig(**{**t.model.__dict__, "reduction": reduction, "out_dim": HEAD_OUT})
    return (jcfg.TrainConfig(**{**j.__dict__, "model": jm,
                                "loss": jcfg.LossConfig(name=loss, loss_dim=loss_dim)}),
            tcfg.TrainConfig(**{**t.__dict__, "model": tm,
                                "loss": tcfg.LossConfig(name=loss, loss_dim=loss_dim)}))


def _head_feeds(cfg):
    """The streaming PCAs' states as the trainer feeds them, fitted by the
    JAX StreamingPCA on rows at the scale of what they see: unit-norm
    descriptors' spread for the projection, the whitened outputs' or the
    descriptors' residuals for the loss PCA."""
    from soft_contrastive_learning_tpu.pca.incremental import StreamingPCA

    rng = np.random.default_rng(7)
    d = cfg.model.descriptor_dim
    feeds = {}
    if cfg.model.reduction == "pca":
        pca = StreamingPCA(HEAD_OUT)
        pca.init(rng.standard_normal((40, d)) / np.sqrt(d) + 1.0 / np.sqrt(d))
        feeds.update(pca_components=pca.v, pca_mean=pca.m, pca_variance=pca.var)
    if cfg.loss.incremental:
        width = cfg.model.output_dim
        scale = 1.0 if cfg.model.reduction == "pca" else 1.4 / np.sqrt(width)
        loss_pca = StreamingPCA(cfg.loss.loss_dim)
        loss_pca.init(scale * rng.standard_normal((30, width)))
        feeds.update(loss_pca_s=loss_pca.s, loss_pca_v=loss_pca.v, loss_pca_m=loss_pca.m,
                     loss_pca_seen=np.float32(loss_pca.seen))
    return feeds


def _head_jax_run(case):
    cfg, _ = _head_cfgs(*case)
    model = create_model(cfg.model)
    params = init_params(cfg.model, jax.random.key(0))
    images, geo = _batch()
    feeds = {k: jnp.asarray(v) for k, v in _head_feeds(cfg).items()}
    init = _flat(params)
    state = jstep.init_train_state(cfg, params)
    step = jstep.build_train_step(cfg, model, jax_build_loss(cfg.loss, cfg.tuples, 1))
    metrics, after = [], []
    for epoch in EPOCHS:
        state, m = step(state, {"images": jnp.asarray(images), "geo_dist_matrix": jnp.asarray(geo),
                                "epoch": jnp.float32(epoch), **feeds})
        metrics.append({k: np.asarray(v) for k, v in m.items()})
        after.append(_flat(state.params))
    return init, metrics, after


def _head_port_run(case, init):
    _, cfg = _head_cfgs(*case)
    model = EmbeddingNet(cfg.model)
    model.load_state_dict(params_from_flax(init, cfg.model))
    state = init_train_state(cfg, model)
    step = build_train_step(cfg, build_loss(cfg.loss, cfg.tuples, 1))
    images, geo = _batch()
    feeds = {k: float(v) if np.ndim(v) == 0 else torch.from_numpy(np.asarray(v))
             for k, v in _head_feeds(_head_cfgs(*case)[0]).items()}
    metrics, after = [], []
    for epoch in EPOCHS:
        state, m = step(state, {"images": torch.from_numpy(images),
                                "geo_dist_matrix": torch.from_numpy(geo), "epoch": epoch, **feeds})
        metrics.append({k: v if isinstance(v, float) else v.numpy() for k, v in m.items()})
        after.append({k: v.clone() for k, v in state.model.state_dict().items()})
    return metrics, after


@pytest.fixture(scope="module", params=HEAD_CASES, ids=lambda c: f"{c[0]}-{c[1]}")
def head_runs(request):
    jax_side = _head_jax_run(request.param)
    return request.param, jax_side, _head_port_run(request.param, jax_side[0])


def test_head_step_losses_and_pca_feeds_match(head_runs):
    """Both steps' losses within 1e-5 relative: of the loss, and for the det
    variant of the products it is the margin plus the difference of (about
    twice the product of the fed singular values; measured 3.9e-7 of it).
    The metrics carry JAX's PCA feeds and no other: ``pca_in`` (the raw
    descriptors, 'pca') and ``loss_pca_in`` (the residuals, incremental
    losses). At the first step (the same weights) ``pca_in`` within 2e-6 of
    its largest entry (measured 8.4e-7) and ``loss_pca_in`` within 1e-4
    (measured 2.7e-5): an untrained net's descriptors nearly coincide, so
    their residuals keep the descriptors' ~1e-7 differences at a thousandth
    of the size (and the whitening of 'pca' magnifies them further). At the
    second, after an update that Adam moves near-zero gradients' weights by
    up to lr in either direction in each package, within 1e-3 (measured
    1.4e-4)."""
    (reduction, loss, loss_dim), (_, want, _), (got, _) = head_runs
    scale = 0.0
    if "det" in loss:
        scale = 2 * float(np.prod(_head_feeds(_head_cfgs(reduction, loss, loss_dim)[0])
                                  ["loss_pca_s"][:loss_dim]))
    for step, (w, g) in enumerate(zip(want, got)):
        feeds = {k for k in w if k in ("pca_in", "loss_pca_in")}
        assert feeds == {k for k in g if k in ("pca_in", "loss_pca_in")}
        assert ("pca_in" in feeds) == (reduction == "pca")
        assert ("loss_pca_in" in feeds) == ("incremental" in loss)
        want_loss = float(w["loss"])
        assert abs(float(g["loss"]) - want_loss) <= 1e-5 * (abs(want_loss) + scale)
        for k in feeds:
            assert g[k].shape == w[k].shape
            err = np.abs(g[k] - w[k]).max() / np.abs(w[k]).max()
            bound = 1e-3 if step else (2e-6 if k == "pca_in" else 1e-4)
            assert err <= bound, (step, k, err)


def test_head_step_params_after_two_steps_match(head_runs):
    """Updates as fractions of lr after each step, as the zoo's: the mean
    difference under 5e-4 of lr and at most 5% of the weights apart by
    more than 1e-3 of lr; the dense head's weights among them."""
    case, (init, _, jax_after), (_, after) = head_runs
    _, cfg = _head_cfgs(*case)
    p0 = params_from_flax(init, cfg.model)
    assert (case[0] == "1fc") == any(k.startswith("fc_head.") for k in p0)
    for want_flat, got in zip(jax_after, after):
        err = _update_errors(p0, got, params_from_flax(want_flat, cfg.model))
        assert err.mean().item() <= 5e-4
        assert (err > 1e-3).float().mean().item() <= 0.05
