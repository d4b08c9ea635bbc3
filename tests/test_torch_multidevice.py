"""The port's data parallelism on the CPU: gloo ranks spawned from the port
package (``launch/multihost.py::run_ranks``), held to the port's one-process
step and trainer and to JAX's step on a mesh of the conftest's virtual CPU
devices.

The pooled step is the JAX dryrun's: 32x32 images, NetVLAD-8, fp32, wms,
one tuple of 1+2+2 per rank (B = 10 over 2 ranks), from JAX's init. An
n-rank step computes the global loss on every rank, so it equals the
one-process step up to the order of the gradient's sums. Tolerances:

* the loss within 1e-6 relative (measured: equal to the one-process step's,
  1.3e-7 from JAX's);
* the first step's gradient summed over the ranks within 1e-4 of each
  tensor's largest entry of the one-process gradient (the port-against-JAX
  gate; measured at most 3.1e-6 for the wms step, conv1_1, and 1.6e-5 for
  the PCA head's, conv5_3's bias: the conv backward's sum over the batch
  taken in two halves), ``average_rgb``'s within 2e-2 (a sum over every
  pixel with heavy cancellation; measured 1.8e-5 with the PCA head, 6.5e-3
  for the PN step's pos part);
* the parameters after the step, as fractions of lr: Adam's first update is
  lr * g / (|g| + 1e-8), so a gradient near Adam's eps turns a last-bit
  difference into a visible one, and the sum of a weight and an update of
  5e-6 rounds at the weight's grain (one ulp of 0.1 is 1.5e-3 of lr).
  Where |g| > 1e-5 the update is held within 1e-6 of lr beyond one rounding
  of the weight, everywhere within 1e-2 (measured 9.5e-4);
* against JAX, the port's own step-one gates of
  ``tests/test_torch_train_step.py`` (1e-3 of lr where |g| > 1e-6, beyond
  one rounding of the weight, which at that test's lr of 1e-4 is 7.5e-5 of
  it; 0.25 everywhere; the two frameworks' conv backwards differ more than
  the ranks' sums do);
* every rank's parameters bit-equal to rank 0's.
"""

import json
import shutil

import jax
import numpy as np
import pytest
import torch
from flax import traverse_util

from soft_contrastive_learning_tpu.core import config as jcfg
from soft_contrastive_learning_tpu.losses.registry import build_loss as jax_build_loss
from soft_contrastive_learning_tpu.models.model import create_model, init_params
from soft_contrastive_learning_tpu.parallel.mesh import make_mesh as jax_make_mesh
from soft_contrastive_learning_tpu.parallel.mesh import replicated_sharding
from soft_contrastive_learning_tpu.parallel.mesh import shard_batch as jax_shard_batch
from soft_contrastive_learning_tpu.train import step as jstep
from soft_contrastive_learning_torch import dryrun
from soft_contrastive_learning_torch.core import config as tcfg
from soft_contrastive_learning_torch.data.pipeline import ToyCitySource
from soft_contrastive_learning_torch.launch.multihost import initialize_multihost, is_primary
from soft_contrastive_learning_torch.launch.multihost import run_ranks
from soft_contrastive_learning_torch.models.weights import params_from_flax
from soft_contrastive_learning_torch.parallel import mesh as tmesh
from soft_contrastive_learning_torch.train.trainer import Trainer

torch.set_num_threads(1)  # tier-1 runs several workers on one host

N = 2
RANK_TIMEOUT_S = 300  # each spawned rank's own deadline, and the group's


def _flat(tree):
    return {k: np.asarray(v) for k, v in
            traverse_util.flatten_dict(jax.device_get(tree), sep="/").items()}


@pytest.fixture(scope="module")
def steps():
    """JAX's pooled step under a 2-device mesh, the port's on 2 gloo ranks
    and in one process, from the same weights on the same inputs."""
    cfg = dryrun.pooled_step_config(N)
    pool, batch = dryrun.pooled_step_inputs(cfg)
    jax_cfg = jcfg.TrainConfig(
        model=jcfg.ModelConfig(vlad_cores=8, reduction="none", image_height=32, image_width=32,
                               compute_dtype="float32", use_pallas=False),
        tuples=jcfg.TupleConfig(positives_per_tuple=2, negatives_per_tuple=2),
        loss=jcfg.LossConfig(name="wms"), tuples_per_batch=N, seed=0)
    model = create_model(jax_cfg.model)
    params = init_params(jax_cfg.model, jax.random.key(0))
    init = {k: v.numpy() for k, v in params_from_flax(_flat(params), cfg.model).items()}
    step = jstep.build_train_step(
        jax_cfg, model, jax_build_loss(jax_cfg.loss, jax_cfg.tuples, N), image_pool=True)
    mesh = jax_make_mesh(num_data=N, devices=jax.devices()[:N])
    with mesh:
        state, metrics = step(jstep.init_train_state(jax_cfg, params),
                              jax_shard_batch(dict(batch, image_idx=batch["image_idx"]
                                                   .astype(np.int32)), mesh),
                              jax.device_put(pool, replicated_sharding(mesh)))
    want = {"losses": [float(metrics["loss"])],
            "params": {k: v.numpy() for k, v in
                       params_from_flax(_flat(state.params), cfg.model).items()}}
    ranks = run_ranks(dryrun.pooled_steps, N, (cfg, init, pool, [batch]), device="cpu",
                      timeout_s=RANK_TIMEOUT_S)
    one = dryrun.pooled_steps(tmesh.make_mesh(devices=["cpu"]), cfg, init, pool, [batch])
    return cfg, init, want, ranks, one


def test_the_ranks_hold_the_same_bits(steps):
    _, _, _, ranks, _ = steps
    assert [r["step"] for r in ranks] == [1, 1]
    assert ranks[0]["digest"] == ranks[1]["digest"]
    for name, value in ranks[0]["params"].items():
        np.testing.assert_array_equal(ranks[1]["params"][name], value)


def test_two_ranks_equal_the_one_process_step(steps):
    cfg, init, _, ranks, one = steps
    got = ranks[0]
    np.testing.assert_allclose(got["losses"], one["losses"], rtol=1e-6, atol=0)
    _hold_gradients(got["grads"], one["grads"])
    for name, g in one["grads"].items():
        diff, beyond = _update_gap(cfg, got["params"][name], one["params"][name])
        assert beyond[np.abs(g) > 1e-5].max(initial=0) <= 1e-6, name
        assert diff.max() <= 1e-2, name


def _update_gap(cfg, a, b):
    """|a - b| as a fraction of lr, and what of it lies beyond one rounding
    of the weight."""
    diff = np.abs(a - b)
    grain = np.spacing(np.maximum(np.abs(a), np.abs(b)))
    return diff / cfg.base_lr, np.maximum(diff - grain, 0) / cfg.base_lr


def test_two_ranks_equal_jax_s_step_on_a_two_device_mesh(steps):
    cfg, init, want, ranks, one = steps
    got = ranks[0]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-6, atol=0)
    for name in init:
        diff, beyond = _update_gap(cfg, got["params"][name], want["params"][name])
        big = np.abs(one["grads"][name]) > 1e-6
        assert beyond[big].max(initial=0) <= 1e-3 and diff.max() <= 0.25, name


HEAD_AND_LOSS_CASES = (("2fc", "wms"), ("pca", "incremental_residual_mm"),
                       ("none", "pairwise_distance_neg_eigenvalue"))


@pytest.mark.parametrize("reduction,loss", HEAD_AND_LOSS_CASES,
                         ids=[f"{r}-{l}" for r, l in HEAD_AND_LOSS_CASES])
def test_heads_pcas_and_the_pn_step_on_two_ranks(reduction, loss):
    """The configurations that mix more than the output: the dense head's
    dropout (each rank keeps its rows of the global batch's masks), the
    streaming PCAs' feeds (whole on every rank; the projection runs on the
    gathered descriptors), the PN step's two updates (two gathers): two
    ranks against one process over two steps, the wms step's gates on the
    losses and the first step's gradient. The PN step's gradient is its
    second update's, taken at weights the first update left one rounding
    apart, and ill-conditioned on an untrained net
    (``tests/test_torch_train_step.py``): its losses (pos + neg) are held."""
    from soft_contrastive_learning_torch.models.model import init_params as port_init
    from soft_contrastive_learning_torch.pca.incremental import StreamingPCA
    from soft_contrastive_learning_torch.sampling.tuples import TupleSampler

    base = dryrun.pooled_step_config(N)
    cfg = tcfg.TrainConfig(**{
        **base.__dict__, "loss": tcfg.LossConfig(name=loss, loss_dim=4),
        "model": tcfg.ModelConfig(**{**base.model.__dict__, "reduction": reduction,
                                     "out_dim": 16})})
    pool, batch = dryrun.pooled_step_inputs(cfg)
    rng = np.random.default_rng(5)
    if cfg.loss.distance_type not in ("none", "wms"):
        xy = np.cumsum(rng.uniform(2.0, 9.0, (10, 2)), axis=0)
        sampler = TupleSampler(cfg.tuples, cfg.loss, cfg.tuple_shape, xy, np.zeros(10))
        tuples = [sampler._payload_one(np.arange(t * 5, t * 5 + 5)) for t in range(N)]
        batch.update({k: np.stack([p[k] for p in tuples]).astype(np.float32) for k in tuples[0]})
    if reduction == "pca":
        pca = StreamingPCA(16)
        pca.init(rng.standard_normal((40, cfg.model.descriptor_dim)) / 64.0)
        batch.update(pca_components=pca.v, pca_mean=pca.m, pca_variance=pca.var)
    if cfg.loss.incremental:
        loss_pca = StreamingPCA(4)
        loss_pca.init(rng.standard_normal((30, cfg.model.output_dim)))
        batch.update(loss_pca_s=loss_pca.s, loss_pca_v=loss_pca.v, loss_pca_m=loss_pca.m,
                     loss_pca_seen=np.float32(loss_pca.seen))
    params = {k: v.numpy() for k, v in port_init(cfg.model, 0).items()}
    batches = [batch, dict(batch, epoch=np.float32(1.0))]
    ranks = run_ranks(dryrun.pooled_steps, N, (cfg, params, pool, batches), device="cpu",
                      timeout_s=RANK_TIMEOUT_S)
    one = dryrun.pooled_steps(tmesh.make_mesh(devices=["cpu"]), cfg, params, pool, batches)
    assert ranks[0]["digest"] == ranks[1]["digest"]
    np.testing.assert_allclose(ranks[0]["losses"], one["losses"], rtol=1e-6, atol=0)
    if not cfg.loss.pn_loss:  # a PN step's last gradient is its ill-conditioned neg part's
        _hold_gradients(ranks[0]["grads"], one["grads"])


def _hold_gradients(got, want):
    """The first step's gradient summed over the ranks against the
    one-process gradient: within 1e-4 of each tensor's largest entry (the
    port-against-JAX gate of ``tests/test_torch_train_step.py``), but
    ``average_rgb``, whose gradient sums every pixel's with heavy
    cancellation, within 2e-2."""
    for name, g in want.items():
        tol = 2e-2 if name == "vgg16.average_rgb" else 1e-4
        assert np.abs(got[name] - g).max() <= tol * np.abs(g).max(), name


def test_shard_batch_splits_only_the_per_image_leaves():
    """Trap (a): JAX lays out every leaf whose first dimension divides the
    axis over it, the (B, B) payload included, and still computes one global
    loss; the port's ranks each keep the whole payload."""
    b = 10
    batch = {"image_idx": np.arange(b), "images": np.zeros((b, 4, 4, 3), np.uint8),
             "geo_dist_matrix": np.ones((b, b), np.float32), "pos_weights": np.ones((b, b)),
             "epoch": np.float32(1.0)}
    for rank in range(N):
        mesh = tmesh.Mesh(group=None, rank=rank, size=N, device=torch.device("cpu"),
                          backend="gloo")
        got = tmesh.shard_batch(batch, mesh)
        np.testing.assert_array_equal(got["image_idx"], np.arange(rank * 5, rank * 5 + 5))
        assert got["images"].shape == (5, 4, 4, 3)
        assert got["geo_dist_matrix"].shape == (b, b) and got["pos_weights"].shape == (b, b)
        assert got["epoch"] == 1.0
    jax_mesh = jax_make_mesh(num_data=N, devices=jax.devices()[:N])
    jax_sharded = jax_shard_batch({"geo_dist_matrix": batch["geo_dist_matrix"]}, jax_mesh)
    shard_shapes = {s.data.shape for s in jax_sharded["geo_dist_matrix"].addressable_shards}
    assert shard_shapes == {(5, b)}  # JAX's layout splits it; its program stays global


def test_the_mesh_refuses_what_it_cannot_hold():
    with pytest.raises(NotImplementedError, match="shards nothing"):
        tmesh.make_mesh(num_model=2)
    with pytest.raises(ValueError, match="process group of 2"):
        tmesh.make_mesh(num_data=2)  # no group in this process
    one = tmesh.make_mesh(devices=["cpu"])
    assert (one.size, one.rank, one.group, one.backend) == (1, 0, None, "none")
    with pytest.raises(ValueError, match="does not divide over 3 data ranks"):
        tcfg.TrainConfig(tuples=tcfg.TupleConfig(positives_per_tuple=2, negatives_per_tuple=2),
                         num_data_shards=3)  # B = 2 x 5 = 10
    with pytest.raises(NotImplementedError, match="num_model_shards"):
        tcfg.TrainConfig(num_model_shards=2)
    defaults = tcfg.TrainConfig()
    jax_defaults = jcfg.TrainConfig()
    for key in ("data_axis", "model_axis", "num_data_shards", "num_model_shards"):
        assert getattr(defaults, key) == getattr(jax_defaults, key), key


def test_initialize_multihost_alone_and_on_ranks(monkeypatch, dryrun_two):
    for key in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(key, raising=False)
    alone = {"process_index": 0, "process_count": 1, "local_device_count": 1,
             "global_device_count": 1}
    assert initialize_multihost() == alone and is_primary()
    monkeypatch.setenv("WORLD_SIZE", "1")  # a launcher's single rank: nothing to join
    assert initialize_multihost() == alone
    results, _ = dryrun_two
    for rank, r in enumerate(results):
        assert r["topology"] == {"process_index": rank, "process_count": N,
                                 "local_device_count": 1, "global_device_count": N,
                                 "is_primary": rank == 0}
        assert (r["backend"], r["device"]) == ("gloo", "cpu")


@pytest.fixture(scope="module")
def dryrun_two(tmp_path_factory):
    """``dryrun_multichip(2, "cpu")`` at the reference lr 5e-6, its run
    directory kept for the module (its checkpoints take ~1 GB)."""
    out_dir = tmp_path_factory.mktemp("dryrun2")
    yield dryrun.dryrun_multichip(N, device="cpu", base_lr=5e-6, out_dir=str(out_dir),
                                  timeout_s=RANK_TIMEOUT_S), out_dir
    shutil.rmtree(out_dir, ignore_errors=True)


@pytest.fixture(scope="module")
def one_process_trainer(tmp_path_factory):
    cfg = dryrun.trainer_config(N, base_lr=5e-6)
    out_dir = tmp_path_factory.mktemp("one")
    tr = Trainer(cfg, ToyCitySource(**dryrun.trainer_source_kwargs(cfg)), out_dir=str(out_dir),
                 device="cpu")
    refreshes = dryrun.record_refreshes(tr)
    tr.train()
    tr.close()
    yield tr, refreshes
    shutil.rmtree(out_dir, ignore_errors=True)


def _losses(records):
    return np.array([r["value"] for r in records if r["tag"] == "loss"])


def test_the_dryrun_trains_as_one_process_does(dryrun_two, one_process_trainer):
    """The dryrun's trainer on 2 ranks against the same configuration in
    one process, the tolerances of ``tests/test_torch_trainer.py``: the
    losses up to the second refresh within 1e-6 relative, the epoch's within
    1e-4; the refreshes at the same anchors."""
    results, _ = dryrun_two
    tr, refreshes = one_process_trainer
    machinery = results[0]["trainer"]
    want = _losses(tr.writers["local"].read_all())
    got = np.array([machinery["series"][("local", "loss", s)][0] for s in range(1, 13)])
    assert len(want) == 12 and machinery["refreshes"] == refreshes == [0, 4, 8, 12, 16, 20]
    np.testing.assert_allclose(got[:2], want[:2], rtol=1e-6, atol=0)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=0)
    assert machinery["resumed_refreshes"] == [16, 20]


def test_the_dryrun_writes_once_and_resumes_exactly(dryrun_two):
    results, out_dir = dryrun_two
    writes = [r["trainer"]["writes"] for r in results]
    assert writes == [{"primary": True, "metrics": True, "checkpoints": True},
                      {"primary": False, "metrics": False, "checkpoints": False}]
    series = results[0]["trainer"]["series"]
    # every record of the uninterrupted run written once: 12 losses and
    # learning rates, 4 evals of the held-out loss and 6 localization tags
    # in each region
    assert all(len(values) == 1 for values in series.values()), series
    assert sum(1 for key in series if key[:2] == ("local", "loss")) == 12
    assert sorted(s for role, tag, s in series if (role, tag) == ("other", "loss")) == [0, 3, 6, 9]
    assert sorted((out_dir / "checkpoints" / "part").iterdir()) == [
        out_dir / "checkpoints" / "part" / str(s) for s in (0, 4, 8)]
    assert json.loads((out_dir / "config.json").read_text())["tuples_per_batch"] == 2
    for r in results:
        assert r["trainer"]["resumed_vs_uninterrupted"] == 0.0
        assert r["trainer"]["resumed_steps"] == 12


def test_a_trainer_on_two_ranks_takes_cudnn_s_deterministic_algorithms(dryrun_two,
                                                                        one_process_trainer):
    """A Trainer on more than one rank turns on cudnn.deterministic in its
    process (on the card, ranks sharing it otherwise reorder cuDNN's atomic
    sums from run to run: scripts/torch_resume_gap.py); a one-process
    Trainer leaves the flag as it was."""
    results, _ = dryrun_two
    assert [r["trainer"]["cudnn_deterministic"] for r in results] == [True, True]
    assert torch.backends.cudnn.deterministic is False


def _cli_argv(out_root, *extra):
    return ["train", "--toy_city", "--device", "cpu", "--out_root", str(out_root),
            "--out_folder", "run", "--image_height", "32", "--image_width", "32",
            "--vlad_cores", "8", "--compute_dtype", "float32", "--positives_per_tuple", "1",
            "--negatives_per_tuple", "1", "--hard_positives_per_tuple", "1",
            "--hard_negatives_per_tuple", "1", "--max_epoch", "1", "--mining_step", "4",
            "--mining_cache_size", "8", "--train_ref_r", "40", "--num_eval_queries", "2",
            "--eval_ref_r", "20", "--loss", "wms", "--base_lr", "5e-6", *extra]


def test_cli_trains_on_two_ranks_as_on_one(tmp_path):
    from soft_contrastive_learning_torch.cli import main
    from soft_contrastive_learning_torch.core.logging import MetricsWriter

    try:
        assert main(_cli_argv(tmp_path / "one")) == 0
        assert main(_cli_argv(tmp_path / "two", "--num_data_shards", "2")) == 0
        want = _losses(MetricsWriter(str(tmp_path / "one" / "run"), "local").read_all())
        got = _losses(MetricsWriter(str(tmp_path / "two" / "run"), "local").read_all())
        assert len(want) == 12 and len(got) == 12  # 2 tuples of 3 a step: 3 images a rank
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=0)
        config = json.loads((tmp_path / "two" / "run" / "config.json").read_text())
        assert config["num_data_shards"] == 2
    finally:  # the runs' checkpoints take ~1 GB
        shutil.rmtree(tmp_path, ignore_errors=True)


def test_cli_refuses_a_batch_that_does_not_divide(tmp_path):
    from soft_contrastive_learning_torch.cli import main

    argv = _cli_argv(tmp_path, "--num_data_shards", "3", "--positives_per_tuple", "2",
                     "--negatives_per_tuple", "2")  # B = 2 x (1 + 2 + 2) = 10
    with pytest.raises(ValueError, match="images_per_batch 10 does not divide over 3"):
        main(argv)
    assert not (tmp_path / "run").exists()


def test_run_inference_on_two_ranks_equals_one_process(tmp_path):
    """Each batch of 8 split over the ranks, the descriptors gathered: the
    dump of 13 toy-city views (the last batch padded) within 1e-6 of the
    one-process dump (the convs run on half batches), written by rank 0."""
    import os

    from soft_contrastive_learning_torch.data.toycity import ToyCity
    from soft_contrastive_learning_torch.evaluation.inference import run_inference
    from soft_contrastive_learning_torch.launch.multihost import call_with_mesh
    from soft_contrastive_learning_torch.models.model import init_params as port_init
    from soft_contrastive_learning_torch.utils.io import load_pickle, save_csv, save_img

    city = ToyCity(num_points=13, radius=8.0, img_h=32, img_w=40, seed=4)
    rel = [f"toy_ref/{i:04d}.png" for i in range(13)]
    os.makedirs(tmp_path / "imgs" / "toy_ref")
    for i, path in enumerate(rel):
        save_img(city.image(i), str(tmp_path / "imgs" / path))
    os.makedirs(tmp_path / "lists")
    save_csv({"path": rel}, str(tmp_path / "lists" / "toy_ref.csv"))
    cfg = tcfg.ModelConfig(vlad_cores=4, image_height=32, image_width=40,
                           compute_dtype="float32")
    args = (cfg, port_init(cfg, 0), "toy_ref", str(tmp_path / "lists"), str(tmp_path / "imgs"))
    one = run_inference(*args, str(tmp_path / "one"), "m", batch_size=8, device="cpu")
    ranks = run_ranks(call_with_mesh, N,
                      ("soft_contrastive_learning_torch.evaluation.inference.run_inference",
                       (*args, str(tmp_path / "two"), "m"), {"batch_size": 8}),
                      device="cpu", timeout_s=RANK_TIMEOUT_S)
    assert ranks == [str(tmp_path / "two" / "toy_ref_m.pickle")] * N
    got, want = load_pickle(ranks[0]), load_pickle(one)
    assert got.shape == want.shape == (13, 4 * 512)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.slow
def test_dryrun_multichip_on_eight_ranks():
    """``MULTICHIP_r05.json``'s scenario: 8 ranks, the pooled step, the
    sharded top-k, 6 refreshes, eval on the mesh, resume at 8 -> 12."""
    results = dryrun.dryrun_multichip(8, device="cpu", timeout_s=600)
    assert len(results) == 8 and results[0]["trainer"]["refresh_count"] == 6
    assert len({r["trainer"]["digest"] for r in results}) == 1
