"""The multi-device dryrun, the counterpart of ``__graft_entry__.py``'s
``dryrun_multichip`` and ``_dryrun_trainer_machinery``.

``dryrun_multichip(n, device)`` starts ``n`` ranks (``launch/multihost.py::
run_ranks``; rank i on card ``i % cards``) and runs on their mesh:

1. one pooled global-batch training step (32x32, NetVLAD-8, fp32, wms, one
   tuple of 1+2+2 per rank), whose loss must be finite;
2. one sharded top-k (``ops/topk.py::topk_l2_sharded``, K2 on a card) of 4
   queries over 16 rows per rank, held to the dense ``topk_l2`` over the
   whole index;
3. the trainer's machinery on a toy city: 12 steps, mining refreshes at
   anchors 0, 4, 8, ... (6), the eval hooks at anchors 0, 6, 12 and 18 (4:
   the held-out loss and localization in both regions, on the mesh), part
   checkpoints every 8 anchors, then a fresh trainer resumed from the part
   checkpoint at step 8 and run to step 12: its restored parameters equal
   the saved ones, the resumed run's final parameters are compared with the
   uninterrupted run's, and every parameter is finite.

JAX's dryrun runs 3 with ``steps_per_dispatch=2``, its fused ``lax.scan``
dispatch; the port refuses that setting (``core/config.py``) and runs 1.
The backend is NCCL when every rank has a card of its own, gloo when ranks
share one or run on the CPU; the dryrun prints the one it chose, and the
device stays the one asked for. Each rank checks that its parameters are
the bits of rank 0's (one digest each).

The spawned ranks run functions of this module, which ``spawn`` imports
anew in each process.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import shutil
import tempfile
from typing import Dict, List, Optional

import numpy as np
import torch

from soft_contrastive_learning_torch.core.config import (
    LossConfig,
    ModelConfig,
    TrainConfig,
    TupleConfig,
)

DRYRUN_TIMEOUT_S = 900.0


def pooled_step_config(n: int) -> TrainConfig:
    """JAX's dryrun step: 32x32 images (a 2x2 conv5 map), NetVLAD-8, fp32,
    wms, one tuple of 1+2+2 per rank."""
    return TrainConfig(
        model=ModelConfig(vlad_cores=8, reduction="none", image_height=32, image_width=32,
                          compute_dtype="float32"),
        tuples=TupleConfig(positives_per_tuple=2, negatives_per_tuple=2),
        loss=LossConfig(name="wms"), tuples_per_batch=n, seed=0)


def pooled_step_inputs(cfg: TrainConfig):
    """JAX's dryrun inputs, drawn in its order from ``default_rng(0)``: the
    batch (``image_idx`` 0..B-1, epoch 0, a (B, B) geo matrix in [0, 30) m),
    then a uint8 pool of B + 3 images."""
    b = cfg.images_per_batch
    h, w = cfg.model.image_height, cfg.model.image_width
    rng = np.random.default_rng(0)
    batch = {"image_idx": np.arange(b, dtype=np.int64), "epoch": np.float32(0.0),
             "geo_dist_matrix": np.abs(rng.random((b, b))).astype(np.float32) * 30.0}
    pool = (rng.random((b + 3, h, w, 3)) * 255.0).astype(np.uint8)
    return pool, batch


def kernel_launches() -> Dict[str, int]:
    """The launch counts of the kernels on the training and search path:
    K1 (NetVLAD, forward and backward), K2 (top-k) and K3 (fused wms)."""
    from soft_contrastive_learning_torch.ops.kernels.netvlad import (
        netvlad_aggregate_cuda,
        netvlad_backward_cuda,
    )
    from soft_contrastive_learning_torch.ops.kernels.topk import topk_l2_cuda
    from soft_contrastive_learning_torch.ops.kernels.wms import wms_loss_cuda

    return {"K1": netvlad_aggregate_cuda.launches, "K1_bwd": netvlad_backward_cuda.launches,
            "K2": topk_l2_cuda.launches, "K3": wms_loss_cuda.launches}


def params_digest(model: torch.nn.Module) -> str:
    """sha256 of every parameter's and buffer's bytes, in state_dict order."""
    h = hashlib.sha256()
    for v in model.state_dict().values():
        h.update(v.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def pooled_steps(mesh, cfg: TrainConfig, params: Dict[str, np.ndarray], pool: np.ndarray,
                 batches: List[dict]) -> dict:
    """The pooled train step on ``mesh`` (``parallel/mesh.py``; one process
    too), from ``params`` (an ``EmbeddingNet`` state_dict as numpy), over
    the host ``batches`` in turn, each cut by ``shard_batch``. Returns the
    losses, the first step's gradients (summed over the ranks) and the
    parameters after the last step (numpy), and the parameters' digest."""
    from soft_contrastive_learning_torch.losses.registry import build_loss
    from soft_contrastive_learning_torch.models.model import EmbeddingNet
    from soft_contrastive_learning_torch.parallel.mesh import shard_batch
    from soft_contrastive_learning_torch.train.step import build_train_step, init_train_state

    device = mesh.device
    model = EmbeddingNet(cfg.model)
    model.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in params.items()})
    state = init_train_state(cfg, model.to(device))
    step = build_train_step(cfg, build_loss(cfg.loss, cfg.tuples, cfg.tuples_per_batch),
                            image_pool=True, mesh=mesh)
    pool_t = torch.from_numpy(pool).to(device)
    losses, grads = [], None
    for batch in batches:
        dev = {k: float(v) if np.ndim(v) == 0 else torch.from_numpy(np.asarray(v)).to(device)
               for k, v in shard_batch(batch, mesh).items()}
        state, metrics = step(state, dev, pool_t)
        losses.append(metrics["loss"].item())
        if grads is None:
            grads = {k: p.grad.cpu().numpy() for k, p in state.model.named_parameters()}
    return {"losses": losses, "step": state.step, "digest": params_digest(state.model),
            "params": {k: v.detach().cpu().numpy() for k, v in state.model.state_dict().items()},
            "grads": grads}


def sharded_topk(mesh, queries: np.ndarray, refs: np.ndarray, k: int):
    """``topk_l2_sharded`` of ``queries`` over this rank's rows of ``refs``
    (which divide over the ranks), on the mesh's device: numpy (distances,
    ids) and K2's launches on this rank (0 on the CPU)."""
    from soft_contrastive_learning_torch.ops.kernels.topk import topk_l2_cuda
    from soft_contrastive_learning_torch.ops.topk import topk_l2_sharded

    shard = torch.from_numpy(refs[mesh.rows(len(refs))]).to(mesh.device)
    before = topk_l2_cuda.launches
    d, i = topk_l2_sharded(torch.from_numpy(queries).to(mesh.device), shard, k, mesh)
    return d.cpu().numpy(), i.cpu().numpy(), topk_l2_cuda.launches - before


def trainer_config(n: int, base_lr: float = 3e-4) -> TrainConfig:
    """JAX's dryrun trainer configuration for ``n`` ranks, with
    ``steps_per_dispatch`` 1: 8 images a tuple, the fewest tuples (at least
    2) whose images divide over the ranks, 12 steps an epoch."""
    tpb = max(2, n // math.gcd(n, 8))
    return TrainConfig(
        model=ModelConfig(vlad_cores=8, reduction="none", image_height=32, image_width=32,
                          compute_dtype="float32"),
        tuples=TupleConfig(positives_per_tuple=3, negatives_per_tuple=4,
                           hard_positives_per_tuple=1, hard_negatives_per_tuple=1),
        loss=LossConfig(name="wms"), tuples_per_batch=tpb, max_epoch=1, base_lr=base_lr,
        mining_step=4, mining_cache_size=8, save_step=8, eval_step=6, num_eval_queries=2,
        eval_ref_r=2, seed=0)


def trainer_source_kwargs(cfg: TrainConfig) -> dict:
    """The dryrun's toy city: 12 anchors a step's tuples apart."""
    return dict(num_points=12 * cfg.tuples_per_batch, radius=30.0,
                img_h=cfg.model.image_height, img_w=cfg.model.image_width, seed=3)


def record_refreshes(trainer) -> List[int]:
    """The anchors at which ``trainer`` refreshes its mining cache, filled
    as it trains (the trainer's per-instance ``_mining_refresh`` seam)."""
    steps: List[int] = []
    refresh = trainer._mining_refresh

    def recording(epoch, step0, *args, **kwargs):
        steps.append(int(step0))
        return refresh(epoch, step0, *args, **kwargs)

    trainer._mining_refresh = recording
    return steps


def metric_series(out_dir: str) -> Dict[tuple, list]:
    """A run directory's metrics records: (role, tag, step) -> the values
    written under it, in file order (more than one: written more than
    once)."""
    series: Dict[tuple, list] = {}
    for role in ("local", "other"):
        path = os.path.join(out_dir, f"metrics_{role}.jsonl")
        if os.path.exists(path):
            with open(path) as f:
                for line in f:
                    rec = json.loads(line)
                    series.setdefault((role, rec["tag"], rec["step"]), []).append(rec["value"])
    return series


def trainer_machinery(mesh, cfg: TrainConfig, out_dir: str) -> dict:
    """JAX's ``_dryrun_trainer_machinery`` on ``mesh``, in ``out_dir`` (the
    same directory on every rank). Returns what each rank saw: steps,
    refresh anchors, its writers' election, the parameter digests, the
    resumed run's largest difference to the uninterrupted one and, on the
    primary, the metrics records of the uninterrupted run."""
    from soft_contrastive_learning_torch.data.pipeline import ToyCitySource
    from soft_contrastive_learning_torch.parallel.mesh import barrier
    from soft_contrastive_learning_torch.train.trainer import Trainer

    source = ToyCitySource(**trainer_source_kwargs(cfg))
    steps_per_epoch = 12
    tr = Trainer(cfg, source, out_dir=out_dir, mesh=mesh)
    refreshes = record_refreshes(tr)
    tr.train()
    tr.close()
    if tr.global_step != steps_per_epoch:
        raise RuntimeError(f"{tr.global_step} steps, expected {steps_per_epoch}")
    if tr.mining.refresh_count < 2:
        raise RuntimeError(f"expected >= 2 mining refreshes, got {tr.mining.refresh_count}")
    barrier(mesh)  # the primary's last metrics are written
    series = metric_series(out_dir) if tr.primary else None
    final = {k: v.detach().clone() for k, v in tr.state.model.state_dict().items()}

    tr2 = Trainer(cfg, source, out_dir=out_dir, mesh=mesh)
    if not tr2.resume_latest("part"):
        raise RuntimeError("no part checkpoint to resume")
    if tr2.global_step != cfg.save_step:
        raise RuntimeError(f"resumed at step {tr2.global_step}, expected {cfg.save_step}")
    saved = tr2.ckpts.load("part", cfg.save_step)["model"]
    restored = tr2.state.model.state_dict()
    if any(not torch.equal(restored[k].cpu(), saved[k]) for k in saved):
        raise RuntimeError("restored parameters differ from the saved ones")
    refreshes_resumed = record_refreshes(tr2)
    tr2.train()
    tr2.close()
    if tr2.global_step != steps_per_epoch:
        raise RuntimeError(f"resumed run ended at {tr2.global_step}, expected {steps_per_epoch}")
    state = tr2.state.model.state_dict()
    if not all(torch.isfinite(v).all() for v in state.values() if v.is_floating_point()):
        raise RuntimeError("non-finite parameters after resumed training")
    return {
        "rank": mesh.rank, "steps": tr.global_step, "refreshes": refreshes,
        "refresh_count": tr.mining.refresh_count, "resumed_refreshes": refreshes_resumed,
        "resumed_steps": tr2.global_step,
        "writes": {"primary": tr.primary, "metrics": tr.writers["local"].enabled,
                   "checkpoints": tr.ckpts.enabled},
        "digest": params_digest(tr.state.model), "resumed_digest": params_digest(tr2.state.model),
        "resumed_vs_uninterrupted": max((state[k].float() - final[k].float()).abs().max().item()
                                        for k in final),
        "series": series,
    }


def eval_summary(series: Dict[tuple, list]) -> str:
    """JAX's ``_assert_multidevice_eval_ran``: localization scalars in both
    regions and the held-out loss were written, finite."""
    tags = {}
    for (role, tag, _), values in series.items():
        tags.setdefault((role, tag), []).extend(values)
    for key in (("local", "%<10m@Top1"), ("other", "%<10m@Top1"), ("other", "loss")):
        values = tags.get(key)
        if not values or not np.isfinite(values).all():
            raise RuntimeError(f"eval metric {key}: {values}; the eval hooks did not run")
    return f"multidevice-eval(localization x{len(tags[('local', '%<10m@Top1')])}, heldout-loss ok)"


def dryrun_rank(mesh, base_lr: float, out_dir: str) -> dict:
    """The three parts of the dryrun on one rank (module docstring)."""
    from soft_contrastive_learning_torch.launch.multihost import initialize_multihost, is_primary
    from soft_contrastive_learning_torch.models.model import init_params
    from soft_contrastive_learning_torch.ops.topk import topk_l2

    n = mesh.size
    topology = {**initialize_multihost(), "is_primary": is_primary()}  # joined: no-op
    counts = kernel_launches()
    cfg = pooled_step_config(n)
    pool, batch = pooled_step_inputs(cfg)
    params = {k: v.numpy() for k, v in init_params(cfg.model, 0).items()}
    step = pooled_steps(mesh, cfg, params, pool, [batch])
    if not np.isfinite(step["losses"][0]):
        raise RuntimeError(f"non-finite loss {step['losses'][0]}")

    rng = np.random.default_rng(1)
    refs = rng.random((n * 16, 64)).astype(np.float32)
    queries = rng.random((4, 64)).astype(np.float32)
    dists, ids, _ = sharded_topk(mesh, queries, refs, 4)
    want_d, want_i = topk_l2(torch.from_numpy(queries), torch.from_numpy(refs), 4)
    if ids.shape != (4, 4) or not np.allclose(dists, want_d.numpy(), rtol=1e-5, atol=1e-5):
        raise RuntimeError(f"sharded top-k {dists} {ids}, dense {want_d} {want_i}")

    machinery = trainer_machinery(mesh, trainer_config(n, base_lr), out_dir)
    return {"rank": mesh.rank, "backend": mesh.backend, "device": str(mesh.device),
            "topology": topology,
            "loss": step["losses"][0], "step": step["step"], "step_digest": step["digest"],
            "topk": (dists, ids), "dense_topk": (want_d.numpy(), want_i.numpy()),
            "trainer": machinery,
            "launches": {k: v - counts[k] for k, v in kernel_launches().items()}}


def dryrun_multichip(n: int, device: str = "cuda", base_lr: float = 3e-4,
                     out_dir: Optional[str] = None,
                     timeout_s: float = DRYRUN_TIMEOUT_S) -> List[dict]:
    """Run the dryrun on ``n`` ranks of ``device`` (module docstring), print
    its line and return each rank's results. ``out_dir``: the trainer's run
    directory, kept (default: a temporary one, removed)."""
    from soft_contrastive_learning_torch.launch.multihost import choose_backend, run_ranks

    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("dryrun_multichip on cuda, but torch.cuda.is_available() is False")
    backend = choose_backend(device, n)
    cards = torch.cuda.device_count() if torch.device(device).type == "cuda" else 0
    print(f"dryrun_multichip({n}): {n} ranks on {device}"
          + (f" ({cards} card(s))" if cards else "") + f", backend {backend}")
    run_dir = out_dir or tempfile.mkdtemp(prefix="scl_dryrun_")
    try:
        results = run_ranks(dryrun_rank, n, (base_lr, run_dir), device=device,
                            timeout_s=timeout_s)
    finally:
        if out_dir is None:
            shutil.rmtree(run_dir, ignore_errors=True)
    first = results[0]
    for r in results:
        if r["backend"] != backend:
            raise RuntimeError(f"rank {r['rank']} ran {r['backend']}, expected {backend}")
        for key, got, want in (("pooled step", r["step_digest"], first["step_digest"]),
                               ("trainer", r["trainer"]["digest"], first["trainer"]["digest"]),
                               ("resumed trainer", r["trainer"]["resumed_digest"],
                                first["trainer"]["resumed_digest"])):
            if got != want:
                raise RuntimeError(f"rank {r['rank']}'s {key} parameters differ from rank 0's")
    tm = first["trainer"]
    print(f"dryrun_multichip({n}): loss={first['loss']:.4f} (pooled step), step={first['step']}, "
          f"sharded-topk ok, trainer(mining_refreshes={tm['refresh_count']}, "
          f"resume@{trainer_config(n).save_step}->{tm['resumed_steps']}, "
          f"{eval_summary(tm['series'])}) ok, backend {backend}, ranks bit-equal")
    return results
