"""The data-parallel mesh over ``torch.distributed``, the counterpart of
``soft_contrastive_learning_tpu/parallel/mesh.py``.

One process per rank, each driving one device; the ranks form the mesh's
data axis. The model axis has size 1: the JAX package shapes its mesh with
one, but shards nothing over it.

JAX's jitted step is one global program over the batch sharded on the data
axis: the loss mixes every image with every other one, and XLA inserts the
gathers and the gradient all-reduce. Here each rank embeds its rows of the
batch (``shard_batch``), ``gather_rows`` hands every rank the whole (B, D)
output in rank order, every rank computes the same global loss, and
``all_reduce_grads`` sums the ranks' gradients. The sum equals the
one-process gradient up to summation order: each rank's backward yields the
contribution of its own rows, which ``gather_rows``'s backward slices out
of the global loss's gradient without communication.

The collectives run whenever the mesh has a process group, one of one rank
included (a no-op in effect, which still drives the backend); a mesh
without one (one process) skips them. They go through the mesh's backend:
NCCL when every rank has a card of its own, gloo on the CPU and when ranks
share a card (NCCL refuses two ranks on one device). gloo moves a CUDA
tensor through the host: it is copied to the CPU, reduced or gathered
there, and copied back.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Iterable, Optional, Sequence

import torch
import torch.distributed as dist

from soft_contrastive_learning_torch.data.pipeline import pad_to_multiple  # noqa: F401

# the batch's per-image leaves: the ones a rank holds its rows of
PER_IMAGE_KEYS = ("images", "image_idx")


@dataclass(frozen=True)
class Mesh:
    """This rank's view of the data axis: the process group (None: one
    process), the rank, the axis size, the rank's device and the backend."""

    group: Any
    rank: int
    size: int
    device: torch.device
    backend: str

    def rows(self, n: int) -> slice:
        """This rank's share of ``n`` rows, which must divide by the size."""
        if n % self.size:
            raise ValueError(f"{n} rows do not divide over {self.size} ranks")
        per = n // self.size
        return slice(self.rank * per, (self.rank + 1) * per)


def default_device() -> torch.device:
    """The device of this rank when ``make_mesh`` is given none: the one
    ``launch/multihost.py::initialize_multihost`` bound, else the card when
    there is one, else the CPU."""
    from soft_contrastive_learning_torch.launch.multihost import bound_device

    device = bound_device()
    if device is not None:
        return device
    return torch.device("cuda", torch.cuda.current_device()) if torch.cuda.is_available() \
        else torch.device("cpu")


def make_mesh(num_data: int = 0, num_model: int = 1,
              devices: Optional[Sequence[Any]] = None) -> Mesh:
    """The (data, model) mesh of the running process group: ``num_data``
    ranks (0: all of them), ``num_model`` 1. ``devices``: each rank's
    device in rank order (default: the one each rank bound). Without a
    process group the mesh is this one process."""
    if num_model != 1:
        raise NotImplementedError(
            f"num_model={num_model}: the model axis has size 1. The JAX package shapes its "
            "mesh with a model axis but shards nothing over it, so the port has none")
    started = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if started else 1
    rank = dist.get_rank() if started else 0
    if num_data <= 0:
        num_data = world
    if num_data != world:
        raise ValueError(
            f"a mesh of {num_data} data ranks needs a process group of {num_data}; this one "
            f"has {world} (start the ranks with launch/multihost.py, torchrun or "
            "`cli train --num_data_shards`)")
    device = torch.device(devices[rank]) if devices is not None else default_device()
    backend = dist.get_backend() if started else "none"
    return Mesh(group=dist.group.WORLD if started else None, rank=rank, size=world,
                device=device, backend=backend)


def shard_batch(batch: Any, mesh: Optional[Mesh]) -> Any:
    """This rank's rows of the per-image leaves of ``batch`` (``images``,
    ``image_idx``; a bare array or tensor is taken to be images); every
    other leaf, the (B, B) geometric payload and the PCA state included,
    stays whole. JAX's ``shard_batch`` lays out every leaf whose first
    dimension divides the axis over it, but its step still computes one
    global loss; slicing the payload by that rule here would give each rank
    a different loss. Without a mesh (or with one rank) ``batch`` as it is."""
    if mesh is None or mesh.size == 1:
        return batch
    if not isinstance(batch, dict):
        return batch[mesh.rows(len(batch))]
    return {k: v[mesh.rows(len(v))] if k in PER_IMAGE_KEYS else v for k, v in batch.items()}


def shard_batch_stacked(batch: Dict[str, Any], mesh: Optional[Mesh]) -> Dict[str, Any]:
    """``shard_batch`` for the K-step dispatch, whose leaves are stacked to
    (K, B, ...): this rank's rows along axis 1 of the per-image leaves,
    every other leaf whole. JAX's ``shard_batch_stacked`` keeps the scan
    axis whole too."""
    if mesh is None or mesh.size == 1:
        return batch
    return {k: v[:, mesh.rows(v.shape[1])] if k in PER_IMAGE_KEYS else v
            for k, v in batch.items()}


def _wire(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The tensor a collective takes: gloo's on the host."""
    return x.cpu() if mesh.backend == "gloo" and x.is_cuda else x


def _collective(mesh: Optional[Mesh]) -> bool:
    """Is there a process group to talk to (one of one rank included)?"""
    return mesh is not None and mesh.group is not None


def all_gather_rows(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """Every rank's ``x`` (of one shape on all ranks) concatenated along
    dim 0 in rank order, on every rank; no autograd."""
    if not _collective(mesh):
        return x
    wire = _wire(x.detach().contiguous(), mesh)
    parts = [torch.empty_like(wire) for _ in range(mesh.size)]
    dist.all_gather(parts, wire, group=mesh.group)
    return torch.cat(parts).to(x.device)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
        ctx.rows = mesh.rows(x.shape[0] * mesh.size)
        return all_gather_rows(x, mesh)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return grad[ctx.rows], None


def gather_rows(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """``all_gather_rows`` with a gradient: the backward returns this
    rank's rows of the incoming gradient and communicates nothing. Every
    rank computes the same global loss from the same gathered rows, so that
    slice is already the loss's gradient with respect to this rank's rows
    (``torch.distributed.nn``'s all_gather would instead sum n copies of it
    across the ranks)."""
    if not _collective(mesh):
        return x
    return _GatherRows.apply(x, mesh)


def all_reduce_sum(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """``x`` summed over the ranks, in place; every rank gets the same bits."""
    if not _collective(mesh):
        return x
    wire = _wire(x, mesh)
    dist.all_reduce(wire, op=dist.ReduceOp.SUM, group=mesh.group)
    if wire is not x:
        x.copy_(wire)
    return x


def all_reduce_grads(params: Iterable[torch.nn.Parameter], mesh: Optional[Mesh]) -> None:
    """Replace each parameter's gradient by its sum over the ranks: one
    collective per gradient dtype, over the gradients flattened into one
    buffer. Parameters without a gradient are skipped (the same ones on
    every rank: the ranks run one graph)."""
    if not _collective(mesh):
        return
    by_dtype: Dict[torch.dtype, list] = {}
    for p in params:
        if p.grad is not None:
            by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in by_dtype.values():
        flat = all_reduce_sum(torch.cat([g.reshape(-1) for g in grads]), mesh)
        offset = 0
        for g in grads:
            g.copy_(flat[offset : offset + g.numel()].view_as(g))
            offset += g.numel()


def barrier(mesh: Optional[Mesh]) -> None:
    """Every rank waits here for the others (no-op without a group)."""
    if not _collective(mesh):
        return
    if mesh.backend == "nccl":
        dist.barrier(group=mesh.group, device_ids=[mesh.device.index])
    else:
        dist.barrier(group=mesh.group)
