"""Starting the ranks of a data-parallel run, the counterpart of
``soft_contrastive_learning_tpu/launch/multihost.py``.

``initialize_multihost`` joins this process to the process group: one
process per rank, each driving one device. Its arguments default to
torch's launcher environment (``torchrun`` sets ``MASTER_ADDR``,
``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK`` and
``LOCAL_WORLD_SIZE``); with one process it does nothing, as JAX's does.
The backend is NCCL when each rank of this host has a card of its own, and
gloo on the CPU and when ranks share a card (NCCL refuses two ranks on one
device). The group gets a timeout, so that a collective one rank never
reaches fails instead of hanging.

``run_ranks`` starts ``n`` local ranks (``torch.multiprocessing``,
``spawn``) that each run a function of this package on the mesh and
return its result: the multi-device dryrun, ``cli train
--num_data_shards`` without a launcher, and the tests use it. Each rank
has its own deadline.

``is_primary()`` is rank 0, the only writer of a run's files.
"""

from __future__ import annotations

import datetime
import importlib
import os
import pickle
import shutil
import socket
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 600.0  # a collective that waits longer fails
_BOUND = {}  # this process's rank device, set by initialize_multihost


def bound_device() -> Optional[torch.device]:
    """The device ``initialize_multihost`` bound this rank to, if any."""
    return _BOUND.get("device")


def rank_device(device: str | torch.device, local_rank: int) -> torch.device:
    """The device of local rank ``local_rank``: on CUDA card ``local_rank %
    cards`` (ranks share cards when there are more of them), else the
    CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA device requested but torch.cuda.is_available() is False; "
                           "pass device='cpu' to run the ranks on the CPU")
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def choose_backend(device: str | torch.device, local_ranks: int) -> str:
    """NCCL when every one of this host's ``local_ranks`` has a card of its
    own, else gloo."""
    device = torch.device(device)
    if device.type == "cuda" and local_ranks <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def _env_int(name: str) -> Optional[int]:
    value = os.environ.get(name)
    return int(value) if value else None


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device: str | torch.device = "cuda",
    local_rank: Optional[int] = None,
    local_ranks: Optional[int] = None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> dict:
    """Join the process group (no-op for one process) and return JAX's
    topology facts. ``coordinator_address`` is ``host:port`` of rank 0
    (default ``MASTER_ADDR:MASTER_PORT``), ``num_processes`` the world size
    (``WORLD_SIZE``), ``process_id`` this rank (``RANK``); ``local_rank``
    and ``local_ranks`` place it among this host's ranks (``LOCAL_RANK``,
    ``LOCAL_WORLD_SIZE``; default: every rank on this host). ``device``:
    ``cuda`` (the card ``local_rank % cards``) or ``cpu``. A rank drives one
    device, so ``local_device_count`` is 1 and ``global_device_count`` the
    world size."""
    if coordinator_address is None and os.environ.get("MASTER_ADDR"):
        coordinator_address = f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '')}"
    num_processes = num_processes if num_processes is not None else _env_int("WORLD_SIZE")
    process_id = process_id if process_id is not None else _env_int("RANK")
    if coordinator_address and (num_processes or 0) > 1 and not dist.is_initialized():
        if process_id is None:
            raise ValueError("a rank of a multi-process run needs its process_id (RANK)")
        if local_rank is None:
            local_rank = _env_int("LOCAL_RANK")
        local_rank = process_id if local_rank is None else local_rank
        local_ranks = local_ranks or _env_int("LOCAL_WORLD_SIZE") or num_processes
        dev = rank_device(device, local_rank)
        backend = choose_backend(dev, local_ranks)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                                world_size=num_processes, rank=process_id,
                                timeout=datetime.timedelta(seconds=timeout_s))
        _BOUND["device"] = dev
    started = dist.is_initialized()
    world = dist.get_world_size() if started else 1
    return {
        "process_index": dist.get_rank() if started else 0,
        "process_count": world,
        "local_device_count": 1,
        "global_device_count": world,
    }


def is_primary() -> bool:
    """True on the process that writes checkpoints, metrics and logs."""
    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def call_with_mesh(mesh, target: str, args: Sequence[Any] = (), kwargs: Optional[dict] = None):
    """``target(*args, mesh=mesh, **kwargs)``, ``target`` a dotted name: a
    ``run_ranks`` target for the functions that take the mesh as a keyword
    (``evaluation/topn.py::top_n_single``, ``get_top_n``,
    ``evaluation/inference.py::run_inference``)."""
    module, name = target.rsplit(".", 1)
    return getattr(importlib.import_module(module), name)(*args, mesh=mesh, **(kwargs or {}))


def free_port() -> int:
    """A TCP port on 127.0.0.1 that nothing listens on now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, n: int, address: str, device: str, target: str, args: tuple,
               out_dir: str, timeout_s: float) -> None:
    """One spawned rank: join the group, run ``target(mesh, *args)``,
    pickle its result (or the error's traceback) into ``out_dir``."""
    from soft_contrastive_learning_torch.parallel.mesh import make_mesh

    try:
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")  # every rank is on this host
        if torch.device(device).type == "cpu":
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
        initialize_multihost(address, n, rank, device=device, local_rank=rank, local_ranks=n,
                             timeout_s=timeout_s)
        module, name = target.rsplit(".", 1)
        result = getattr(importlib.import_module(module), name)(make_mesh(), *args)
        with open(os.path.join(out_dir, f"result_{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
    except BaseException:
        with open(os.path.join(out_dir, f"error_{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise SystemExit(1)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(target: Callable | str, n: int, args: Sequence[Any] = (),
              device: str = "cuda", timeout_s: Optional[float] = DEFAULT_TIMEOUT_S) -> List[Any]:
    """Run ``target(mesh, *args)`` on ``n`` local ranks, one process each
    (``spawn``: the target, a function of an importable module, is imported
    anew in each), on ``device`` (``cuda``: rank i on card ``i % cards``).
    Returns each rank's result in rank order. A rank that fails stops the
    others and raises with its traceback; so does one still running after
    ``timeout_s`` seconds (None: no deadline, as for a training run). The
    group's collectives time out after ``timeout_s`` too (at most
    ``DEFAULT_TIMEOUT_S``)."""
    if not isinstance(target, str):
        target = f"{target.__module__}.{target.__qualname__}"
    address = f"127.0.0.1:{free_port()}"
    ctx = torch.multiprocessing.get_context("spawn")
    out_dir = tempfile.mkdtemp(prefix="scl_ranks_")
    group_timeout = min(timeout_s or DEFAULT_TIMEOUT_S, DEFAULT_TIMEOUT_S)
    procs = [ctx.Process(target=_rank_main, name=f"rank-{r}",
                         args=(r, n, address, str(device), target, tuple(args), out_dir,
                               group_timeout))
             for r in range(n)]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + (timeout_s if timeout_s is not None else float("inf"))
        while any(p.is_alive() for p in procs) and time.monotonic() < deadline:
            if any(p.exitcode not in (None, 0) for p in procs):
                time.sleep(1.0)  # a failed rank: give the others a moment to fail too
                break
            time.sleep(0.05)
        errors = []
        for r, p in enumerate(procs):
            if p.is_alive():
                p.terminate()
                p.join(10.0)
                if p.is_alive():
                    p.kill()
                    p.join()
                errors.append(f"rank {r}: stopped (past its {timeout_s} s or a rank failed)")
            elif p.exitcode != 0:
                path = os.path.join(out_dir, f"error_{r}.txt")
                text = open(path).read() if os.path.exists(path) else f"exit code {p.exitcode}"
                errors.append(f"rank {r}: {text}")
        if errors:
            raise RuntimeError(f"{target} on {n} ranks failed:\n" + "\n".join(errors))
        results = []
        for r in range(n):
            with open(os.path.join(out_dir, f"result_{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(out_dir, ignore_errors=True)
