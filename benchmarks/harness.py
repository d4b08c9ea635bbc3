"""What every cell's run shares: the cell as the run sees it, the outcome a
traffic kind hands back, and the host-side instruments that the traced runs
wrap around the program's calls (spans on the host's clock, a lock that
times its waits)."""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "soft_contrastive_learning_tpu")


def process_start_s() -> float:
    """The wall-clock time at which this process started (from /proc, so
    that the interpreter's own start counts), or now where /proc is absent."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f if line.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, StopIteration, IndexError, ValueError):
        return time.time()


def forbidden_loaded(modules) -> List[str]:
    """The loaded modules whose top-level name (before the first dot),
    compared whole, is JAX's or the JAX package's."""
    return sorted({m for m in modules if m.split(".", 1)[0] in FORBIDDEN_MODULES})


@dataclass
class Cell:
    name: str
    config: dict
    params: dict
    seed: int
    seconds: float
    trace: bool
    device: object  # torch.device
    work_dir: Path
    started: float  # wall-clock seconds at the process's start


@dataclass
class Outcome:
    correct: bool
    attempted: int
    failed: int
    e2e: Dict[str, float]
    checks: List[Tuple[str, float, float]]  # (name, value, limit), value <= limit passes
    readings: dict = field(default_factory=dict)  # what the per-layer readers read
    memory_peak_bytes: int = 0
    trace: Optional[object] = None  # metrics/_trace.py::DeviceTrace of the traced window


class SpanLog:
    """Host spans (name, start, end) in wall-clock ns, kept in memory."""

    def __init__(self):
        self.spans: List[Tuple[str, int, int]] = []
        self._lock = threading.Lock()

    def add(self, name: str, start_ns: int, end_ns: int) -> None:
        with self._lock:
            self.spans.append((name, start_ns, end_ns))

    def wrap(self, name: str, fn: Callable, on_done: Optional[Callable] = None) -> Callable:
        def timed(*args, **kwargs):
            t0 = time.time_ns()
            try:
                return fn(*args, **kwargs)
            finally:
                t1 = time.time_ns()
                self.add(name, t0, t1)
                if on_done is not None:
                    on_done(t0, t1)
        return timed

    def total_s(self, name: str) -> float:
        return sum(e - s for n, s, e in self.spans if n == name) / 1e9


class TimingLock:
    """A drop-in for ``threading.Lock`` that records each wait to acquire it
    (as a ``lock_wait`` span) and keeps each thread's waits summed."""

    def __init__(self, spans: SpanLog):
        self._lock = threading.Lock()
        self._spans = spans
        self._local = threading.local()

    def thread_wait_ns(self) -> int:
        return getattr(self._local, "wait_ns", 0)

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        t0 = time.time_ns()
        ok = self._lock.acquire(blocking, timeout)
        t1 = time.time_ns()
        self._spans.add("lock_wait", t0, t1)
        self._local.wait_ns = self.thread_wait_ns() + (t1 - t0)
        return ok

    def release(self) -> None:
        self._lock.release()

    def locked(self) -> bool:
        return self._lock.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()
