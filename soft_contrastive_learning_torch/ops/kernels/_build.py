"""Build the hand-written CUDA kernels under ``csrc/`` and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own with
``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
-cudart shared`` into ``soft_contrastive_learning_torch/_build/<name>-<hash>.so``. The hash
covers every source under ``csrc/`` and the flags, so an edited source
rebuilds at first use and an unchanged one is reused. All missing libraries
build in parallel, one ``nvcc`` per source. ``ptxas -v`` output (registers,
shared memory, spills) is kept beside each library as ``<name>-<hash>.log``.

Nothing here runs at import time: the CPU tests import every module, and
this host need not have ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

SRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
    # link the CUDA runtime PyTorch has loaded instead of a static copy, so
    # the process holds one runtime
    "-cudart", "shared",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def kernel_names() -> list[str]:
    return sorted(p.stem for p in SRC_DIR.glob("*.cu"))


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
            "PATH); the CUDA kernels cannot be built on this machine"
        )
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(SRC_DIR.iterdir()):
        if src.suffix in (".cu", ".cuh", ".h"):
            h.update(src.name.encode())
            h.update(src.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_digest()}.so"


def build(names: Iterable[str] | None = None) -> float:
    """Compile the named kernels (default: all) that are not built yet, all
    at once; return the wall seconds spent. Raises with nvcc's output when a
    compile fails."""
    todo = [n for n in (names or kernel_names()) if not library_path(n).exists()]
    start = time.perf_counter()
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name in todo:
        out = library_path(name)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SRC_DIR / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    if failed:
        raise RuntimeError("\n".join(failed))
    return time.perf_counter() - start


def build_log(name: str) -> str:
    path = library_path(name).with_suffix(".log")
    return path.read_text() if path.exists() else ""


def ptxas_summary(name: str) -> list[dict]:
    """Per kernel function of library ``name``, what ``ptxas -v`` said:
    registers, spill stores and loads (bytes) and static shared memory
    (bytes; dynamic shared memory is the launch's and not in the log)."""
    out: list[dict] = []
    current: dict = {}
    for line in build_log(name).splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            current = dict(function=m.group(1), registers=None, spill_stores=0, spill_loads=0,
                           smem=0)
            out.append(current)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and current:
            current["spill_stores"], current["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and current:
            current["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            current["smem"] = int(sm.group(1)) if sm else 0
    return out


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of kernel library ``name``, building it first if
    needed. Callers declare argtypes/restype on the functions they use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _libs[name] = lib
        return lib


_count_lock = threading.Lock()


def count_launch(wrapper) -> None:
    """One more launch on ``wrapper.launches``. Under a lock: the training
    thread and the async mining worker launch K1 at once, and ``+= 1`` on
    an attribute is a read and a write."""
    with _count_lock:
        wrapper.launches += 1


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise when a C entry point returned a non-zero cudaError_t."""
    if err != 0:
        fn = lib.scl_cuda_error_string
        fn.argtypes = [ctypes.c_int]
        fn.restype = ctypes.c_char_p
        raise RuntimeError(f"{what}: CUDA error {err} ({fn(err).decode()}) at launch")

