"""Runs one cell of the benchmark and prints its result as the last line of
standard output (one JSON object), the numbers compared for ``correct``
beside their limits last on standard error and under ``checks``::

    python3 -m benchmarks.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

With ``--trace 0`` the line's metrics are the cell's end-to-end metrics,
with ``--trace 1`` its per-layer ones, read from a profiled window.
Exits non-zero, with no result, where there is no CUDA card or fewer than
the cell asks for, and where JAX or the JAX package was loaded."""

from __future__ import annotations

from benchmarks.harness import process_start_s

STARTED = process_start_s()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

from benchmarks.harness import Cell, forbidden_loaded  # noqa: E402

ROOT = Path(__file__).resolve().parent  # the benchmark's folder
REPO = ROOT.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def find_workload(name: str, root: Path = ROOT) -> dict:
    return load_json(root / "workloads" / f"{name}.json")


def find_config(name: str, root: Path = ROOT) -> dict:
    return load_json(root / "configs" / f"{name}.json")


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def find_traffic(kind: str, root: Path = ROOT):
    """The traffic kind's module, ``traffic/<kind>.py``."""
    return _load(root / "traffic" / f"{kind}.py", f"benchmarks.traffic.{kind}")


def find_reader(metric: str, root: Path = ROOT):
    """The reader of a per-layer metric: ``metrics/<base>.py`` for ``<base>[.<family>]``."""
    base = metric.split(".", 1)[0]
    return _load(root / "metrics" / f"{base}.py", f"benchmarks.metrics.{base}")


def cell_metrics(bench: dict, cell: str, trace: bool) -> list:
    """The metric entries of ``BENCHMARK.json`` that ``cell`` reports: its
    end-to-end ones, or with ``trace`` its per-layer ones (those listing
    it, or without a list, those moving an end-to-end metric it reports)."""
    def listed(m):
        return "workloads" not in m or cell in m["workloads"]

    e2e = [m for m in bench["end_to_end"] if listed(m)]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if ((cell in m["workloads"]) if "workloads" in m else (m["moves"] in names))]


def set_cache_dirs(work: Path) -> None:
    """Build and kernel caches at fixed paths inside the checkout (the port
    builds its kernels into its own ``_build`` there)."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(work / sub)
    os.environ["USE_FLAX"] = "0"


def result_line(outcome, metrics: list, trace: bool, device_info: dict, cell: str) -> dict:
    values = {}
    for m in metrics:
        if not trace:
            value = outcome.e2e[m["name"]]
        else:
            value = find_reader(m["name"]).read(m["name"], outcome.readings)
        if value is None:
            continue
        if not math.isfinite(value):
            raise ValueError(f"{m['name']} is not finite: {value}")
        values[m["name"]] = {"value": float(value), "unit": m["unit"]}
    line = {"correct": bool(outcome.correct), "attempted": int(outcome.attempted),
            "failed": int(outcome.failed), "metrics": values, "device": device_info}
    if trace and outcome.trace is not None:
        spans = outcome.readings["spans"].spans if outcome.readings.get("spans") else []
        line["device"]["busy_s"] = outcome.trace.busy_s()
        line["device"]["window_s"] = outcome.trace.window_s
        line["breakdown"] = outcome.trace.breakdown(spans)
    line["checks"] = {name: {"value": float(v), "limit": float(lim)}
                      for name, v, lim in outcome.checks}
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = load_json(REPO / "BENCHMARK.json")
    workload = find_workload(args.workload)
    config = find_config(workload["config"])
    chips = int(workload["chips"])

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"this cell needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    work = ROOT / "_work" / args.workload
    work.mkdir(parents=True, exist_ok=True)
    set_cache_dirs(ROOT / "_work")
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    cell = Cell(name=args.workload, config=config, params=workload["params"], seed=args.seed,
                seconds=args.seconds, trace=bool(args.trace), device=device, work_dir=work,
                started=STARTED)
    outcome = find_traffic(workload["kind"]).run(cell)
    device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": chips,
                   "memory_peak_bytes": int(outcome.memory_peak_bytes)}
    line = result_line(outcome, cell_metrics(bench, args.workload, bool(args.trace)),
                       bool(args.trace), device_info, args.workload)
    found = forbidden_loaded(sys.modules)
    if found:
        print(f"JAX or the JAX package was loaded: {found}", file=sys.stderr)
        return 3
    for name, check in line["checks"].items():
        print(f"check {name} {check['value']!r} limit {check['limit']!r}", file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
