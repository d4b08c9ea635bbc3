"""The harness finds every piece by name, and a cell added as files only is
picked up without an edit."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

from benchmarks import run
from benchmarks.harness import Outcome

REPO = Path(__file__).resolve().parents[2]
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files(cell):
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    workload = run.find_workload(cell)
    # what the run reads, and nothing else: the why and the traffic's name live in BENCHMARK.json
    assert set(workload) == {"config", "kind", "chips", "params"}
    assert workload["config"] == entry["config"] and workload["chips"] == entry["chips"]
    config = run.find_config(workload["config"])
    assert config["reduced"] == next(c for c in BENCH["configs"]
                                     if c["name"] == workload["config"])["reduced"]
    assert callable(run.find_traffic(workload["kind"]).run)
    e2e = run.cell_metrics(BENCH, cell, trace=False)
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    layer = run.cell_metrics(BENCH, cell, trace=True)
    assert layer
    for m in layer:
        assert m["moves"] in {e["name"] for e in e2e}
        assert callable(run.find_reader(m["name"]).read)


def test_contract_shapes():
    assert BENCH["command"] == ["python3", "-m", "benchmarks.run"]
    for c in BENCH["configs"]:
        assert (REPO / c["file"]).is_file()
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25


def _dummy_root(tmp_path: Path) -> Path:
    root = tmp_path / "bench"
    for sub in ("workloads", "configs", "traffic", "metrics"):
        shutil.copytree(run.ROOT / sub, root / sub)
    (root / "configs" / "dummy_cfg.json").write_text(json.dumps({"reduced": [], "n": 3}))
    (root / "workloads" / "dummy-cell.json").write_text(json.dumps(
        {"config": "dummy_cfg", "kind": "dummy_kind", "chips": 1, "params": {"work": 7}}))
    (root / "traffic" / "dummy_kind.py").write_text(
        "from benchmarks.harness import Outcome\n"
        "def run(cell):\n"
        "    n = cell.config['n'] * cell.params['work']\n"
        "    return Outcome(correct=True, attempted=n, failed=0,\n"
        "                   e2e={'dummy_per_s': float(n), 'setup_s': 1.0}, checks=[],\n"
        "                   readings={'dummy': n / 2})\n")
    (root / "metrics" / "dummy_half.py").write_text(
        "def read(name, r):\n    return r.get('dummy')\n")
    return root


def test_new_cell_is_picked_up_from_files(tmp_path):
    from benchmarks.tests import tiny

    root = _dummy_root(tmp_path)
    workload = run.find_workload("dummy-cell", root)
    config = run.find_config(workload["config"], root)
    outcome = run.find_traffic(workload["kind"], root).run(
        tiny.cell("dummy-cell", config, workload["params"], tmp_path))
    assert isinstance(outcome, Outcome) and outcome.attempted == 21
    bench = dict(BENCH, end_to_end=BENCH["end_to_end"] + [
        {"name": "dummy_per_s", "unit": "1/s", "better": "higher", "bound": 0.05,
         "source": "host_clock", "workloads": ["dummy-cell"]}],
        per_layer=BENCH["per_layer"] + [
        {"name": "dummy_half.cell", "unit": "1", "better": "higher", "source": "program_counter",
         "layer": "dummy", "moves": "dummy_per_s", "workloads": ["dummy-cell"]}])
    metrics = run.cell_metrics(bench, "dummy-cell", trace=True)
    assert [m["name"] for m in metrics] == ["dummy_half.cell"]
    assert run.find_reader("dummy_half.cell", root).read("dummy_half.cell",
                                                         outcome.readings) == 10.5
    e2e = [m["name"] for m in run.cell_metrics(bench, "dummy-cell", trace=False)]
    assert sorted(e2e) == ["dummy_per_s", "setup_s"]


def test_new_open_loop_cell_reads_the_per_request_mfu(tmp_path):
    """A search cell at a fixed offered rate, added as files only (its
    configuration, its workload on the open loop, an ``mfu`` entry under its
    own name), reads the share per request: the requests' least device time
    over their summed latencies, not over the window."""
    from benchmarks.roofline import PEAK_INT8, int8_ops, k2_bound_s
    from benchmarks.tests import tiny

    root = tmp_path / "bench"
    for sub in ("workloads", "configs", "traffic", "metrics"):
        shutil.copytree(run.ROOT / sub, root / sub)
    pool = tiny.upload_pool(tmp_path / "uploads")
    (root / "configs" / "tiny_search.json").write_text(json.dumps(tiny.search_config(pool)))
    limits = run.find_workload("search-fleet-pitts250k")["params"]["limits"]
    (root / "workloads" / "search-open-tiny.json").write_text(json.dumps(
        {"config": "tiny_search", "kind": "open_loop_search", "chips": 1,
         "params": {"rate_per_s": 6.0, "arrival_seed": 0, "images_per_request": 1, "k": 5,
                    "limits": limits}}))
    workload = run.find_workload("search-open-tiny", root)
    config = run.find_config(workload["config"], root)
    outcome = run.find_traffic(workload["kind"], root).run(
        tiny.cell("search-open-tiny", config, workload["params"], tmp_path, seconds=1.0))
    assert outcome.correct, outcome.checks
    bench = dict(BENCH, end_to_end=BENCH["end_to_end"] + [
        {"name": "search_p95_ms", "unit": "ms", "better": "lower", "bound": 0.05,
         "source": "host_clock", "workloads": ["search-open-tiny"]}],
        per_layer=BENCH["per_layer"] + [
        {"name": "mfu.open_tiny", "unit": "%", "better": "higher", "source": "host_clock",
         "layer": "whole step", "moves": "search_p95_ms", "workloads": ["search-open-tiny"]}])
    line = run.result_line(outcome, run.cell_metrics(bench, "search-open-tiny", True), True,
                           {"platform": "cpu"}, "search-open-tiny")
    rows = outcome.readings["rows"]
    model = config["model"]
    least = (k2_bound_s(1, config["index_rows"], 512 * model["vlad_cores"], 5)
             + int8_ops(model["image_height"], model["image_width"]) / PEAK_INT8)
    per_request = 100.0 * least * len(rows) / sum(r[2] - r[0] for r in rows)
    assert line["metrics"]["mfu.open_tiny"]["value"] == pytest.approx(per_request)
    assert per_request != pytest.approx(100.0 * least * len(rows) / 1.0)


def test_result_line_orders_checks_last():
    outcome = Outcome(correct=True, attempted=3, failed=0, e2e={"setup_s": 2.5},
                      checks=[("gap", 0.1, 0.2)])
    line = run.result_line(outcome, [{"name": "setup_s", "unit": "s"}], False,
                           {"platform": "gpu"}, "x")
    assert list(line)[-1] == "checks" and line["metrics"]["setup_s"]["value"] == 2.5
