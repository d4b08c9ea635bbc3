"""Nothing of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the program either (top-level module names,
compared whole, in a fresh interpreter)."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

HARNESS = """
import json, sys
from benchmarks import run
bench = run.load_json(run.REPO / "BENCHMARK.json")
for cell in bench["workloads"]:
    run.find_traffic(run.find_workload(cell["name"])["kind"])
for m in bench["per_layer"]:
    run.find_reader(m["name"])
import soft_contrastive_learning_torch.serving, soft_contrastive_learning_torch.models.quant
import soft_contrastive_learning_torch.train.trainer
import soft_contrastive_learning_torch.data.decoded_cache
from benchmarks.harness import forbidden_loaded
print(json.dumps(forbidden_loaded(sys.modules)))
"""

REFERENCE = """
import json, sys
import benchmarks.reference.model, benchmarks.reference.search
import benchmarks.reference.train, benchmarks.reference.toycity
top = {m.split(".", 1)[0] for m in sys.modules}
print(json.dumps(sorted(top & {"jax", "jaxlib", "flax", "soft_contrastive_learning_tpu",
                                "soft_contrastive_learning_torch"})))
"""


def _loaded(code: str) -> list:
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=300, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_harness_loads_no_jax():
    assert _loaded(HARNESS) == []


def test_reference_loads_nothing_of_the_program():
    assert _loaded(REFERENCE) == []


def test_prefix_is_not_a_match():
    from benchmarks.harness import forbidden_loaded

    assert forbidden_loaded(["soft_contrastive_learning_torch.serving", "jaxtyping"]) == []
    assert forbidden_loaded(["jax.numpy", "soft_contrastive_learning_tpu"]) == [
        "jax.numpy", "soft_contrastive_learning_tpu"]
