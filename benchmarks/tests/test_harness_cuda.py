"""Card-only checks of the benchmark (marked ``cuda``; they skip where there
is no card): K2 at the search cells' full index, and the controls of every
cell at the cell's own size. Run on the card from the repository root::

    python -m pytest -p no:cacheprovider -m cuda benchmarks/tests/test_harness_cuda.py -s
"""

from __future__ import annotations

import pytest
import torch

pytestmark = pytest.mark.cuda


def _card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda", 0)


def test_k2_at_pitts250k():
    """One search of K2 over 250,000 x 32,768 fp32 rows (byte offsets past
    2^32) against the float64 reference, at Q 1 and 4, k 5 and 25, with
    near neighbours planted at the index's start, middle and end."""
    from benchmarks.reference.search import exact_topk
    from soft_contrastive_learning_torch.ops.topk import topk_l2_streamed

    dev = _card()
    rows, dim = 250_000, 32_768
    gen = torch.Generator(device=dev).manual_seed(11)
    index = torch.empty((rows, dim), dtype=torch.float32, device=dev)
    for s in range(0, rows, 16384):
        b = torch.randn((min(16384, rows - s), dim), generator=gen, device=dev)
        index[s : s + len(b)] = b / b.norm(dim=1, keepdim=True)
    q = torch.randn((4, dim), generator=gen, device=dev)
    q = q / q.norm(dim=1, keepdim=True)
    for j, at in enumerate((3, 131_072, 200_000, rows - 2)):  # past 2^32 bytes from 131,072 on
        for t in range(6):
            row = q[j] + 0.05 * (t + 1) * torch.randn(dim, generator=gen, device=dev) / dim**0.5
            index[at - t] = row / row.norm()
    for nq, k in ((1, 5), (4, 25)):
        d, i = topk_l2_streamed(q[:nq], index, k)
        torch.cuda.synchronize()
        ref_d, ref_i = exact_topk(q[:nq], index, k)
        gap = float((d.double().cpu() ** 2 - torch.from_numpy(ref_d) ** 2).abs().max())
        same = float((i.cpu().numpy() == ref_i).mean())
        print(f"K2 at {rows} x {dim}, Q {nq}, k {k}: max squared-distance gap {gap:.3e}, "
              f"ids equal {same:.4f}")
        assert gap < 1e-5  # 3xTF32 sums: 4-7e-6 of unit rows' squared distances
        assert (i.cpu().numpy()[:, :6] == ref_i[:, :6]).all()  # the planted neighbours


def _cell(name: str, seed: int):
    import json
    from pathlib import Path

    from benchmarks import run
    from benchmarks.harness import Cell

    workload = run.find_workload(name)
    work = run.ROOT / "_work" / name
    work.mkdir(parents=True, exist_ok=True)
    return Cell(name=name, config=run.find_config(workload["config"]),
                params=json.loads(json.dumps(workload["params"])), seed=seed, seconds=1.0,
                trace=False, device=_card(), work_dir=Path(work), started=0.0)


def _record(name: str, readings: dict) -> None:
    import json

    from benchmarks import run

    out = run.ROOT / "_work" / "controls"
    out.mkdir(parents=True, exist_ok=True)
    with open(out / f"{name}.jsonl", "a") as f:
        f.write(json.dumps(readings) + "\n")
    print(name, json.dumps(readings))


SEEDS = (2_147_483_659, 3_000_000_019, 4_000_000_007)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", ["search-phone-pitts250k", "search-fleet-pitts250k"])
def test_search_controls_fail(name, seed):
    """The controls (the int8 reference through int4, and its descriptors
    searched with TF32 products, each in the program's place) read over
    the cell's limits, on the cell's own index."""
    from benchmarks.traffic._search import control_readings

    cell = _cell(name, seed)
    readings = control_readings(cell, cell.params["images_per_request"], cell.params["k"])
    _record(name, dict(readings, seed=seed))
    limits = cell.params["limits"]
    for control in ("control_int4", "control_tf32_search"):
        assert any(readings[control][n] > limits[n] for n in limits), control


@pytest.mark.parametrize("seed", SEEDS)
def test_train_controls_fail(seed):
    """The control (the reference through float8, in the program's place)
    and the faults (the loss over half the batch, the update applied the
    other way, the miner's order reversed) read over the cell's limits."""
    from benchmarks.traffic.train_loop import control_readings

    cell = _cell("train-wms-toycity", seed)
    readings = control_readings(cell)
    _record("train-wms-toycity", dict(readings, seed=seed))
    limits = cell.params["limits"]
    for name in ("control_fp8", "fault_half_batch", "fault_negated_update",
                 "fault_reversed_order"):
        assert any(readings[name][n] > limits[n] for n in limits), name
    assert all(readings["program"][n] <= limits[n] for n in limits)
