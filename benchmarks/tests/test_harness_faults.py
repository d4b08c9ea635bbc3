"""A whole run of each kind of cell, at a tiny size on the CPU (the look
for a card skipped), comes out correct; with the timed path broken
underneath, in each way the cell can break, it comes out not correct."""

from __future__ import annotations

import json
from pathlib import Path

import pytest
import torch

from benchmarks.tests import tiny
from benchmarks.traffic import closed_loop_search, open_loop_search, train_loop

WORKLOADS = Path(__file__).resolve().parents[1] / "workloads"


def params(name, **over):
    return dict(json.loads((WORKLOADS / f"{name}.json").read_text())["params"], **over)


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    return tiny.upload_pool(tmp_path_factory.mktemp("uploads"))


def phone(pool, tmp_path):
    return open_loop_search.run(tiny.cell("phone", tiny.search_config(pool),
                                          params("search-phone-pitts250k", rate_per_s=6.0),
                                          tmp_path, seconds=1.0))


def fleet(pool, tmp_path):
    return closed_loop_search.run(tiny.cell(
        "fleet", tiny.search_config(pool),
        params("search-fleet-pitts250k", clients=3, images_per_request=4, k=5), tmp_path,
        seconds=1.0))


def _altered_distances(topk):
    def fn(q, refs, k):
        d, i = topk(q, refs, k)
        return d + 1e-2, i
    return fn


def _altered_ids(topk):
    def fn(q, refs, k):
        d, i = topk(q, refs, k)
        return d, torch.roll(i, 1, dims=1)
    return fn


def test_search_cells_are_correct(pool, tmp_path):
    for out in (phone(pool, tmp_path), fleet(pool, tmp_path)):
        assert out.correct, out.checks


@pytest.mark.parametrize("fault", ["distances", "ids"])
def test_altered_answers_fail(pool, tmp_path, monkeypatch, fault):
    from soft_contrastive_learning_torch import serving

    wrap = _altered_distances if fault == "distances" else _altered_ids
    monkeypatch.setattr(serving, "topk_l2", wrap(serving.topk_l2))
    assert not phone(pool, tmp_path).correct


def test_half_the_images_left_out_fails(pool, tmp_path, monkeypatch):
    from soft_contrastive_learning_torch.serving import DescriptorService

    search = DescriptorService.search
    monkeypatch.setattr(DescriptorService, "search",
                        lambda self, images, k=5: search(self, images[: len(images) // 2], k))
    out = fleet(pool, tmp_path)
    assert not out.correct and out.failed > 0


def _train(tmp_path):
    return train_loop.run(tiny.cell("train", tiny.train_config(),
                                    params("train-wms-toycity", warm_steps=4, mining_rows=4),
                                    tmp_path, seconds=4.0))


def test_train_cell_is_correct(tmp_path):
    out = _train(tmp_path)
    assert out.correct, out.checks


def test_unchanged_state_fails(tmp_path, monkeypatch):
    from soft_contrastive_learning_torch.train import trainer

    build = trainer.build_train_step

    def frozen(cfg, loss_fn, image_pool=False, mesh=None):
        step = build(cfg, loss_fn, image_pool=image_pool, mesh=mesh)

        def no_update(state, batch, pool=None):
            saved = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
            state, metrics = step(state, batch, pool)
            state.model.load_state_dict(saved)
            state.optimizer.state.clear()
            return state, metrics
        return no_update

    monkeypatch.setattr(trainer, "build_train_step", frozen)
    out = _train(tmp_path)
    assert not out.correct
    assert dict((n, v) for n, v, _ in out.checks)["change_gap"] == pytest.approx(1.0)


def test_half_the_batch_fails(tmp_path, monkeypatch):
    from soft_contrastive_learning_torch.losses import ms
    from soft_contrastive_learning_torch.losses.registry import LossResult
    from soft_contrastive_learning_torch.train import trainer

    def half_loss(cfg, tuples, tuples_per_batch):
        def fn(b, p, st=None):
            n = b.embeddings.shape[0] // 2
            geo = p["geo_dist_matrix"][:n, :n]
            return LossResult(ms.wms_loss(geo, b.embeddings[:n], d_alpha=cfg.alpha,
                                          d_beta=cfg.beta, ms_mining=True))
        return fn

    monkeypatch.setattr(trainer, "build_loss", half_loss)
    out = _train(tmp_path)
    assert not out.correct
    assert dict((n, v) for n, v, _ in out.checks)["loss_gap"] > 0.05


def test_negated_update_fails(tmp_path, monkeypatch):
    """Adam's update applied the other way (``maximize``): every leaf's norm
    of change is the same, its direction is not."""
    class Negated(torch.optim.Adam):
        def __init__(self, params, **kwargs):
            super().__init__(params, maximize=True, **kwargs)

    monkeypatch.setattr(torch.optim, "Adam", Negated)
    out = _train(tmp_path)
    assert not out.correct
    assert dict((n, v) for n, v, _ in out.checks)["sign_median_gap"] > 0.9


def test_reversed_neighbour_order_fails(tmp_path, monkeypatch):
    """The miner's order farthest first: the hard positives and negatives
    picked from the wrong end of the cache."""
    from soft_contrastive_learning_torch.train import mining_manager

    order = mining_manager.neighbor_order
    monkeypatch.setattr(mining_manager, "neighbor_order", lambda f: order(f).flip(1))
    out = _train(tmp_path)
    checks = {n: (v, lim) for n, v, lim in out.checks}
    assert not out.correct and checks["order_gap"][0] > checks["order_gap"][1]


def test_traced_run_reads_the_host_metrics(pool, tmp_path):
    """A traced run on the CPU: the readers of spans and counts give their
    numbers; those of the device trace find nothing and are left out."""
    from benchmarks import run

    bench = run.load_json(run.REPO / "BENCHMARK.json")
    name = "search-fleet-pitts250k"
    out = closed_loop_search.run(tiny.cell(
        name, tiny.search_config(pool),
        params(name, clients=3, images_per_request=4, k=5), tmp_path, seconds=1.0, trace=True))
    line = run.result_line(out, run.cell_metrics(bench, name, True), True, {"platform": "cpu"},
                           name)
    assert out.correct
    assert {"decode_ms.fleet", "embed_ms.fleet", "mfu.fleet"} <= set(line["metrics"])
    assert not {"k2_roofline.fleet", "device_idle.fleet"} & set(line["metrics"])
    assert line["metrics"]["decode_ms.fleet"]["value"] > 0
    assert run.find_reader("lock_wait_ms.phone").read("lock_wait_ms.phone", out.readings) >= 0
