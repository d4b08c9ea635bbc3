"""Where a 2-rank run resumed on one card parts from its uninterrupted run.

The flagship at full width (chip_smoke.py's md_train_config: fp32 convs,
B = 50, 25 images a rank, fused wms, 12 steps with a part checkpoint at
step 8) on two gloo ranks that share one card, run as chip_smoke.py's
multidevice phase runs it. Each rank reports, as max-abs gaps:

* ``restore``: the state a fresh Trainer resumes from part@8 (parameters,
  Adam's moments and counts, the step, the dropout generator) against the
  uninterrupted run's state just before its step 8;
* ``rerun``: a second uninterrupted run against the first (the run-to-run
  floor), and ``resumed``: the resumed run's final parameters against the
  first run's;
* ``step_repeat``: one step (step 8's batch, from step 8's state) taken 3
  times, each result against the first, with cuDNN's default algorithms
  and with ``torch.backends.cudnn.deterministic``;
* the same ``rerun`` and ``resumed`` with ``cudnn.deterministic`` on;
* ``step_ms``: the median host time of those repeated steps between two
  synchronizations, after one warm-up, per mode (the two modes in turns:
  default, deterministic, deterministic, default).

Run from the repository root on a machine with a CUDA card:

    python3 scripts/torch_resume_gap.py

It prints the card's name and power limit and one JSON line, and writes
``chiprun_out/resume_gap.json``.
"""

from __future__ import annotations

import copy
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
REPEATS = 3
RESUME_STEP = 8


def snapshot(state):
    """A copy of a TrainState's parameters, optimizer state, step and
    generator."""
    return dict(model={k: v.detach().clone() for k, v in state.model.state_dict().items()},
                opt=copy.deepcopy(state.optimizer.state_dict()), step=state.step,
                rng=state.rng.get_state().clone() if state.rng is not None else None)


def gap(a, b) -> float:
    """The largest absolute difference between two snapshots (or two
    parameter dicts): every tensor of each, and the steps."""
    import torch

    if "model" not in a:
        return max(float((a[k].double() - b[k].double()).abs().max()) for k in a)
    out = gap(a["model"], b["model"])
    for pa, pb in zip(a["opt"]["state"].values(), b["opt"]["state"].values()):
        for key in pa:
            out = max(out, float((torch.as_tensor(pa[key]).double()
                                  - torch.as_tensor(pb[key]).double()).abs().max()))
    if a["step"] != b["step"]:
        out = float("inf")
    if a["rng"] is not None and not torch.equal(a["rng"], b["rng"]):
        out = float("inf")
    return out


def rank_main(mesh, out_dir):
    import torch

    import chip_smoke as cs
    from soft_contrastive_learning_torch.losses.registry import build_loss
    from soft_contrastive_learning_torch.models.model import EmbeddingNet
    from soft_contrastive_learning_torch.models.weights import load_trained_params
    from soft_contrastive_learning_torch.train.step import build_train_step, init_train_state
    from soft_contrastive_learning_torch.train.trainer import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = cs.md_train_config()
    params = load_trained_params(cfg=cfg.model)
    source = cs.toy_city()

    def run(sub, resume=False, keep=None):
        tr = Trainer(cfg, source, out_dir=os.path.join(out_dir, sub), params=params, mesh=mesh)
        restored = None
        if resume:
            if not tr.resume_latest("part") or tr.global_step != RESUME_STEP:
                raise RuntimeError(f"resume from part@{RESUME_STEP} failed: {tr.global_step}")
            restored = snapshot(tr.state)
        step = tr.train_step_pooled

        def watched(state, batch, pool):
            if keep is not None and state.step == RESUME_STEP and "state" not in keep:
                keep.update(state=snapshot(state), pool=pool,
                            batch={k: v.clone() if torch.is_tensor(v) else v
                                   for k, v in batch.items()})
            return step(state, batch, pool)

        tr.train_step_pooled = watched
        tr._ensure_image_pool(source.epoch_meta(cfg.local_ref_set, 0))
        tr.train()
        tr.close()
        final = {k: v.detach().clone() for k, v in tr.state.model.state_dict().items()}
        return final, restored

    def step_repeats(keep, deterministic):
        torch.backends.cudnn.deterministic = deterministic
        snap, outs, times = keep["state"], [], []
        for _ in range(REPEATS + 1):
            model = EmbeddingNet(cfg.model)
            model.load_state_dict(snap["model"])
            state = init_train_state(cfg, model.to(mesh.device))
            state.optimizer.load_state_dict(copy.deepcopy(snap["opt"]))
            state.step = snap["step"]
            state.rng.set_state(snap["rng"])
            step = build_train_step(cfg, build_loss(cfg.loss, cfg.tuples, cfg.tuples_per_batch),
                                    image_pool=True, mesh=mesh)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, _ = step(state, dict(keep["batch"]), keep["pool"])
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
            outs.append({k: v.detach().clone() for k, v in state.model.state_dict().items()})
        torch.backends.cudnn.deterministic = False
        outs = outs[1:]  # the first step warms up
        return max(gap(outs[0], o) for o in outs[1:]), statistics.median(times[1:])

    result, keeps = {"rank": mesh.rank}, {}
    for mode, det in (("default", False), ("cudnn_deterministic", True)):
        torch.backends.cudnn.deterministic = det
        keeps[mode] = keep = {}
        first, _ = run(f"{mode}_a", keep=keep)
        second, _ = run(f"{mode}_b")
        resumed, restored = run(f"{mode}_a", resume=True)
        torch.backends.cudnn.deterministic = False
        result[mode] = dict(restore=gap(restored, keep["state"]), rerun=gap(first, second),
                            resumed=gap(first, resumed), step_ms=[])
    for mode, det in (("default", False), ("cudnn_deterministic", True),
                      ("cudnn_deterministic", True), ("default", False)):
        repeat, ms = step_repeats(keeps[mode], det)
        result[mode]["step_repeat"] = max(result[mode].get("step_repeat", 0.0), repeat)
        result[mode]["step_ms"].append(ms)
    return result


def main() -> int:
    import torch

    from soft_contrastive_learning_torch.launch.multihost import run_ranks

    if not torch.cuda.is_available():
        print("no CUDA card")
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip())
    with tempfile.TemporaryDirectory(prefix="scl_resume_gap_") as out_dir:
        ranks = run_ranks("torch_resume_gap.rank_main", 2, (out_dir,), device="cuda",
                          timeout_s=1200)
    line = {"card": smi.stdout.strip(), "ranks": ranks}
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "resume_gap.json"), "w") as f:
        json.dump(line, f, indent=1)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
