"""The port's job launcher (``launch/jobs.py``) and ``cli metrics`` on the
CPU, against JAX's: the SGE and Slurm scripts of one ``JobSpec``, a
rendered job apart from its entry point, ``train --task_id -1``'s
self-submission, and the metrics summary of one run directory."""

import argparse
import os
import shlex

import pytest

from soft_contrastive_learning_tpu import cli as jax_cli
from soft_contrastive_learning_tpu.launch import jobs as jjobs
from soft_contrastive_learning_torch import cli
from soft_contrastive_learning_torch.core.logging import MetricsWriter
from soft_contrastive_learning_torch.launch import jobs as tjobs

SPECS = [
    dict(script="/opt/x/cli.py", script_parameters=(("loss", "wms"), ("base_lr", 5e-6),
                                                    ("resume", True), ("save_plots", False),
                                                    ("out_folder", "a b"), ("seed", None)),
         positional_args=("train",), out_dir="runs/job", name="train_wms", queue="48h"),
    dict(script="s.py", out_dir="runs/x", name="n", cpu_only=True, num_cpu_cores=4,
         memory_gb=8, hostname="node*", array=True, num_jobs=3, task_flag="task"),
    dict(script="s.py", out_dir="o", gpu=2, array=True, num_jobs=7),
]


@pytest.mark.parametrize("spec", SPECS, ids=["train", "cpu_array", "gpu_array"])
def test_sge_and_slurm_scripts_equal_jax_s(spec):
    ours, theirs = tjobs.JobSpec(**spec), jjobs.JobSpec(**spec)
    assert tjobs._sge_script(ours) == jjobs._sge_script(theirs)
    assert tjobs._slurm_script(ours) == jjobs._slurm_script(theirs)
    assert ours.rendered_command(" --task_id 3") == theirs.rendered_command(" --task_id 3")


@pytest.mark.parametrize("backend", ["sge", "slurm"])
def test_run_one_job_equals_jax_s_apart_from_the_entry_point(tmp_path, backend):
    """Each package freezes its own CLI; the rendered scripts differ only in
    that file's name."""
    made = {}
    for name, mod, script in (("port", tjobs, cli.__file__), ("jax", jjobs, jax_cli.__file__)):
        out_dir = str(tmp_path / "job")
        submitted = []
        path = mod.run_one_job(script, [("loss", "wms"), ("max_epoch", 2)],
                               positional_args=("train",), out_dir=out_dir, overwrite=True,
                               array=True, num_jobs=2, backend=backend,
                               submit=submitted.append)
        assert submitted == [path] and os.path.basename(path) == (
            "qsub.sh" if backend == "sge" else "sbatch.sh")
        frozen = os.path.join(out_dir, os.path.basename(script))
        assert open(frozen).read() == open(script).read() and os.access(frozen, os.X_OK)
        made[name] = open(path).read()
    assert made["port"] == made["jax"]  # both freeze a cli.py into the same run dir
    assert tjobs.run_one_job(cli.__file__, out_dir=str(tmp_path / "job")) is None  # exists


def test_local_array_run():
    seen = []
    tjobs.local_array_run(seen.append, 5)
    assert seen == [1, 2, 3, 4, 5]


def test_train_task_id_minus_one_submits_this_cli(tmp_path, monkeypatch):
    """``train --task_id -1`` freezes the port's cli.py and renders
    ``python cli.py train <flags> --task_id $SGE_TASK_ID``; the rendered
    flags parse back to the given ones."""
    calls = []
    monkeypatch.setattr(tjobs.subprocess, "call", lambda argv: calls.append(argv) or 0)
    given = ["train", "--toy_city", "--out_root", str(tmp_path), "--loss", "wms",
             "--async_mining", "true", "--device_image_pool", "false", "--max_epoch", "2",
             "--device", "cpu"]
    assert cli.main(given + ["--task_id", "-1", "--queue", "24h"]) == 0
    out_dir = tmp_path / cli.config_from_args(cli.build_parser().parse_args(given)).encode_name()
    script = (out_dir / "qsub.sh").read_text()
    assert calls == [["qsub", str(out_dir / "qsub.sh")]]
    assert (out_dir / "cli.py").read_text() == open(cli.__file__).read()
    assert "#$ -q 24h" in script and "#$ -t 1-1" in script
    run = script.strip().splitlines()[-1]
    argv = shlex.split(run)
    assert argv[:3] == ["python", os.path.abspath(out_dir / "cli.py"), "train"]
    assert argv[-2:] == ["--task_id", "$SGE_TASK_ID"]
    rendered = vars(cli.build_parser().parse_args(argv[2:-2]))
    want = vars(cli.build_parser().parse_args(given + ["--queue", "24h"]))
    assert rendered.pop("out_folder") == out_dir.name and want.pop("out_folder") == ""
    assert rendered == want


def _metrics_run(run_dir):
    for role in ("local", "other"):
        mw = MetricsWriter(str(run_dir), role=role)
        for step in range(1, 4):
            mw.scalars({"loss": 1.0 / step, "learning_rate": 5e-6}, step)
        mw.scalars({"%<25m@Top1": 75.0}, 3)
    with open(run_dir / "metrics_local.jsonl", "a") as f:
        f.write("\n{truncated")  # a blank and a torn last line are skipped


def test_cli_metrics_prints_what_jax_s_prints(tmp_path, capsys):
    _metrics_run(tmp_path)
    assert cli.main(["metrics", "--run_dir", str(tmp_path)]) == 0
    ours = capsys.readouterr().out
    assert jax_cli.main(["metrics", "--run_dir", str(tmp_path)]) == 0
    theirs = capsys.readouterr().out
    assert ours == theirs and "[local] loss: n=3 last=0.333333 min=0.333333 max=1" in ours
    empty = tmp_path / "empty"
    empty.mkdir()
    assert cli.main(["metrics", "--run_dir", str(empty)]) == 1
    assert capsys.readouterr().out == "no metrics found\n"


def test_cli_metrics_and_cache_flags_are_jax_s():
    """The parsers of ``metrics`` and ``cache`` take JAX's flags with JAX's
    defaults."""
    def defaults(parser, command):
        sub = next(a for a in parser._actions if isinstance(a, argparse._SubParsersAction))
        return {a.dest: a.default for a in sub.choices[command]._actions
                if a.dest not in ("help", "func")}

    captured = {}
    real = argparse.ArgumentParser.parse_args

    def keep(self, *a, **k):
        captured.setdefault("parser", self)
        raise SystemExit(0)

    argparse.ArgumentParser.parse_args = keep
    try:
        with pytest.raises(SystemExit):
            jax_cli.main(["metrics"])
    finally:
        argparse.ArgumentParser.parse_args = real
    for command in ("metrics", "cache"):
        assert defaults(cli.build_parser(), command) == defaults(captured["parser"], command)
