"""Cluster job launcher. Own copy of
``soft_contrastive_learning_tpu/launch/jobs.py`` (the port imports nothing
of the JAX package; the module is pure Python), the same scripts for the
same ``JobSpec``.

``run_one_job`` copies the script into the run directory (so that a queued
job does not see later edits of the source), renders a submission script
with the resource requests, and submits it. Parameters become flags; an
array job shards its work by a task-id flag. Backends:

* ``sge``: qsub scripts (GPU or CPU, single or array),
* ``slurm``: sbatch scripts with the same meaning,
* ``local_array_run``: the array on this host, serially or on a process
  pool.

``cli train --task_id -1`` submits the port's own ``cli.py`` this way.
"""

from __future__ import annotations

import os
import shlex
import subprocess
from dataclasses import dataclass
from shutil import copyfile, rmtree
from typing import Callable, Optional, Sequence, Tuple


@dataclass
class JobSpec:
    script: str
    script_parameters: Sequence[Tuple[str, object]] = ()
    positional_args: Sequence[str] = ()  # e.g. a CLI subcommand like 'train'
    out_dir: str = "runs/job"
    name: str = ""
    queue: str = "middle"  # CPU: short/middle/long; GPU: 2h/24h/48h/5d
    cpu_only: bool = False
    gpu: int = 1
    num_cpu_cores: int = 1
    memory_gb: int = 50
    hostname: str = "*"
    array: bool = False
    num_jobs: int = 10
    task_flag: str = "task_id"

    def rendered_command(self, extra: str = "") -> str:
        """Shell-safe command line: values are quoted; booleans render as
        bare flags when True (argparse store_true) and are omitted when
        False/None/empty."""
        parts = [shlex.quote(os.path.abspath(
            os.path.join(self.out_dir, os.path.basename(self.script))))]
        parts += [shlex.quote(str(a)) for a in self.positional_args]
        for k, v in self.script_parameters:
            if v is None or v == "" or v is False:
                continue
            if v is True:
                parts.append(f"--{k}")
            else:
                parts.append(f"--{k} {shlex.quote(str(v))}")
        return " ".join(parts) + extra


def _sge_script(spec: JobSpec) -> str:
    lines = [
        "#!/bin/bash",
        f"#$ -N {spec.name}",
        "#$ -cwd",  # SGE defaults to $HOME; frozen-script/log paths assume cwd
        f"#$ -o {os.path.abspath(spec.out_dir)}",
        f"#$ -e {os.path.abspath(spec.out_dir)}",
        f"#$ -q {spec.queue}",
        f"#$ -l h_vmem={spec.memory_gb}G",
        f"#$ -l hostname={spec.hostname}",
    ]
    if not spec.cpu_only:
        lines.append(f"#$ -l gpu={spec.gpu}")
    if spec.num_cpu_cores > 1:
        lines.append(f"#$ -pe multicore {spec.num_cpu_cores}")
    if spec.array:
        lines.append(f"#$ -t 1-{spec.num_jobs}")
        run = f"python {spec.rendered_command(f' --{spec.task_flag} $SGE_TASK_ID')}"
    else:
        run = f"python {spec.rendered_command()}"
    lines += ["set -e", run]
    return "\n".join(lines) + "\n"


def _slurm_script(spec: JobSpec) -> str:
    lines = [
        "#!/bin/bash",
        f"#SBATCH --job-name={spec.name}",
        f"#SBATCH --output={spec.out_dir}/%j.out",
        f"#SBATCH --mem={spec.memory_gb}G",
        f"#SBATCH --cpus-per-task={max(spec.num_cpu_cores, 1)}",
    ]
    if not spec.cpu_only:
        lines.append(f"#SBATCH --gres=gpu:{spec.gpu}")
    if spec.array:
        lines.append(f"#SBATCH --array=1-{spec.num_jobs}")
        run = f"python {spec.rendered_command(f' --{spec.task_flag} $SLURM_ARRAY_TASK_ID')}"
    else:
        run = f"python {spec.rendered_command()}"
    lines += ["set -e", run]
    return "\n".join(lines) + "\n"


def run_one_job(
    script: str,
    script_parameters: Sequence[Tuple[str, object]] = (),
    positional_args: Sequence[str] = (),
    queue: str = "middle",
    out_dir: str = "runs/job",
    gpu: int = 1,
    hostname: str = "*",
    cpu_only: bool = False,
    array: bool = False,
    num_jobs: int = 10,
    name: str = "",
    memory: int = 50,
    overwrite: bool = False,
    hold_off: bool = False,
    num_cpu_cores: int = 1,
    backend: str = "sge",
    submit: Optional[Callable[[str], int]] = None,
) -> Optional[str]:
    """Render (and unless ``hold_off`` submit) the job. Returns the path of
    the rendered submission script, or None if the run dir exists and
    overwrite is off."""
    if os.path.exists(out_dir):
        if not overwrite:
            print(f"Experiment already exists: {out_dir} Will not re-run.")
            return None
        rmtree(out_dir)
    os.makedirs(out_dir)

    if not name:
        name = (
            os.path.basename(os.path.dirname(out_dir))
            + "_"
            + os.path.basename(out_dir)
        )
    # Freeze the script so queued jobs ignore later source edits.
    frozen = os.path.join(out_dir, os.path.basename(script))
    copyfile(script, frozen)
    os.chmod(frozen, 0o755)

    spec = JobSpec(
        script=script, script_parameters=tuple(script_parameters),
        positional_args=tuple(positional_args),
        out_dir=out_dir, name=name, queue=queue, cpu_only=cpu_only, gpu=gpu,
        num_cpu_cores=num_cpu_cores, memory_gb=memory, hostname=hostname,
        array=array, num_jobs=num_jobs,
    )
    if backend == "sge":
        text, submit_cmd = _sge_script(spec), "qsub"
    elif backend == "slurm":
        text, submit_cmd = _slurm_script(spec), "sbatch"
    else:
        raise ValueError(f"unknown backend {backend!r}")

    sub_path = os.path.join(out_dir, f"{submit_cmd}.sh")
    with open(sub_path, "w") as f:
        f.write(text)
    os.chmod(sub_path, 0o755)

    if not hold_off:
        if submit is None:
            def submit(p):
                try:
                    return subprocess.call([submit_cmd, p])
                except FileNotFoundError:
                    print(
                        f"{submit_cmd} not available on this host; "
                        f"submission script rendered at {p}"
                    )
                    return 127
        submit(sub_path)
    return sub_path


def local_array_run(
    fn: Callable[[int], None], num_jobs: int, processes: int = 0
) -> None:
    """Run an array job on this host: fn(task_id) for task_id in 1..num_jobs,
    serially or with a process pool (spawned: ``fn`` must be importable)."""
    if processes <= 1:
        for task_id in range(1, num_jobs + 1):
            fn(task_id)
        return
    import multiprocessing as mp

    with mp.get_context("spawn").Pool(processes) as pool:
        pool.map(fn, range(1, num_jobs + 1))
