"""Job launching: ``jobs.py`` (SGE and Slurm scripts, local arrays) and
``multihost.py`` (the ranks of a data-parallel run)."""

from soft_contrastive_learning_torch.launch.jobs import (  # noqa: F401
    JobSpec,
    local_array_run,
    run_one_job,
)
