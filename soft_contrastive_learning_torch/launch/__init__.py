"""Job launching: ``jobs.py`` (SGE and Slurm scripts, local arrays). JAX's
``launch/multihost.py`` (the multi-host bootstrap) is not ported yet."""

from soft_contrastive_learning_torch.launch.jobs import (  # noqa: F401
    JobSpec,
    local_array_run,
    run_one_job,
)
