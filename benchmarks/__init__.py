"""The benchmark of the PyTorch/CUDA port (``soft_contrastive_learning_torch``).

One command runs one cell::

    python3 -m benchmarks.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything is found by name: ``workloads/<cell>.json`` (the cell: its
configuration, its traffic kind and that traffic's parameters),
``configs/<config>.json`` (the configuration as it is run),
``traffic/<kind>.py`` (the generator and the measured window of each kind
of traffic), ``metrics/<metric>.py`` (the reader of each per-layer metric;
``lock_wait_ms.phone`` is read by ``metrics/lock_wait_ms.py``), and
``BENCHMARK.json`` at the repository's root says which metrics each cell
reports. ``roofline.py`` holds the peaks and each kernel's operations and
bytes; ``reference/`` the plain implementation that decides ``correct``.
Nothing here imports JAX or the JAX package.
"""
