"""The probe scripts of the port: what rate a hand-written kernel reaches
beside the library's matmul, and where the Winograd kernel's time goes.

Counterparts of the probe scripts under ``perf/``, with their names:
``mxu_probe`` (resident and blocked products), ``mxu_probe2`` (the large
blocked product, tile sweep; also the larger-block sweep of
``perf/mxu_probe3.py``), ``mxu_probe4`` (int8 beside bf16), ``matmul_probe``
(the Winograd kernel's product shapes) and ``winograd_ablate`` (the Winograd
kernel stage by stage). Each runs as

    python -m soft_contrastive_learning_torch.perf.<name> [--device cuda] [--reps N]

on the card unless ``--device cpu`` is given; on the CPU it runs the plain
versions at a small size and prints no rate. Shared helpers are in
``perf/common.py``.
"""
