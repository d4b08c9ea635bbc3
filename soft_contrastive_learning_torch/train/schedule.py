"""Learning-rate schedule, the counterpart of
``soft_contrastive_learning_tpu/train/schedule.py``: epoch-indexed
exponential decay with a floor, ``max(base * f^floor(epoch / freq), min)``.
The trainer writes it into the optimizer's ``param_groups`` each step."""

from __future__ import annotations

import math

from soft_contrastive_learning_torch.core.config import TrainConfig


def learning_rate(cfg: TrainConfig, epoch: float) -> float:
    decayed = cfg.base_lr * cfg.lr_down_factor ** math.floor(epoch / cfg.lr_down_frequency)
    return max(decayed, cfg.minimal_lr)
