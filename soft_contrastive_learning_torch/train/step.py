"""The embed step, the counterpart of
``soft_contrastive_learning_tpu/train/step.py::build_embed_step``. The
train and eval steps come with the training slice."""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from soft_contrastive_learning_torch.models.model import EmbeddingNet


def build_embed_step(
    model: EmbeddingNet,
) -> Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]:
    """Batch descriptor extraction: images -> (output, full_out), with no
    autograd state recorded. The model carries its config and parameters,
    which the JAX step takes as arguments."""
    model.eval()

    @torch.inference_mode()
    def embed(images: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return model(images)

    return embed
