"""Offline batch descriptor extraction, the counterpart of
``soft_contrastive_learning_tpu/evaluation/inference.py``
(``DescriptorExtractor`` with ``extract_images`` and ``extract_files``, and
``run_inference``).

``run_inference`` embeds a CSV image list (column ``path``, relative to an
image root) and dumps the feature matrix as ``{set}_{out_name}.pickle``,
float32 or float16: the raw descriptor with ``reduction`` ``none`` and
``pca`` (32,768-D for the flagship, which the top-N sweep whitens
downstream), the reduced output (FC, SPP) otherwise, as in JAX. Images are read by
the port's PNG decoder (``utils/io.py::load_img``), 4 batches at a time on
an 8-thread pool while the card embeds the batches before them; ``oxs``
sets, which the JAX package reads as JPEG, are refused by that decoder.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import List, Mapping, Sequence

import numpy as np
import torch

from soft_contrastive_learning_torch.core.config import ModelConfig, resolve_device
from soft_contrastive_learning_torch.data.pipeline import pad_to_multiple
from soft_contrastive_learning_torch.models.model import EmbeddingNet
from soft_contrastive_learning_torch.train.step import build_embed_step
from soft_contrastive_learning_torch.utils.cv import normalize_geometry
from soft_contrastive_learning_torch.utils.io import load_csv, load_img, save_pickle

DUMP_DTYPES = ("float32", "float16")


class DescriptorExtractor:
    """EmbeddingNet on ``device`` with ``params`` (a state_dict, see
    ``models/weights.py``), fed fixed-size uint8 batches. ``portrait``
    swaps the input's height and width; ``raw_descriptor`` returns the
    descriptor before the reduction head (``full_out``), else its output."""

    def __init__(
        self,
        cfg: ModelConfig,
        params: Mapping[str, torch.Tensor],
        batch_size: int = 32,
        device: str | torch.device = "cuda",
        portrait: bool = False,
        raw_descriptor: bool = True,
    ):
        self.cfg = cfg
        self.batch_size = batch_size
        self.device = resolve_device(device)
        self.portrait = portrait
        self.raw = raw_descriptor
        model = EmbeddingNet(cfg)
        model.load_state_dict(params)
        self._embed = build_embed_step(model.to(self.device))
        self._pool = ThreadPoolExecutor(max_workers=8)  # decode threads for extract_files

    def extract_images(self, images: Sequence[np.ndarray]) -> np.ndarray:
        prepared = [
            normalize_geometry(
                np.asarray(im), self.cfg.image_height, self.cfg.image_width,
                keep_aspect=self.cfg.vlad_cores > 0, portrait=self.portrait,
            )
            for im in images
        ]
        # uint8 on the wire; the model casts
        arr = np.stack(prepared).astype(np.uint8)
        n = len(arr)
        arr = pad_to_multiple(arr, self.batch_size)
        feats = []
        for start in range(0, len(arr), self.batch_size):
            x = torch.from_numpy(arr[start : start + self.batch_size]).to(self.device)
            output, full = self._embed(x)
            feats.append((full if self.raw else output).cpu().numpy())
        return np.concatenate(feats)[:n]

    def extract_files(self, paths: Sequence[str], img_root: str = "") -> np.ndarray:
        """Embed image files in chunks of 4 batches: the pool decodes the
        next chunk while the card embeds this one."""

        def load(p):
            return load_img(os.path.join(img_root, p))

        chunk = self.batch_size * 4
        out: List[np.ndarray] = []
        pending = self._pool.map(load, paths[:chunk]) if len(paths) else None
        for start in range(0, len(paths), chunk):
            images = list(pending)
            nxt = paths[start + chunk : start + 2 * chunk]
            pending = self._pool.map(load, nxt) if nxt else None
            out.append(self.extract_images(images))
        if out:
            return np.concatenate(out)
        dim = self.cfg.descriptor_dim if self.raw else self.cfg.output_dim
        return np.zeros((0, dim), np.float32)


def run_inference(
    cfg: ModelConfig,
    params: Mapping[str, torch.Tensor],
    set_name: str,
    csv_root: str,
    img_root: str,
    out_root: str,
    out_name: str,
    batch_size: int = 32,
    device: str | torch.device = "cuda",
    dump_dtype: str = "float32",
) -> str:
    """CSV image list -> feature pickle ``{set}_{out_name}.pickle``, the
    descriptors in ``dump_dtype`` (float16 halves the dump; descriptors are
    unit-norm, so it cannot overflow). As in the JAX package, ``oxs`` sets
    read ``.jpg`` in place of ``.png`` and ``achen`` sets are portrait."""
    if dump_dtype not in DUMP_DTYPES:
        raise ValueError(f"dump_dtype must be float32|float16, got {dump_dtype!r}")
    meta = load_csv(os.path.join(csv_root, f"{set_name}.csv"))
    paths = list(meta["path"])
    if "oxs" in set_name:
        paths = [p.replace(".png", ".jpg") for p in paths]
    extractor = DescriptorExtractor(
        cfg, params, batch_size=batch_size, device=device,
        portrait="achen" in set_name, raw_descriptor=cfg.reduction in ("none", "pca"))
    features = extractor.extract_files(paths, img_root)
    extractor._pool.shutdown(wait=False)
    features = features.astype(np.dtype(dump_dtype), copy=False)
    os.makedirs(out_root, exist_ok=True)
    out_path = os.path.join(out_root, f"{set_name}_{out_name}.pickle")
    save_pickle(features, out_path)
    return out_path
