"""Offline batch descriptor extraction, the counterpart of
``soft_contrastive_learning_tpu/evaluation/inference.py``
(``DescriptorExtractor`` with ``extract_images`` and ``extract_files``, and
``run_inference``).

``run_inference`` embeds a CSV image list (column ``path``, relative to an
image root) and dumps the feature matrix as ``{set}_{out_name}.pickle``,
float32 or float16: the raw descriptor with ``reduction`` ``none`` and
``pca`` (32,768-D for the flagship, which the top-N sweep whitens
downstream), the reduced output (FC, SPP) otherwise, as in JAX. Images are read by
the port's codecs (``utils/io.py``: PNG on the host, JPEG on the
extractor's device) in chunks of 4 batches while the card embeds the chunk
before: an 8-thread pool reads and entropy-decodes a chunk's files
(``prepare_img``), then one J1 launch on the JPEG decoder's own stream
turns the chunk's JPEGs into pixels (``finish_imgs``, on a thread of its
own, so that it does not wait for the model); ``oxs`` sets are read as
``.jpg``, as the JAX package reads them.
With a mesh (``parallel/mesh.py``) each padded batch is split over the
ranks: each rank embeds its rows on its device and the descriptors are
gathered in rank order, so every rank returns the whole output, as JAX's
replicated result.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import List, Mapping, Optional, Sequence

import numpy as np
import torch

from soft_contrastive_learning_torch.core.config import (
    ModelConfig, indexed_device, resolve_device)
from soft_contrastive_learning_torch.data.pipeline import pad_to_multiple
from soft_contrastive_learning_torch.models.model import EmbeddingNet
from soft_contrastive_learning_torch.parallel.mesh import Mesh, all_gather_rows, shard_batch
from soft_contrastive_learning_torch.train.step import build_embed_step
from soft_contrastive_learning_torch.utils.cv import normalize_geometry
from soft_contrastive_learning_torch.utils.io import (
    finish_imgs, load_csv, prepare_img, save_pickle)

DUMP_DTYPES = ("float32", "float16")


class DescriptorExtractor:
    """EmbeddingNet on ``device`` with ``params`` (a state_dict, see
    ``models/weights.py``), fed fixed-size uint8 batches. ``portrait``
    swaps the input's height and width; ``raw_descriptor`` returns the
    descriptor before the reduction head (``full_out``), else its output.
    With ``quant_scales`` (``models/quant.py``'s activation scales) it
    embeds through ``QuantizedEmbedder``, the int8-PTQ conv stack (Q1 on a
    CUDA device), with the weights quantized once here. ``mesh``: the
    batches are split over its ranks (module docstring), each rank on the
    mesh's device; ``batch_size`` must divide over them."""

    def __init__(
        self,
        cfg: ModelConfig,
        params: Mapping[str, torch.Tensor],
        batch_size: int = 32,
        device: str | torch.device = "cuda",
        portrait: bool = False,
        raw_descriptor: bool = True,
        quant_scales: Optional[Mapping[str, float]] = None,
        mesh: Optional[Mesh] = None,
    ):
        self.cfg = cfg
        self.batch_size = batch_size
        self.mesh = mesh
        if mesh is not None:
            mesh.rows(batch_size)  # raises unless the batch divides over the ranks
        # indexed: the decode threads' current device is cuda:0
        self.device = mesh.device if mesh is not None else indexed_device(resolve_device(device))
        self.portrait = portrait
        self.raw = raw_descriptor
        if quant_scales is not None:
            from soft_contrastive_learning_torch.models.quant import QuantizedEmbedder

            self._embed = QuantizedEmbedder(cfg, params, scales=dict(quant_scales),
                                            device=self.device).embed
        else:
            model = EmbeddingNet(cfg)
            model.load_state_dict(params)
            self._embed = build_embed_step(model.to(self.device))
        self._pool = ThreadPoolExecutor(max_workers=8)  # decode threads for extract_files
        self._pixels = ThreadPoolExecutor(max_workers=1)  # a chunk's J1 launch and download

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
            x = shard_batch(arr[start : start + self.batch_size], self.mesh)
            output, full = self._embed(torch.from_numpy(x).to(self.device))
            feats.append(all_gather_rows(full if self.raw else output, self.mesh).cpu().numpy())
        return np.concatenate(feats)[:n]

    def extract_files(self, paths: Sequence[str], img_root: str = "") -> np.ndarray:
        """Embed image files in chunks of 4 batches: the pool reads and
        entropy-decodes the next chunk, and J1 turns its JPEGs into pixels
        in one launch, while the card embeds this one. A refused file
        raises, naming it, as JAX's ``load_img`` does."""

        def prepare(p):
            path = os.path.join(img_root, p)
            with open(path, "rb") as f:
                return prepare_img(f.read(), path, self.device, source="file")

        def decode(chunk):
            return finish_imgs(list(self._pool.map(prepare, chunk)), self.device)

        chunk = self.batch_size * 4
        out: List[np.ndarray] = []
        pending = self._pixels.submit(decode, paths[:chunk]) if len(paths) else None
        for start in range(0, len(paths), chunk):
            images = pending.result()
            nxt = paths[start + chunk : start + 2 * chunk]
            pending = self._pixels.submit(decode, nxt) if nxt else None
            out.append(self.extract_images(images))
        if out:
            return np.concatenate(out)
        dim = self.cfg.descriptor_dim if self.raw else self.cfg.output_dim
        return np.zeros((0, dim), np.float32)

    def close(self) -> None:
        """Let the decode threads go (without waiting)."""
        self._pool.shutdown(wait=False)
        self._pixels.shutdown(wait=False)


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
    mesh: Optional[Mesh] = None,
) -> str:
    """CSV image list -> feature pickle ``{set}_{out_name}.pickle``, the
    descriptors in ``dump_dtype`` (float16 halves the dump; descriptors are
    unit-norm, so it cannot overflow). As in the JAX package, ``oxs`` sets
    read ``.jpg`` in place of ``.png`` and ``achen`` sets are portrait.
    ``mesh``: the embedding is split over its ranks, and only the primary
    (rank 0) writes the dump; every rank returns its path."""
    if dump_dtype not in DUMP_DTYPES:
        raise ValueError(f"dump_dtype must be float32|float16, got {dump_dtype!r}")
    meta = load_csv(os.path.join(csv_root, f"{set_name}.csv"))
    paths = list(meta["path"])
    if "oxs" in set_name:
        paths = [p.replace(".png", ".jpg") for p in paths]
    extractor = DescriptorExtractor(
        cfg, params, batch_size=batch_size, device=device,
        portrait="achen" in set_name, raw_descriptor=cfg.reduction in ("none", "pca"), mesh=mesh)
    features = extractor.extract_files(paths, img_root)
    extractor.close()
    features = features.astype(np.dtype(dump_dtype), copy=False)
    out_path = os.path.join(out_root, f"{set_name}_{out_name}.pickle")
    if mesh is None or mesh.rank == 0:
        os.makedirs(out_root, exist_ok=True)
        save_pickle(features, out_path)
    return out_path
