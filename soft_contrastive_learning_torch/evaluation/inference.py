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

The int8 embed on a card without a mesh runs as one CUDA graph a batch
(``EmbedGraph``): its 18 hand-kernel launches (Q1_stem, 12 Q1, 4 Q1_pool,
K1), the torch ops between them (the channel L2 norm, the casts, NetVLAD's
assignment product) and both copies, captured once at a padded batch shape
from static buffers, the input staged in pinned host memory and the
descriptors read back into pinned memory. The extractor captures the shape
its geometry gives when it is built, and any other on first use (at most
``MAX_GRAPHS``, the oldest dropped). The float path, the mesh and the CPU
run eagerly.

The extractor's ``timer`` (``core/logging.py::StepTimer``) spans each
``extract_images``: ``embed.prep`` (geometry; on the eager path also the
stack and the padding to the batch) and ``embed.device`` (the upload, the
model's launches and the download to the host; on the graph path the
rows written into the staging buffer, the replay, the wait and the copy of
the rows asked for), and counts its images (``embed.images``), the padding
rows the model runs besides them (``embed.padded``), and per batch the
graph's replays (``embed.graph_replays``: 1 a batch replayed, 0 an eager
batch) and its captures (``embed.graph_captures``).
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from soft_contrastive_learning_torch.core.config import (
    ModelConfig, indexed_device, resolve_device)
from soft_contrastive_learning_torch.core.logging import StepTimer
from soft_contrastive_learning_torch.data.pipeline import pad_to_multiple
from soft_contrastive_learning_torch.models.model import EmbeddingNet
from soft_contrastive_learning_torch.ops.kernels import _build
from soft_contrastive_learning_torch.parallel.mesh import Mesh, all_gather_rows, shard_batch
from soft_contrastive_learning_torch.train.step import build_embed_step
from soft_contrastive_learning_torch.utils.cv import normalize_geometry
from soft_contrastive_learning_torch.utils.io import (
    finish_imgs, load_csv, prepare_img, save_pickle)

DUMP_DTYPES = ("float32", "float16")
MAX_GRAPHS = 4  # batch shapes an extractor keeps a captured embed of


class EmbedGraph:
    """The embed ``embed`` (images -> (output, full_out)) of one uint8 batch
    ``shape`` (B, H, W, C) on a CUDA ``device``, captured as one CUDA graph
    with its static buffers: a pinned host input, its device copy, the
    graph's outputs and a pinned host copy of the rows returned (``full_out``
    with ``raw``, else ``output``). The kernels' tensor maps hold the
    buffers' addresses, so every replay goes through these buffers.

    One eager call on a side stream first settles what a capture cannot
    do (library loads, kernel attributes, cuBLAS handles); it launches its
    kernels as any call does. The capture launches nothing: its kernel
    launches are recorded (``_build.recorded_launches``) and each replay
    counts them on the wrappers. Not thread-safe: the caller holds a lock
    around ``run``."""

    def __init__(self, embed: Callable, raw: bool, shape: Tuple[int, ...],
                 device: torch.device):
        self.device = device
        self.host_in = torch.zeros(shape, dtype=torch.uint8, pin_memory=True)
        self.rows_in = self.host_in.numpy()
        with torch.cuda.device(device):
            self.dev_in = torch.empty(shape, dtype=torch.uint8, device=device)
            side = torch.cuda.Stream(device)
            side.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(side):
                self.dev_in.copy_(self.host_in, non_blocking=True)
                out = embed(self.dev_in)[1 if raw else 0]
            torch.cuda.current_stream(device).wait_stream(side)
            self.host_out = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
            self.rows_out = self.host_out.numpy()
            self.graph = torch.cuda.CUDAGraph()
            # on the side stream (one of this device); thread_local: the
            # service's other threads decode on the card meanwhile
            with _build.recorded_launches() as self.launches, \
                    torch.cuda.graph(self.graph, stream=side, capture_error_mode="thread_local"):
                self.dev_in.copy_(self.host_in, non_blocking=True)
                self.host_out.copy_(embed(self.dev_in)[1 if raw else 0], non_blocking=True)
            self.done = torch.cuda.Event()

    def run(self, rows: Sequence[np.ndarray], pad: np.ndarray) -> np.ndarray:
        """The embed of ``rows`` (at most B images of the batch's (H, W, C),
        cast to uint8 as ``astype`` casts), the batch's remaining rows
        ``pad``: a copy of their rows of the output."""
        m = len(rows)
        for i, im in enumerate(rows):
            self.rows_in[i] = im
        self.rows_in[m:] = pad
        with torch.cuda.device(self.device):
            self.graph.replay()
            self.done.record()
        self.done.synchronize()
        for wrapper, n in self.launches.items():
            _build.count_launch(wrapper, n)
        return self.rows_out[:m].copy()


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
        self.timer = StepTimer()
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
        # the int8 embed on a card without a mesh: CUDA graphs by batch shape
        self._graphs: Optional[OrderedDict] = None
        if quant_scales is not None and self.device.type == "cuda" and mesh is None:
            self._graphs = OrderedDict()
            self._graph_lock = threading.Lock()
            h, w = cfg.image_height, cfg.image_width
            if portrait:
                h, w = max(h, w), min(h, w)
            with self._graph_lock:
                self._graph((batch_size, h, w, 3))
        self._pool = ThreadPoolExecutor(max_workers=8)  # decode threads for extract_files
        self._pixels = ThreadPoolExecutor(max_workers=1)  # a chunk's J1 launch and download

    def _graph(self, shape: Tuple[int, ...]) -> EmbedGraph:
        """The captured embed of uint8 batches of ``shape``, captured now if
        it is not yet kept (the oldest dropped past ``MAX_GRAPHS``). Under
        ``_graph_lock``."""
        graph = self._graphs.get(shape)
        if graph is None:
            graph = self._graphs[shape] = EmbedGraph(self._embed, self.raw, shape, self.device)
            self.timer.count("embed.graph_captures")
            if len(self._graphs) > MAX_GRAPHS:
                self._graphs.popitem(last=False)
        self._graphs.move_to_end(shape)
        return graph

    def extract_images(self, images: Sequence[np.ndarray]) -> np.ndarray:
        timer = self.timer
        bs = self.batch_size
        with timer.span("embed.prep"):
            prepared = [
                normalize_geometry(
                    np.asarray(im), self.cfg.image_height, self.cfg.image_width,
                    keep_aspect=self.cfg.vlad_cores > 0, portrait=self.portrait,
                )
                for im in images
            ]
            n = len(prepared)
            # images of mixed shapes go the eager way, where np.stack refuses them
            graphed = self._graphs is not None and n > 0 and all(
                im.shape == prepared[0].shape for im in prepared)
            if not graphed:
                # uint8 on the wire; the model casts
                arr = pad_to_multiple(np.stack(prepared).astype(np.uint8), bs)
        timer.count("embed.images", n)
        timer.count("embed.padded", -n % bs)
        with timer.span("embed.device"):
            if graphed:
                return self._replay(prepared)
            feats = []
            for start in range(0, len(arr), bs):
                x = shard_batch(arr[start : start + bs], self.mesh)
                output, full = self._embed(torch.from_numpy(x).to(self.device))
                feats.append(all_gather_rows(full if self.raw else output, self.mesh)
                             .cpu().numpy())
                timer.count("embed.graph_replays", 0)
            return np.concatenate(feats)[:n]

    def _replay(self, prepared: List[np.ndarray]) -> np.ndarray:
        """The graph path of ``extract_images``: each batch's rows written
        into the staging buffer, padded with repeats of the first image (as
        ``pad_to_multiple`` pads), one replay each."""
        bs = self.batch_size
        feats = []
        with self._graph_lock:
            graph = self._graph((bs,) + prepared[0].shape)
            for start in range(0, len(prepared), bs):
                feats.append(graph.run(prepared[start : start + bs], prepared[0]))
                self.timer.count("embed.graph_replays")
        return feats[0] if len(feats) == 1 else np.concatenate(feats)

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
