"""Host data pipeline: data sources, batch assembly, threaded prefetch.
Own copy of ``soft_contrastive_learning_tpu/data/pipeline.py``
(``FilesystemSource``, ``ToyCitySource``, ``load_images_standard`` with its
decode pool, ``assemble_batch``, ``Prefetcher``) and of
``parallel/mesh.py::pad_to_multiple``.

``FilesystemSource`` reads the prep pipeline's tree: shuffled epoch CSVs,
per-epoch anchor lists, cluster references and images at
``{img_root}/{date}_stereo_centre_{folder:02d}/{t}.png``, decoded by the
port's own PNG codec (``utils/io.py``). An image at the model's (height,
width) needs no resize, so no OpenCV; ``utils/cv.py`` raises where a resize
would need it.
"""

from __future__ import annotations

import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from soft_contrastive_learning_torch.core.config import TrainConfig
from soft_contrastive_learning_torch.data.toycity import ToyCity
from soft_contrastive_learning_torch.utils.cv import normalize_geometry
from soft_contrastive_learning_torch.utils.io import load_csv, load_img

ImageKey = Tuple[str, str, str]  # (date, folder, t)


def pad_to_multiple(x: np.ndarray, multiple: int, axis: int = 0) -> np.ndarray:
    """Pad with repeats of row 0 so shape[axis] % multiple == 0, so every
    call runs at the one batch shape."""
    rem = (-x.shape[axis]) % multiple
    if rem == 0:
        return x
    pad = np.take(x, np.zeros(rem, dtype=int), axis=axis)
    return np.concatenate([x, pad], axis=axis)


class FilesystemSource:
    """Reads the prep pipeline's CSV and PNG artifacts."""

    def __init__(self, img_root: str, shuffled_root: str, anchor_root: str = "",
                 loc_ref_root: str = ""):
        self.img_root = img_root
        self.shuffled_root = shuffled_root
        self.anchor_root = anchor_root
        self.loc_ref_root = loc_ref_root

    def image_path(self, key: ImageKey) -> str:
        date, folder, t = key
        return os.path.join(self.img_root, f"{date}_stereo_centre_{int(folder):02d}", f"{t}.png")

    def load_image(self, key: ImageKey) -> np.ndarray:
        return load_img(self.image_path(key))

    def epoch_meta(self, set_name: str, epoch: int) -> Dict[str, List[str]]:
        return load_csv(os.path.join(self.shuffled_root, f"{set_name}_{epoch:03d}.csv"))

    def anchor_indices(self, set_name: str, r: int, epoch: int) -> np.ndarray:
        meta = load_csv(os.path.join(self.anchor_root, f"{set_name}_{r}_{epoch:03d}.csv"))
        return np.asarray(meta["idx"], dtype=int)

    def cluster_meta(self, set_name: str, r: int) -> Dict[str, List[str]]:
        return load_csv(os.path.join(self.loc_ref_root, f"{set_name}_{r}.csv"))


class ToyCitySource:
    """In-memory source over two ToyCity regions (train/test), with
    deterministic per-epoch shuffles and r-spaced anchors."""

    def __init__(self, train_city: Optional[ToyCity] = None,
                 test_city: Optional[ToyCity] = None, seed: int = 42,
                 num_points: int = 240, img_h: int = 96, img_w: int = 128,
                 radius: float = 120.0):
        self.cities = {
            "train": train_city
            or ToyCity(num_points=num_points, radius=radius, seed=seed,
                       img_h=img_h, img_w=img_w, center=(1000.0, 2000.0)),
            "test": test_city
            or ToyCity(num_points=num_points, radius=radius, seed=seed + 1,
                       img_h=img_h, img_w=img_w, center=(9000.0, 9000.0),
                       date="2020-02-02-00-00-00"),
        }
        self.seed = seed

    def _city(self, set_name: str) -> ToyCity:
        return self.cities["test" if set_name.startswith("test") else "train"]

    def load_image(self, key: ImageKey) -> np.ndarray:
        for city in self.cities.values():
            if key[0] == city.date:
                return city.image_by_key(key)
        raise KeyError(key)

    def epoch_meta(self, set_name: str, epoch: int) -> Dict[str, List[str]]:
        city = self._city(set_name)
        meta = city.meta()
        order = np.random.default_rng(self.seed + 1000 * epoch).permutation(len(city))
        return {k: [v[i] for i in order] for k, v in meta.items()}

    def anchor_indices(self, set_name: str, r: int, epoch: int) -> np.ndarray:
        """Shuffled indices of one image per r-spaced point along the loop."""
        city = self._city(set_name)
        meta = self.epoch_meta(set_name, epoch)
        spacing = 2 * np.pi * city.radius / len(city)
        stride = max(int(round(max(r, 1) / max(spacing, 1e-9))), 1)
        selected = set(range(0, len(city), stride))
        rows = [row for row, orig in enumerate(np.asarray(meta["idx"], dtype=int))
                if orig in selected]
        rng = np.random.default_rng(self.seed + 7 * epoch)
        return rng.permutation(np.asarray(rows, dtype=int))

    def cluster_meta(self, set_name: str, r: int) -> Dict[str, List[str]]:
        """Every ``r``-th pose of the set's city, in loop order: the
        localization eval's reference set."""
        city = self._city(set_name)
        meta = city.meta()
        keep = list(range(0, len(city), max(int(r), 1)))
        return {k: [v[i] for i in keep] for k, v in meta.items()}


def load_images_standard(source, keys: Sequence[ImageKey], cfg: TrainConfig,
                         pool: Optional[ThreadPoolExecutor] = None) -> np.ndarray:
    """Load and geometry-normalize images -> (B, H, W, 3) uint8 RGB, the
    (H, W) of ``cfg.model``, decoded on ``pool`` when one is given. NetVLAD
    models keep aspect via a max-side resize; others scale and center-crop."""
    h, w = cfg.model.image_height, cfg.model.image_width
    keep_aspect = cfg.model.vlad_cores > 0

    def one(key):
        return normalize_geometry(source.load_image(key), h, w, keep_aspect=keep_aspect)

    imgs = list(pool.map(one, keys)) if pool is not None else [one(k) for k in keys]
    # uint8 on the wire; the model's first op casts to its compute dtype
    return np.stack(imgs).astype(np.uint8)


def assemble_batch(
    cfg: TrainConfig,
    source,
    meta: Dict[str, List[str]],
    indices: np.ndarray,  # (T, S) from the sampler
    payload: Dict[str, np.ndarray],
    epoch: int,
    pool: Optional[ThreadPoolExecutor] = None,
) -> Dict[str, np.ndarray]:
    keys = [(meta["date"][i], meta["folder"][i], meta["t"][i]) for i in indices.reshape(-1)]
    batch = {"images": load_images_standard(source, keys, cfg, pool),
             "epoch": np.float32(epoch)}
    batch.update(payload)
    return batch


class Prefetcher:
    """Runs ``build_fn(i)`` (which makes one host batch) for i in
    ``range(num_items)`` on a thread of its own, ahead of the consumer, in
    a bounded queue of ``depth`` items: the decode of the next batches
    hides behind the card's step. Items come out in order; an exception of
    ``build_fn`` is raised on the consumer's side."""

    _SENTINEL = object()

    def __init__(self, build_fn: Callable[[int], Optional[Dict]], num_items: int,
                 depth: int = 2):
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._num = num_items
        self._build = build_fn
        self._err: Optional[BaseException] = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        try:
            for i in range(self._num):
                if self._stop.is_set():
                    return
                item = self._build(i)
                # a bounded put that stays interruptible: a consumer that
                # leaves early sets _stop, and the producer must not block
                # on a full queue for ever
                while not self._stop.is_set():
                    try:
                        self._q.put(item, timeout=0.2)
                        break
                    except queue.Full:
                        continue
        except BaseException as e:  # raised on the consumer's side
            self._err = e
        finally:
            if not self._stop.is_set():
                self._q.put(self._SENTINEL)

    def close(self) -> None:
        """Stop the producer and drop what it queued; idempotent. Call it
        when the consumer leaves early, or the thread and its batches stay
        for the life of the process."""
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=10)

    def __iter__(self):
        while True:
            item = self._q.get()
            if item is self._SENTINEL:
                if self._err is not None:
                    raise self._err
                return
            yield item
