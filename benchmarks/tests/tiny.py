"""Tiny configurations of the benchmark's cells for the CPU tests: the same
traffic kinds and reference at a size the CPU runs in seconds, with a
PNG upload pool written here (PNG is lossless, so its pixels are the
reference's)."""

from __future__ import annotations

import json
import struct
import zlib
from pathlib import Path

import numpy as np
import torch

from benchmarks.harness import Cell


def png(rgb: np.ndarray) -> bytes:
    """An 8-bit RGB PNG of ``rgb`` (filter type 0 on every row)."""
    h, w, _ = rgb.shape
    raw = b"".join(b"\x00" + rgb[y].tobytes() for y in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def upload_pool(root: Path, n: int = 8, h: int = 32, w: int = 40, seed: int = 0) -> Path:
    rng = np.random.default_rng(seed)
    (root / "uploads").mkdir(parents=True, exist_ok=True)
    pixels = []
    for i in range(n):
        base = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
        for kind, img in (("q", base), ("db", np.roll(base, 2, axis=1))):
            (root / "uploads" / f"{kind}_{i:02d}.png").write_bytes(png(img))
        pixels.append(base)
    np.savez_compressed(root / "query_pixels.npz", pixels=np.stack(pixels))
    return root


def search_config(uploads: Path) -> dict:
    return {"model": {"vlad_cores": 4, "reduction": "none", "image_height": 32,
                      "image_width": 40, "compute_dtype": "float32"},
            "batch_size": 4, "calibration_images": 4, "index_rows": 300,
            "uploads": str(uploads), "upload_ext": "png"}


def train_config() -> dict:
    return {"model": {"vlad_cores": 4, "reduction": "none", "image_height": 32,
                      "image_width": 40, "compute_dtype": "float32"},
            "tuples": {"positives_per_tuple": 3, "negatives_per_tuple": 3,
                       "hard_positives_per_tuple": 1, "hard_negatives_per_tuple": 1},
            "loss": {"name": "wms", "alpha": 0.8, "beta": 15.0, "fused_wms": True},
            "train": {"tuples_per_batch": 1, "max_epoch": 1000, "base_lr": 5e-6,
                      "mining_step": 6, "mining_cache_size": 10, "eval_step": 100000000,
                      "save_step": 100000000, "num_eval_queries": 4, "eval_ref_r": 4,
                      "train_ref_r": 1},
            "city": {"train_poses": 24, "seed": 3}}


def cell(name: str, config: dict, params: dict, work: Path, seed: int = 5,
         seconds: float = 1.0, trace: bool = False) -> Cell:
    return Cell(name=name, config=config, params=json.loads(json.dumps(params)), seed=seed,
                seconds=seconds, trace=trace, device=torch.device("cpu"), work_dir=work,
                started=0.0)
