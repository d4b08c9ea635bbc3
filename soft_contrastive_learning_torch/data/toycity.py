"""Deterministic synthetic 'toy city'. Own copy of
``soft_contrastive_learning_tpu/data/toycity.py`` without ``write_to_disk``
(which needs an image writer).

A camera drives a circular road through a procedurally textured world; each
pose renders a pseudo-perspective view of the ground texture, so images of
nearby poses share content while far poses look different. The dataset is
a pure function of the seed, with the RobotCar metadata contract
(date/folder/t/easting/northing/yaw/idx columns).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


class ToyCity:
    def __init__(
        self,
        num_points: int = 300,
        radius: float = 120.0,
        img_h: int = 96,
        img_w: int = 128,
        num_frequencies: int = 24,
        seed: int = 0,
        date: str = "2020-01-01-00-00-00",
        center: Tuple[float, float] = (1000.0, 2000.0),
    ):
        self.num_points = num_points
        self.radius = radius
        self.img_h, self.img_w = img_h, img_w
        self.date = date
        rng = np.random.default_rng(seed)

        angles = np.linspace(0.0, 2 * np.pi, num_points, endpoint=False)
        self.easting = center[0] + radius * np.cos(angles)
        self.northing = center[1] + radius * np.sin(angles)
        self.yaw = (angles + np.pi / 2) % (2 * np.pi)  # tangent direction

        # random low-frequency Fourier texture of world coordinates
        length_scale = 15.0  # meters
        self._freqs = rng.normal(0.0, 1.0 / length_scale, size=(3, num_frequencies, 2))
        self._phases = rng.uniform(0.0, 2 * np.pi, size=(3, num_frequencies))
        self._amps = rng.dirichlet(np.ones(num_frequencies), size=3)

        # fixed pixel -> camera-frame ground coordinates (pseudo-perspective)
        v = (np.arange(img_h) + 0.5) / img_h  # 0 (top) .. 1 (bottom)
        depth = 4.0 + 36.0 * (1.0 - v) ** 2  # meters ahead: 40 (top) .. 4
        u = (np.arange(img_w) + 0.5) / img_w - 0.5
        self._ahead = np.broadcast_to(depth[:, None], (img_h, img_w))
        self._lateral = u[None, :] * (0.9 * depth[:, None])

    def __len__(self) -> int:
        return self.num_points

    def meta(self) -> Dict[str, List[str]]:
        n = self.num_points
        return {
            "date": [self.date] * n,
            "folder": ["1"] * n,
            "t": [f"{1400000000000000 + 100000 * i}" for i in range(n)],
            "easting": [f"{e}" for e in self.easting],
            "northing": [f"{x}" for x in self.northing],
            "yaw": [f"{y}" for y in self.yaw],
            "idx": [f"{i}" for i in range(n)],
        }

    def _texture(self, world_xy: np.ndarray) -> np.ndarray:
        """world (..., 2) -> RGB in [0, 1] (..., 3)."""
        proj = np.einsum("...d,cfd->...cf", world_xy, self._freqs)
        waves = np.sin(proj + self._phases)  # (..., 3, F)
        vals = np.einsum("...cf,cf->...c", waves, self._amps)
        return 0.5 + 0.5 * vals

    def image(self, index: int) -> np.ndarray:
        """Render the uint8 RGB view from pose ``index``. Deterministic."""
        c, s = np.cos(self.yaw[index]), np.sin(self.yaw[index])
        wx = self.easting[index] + c * self._ahead - s * self._lateral
        wy = self.northing[index] + s * self._ahead + c * self._lateral
        rgb = self._texture(np.stack([wx, wy], axis=-1))
        return np.clip(rgb * 255.0, 0, 255).astype(np.uint8)

    def image_by_key(self, key: Tuple[str, str, str]) -> np.ndarray:
        _, _, t = key
        index = (int(t) - 1400000000000000) // 100000
        return self.image(index)
