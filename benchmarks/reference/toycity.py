"""The toy city's poses and views, a frozen copy of the port's renderer
(``data/toycity.py``): a camera on a circular road over a procedural ground
texture, so that views of nearby poses share content. The training cell's
images are these views; the reference renders the ones it needs itself."""

from __future__ import annotations

from typing import Tuple

import numpy as np


class City:
    def __init__(self, num_points: int, radius: float, img_h: int, img_w: int, seed: int,
                 num_frequencies: int = 24, center: Tuple[float, float] = (1000.0, 2000.0)):
        rng = np.random.default_rng(seed)
        angles = np.linspace(0.0, 2 * np.pi, num_points, endpoint=False)
        self.easting = center[0] + radius * np.cos(angles)
        self.northing = center[1] + radius * np.sin(angles)
        self.yaw = (angles + np.pi / 2) % (2 * np.pi)
        length_scale = 15.0
        self._freqs = rng.normal(0.0, 1.0 / length_scale, size=(3, num_frequencies, 2))
        self._phases = rng.uniform(0.0, 2 * np.pi, size=(3, num_frequencies))
        self._amps = rng.dirichlet(np.ones(num_frequencies), size=3)
        v = (np.arange(img_h) + 0.5) / img_h
        depth = 4.0 + 36.0 * (1.0 - v) ** 2
        u = (np.arange(img_w) + 0.5) / img_w - 0.5
        self._ahead = np.broadcast_to(depth[:, None], (img_h, img_w))
        self._lateral = u[None, :] * (0.9 * depth[:, None])

    def xy(self, index: np.ndarray) -> np.ndarray:
        return np.stack([self.easting[index], self.northing[index]], axis=-1)

    def image(self, index: int) -> np.ndarray:
        c, s = np.cos(self.yaw[index]), np.sin(self.yaw[index])
        wx = self.easting[index] + c * self._ahead - s * self._lateral
        wy = self.northing[index] + s * self._ahead + c * self._lateral
        proj = np.einsum("...d,cfd->...cf", np.stack([wx, wy], axis=-1), self._freqs)
        vals = np.einsum("...cf,cf->...c", np.sin(proj + self._phases), self._amps)
        return np.clip((0.5 + 0.5 * vals) * 255.0, 0, 255).astype(np.uint8)
