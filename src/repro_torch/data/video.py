"""Synthetic video stream for the Face Recognition example.

Generates frames with a known number of rendered "faces" (bright gaussian
blobs) at known positions, so the live pipeline's detector can be
validated end-to-end (found boxes vs ground truth) without any real video
assets. Frame statistics mirror the paper: 1920x1080 source resized to
960x540 for detection, 0-5 faces per frame averaging ~0.64.

The port's own copy of ``repro.data.video``: numpy-seeded, so both
packages see the same frames from one seed.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class Frame:
    index: int
    pixels: np.ndarray          # (H, W, 3) uint8
    true_boxes: list            # [(y, x, size), ...]


class VideoStream:
    def __init__(self, height: int = 216, width: int = 384,
                 avg_faces: float = 0.64, seed: int = 0):
        """Default resolution is a 5x-reduced stand-in for 1080p so the
        CPU example runs fast; ratios match the paper's pipeline."""
        self.h, self.w = height, width
        self.avg = avg_faces
        self.rng = np.random.default_rng(seed)
        self._i = 0

    def _render_face(self, img, y, x, size):
        yy, xx = np.mgrid[0:self.h, 0:self.w]
        blob = np.exp(-(((yy - y) / size) ** 2 + ((xx - x) / size) ** 2))
        img += (blob[..., None] * np.array([220.0, 180.0, 150.0]))

    def next_frame(self) -> Frame:
        img = self.rng.normal(30.0, 8.0, (self.h, self.w, 3))
        # face-count distribution: mean ~0.64, spiky (0..5)
        r = self.rng.random()
        n = 0 if r < 0.55 else 1 if r < 0.80 else 2 if r < 0.92 \
            else int(self.rng.integers(3, 6))
        boxes = []
        for _ in range(n):
            size = float(self.rng.uniform(8, 16))
            y = float(self.rng.uniform(2 * size, self.h - 2 * size))
            x = float(self.rng.uniform(2 * size, self.w - 2 * size))
            self._render_face(img, y, x, size)
            boxes.append((y, x, size))
        f = Frame(self._i, np.clip(img, 0, 255).astype(np.uint8), boxes)
        self._i += 1
        return f
