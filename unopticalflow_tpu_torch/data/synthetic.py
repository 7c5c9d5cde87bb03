"""In-memory training snippets of a textured scene under a known motion.

For runs that have no prepared KITTI directory (the smoke test and the probe
on the card, which has no opencv): ``SyntheticSnippets`` has the dataset
contract of ``KITTI_Prepared(emit_uint8=True)``, a (3H, W, 3) uint8 stack of
(prev, center, next) per index.  Each snippet is a smooth random texture made
from ``seed`` in which every frame is the previous one moved by ``SHIFT``
pixels (x, y); a pool of ``POOL`` snippets is made in bulk and indices cycle
through it.
"""

from __future__ import annotations

import numpy as np

SHIFT = (2, 1)  # the motion between consecutive frames, pixels (x, y)
POOL = 8  # distinct snippets: one batch of the KITTI recipe


class SyntheticSnippets:
    num_frames = 3

    def __init__(self, img_hw, num_samples: int, seed: int = 0):
        h, w = int(img_hw[0]), int(img_hw[1])
        dx, dy = SHIFT
        k = 4  # box-filter width: texture at a few pixels' scale
        rng = np.random.RandomState(seed)
        noise = rng.rand(POOL, h + 2 * dy + k, w + 2 * dx + k, 3).astype(np.float32)
        c = np.pad(noise.cumsum(1).cumsum(2), ((0, 0), (1, 0), (1, 0), (0, 0)))
        tex = (c[:, k:, k:] - c[:, :-k, k:] - c[:, k:, :-k] + c[:, :-k, :-k]) / (k * k)
        tex = 0.5 + 0.2 * (tex - tex.mean()) / tex.std()
        frames = [tex[:, i * dy:i * dy + h, i * dx:i * dx + w] for i in range(3)]
        self.snippets = np.clip(np.concatenate(frames, 1) * 255.0 + 0.5, 0, 255).astype(np.uint8)
        self.num_samples = num_samples

    def __len__(self):
        return self.num_samples

    def __getitem__(self, idx):
        if idx >= self.num_samples:
            raise IndexError(idx)
        return self.snippets[idx % len(self.snippets)]
