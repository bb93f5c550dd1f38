"""The traffic generator: reads a mix from ``benchmark/traffic/<name>.json``
and draws its requests from the run's seed.

Two kinds of mix:

- ``train``: one batch a step, 2^batch_log2 rays as 2x2 pixel patches,
  one set of patch corners shared by every camera (the reference's
  sampler: corners drawn without replacement while a row or column has
  room, with replacement beyond). Every step's batch differs; every seed
  draws batches of the same size.
- ``render``: one frame a request, ``height`` x ``width`` pixels through a
  pinhole of horizontal field of view ``fov_deg``, from a pose on a fixed
  path: ``path_points`` eyes evenly spaced from ``eye_from`` to
  ``eye_to``, each looking along ``forward`` with ``up``. The seed
  permutes the order in which the path's poses are rendered, so every
  seed renders the same set of frames, in another order.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))


def load(name: str) -> dict:
    with open(os.path.join(HERE, "traffic", f"{name}.json")) as f:
        return json.load(f)


class TrainBatches:
    """Batches of pixel indices (ray_idx [4P] int64 into a flattened H x W
    image, pixel coordinates [4P, 2]) for ``cameras`` cameras."""

    def __init__(self, mix: dict, seed: int, cameras: int, H: int, W: int, device):
        self.P = max(2 ** mix["batch_log2"] // cameras // 4, 1)
        self.H, self.W, self.device = H, W, device
        self.gen = torch.Generator().manual_seed((int(seed) * 104729 + 17) % 2**63)

    def rays_per_step(self, cameras: int) -> int:
        return 4 * self.P * cameras

    def next(self):
        def pick(n):
            if self.P <= n:
                return torch.randperm(n, generator=self.gen)[:self.P]
            return torch.randint(0, n, (self.P,), generator=self.gen)

        px, py = pick(self.W - 2), pick(self.H - 2)
        idx = ((py * self.W + px)[:, None] + torch.tensor([0, 1, self.W, self.W + 1]))
        idx = idx.reshape(-1)
        locs = torch.stack([idx % self.W, torch.div(idx, self.W, rounding_mode="floor")], -1)
        return idx.to(self.device), locs.to(self.device)


def intrinsics(mix: dict) -> np.ndarray:
    W, H = mix["width"], mix["height"]
    f = W / 2.0 / np.tan(np.deg2rad(mix["fov_deg"]) / 2.0)
    return np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)


def path_poses(mix: dict) -> np.ndarray:
    """The path's camera-to-world poses [n, 3, 4]."""
    fwd = np.asarray(mix["forward"], np.float64)
    fwd /= np.linalg.norm(fwd)
    x = np.cross(np.asarray(mix["up"], np.float64), fwd)
    x /= np.linalg.norm(x)
    R = np.stack([x, np.cross(fwd, x), fwd], -1)
    a, b = np.asarray(mix["eye_from"], np.float64), np.asarray(mix["eye_to"], np.float64)
    n = mix["path_points"]
    eyes = [a + (b - a) * i / max(n - 1, 1) for i in range(n)]
    return np.stack([np.concatenate([R, e[:, None]], -1) for e in eyes]).astype(np.float32)


def frame_order(mix: dict, seed: int) -> list[int]:
    """The order in which a run renders the path's poses (then again)."""
    rng = np.random.default_rng(int(seed) % 2**63)
    return [int(i) for i in rng.permutation(mix["path_points"])]
