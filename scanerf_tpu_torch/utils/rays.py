"""Ray generation with the +0.5 pixel-center convention (counterpart of
``scanerf_tpu/utils/rays.py:17-42``). Rays are not normalized."""

from __future__ import annotations

import torch

from scanerf_tpu_torch.utils import lie


def pixel_grid(H: int, W: int, device="cpu", dtype=torch.float32) -> torch.Tensor:
    """[H*W, 2] grid of (x+0.5, y+0.5) pixel centers, row-major in y."""
    y = torch.arange(H, dtype=dtype, device=device) + 0.5
    x = torch.arange(W, dtype=dtype, device=device) + 0.5
    Y, X = torch.meshgrid(y, x, indexing="ij")
    return torch.stack([X, Y], dim=-1).reshape(-1, 2)


def get_center_and_ray(
    xy: torch.Tensor, pose_w2c: torch.Tensor, K: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Centers and directions [N, 3] for pixel coords ``xy`` [N, 2] under a
    world-to-camera pose [3, 4] and intrinsics [3, 3]."""
    grid_3d = lie.img2cam(lie.to_hom(xy), K)
    center_3d = torch.zeros_like(grid_3d)
    grid_3d = lie.cam2world(grid_3d, pose_w2c)
    center_3d = lie.cam2world(center_3d, pose_w2c)
    return center_3d, grid_3d - center_3d
