"""Ray generation with the +0.5 pixel-center convention (counterpart of
``scanerf_tpu/utils/rays.py``). Rays are not normalized."""

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


def get_all_rays(H: int, W: int, pose_w2c: torch.Tensor, K: torch.Tensor):
    """All rays of an H x W image -> (centers [H*W, 3], directions [H*W, 3])."""
    return get_center_and_ray(pixel_grid(H, W, device=pose_w2c.device), pose_w2c, K)


def make_intrinsics(fx, fy, cx, cy, device="cpu", dtype=torch.float32) -> torch.Tensor:
    return torch.tensor([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], dtype=dtype, device=device)


def patch_ray_indices(generator: torch.Generator, H: int, W: int,
                      num_patch: int) -> torch.Tensor:
    """2x2-patch ray indices [num_patch * 4] (int64) into a flattened H x W
    image: ``num_patch`` x- and y-coordinates drawn from ``generator`` in
    [0, W-2] and [0, H-2], paired, each expanded into its 2x2 patch (on
    the generator's device)."""
    dev = generator.device
    xs = torch.randint(0, W - 1, (num_patch,), generator=generator, device=dev)
    ys = torch.randint(0, H - 1, (num_patch,), generator=generator, device=dev)
    offsets = torch.tensor([0, 1, W, W + 1], device=dev)
    return ((ys * W + xs)[:, None] + offsets[None, :]).reshape(-1)
