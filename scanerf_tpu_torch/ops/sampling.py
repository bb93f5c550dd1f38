"""Occupancy-proportional CDF sampling core (counterpart of
``scanerf_tpu/ops/sampling.py:33-153``): march ``num_march`` candidate
segments over [t_near, t_far], weight them by occupancy, and invert the
CDF of occupied length at ``num_sample`` left-edge quantiles."""

from __future__ import annotations

import torch


def occupancy_lookup(points, grid, grid_corner, grid_size) -> torch.Tensor:
    """Boolean occupancy of world points [..., 3] in a [Rx, Ry, Rz] bool
    grid spanning [corner, corner + size]; out-of-bounds is unoccupied."""
    shape = torch.tensor(grid.shape, device=points.device)
    res = shape.to(points.dtype)
    u = (points - grid_corner) / grid_size * res
    cell = torch.floor(u).to(torch.int64)
    inb = ((cell >= 0) & (cell < shape)).all(dim=-1)
    cell = torch.minimum(cell.clamp_min(0), shape - 1)
    occ = grid[cell[..., 0], cell[..., 1], cell[..., 2]]
    return occ & inb


def cdf_sample_from_bounds(
    rays_o, rays_d, t_near, t_far, num_sample: int, grid, grid_corner,
    grid_size, num_march: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """z_vals [N, S] and total occupied length [N]. CPU tensors take the
    plain PyTorch version; CUDA tensors launch the fused sampler kernel
    (``ops/kernels/sampler.py``)."""
    from scanerf_tpu_torch.ops.kernels import sampler

    return sampler.sample_fused(
        rays_o, rays_d, t_near, t_far, num_sample, grid, grid_corner,
        grid_size, num_march)
