"""Ray samplers (counterpart of ``scanerf_tpu/ops/sampling.py``).

Foreground: occupancy-proportional CDF sampling -- march ``num_march``
candidate segments over the ray's span of the grid box, weight them by
occupancy, and invert the CDF of occupied length at ``num_sample``
left-edge quantiles (``cdf_sample_from_bounds``: the plain version on the
CPU, kernel B1 on the card). Background: inverse-depth samples beyond the
doubled tile box, or (BS mode) a window around the proxy mesh's depth.
Like the reference's no-grad samplers, z and dists carry
no gradient: the pose reaches the samples only through o + z d and the
view directions.
"""

from __future__ import annotations

import torch

from scanerf_tpu_torch.ops.intersect import ray_aabb
from scanerf_tpu_torch.ops.kernels.sampler import linspace01


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


@torch.no_grad()
def sample_points_grid(rays_o, rays_d, num_sample: int, grid, grid_corner,
                       grid_size, num_march: int = 512):
    """Foreground samples over the grid box (the tile's inner bbox):
    z_vals [N, S], dists [N, S] (-1 on invalid rays), valid [N] bool."""
    bounds = ray_aabb(rays_o, rays_d, grid_corner + grid_size / 2, grid_size / 2)
    t_near, t_far = bounds[:, 0], bounds[:, 1]
    hit = t_near != -1.0
    t_near = torch.where(hit, t_near, torch.zeros_like(t_near))
    t_far = torch.where(hit, t_far, torch.ones_like(t_far))
    z_vals, total = cdf_sample_from_bounds(
        rays_o, rays_d, t_near, t_far, num_sample, grid, grid_corner, grid_size, num_march)
    valid = hit & (total > 0)
    dists = (total[:, None] / num_sample).expand_as(z_vals)
    neg = torch.full_like(z_vals, -1.0)
    return (torch.where(valid[:, None], z_vals, neg),
            torch.where(valid[:, None], dists, neg), valid)


@torch.no_grad()
def background_window_sampling(rays_o, rays_d, bg_depth, bbox_center, bbox_size,
                               num_sample: int, sample_range):
    """BS-mode background samples: ``num_sample`` evenly spaced z over a
    window of ``sample_range`` from max(the doubled bbox's exit, bg_depth
    - range / 2), where ``bg_depth`` [N] is the proxy mesh's depth behind
    the tile (0 = none; ``geometry/mesh_engine.py``). Rays without one, or
    that miss the bbox, are invalid: z -1, valid False. The last dist is
    1e-6."""
    bounds = ray_aabb(rays_o, rays_d, bbox_center, bbox_size / 2.0)
    t_exit = bounds[:, 1]
    valid = (t_exit != -1.0) & (bg_depth > 0)
    start = torch.maximum(t_exit, bg_depth - sample_range / 2.0)
    i = torch.arange(num_sample, dtype=rays_o.dtype, device=rays_o.device)
    z_vals = start[:, None] + i[None, :] * (sample_range / num_sample)
    dists = torch.cat([z_vals[:, 1:] - z_vals[:, :-1],
                       torch.full_like(z_vals[:, :1], 1e-6)], dim=-1)
    return torch.where(valid[:, None], z_vals, torch.full_like(z_vals, -1.0)), dists, valid


@torch.no_grad()
def inverse_z_sampling(rays_o, rays_d, num_sample: int, bbox_center, bbox_size,
                       invalid_underground: bool = False, far: float = 1e6):
    """Inverse-depth samples from the doubled bbox's exit out to ``far``:
    z = 1 / lerp(1/(t_exit + 1e-6), 1/far, t); rays that miss exit at 0.1;
    the last dist is 1e-6. With ``invalid_underground``, rays leaving
    through the inner bbox's floor are invalid."""
    bounds = ray_aabb(rays_o, rays_d, bbox_center, bbox_size / 2)
    miss = (bounds == -1.0).any(dim=-1)
    t_exit = torch.where(miss, torch.full_like(bounds[:, 1], 0.1), bounds[:, 1])
    if invalid_underground:
        outgoing = rays_o + bounds[:, 1:] * rays_d
        inner_corner_y = bbox_center[1] - bbox_size[1] / 4.0
        valid = ~((outgoing[:, 1] - inner_corner_y).abs() < 1e-4)
    else:
        valid = torch.ones_like(rays_d[:, 0], dtype=torch.bool)
    return (*inverse_z_vals(t_exit, num_sample, far), valid)


def inverse_z_vals(t_exit, num_sample: int, far: float = 1e6):
    """Inverse-depth samples z [N, S] from each exit distance t_exit [N]
    out to ``far``, and their spacings (the last 1e-6)."""
    t_vals = linspace01(num_sample, t_exit.device)[None, :]
    z_vals = 1.0 / (1.0 / (t_exit[:, None] + 1e-6) * (1.0 - t_vals) + (1.0 / far) * t_vals)
    dists = torch.cat([z_vals[:, 1:] - z_vals[:, :-1],
                       torch.full_like(z_vals[:, :1], 1e-6)], dim=-1)
    return z_vals, dists
