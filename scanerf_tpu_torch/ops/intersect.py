"""Ray-AABB slab test (counterpart of ``scanerf_tpu/ops/intersect.py``):
boxes as (center, half-size); a miss returns (-1, -1); the entry t is
clamped to 0 when the origin is inside."""

from __future__ import annotations

import torch


def ray_aabb(rays_o, rays_d, center, half_size, eps: float = 1e-9) -> torch.Tensor:
    """bounds [..., 2] = (t_near, t_far), broadcasting over leading dims."""
    safe = torch.where(
        rays_d.abs() < eps,
        torch.where(rays_d >= 0, torch.full_like(rays_d, eps),
                    torch.full_like(rays_d, -eps)),
        rays_d,
    )
    inv_d = 1.0 / safe
    t0 = (center - half_size - rays_o) * inv_d
    t1 = (center + half_size - rays_o) * inv_d
    t_near = torch.minimum(t0, t1).amax(dim=-1)
    t_far = torch.maximum(t0, t1).amin(dim=-1)
    t_near = t_near.clamp_min(0.0)
    hit = (t_far > t_near) & (t_far > 0)
    bounds = torch.stack([t_near, t_far], dim=-1)
    return torch.where(hit[..., None], bounds, -torch.ones_like(bounds))


def ray_aabb_multi(rays_o, rays_d, centers, half_sizes) -> torch.Tensor:
    """Rays [N, 3] against K boxes [K, 3] -> bounds [N, K, 2]."""
    return ray_aabb(rays_o[:, None, :], rays_d[:, None, :],
                    centers[None], half_sizes[None])
