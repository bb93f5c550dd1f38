"""Volume-rendering integration (counterpart of
``scanerf_tpu/ops/integrate.py``): dists scaled by |rays_d|, the last
distance forced to 1e10 when ``infinity``, alpha = 1 - exp(-sigma d),
transmittance T_i = prod_{j<i} (1 - alpha_j + 1e-6), and T_left = T at the
last sample (it excludes that sample's own alpha, as the reference does)."""

from __future__ import annotations

import torch


def integrate_weights(sigma, dists, rays_d, infinity: bool = False, eps: float = 1e-6):
    """(weights [N, S], T_left [N]) from sigma [N, S] or [N, S, 1], dists
    [N, S] (unscaled) and unnormalized rays_d [N, 3]."""
    if sigma.ndim == 3:
        sigma = sigma[..., 0]
    d = dists * torch.linalg.vector_norm(rays_d, dim=-1, keepdim=True)
    if infinity:
        d = torch.cat([d[:, :-1], torch.full_like(d[:, -1:], 1e10)], dim=1)
    alpha = 1.0 - torch.exp(-sigma * d)
    trans = 1.0 - alpha + eps
    T = torch.cumprod(torch.cat([torch.ones_like(trans[:, :1]), trans], dim=1), dim=1)[:, :-1]
    return alpha * T, T[:, -1]


def accumulate(weights: torch.Tensor, attr: torch.Tensor) -> torch.Tensor:
    """sum_i w_i * attr_i: weights [N, S], attr [N, S, C] -> [N, C]."""
    return (weights[..., None] * attr).sum(dim=1)
