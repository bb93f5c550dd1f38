"""Multiresolution hash tables (counterpart of
``scanerf_tpu/ops/hash_encode.py``): the table helpers of both layouts
and the global prime-XOR hash, the ``xla`` backend of the field.

The global hash is the reference's: points in [-2, 2] are normalized to
u = (p + 2) / 4, each level's lattice is corner-anchored (v = u * (res -
1)), a corner's entry is ``x * 1 ^ y * 2654435761 ^ z * 805459861``
masked to the table, and the 8 corners are blended trilinearly. The JAX
package computes it in XLA, outside any Pallas kernel, and so does the
port: gathers whose autograd is an ``index_add`` into the table (the
reference's atomic-add backward) and the analytic dL/dpoints through the
trilinear weights. It serves tables under 2^14 entries, where the
windowed layout has no room (``models/field.py::effective_backend``),
and ``backend="xla"``.
"""

from __future__ import annotations

import numpy as np
import torch

PRIMES = (1, 2654435761, 805459861)
MASK32 = 0xFFFFFFFF
# corner order: 000 001 010 011 100 101 110 111 (x-major)
CORNERS = np.stack(np.meshgrid([0, 1], [0, 1], [0, 1], indexing="ij"), -1).reshape(8, 3)


def as_3d(features: torch.Tensor, n_features: int = 2) -> torch.Tensor:
    """Normalize a hash table to [L, H, F] (exports may be flat [L, H*F])."""
    if features.ndim == 2:
        L, HF = features.shape
        return features.reshape(L, HF // n_features, n_features)
    return features


def table_rows(features: torch.Tensor, n_features: int = 2) -> int:
    """Hash-table row count H for either layout ([L, H, F] or flat [L, H*F])."""
    if features.ndim == 2:
        return features.shape[1] // n_features
    return features.shape[1]


def make_level_resolutions(
    base_resolution, finest_resolution, n_levels: int = 16
) -> np.ndarray:
    """Geometric per-level per-axis resolutions [L, 3] int32."""
    base = np.asarray(base_resolution, dtype=np.float64).reshape(3)
    finest = np.asarray(finest_resolution, dtype=np.float64).reshape(3)
    b = np.exp((np.log(finest) - np.log(base)) / (n_levels - 1))
    levels = [(base * b**i).astype(np.int32) for i in range(n_levels)]
    return np.stack(levels, axis=0)


def init_features(generator: torch.Generator, n_levels: int, log2_hashmap_size: int,
                  n_features: int = 2, device="cpu") -> torch.Tensor:
    """Xavier-normal table init (the reference default), flat [L, H*F] f32:
    std = sqrt(2 / (H*F + L)). ``generator`` lives on ``device``."""
    H = 2**log2_hashmap_size
    std = float(np.sqrt(2.0 / (H * n_features + n_levels)))
    return std * torch.randn((n_levels, H * n_features), generator=generator,
                             dtype=torch.float32, device=device)


def hash_index(loc: torch.Tensor, hashmap_size: int) -> torch.Tensor:
    """Prime-XOR hash of integer coords [..., 3] -> int64 in [0, H): the
    uint32 products and XOR of the reference, done in int64 with a 32-bit
    mask."""
    loc = loc.to(torch.int64) & MASK32
    h = ((loc[..., 0] * PRIMES[0]) & MASK32) ^ ((loc[..., 1] * PRIMES[1]) & MASK32) \
        ^ ((loc[..., 2] * PRIMES[2]) & MASK32)
    return h & (hashmap_size - 1)


def _encode_one_level(points: torch.Tensor, table: torch.Tensor,
                      resolution: torch.Tensor) -> torch.Tensor:
    """One level: points [N, 3] in [-2, 2], table [H, F], resolution [3]
    -> trilinear features [N, F]. A corner's hash is the XOR of three
    per-axis terms, so each axis hashes its two lattice coordinates once."""
    H = table.shape[0]
    u = (points + 2.0) / 4.0
    v = u * (resolution.to(points.dtype) - 1.0)
    bl = torch.floor(v)
    off = v - bl  # [N, 3]; floor carries no gradient, so dL/dv flows through off
    pair = torch.arange(2, device=points.device)
    ib = bl.detach().to(torch.int64)
    hx, hy, hz = (((((ib[:, a:a + 1] + pair) & MASK32) * PRIMES[a]) & MASK32)
                  for a in range(3))  # [N, 2] each
    cx, cy, cz = (torch.as_tensor(CORNERS[:, a], device=points.device) for a in range(3))
    h = (hx[:, cx] ^ hy[:, cy] ^ hz[:, cz]) & (H - 1)  # [N, 8]
    # per-axis factors (1 - off, off) of each corner, multiplied x * y * z
    fx, fy, fz = (torch.stack([1 - off[:, a], off[:, a]], dim=-1) for a in range(3))
    w = fx[:, cx] * fy[:, cy] * fz[:, cz]  # [N, 8]
    return (w[..., None] * table[h]).sum(dim=1)


def hash_encode(points: torch.Tensor, features: torch.Tensor,
                resolutions: torch.Tensor) -> torch.Tensor:
    """Encode points [N, 3] in [-2, 2] through every level of ``features``
    ([L, H, F] or flat [L, H*F], H a power of two) at ``resolutions``
    [L, 3] -> [N, L*F] (level-major: l0f0 l0f1 l1f0 ...). Differentiable
    in points and features."""
    features = as_3d(features)
    L, _, F = features.shape
    out = [_encode_one_level(points, features[lvl], resolutions[lvl]) for lvl in range(L)]
    return torch.stack(out, dim=1).reshape(points.shape[0], L * F)
