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

``hash_encode_stoch`` (the ``STOCHASTIC_HASH_GRAD`` option) has the same
forward and a cheaper backward: each (point, level) sends its whole
cotangent to one corner drawn with the trilinear weights as
probabilities, and dL/dpoints comes from one uniformly drawn corner times
8; both draws come from a hash of the point's float bits, so the
backward is deterministic and equals the JAX package's up to the order
of the table gradient's sums.
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


_U_PRIMES = (0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D)


def _corner_sample_u(points: torch.Tensor) -> torch.Tensor:
    """A uniform in [0, 1] per point from its float bits (the JAX
    ``_corner_sample_u``): the three coordinates' bits times odd constants
    mod 2^32, XORed, h ^ (h >> 15), as f32 / 2^32. The uint32 arithmetic
    runs in int64 with a 32-bit mask after each product; the conversion to
    f32 rounds to nearest, as the JAX one does."""
    bits = points.contiguous().view(torch.int32).to(torch.int64) & MASK32
    h = ((bits[:, 0] * _U_PRIMES[0]) & MASK32) ^ ((bits[:, 1] * _U_PRIMES[1]) & MASK32) \
        ^ ((bits[:, 2] * _U_PRIMES[2]) & MASK32)
    h = h ^ (h >> 15)
    return h.to(torch.float32) / 4294967296.0


def _stoch_level_bwd(points, u_sample, table, resolution, g_l):
    """One level of ``hash_encode_stoch``'s backward -> (d_points [N, 3],
    d_table [H, F]), in the JAX ``level_bwd``'s order of operations."""
    H = table.shape[0]
    v = (points + 2.0) / 4.0 * (resolution.to(points.dtype) - 1.0)
    bl = torch.floor(v)
    off = v - bl
    ib = bl.to(torch.int64)
    pair = torch.arange(2, device=points.device)
    hx, hy, hz = (((((ib[:, a:a + 1] + pair) & MASK32) * PRIMES[a]) & MASK32)
                  for a in range(3))  # [N, 2]
    cx, cy, cz = (torch.as_tensor(CORNERS[:, a], device=points.device) for a in range(3))
    fx, fy, fz = (torch.stack([1 - off[:, a], off[:, a]], dim=-1) for a in range(3))
    w = fx[:, cx] * fy[:, cy] * fz[:, cz]  # [N, 8]
    # the corner drawn with the weights: a sequential f32 prefix sum (the JAX
    # cumsum's order; torch.cumsum on the CPU sums in f64)
    cdf = [w[:, 0]]
    for k in range(1, 8):
        cdf.append(cdf[-1] + w[:, k])
    cdf = torch.stack(cdf, dim=1)
    corner_id = (cdf < u_sample[:, None] * cdf[:, -1:]).sum(dim=1).clamp(0, 7)

    def corner_hash(cid):
        bits = [(cid >> 2) & 1, (cid >> 1) & 1, cid & 1]
        sel = [torch.gather(hh, 1, b[:, None])[:, 0] for hh, b in zip((hx, hy, hz), bits)]
        return (sel[0] ^ sel[1] ^ sel[2]) & (H - 1)

    d_table = torch.zeros_like(table, dtype=g_l.dtype)
    d_table.index_add_(0, corner_hash(corner_id), g_l)
    # dL/dpoints from one uniformly drawn corner, times 8
    c2 = torch.floor(u_sample * 7.9999).to(torch.int64)
    T_c = table[corner_hash(c2)]  # [N, F]
    gv = T_c[:, 0] * g_l[:, 0] + T_c[:, 1] * g_l[:, 1]
    b2 = [((c2 >> s) & 1).to(points.dtype) for s in (2, 1, 0)]
    wc = [b * off[:, a] + (1 - b) * (1 - off[:, a]) for a, b in enumerate(b2)]
    sg = [2.0 * b - 1.0 for b in b2]
    dscale = (resolution.to(points.dtype) - 1.0) / 4.0
    d_points = torch.stack([8.0 * gv * sg[0] * wc[1] * wc[2] * dscale[0],
                            8.0 * gv * wc[0] * sg[1] * wc[2] * dscale[1],
                            8.0 * gv * wc[0] * wc[1] * sg[2] * dscale[2]], dim=-1)
    return d_points, d_table


class _HashEncodeStoch(torch.autograd.Function):
    @staticmethod
    def forward(ctx, points, features, resolutions):
        ctx.save_for_backward(points, features, resolutions)
        return hash_encode(points, features, resolutions)

    @staticmethod
    def backward(ctx, g):
        points, features, resolutions = ctx.saved_tensors
        f3 = as_3d(features)
        L, _, F = f3.shape
        g3 = g.reshape(points.shape[0], L, F)
        u_sample = _corner_sample_u(points)
        d_points = torch.zeros_like(points)
        d_tables = []
        for lvl in range(L):
            dp, dt = _stoch_level_bwd(points, u_sample, f3[lvl], resolutions[lvl], g3[:, lvl])
            d_points = d_points + dp
            d_tables.append(dt)
        return d_points, torch.stack(d_tables).reshape(features.shape), None


def hash_encode_stoch(points: torch.Tensor, features: torch.Tensor,
                      resolutions: torch.Tensor) -> torch.Tensor:
    """``hash_encode`` with the stochastic-corner backward (module
    docstring): the forward is exact; the table gradient of each (point,
    level) lands whole on one corner drawn by the trilinear weights, and
    dL/dpoints is 8 times one uniformly drawn corner's term."""
    return _HashEncodeStoch.apply(points, features, resolutions)
