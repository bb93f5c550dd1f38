"""B1: the fused occupancy-CDF ray sampler, in CUDA for Hopper.

Replaces the Pallas kernel ``scanerf_tpu/ops/pallas/sampler.py::_make_kernel``
(launched by ``sample_fused``, sampler.py:240). One warp per ray
(``csrc/sampler.cu``): the lanes march the M segment midpoints and test
the occupancy grid (the bool tensor's bytes, read through the read-only
cache), the ray's occupied lengths are scanned in shared memory, and the
CDF is inverted at the S quantiles in M + S work: each cum value's first
quantile J(m) by a binary search, a histogram of J in shared memory, and
its prefix sum, which is ``#{m : cum[m] <= s_j}`` exactly, whatever the
order of the cum values (``csrc/sampler.cu`` gives the argument). Per ray
the kernel reads 32 bytes and writes 4(S+1); the grid stays in L2. What
bounds it on the H100 is the march's arithmetic, not device memory. The
wrapper allocates the two outputs and nothing else: the kernel computes
``linspace01``'s fractions itself and reads the grid box through the
caller's tensors.

The scan adds in the order XLA's CPU ``cumsum`` does (blocks of 16, then
the block totals, recursively) and every multiply-add is rounded as two
operations, so the kernel, the plain version below and the JAX reference
on the CPU place quantiles that tie with a CDF value identically.
"""

from __future__ import annotations

import ctypes

import torch

from scanerf_tpu_torch import _build

SCAN_BLOCK = 16  # XLA CPU cumsum's block length (reduce-window rewriter)


def linspace01(n: int, device) -> torch.Tensor:
    """``jnp.linspace(0, 1, n)`` bit for bit: i * f32(1 / (n-1)), last
    entry 1."""
    if n == 1:
        return torch.zeros(1, device=device)
    step = torch.arange(n - 1, dtype=torch.float32, device=device) * (1.0 / (n - 1))
    return torch.cat([step, torch.ones(1, device=device)])


def blocked_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive cumsum over the last dim, added in XLA's CPU order:
    sequentially inside blocks of 16, block totals scanned the same way
    recursively, then each block offset by the preceding totals."""
    M = x.shape[-1]
    if M <= SCAN_BLOCK:
        cols = [x[..., 0]]
        for m in range(1, M):
            cols.append(cols[-1] + x[..., m])
        return torch.stack(cols, dim=-1)
    nb = -(-M // SCAN_BLOCK)
    xp = torch.nn.functional.pad(x, (0, nb * SCAN_BLOCK - M))
    loc = blocked_cumsum(xp.reshape(*x.shape[:-1], nb, SCAN_BLOCK))
    tot = blocked_cumsum(loc[..., -1])
    excl = torch.nn.functional.pad(tot[..., :-1], (1, 0))
    return (loc + excl[..., None]).reshape(*x.shape[:-1], nb * SCAN_BLOCK)[..., :M]


def sample_plain(rays_o, rays_d, t_near, t_far, num_sample, grid,
                 grid_corner, grid_size, num_march):
    """Plain PyTorch version: the op-by-op composition of the JAX
    reference's XLA branch (sampling.py:132-153). On a CUDA tensor
    PyTorch divides by a Python number through its reciprocal, so there
    it matches the kernel bit for bit only when num_march and num_sample
    are powers of two."""
    from scanerf_tpu_torch.ops.sampling import occupancy_lookup

    frac = linspace01(num_march + 1, rays_o.device)
    edges = t_near[:, None] + (t_far - t_near)[:, None] * frac[None, :]
    mids = 0.5 * (edges[:, :-1] + edges[:, 1:])
    pts = rays_o[:, None, :] + mids[..., None] * rays_d[:, None, :]
    occ = occupancy_lookup(pts, grid, grid_corner, grid_size)
    seg = (t_far - t_near)[:, None] / num_march
    occ_len = torch.where(occ, seg, torch.zeros_like(seg))
    cum = blocked_cumsum(occ_len)
    total = cum[:, -1]
    j = torch.arange(num_sample, dtype=rays_o.dtype, device=rays_o.device)
    s = j[None, :] * (total[:, None] / num_sample)
    seg_idx = (cum[:, None, :] <= s[:, :, None]).sum(-1).clamp(0, num_march - 1)
    cum_before = torch.gather(torch.nn.functional.pad(cum, (1, 0)), 1, seg_idx)
    seg_left = torch.gather(edges[:, :-1], 1, seg_idx)
    return seg_left + (s - cum_before), total


def _fn():
    f = _build.load("sampler").scanerf_sample
    f.restype = ctypes.c_int
    f.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_float] + [ctypes.c_int] * 6 \
        + [ctypes.c_void_p] * 3
    return f


def sample_fused(rays_o, rays_d, t_near, t_far, num_sample, grid,
                 grid_corner, grid_size, num_march):
    """z_vals [N, S] f32 and total [N] f32. CPU tensors take
    ``sample_plain``; CUDA tensors launch the kernel (``grid_corner`` and
    ``grid_size`` then contiguous f32 (3,) tensors on the rays' device)."""
    if rays_o.device.type == "cpu":
        return sample_plain(rays_o, rays_d, t_near, t_far, num_sample, grid,
                            grid_corner, grid_size, num_march)
    if rays_o.device.type != "cuda":
        raise ValueError(f"unsupported device {rays_o.device}")
    N = rays_o.shape[0]
    if num_sample < 1 or num_march < 1:
        raise ValueError(f"need num_sample, num_march >= 1, got {num_sample}, {num_march}")
    for name, t, shape in (("rays_o", rays_o, (N, 3)), ("rays_d", rays_d, (N, 3)),
                           ("t_near", t_near, (N,)), ("t_far", t_far, (N,))):
        if t.dtype != torch.float32 or tuple(t.shape) != shape \
                or t.device != rays_o.device:
            raise ValueError(f"{name}: want f32 {shape} on {rays_o.device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if grid.dtype != torch.bool or grid.ndim != 3 or grid.device != rays_o.device \
            or not grid.is_contiguous():
        raise ValueError("grid must be a contiguous 3-D bool tensor on the rays' device")
    for name, t in (("grid_corner", grid_corner), ("grid_size", grid_size)):
        if t.dtype != torch.float32 or tuple(t.shape) != (3,) or not t.is_contiguous() \
                or t.device != rays_o.device:
            raise ValueError(f"{name}: want contiguous f32 (3,) on {rays_o.device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    rays_o, rays_d = rays_o.contiguous(), rays_d.contiguous()
    t_near, t_far = t_near.contiguous(), t_far.contiguous()
    z = torch.empty((N, num_sample), dtype=torch.float32, device=rays_o.device)
    total = torch.empty((N,), dtype=torch.float32, device=rays_o.device)
    if N == 0:
        return z, total
    P = _build.ptr
    # f32(1 / M), as linspace01's step: the kernel's frac[m] = m * inv_m
    err = _fn()(P(rays_o), P(rays_d), P(t_near), P(t_far), P(grid), P(grid_corner),
                P(grid_size), 1.0 / num_march, *grid.shape, N, num_sample, num_march,
                P(z), P(total), _build.stream_ptr(rays_o))
    _build.check(err, "scanerf_sample")
    sample_fused.launches += 1
    return z, total


sample_fused.launches = 0
