"""Plain PyTorch radiance field of one tile, the benchmark's reference.

Written from ScaNeRF's published semantics, with nothing imported from
the system under test: the occupancy-CDF sampler, the inverse-depth
background samples, the windowed slot hash (each level's table split
into windows of 512 entries, a point's window a raster cell of a warped
[0, 1]^3, its corners a folded prime-XOR hash inside the window), the
ShallowMLP decoder, volume integration and the pose algebra. Every
gather is an ``index_select`` (its backward an ``index_add``) and every
product a plain ``torch.matmul`` in f32; the caller decides whether TF32
is allowed (the reference runs with it off, the lower-precision control
with it on).

The sampler adds its cumulative sums in blocks of 16 (sequential inside
a block, then the block totals the same way): a quantile that ties with
a CDF value then lands on the same side as it does on the card, so the
reference places the same samples.
"""

from __future__ import annotations

import math

import numpy as np
import torch

WINDOW = 512  # table entries per window
PRIMES = (1, 2654435761, 805459861)
PRIMES32 = tuple(p - 2**32 if p >= 2**31 else p for p in PRIMES)  # the same low 32 bits
DECODER_SHAPES = {  # (fan_in, fan_out), in the packed order
    "spatial0": (32, 64), "spatial1": (64, 64), "sigma": (32, 1), "diffuse": (32, 3),
    "tint": (32, 3), "dir0": (48, 64), "dir1": (64, 64), "dir2": (64, 3),
}
GAUSS_SIGMA = 0.1
SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)


# ---------------------------------------------------------------------------
# geometry and samplers
# ---------------------------------------------------------------------------

def ray_aabb(rays_o, rays_d, center, half, eps: float = 1e-9):
    """(t_near, t_far) [..., 2] of rays against boxes (center, half size);
    (-1, -1) on a miss; t_near clamped to 0 inside the box."""
    safe = torch.where(rays_d.abs() < eps,
                       torch.where(rays_d >= 0, torch.full_like(rays_d, eps),
                                   torch.full_like(rays_d, -eps)), rays_d)
    inv = 1.0 / safe
    t0 = (center - half - rays_o) * inv
    t1 = (center + half - rays_o) * inv
    tn = torch.minimum(t0, t1).amax(dim=-1).clamp_min(0.0)
    tf = torch.maximum(t0, t1).amin(dim=-1)
    hit = (tf > tn) & (tf > 0)
    b = torch.stack([tn, tf], dim=-1)
    return torch.where(hit[..., None], b, -torch.ones_like(b))


def linspace01(n: int, device) -> torch.Tensor:
    """n fractions i * f32(1 / (n - 1)), the last exactly 1."""
    if n == 1:
        return torch.zeros(1, device=device)
    return torch.cat([torch.arange(n - 1, dtype=torch.float32, device=device) * (1.0 / (n - 1)),
                      torch.ones(1, device=device)])


def blocked_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive cumulative sum over the last dim, in blocks of 16."""
    M = x.shape[-1]
    if M <= 16:
        cols = [x[..., 0]]
        for m in range(1, M):
            cols.append(cols[-1] + x[..., m])
        return torch.stack(cols, dim=-1)
    nb = -(-M // 16)
    xp = torch.nn.functional.pad(x, (0, nb * 16 - M))
    loc = blocked_cumsum(xp.reshape(*x.shape[:-1], nb, 16))
    tot = blocked_cumsum(loc[..., -1])
    excl = torch.nn.functional.pad(tot[..., :-1], (1, 0))
    return (loc + excl[..., None]).reshape(*x.shape[:-1], nb * 16)[..., :M]


def grid_occupied(points, grid, corner, size) -> torch.Tensor:
    """Occupancy of points [..., 3] in a bool grid over [corner, corner + size]."""
    shape = torch.tensor(grid.shape, device=points.device)
    cell = torch.floor((points - corner) / size * shape.to(points.dtype)).to(torch.int64)
    inside = ((cell >= 0) & (cell < shape)).all(dim=-1)
    cell = torch.minimum(cell.clamp_min(0), shape - 1)
    return grid[cell[..., 0], cell[..., 1], cell[..., 2]] & inside


def cdf_samples(rays_o, rays_d, t_near, t_far, n: int, grid, corner, size, march: int):
    """Occupancy-proportional samples: ``march`` segments of [t_near,
    t_far] weighted by the occupancy at their midpoints, the CDF of
    occupied length inverted at n left-edge quantiles -> (z [N, n], total
    occupied length [N])."""
    frac = linspace01(march + 1, rays_o.device)
    edges = t_near[:, None] + (t_far - t_near)[:, None] * frac[None, :]
    mids = 0.5 * (edges[:, :-1] + edges[:, 1:])
    occ = grid_occupied(rays_o[:, None, :] + mids[..., None] * rays_d[:, None, :],
                        grid, corner, size)
    seg = (t_far - t_near)[:, None] / march
    cum = blocked_cumsum(torch.where(occ, seg, torch.zeros_like(seg)))
    total = cum[:, -1]
    j = torch.arange(n, dtype=torch.float32, device=rays_o.device)
    s = j[None, :] * (total[:, None] / n)
    idx = (cum[:, None, :] <= s[:, :, None]).sum(-1).clamp(0, march - 1)
    before = torch.gather(torch.nn.functional.pad(cum, (1, 0)), 1, idx)
    return torch.gather(edges[:, :-1], 1, idx) + (s - before), total


def fg_samples(rays_o, rays_d, n: int, grid, corner, size, march: int):
    """Foreground samples over the occupancy grid's box -> (z [N, n],
    dists [N, n], valid [N]); z and dists are -1 on invalid rays."""
    b = ray_aabb(rays_o, rays_d, corner + size / 2, size / 2)
    hit = b[:, 0] != -1.0
    tn = torch.where(hit, b[:, 0], torch.zeros_like(b[:, 0]))
    tf = torch.where(hit, b[:, 1], torch.ones_like(b[:, 1]))
    z, total = cdf_samples(rays_o, rays_d, tn, tf, n, grid, corner, size, march)
    valid = hit & (total > 0)
    dists = (total[:, None] / n).expand_as(z)
    neg = torch.full_like(z, -1.0)
    return torch.where(valid[:, None], z, neg), torch.where(valid[:, None], dists, neg), valid


def inverse_z(t_exit, n: int, far: float = 1e6):
    """Inverse-depth samples from t_exit out to ``far`` and their spacings
    (the last 1e-6)."""
    t = linspace01(n, t_exit.device)[None, :]
    z = 1.0 / (1.0 / (t_exit[:, None] + 1e-6) * (1.0 - t) + (1.0 / far) * t)
    return z, torch.cat([z[:, 1:] - z[:, :-1], torch.full_like(z[:, :1], 1e-6)], dim=-1)


def bg_samples(rays_o, rays_d, n: int, center, size):
    """Background samples beyond the box (center, size); rays that miss it
    start at 0.1 -> (z, dists, valid)."""
    b = ray_aabb(rays_o, rays_d, center, size / 2)
    miss = (b == -1.0).any(dim=-1)
    t_exit = torch.where(miss, torch.full_like(b[:, 1], 0.1), b[:, 1])
    z, d = inverse_z(t_exit, n)
    return z, d, torch.ones_like(rays_d[:, 0], dtype=torch.bool)


# ---------------------------------------------------------------------------
# windowed slot hash
# ---------------------------------------------------------------------------

def level_resolutions(base, finest, levels: int = 16) -> np.ndarray:
    """Geometric per-level per-axis lattice resolutions [L, 3] int32."""
    base = np.asarray(base, np.float64).reshape(3)
    finest = np.asarray(finest, np.float64).reshape(3)
    b = np.exp((np.log(finest) - np.log(base)) / (levels - 1))
    return np.stack([(base * b**i).astype(np.int32) for i in range(levels)])


def window_dims(H: int) -> tuple[int, int, int]:
    """Raster dims of the NW = H / 512 windows of a level."""
    bits = int(np.log2(H // WINDOW))
    return 2 ** ((bits + 2) // 3), 2 ** ((bits + 1) // 3), 2 ** (bits // 3)


def window_of(u: torch.Tensor, H: int) -> torch.Tensor:
    """Window id [N] int64 of points u [N, 3] in [0, 1]^3: a raster cell of
    u warped piecewise linearly (the inner half of each axis gets 3/4 of
    the cells)."""
    cx, cy, cz = window_dims(H)
    warped = torch.where(u < 0.25, u * 0.5,
                         torch.where(u < 0.75, 0.125 + (u - 0.25) * 1.5,
                                     0.875 + (u - 0.75) * 0.5))
    dims = torch.tensor([cx, cy, cz], dtype=u.dtype, device=u.device)
    c = torch.floor(warped * dims).to(torch.int64)
    c = torch.minimum(c.clamp_min(0), (dims - 1).to(torch.int64))
    return (c[..., 0] * cy + c[..., 1]) * cz + c[..., 2]


def corners(u, wid, res):
    """A level's 8 corner entries [N, 8] (indices into its [H, F] table)
    and trilinear weights [N, 8] of rows u [N, 3] in windows ``wid``;
    corner c = 4 cx + 2 cy + cz."""
    v = u * (res.to(u.dtype) - 1.0)
    bl = torch.floor(v)
    off = v - bl
    # uint32 arithmetic in int32: products wrap to the same low 32 bits, and
    # the slot keeps bits 0-26 of the hash, which no sign bit reaches
    lo = bl.to(torch.int32)
    h = [torch.stack([lo[:, a], lo[:, a] + 1], -1) * PRIMES32[a] for a in range(3)]
    h = h[0][:, :, None, None] ^ h[1][:, None, :, None] ^ h[2][:, None, None, :]
    h = h.reshape(-1, 8)
    h = ((h ^ (h >> 9) ^ (h >> 18)) & (WINDOW - 1)).to(torch.int64)
    f = [torch.stack([1 - off[:, a], off[:, a]], -1) for a in range(3)]
    w = f[0][:, :, None, None] * f[1][:, None, :, None] * f[2][:, None, None, :]
    return wid[:, None] * WINDOW + h, w.reshape(-1, 8)


def encode(x, tables, resolutions) -> torch.Tensor:
    """Windowed hash features [N, L*F] of points x [N, 3] in [-2, 2];
    ``tables`` is a list of per-level [H, F] tensors."""
    u = (x + 2.0) * 0.25
    H = tables[0].shape[0]
    wid = window_of(u, H)
    out = []
    for lvl, tab in enumerate(tables):
        idx, w = corners(u, wid, resolutions[lvl])
        g = torch.index_select(tab, 0, idx.reshape(-1)).reshape(*idx.shape, tab.shape[1])
        out.append((w[..., None] * g).sum(dim=1))
    return torch.cat(out, dim=-1)


def mark_touched(x, resolutions, seen: torch.Tensor) -> None:
    """Mark in ``seen`` [L, H] bool every table entry the corners of points
    x [N, 3] in [-2, 2] touch."""
    u = (x + 2.0) * 0.25
    wid = window_of(u, seen.shape[1])
    for lvl in range(seen.shape[0]):
        idx, _ = corners(u, wid, resolutions[lvl])
        seen[lvl][idx.reshape(-1)] = True


# ---------------------------------------------------------------------------
# decoder
# ---------------------------------------------------------------------------

def unpack_decoder(vec: torch.Tensor) -> dict:
    """A packed decoder vector [13994] (per layer the bias, then W as [out,
    in]) -> {layer: {"w": [in, out], "b": [out]}}."""
    out, i = {}, 0
    for name, (fi, fo) in DECODER_SHAPES.items():
        b = vec[i:i + fo]
        i += fo
        w = vec[i:i + fi * fo].reshape(fo, fi).t()
        i += fi * fo
        out[name] = {"w": w, "b": b}
    return out


def gauss(x):
    return torch.exp(x * x * (-1.0 / (2.0 * GAUSS_SIGMA**2)))


def softplus(x):
    return x.clamp_min(0.0) + torch.log1p(torch.exp(-x.abs()))


def sh3(d):
    """Real spherical harmonics of degree 3 of unit directions [..., 3]."""
    x, y, z = d[..., 0:1], d[..., 1:2], d[..., 2:3]
    xx, yy, zz, xy, yz, xz = x * x, y * y, z * z, x * y, y * z, x * z
    return torch.cat([
        torch.ones_like(x) * SH_C0, SH_C1 * y, SH_C1 * z, SH_C1 * x,
        SH_C2[0] * xy, SH_C2[1] * yz, SH_C2[2] * (2.0 * zz - xx - yy), SH_C2[3] * xz,
        SH_C2[4] * (xx - yy),
        SH_C3[0] * y * (3 * xx - yy), SH_C3[1] * xy * z, SH_C3[2] * y * (4 * zz - xx - yy),
        SH_C3[3] * z * (2 * zz - 3 * xx - 3 * yy), SH_C3[4] * x * (4 * zz - xx - yy),
        SH_C3[5] * z * (xx - yy), SH_C3[6] * x * (xx - 3 * yy)], dim=-1)


def decode(p: dict, feats, dirs) -> dict:
    """ShallowMLP: features [N, 32] and view directions [N, 3] -> sigma
    [N, 1], diffuse, tint, specular [N, 3]."""
    def lin(name, x):
        return x @ p[name]["w"] + p[name]["b"]

    dirs = dirs / (torch.linalg.vector_norm(dirs, dim=-1, keepdim=True) + 1e-8)
    h = lin("spatial1", gauss(lin("spatial0", feats)))
    geo, hd = h[..., :32], h[..., 32:]
    d = gauss(lin("dir1", gauss(lin("dir0", torch.cat([hd, sh3(dirs)], dim=-1)))))
    return {"sigma": softplus(lin("sigma", geo)), "diffuse": torch.sigmoid(lin("diffuse", geo)),
            "tint": torch.sigmoid(lin("tint", geo)), "specular": torch.sigmoid(lin("dir2", d))}


# ---------------------------------------------------------------------------
# integration and poses
# ---------------------------------------------------------------------------

def integrate(sigma, dists, rays_d, infinity: bool):
    """(weights [N, S], T_left [N]): alpha = 1 - exp(-sigma d |rays_d|),
    T_i = prod_{j<i} (1 - alpha_j + 1e-6); with ``infinity`` the last
    interval is 1e10."""
    d = dists * torch.linalg.vector_norm(rays_d, dim=-1, keepdim=True)
    if infinity:
        d = torch.cat([d[:, :-1], torch.full_like(d[:, -1:], 1e10)], dim=1)
    alpha = 1.0 - torch.exp(-sigma * d)
    T = torch.cumprod(torch.cat([torch.ones_like(alpha[:, :1]), 1.0 - alpha + 1e-6], dim=1),
                      dim=1)[:, :-1]
    return alpha * T, T[:, -1]


def _taylor(x2, nth, first, step):
    ans, denom = torch.zeros_like(x2), 1.0
    for i in range(nth + 1):
        denom *= step(i) if (i > 0 or first) else 1.0
        ans = ans + (-1) ** i * x2**i / denom
    return ans


def se3_exp(wu: torch.Tensor) -> torch.Tensor:
    """Twists [..., 6] (w | u) -> poses [..., 3, 4], by the 10-term Taylor
    series of sin(x)/x, (1-cos x)/x^2 and (x-sin x)/x^3 in x^2."""
    w, u = wu[..., :3], wu[..., 3:]
    w0, w1, w2 = w[..., 0], w[..., 1], w[..., 2]
    O = torch.zeros_like(w0)
    wx = torch.stack([torch.stack([O, -w2, w1], -1), torch.stack([w2, O, -w0], -1),
                      torch.stack([-w1, w0, O], -1)], dim=-2)
    t2 = (w * w).sum(dim=-1)[..., None, None]
    A = _taylor(t2, 10, False, lambda i: (2 * i) * (2 * i + 1))
    B = _taylor(t2, 10, True, lambda i: (2 * i + 1) * (2 * i + 2))
    C = _taylor(t2, 10, True, lambda i: (2 * i + 2) * (2 * i + 3))
    eye = torch.eye(3, dtype=wu.dtype, device=wu.device)
    R = eye + A * wx + B * (wx @ wx)
    V = eye + B * wx + C * (wx @ wx)
    return torch.cat([R, V @ u[..., None]], dim=-1)


def pose_invert(p):
    R, t = p[..., :3], p[..., 3:]
    Ri = R.transpose(-1, -2)
    return torch.cat([Ri, -Ri @ t], dim=-1)


def pose_compose(a, b):
    """b after a."""
    Ra, ta = a[..., :3], a[..., 3:]
    Rb, tb = b[..., :3], b[..., 3:]
    return torch.cat([Rb @ Ra, Rb @ ta + tb], dim=-1)


def rays_from(xy, w2c, K):
    """Origins and directions [..., N, 3] of pixel coordinates xy [N, 2] (or
    [..., N, 2]) under world-to-camera poses [..., 3, 4] and intrinsics
    [..., 3, 3]; directions are not normalised."""
    hom = torch.cat([xy, torch.ones_like(xy[..., :1])], dim=-1)
    cam = hom @ torch.linalg.inv(K).transpose(-1, -2)
    c2w = pose_invert(w2c)

    def to_world(X):
        return torch.cat([X, torch.ones_like(X[..., :1])], dim=-1) @ c2w.transpose(-1, -2)

    o = to_world(torch.zeros_like(cam))
    return o, to_world(cam) - o


def barf_weights(step: float, levels: int = 16) -> torch.Tensor:
    """BARF's per-level weights at ``step``: alpha = clip(step / 10000 * 8
    + 8, 0, 16), w_k = (1 - cos(clip(alpha - k, 0, 1) pi)) / 2."""
    alpha = min(max(step / 10000.0 * 8.0 + 8.0, 0.0), float(levels))
    return torch.tensor([(1.0 - math.cos(min(max(alpha - k, 0.0), 1.0) * math.pi)) / 2.0
                         for k in range(levels)], dtype=torch.float32)
