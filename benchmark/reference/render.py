"""Plain PyTorch render of exported tiles, the benchmark's reference.

A city's tiles each carry a doubled box, an occupancy grid over its inner
half, a windowed hash table and a ShallowMLP. A ray is rendered as the
reference renderer does it: one occupancy-CDF pass over the union of the
tiles' grids, rasterised at the finest cell pitch; each fg sample blended
over the tiles whose inner box contains it (at most ``max_tiles``, chosen
by seam weight, the product of the x and z distances to the box's edge),
each tile's contribution gated by the union occupancy and weighted by its
seam weight; front-to-back compositing of the premultiplied colours; the
background from the tiles through which the ray leaves the city
(inverse-depth samples beyond the last exit, each exit tile's composite
blended by the seam weight of the exit point). Every tile is evaluated
under its own table and decoder, rows by rows; nothing is sorted or
packed.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import field as F


def union_grids(corners, sizes, grids: torch.Tensor) -> torch.Tensor:
    """Each tile's grid [T, R, R, R] (bool, on any device) with every cell
    marked that covers the centre of a cell occupied in another tile."""
    T, dev = grids.shape[0], grids.device
    out = grids.clone()
    corners, sizes = np.asarray(corners, np.float32), np.asarray(sizes, np.float32)
    ic = torch.as_tensor(corners + sizes / 4.0, device=dev).double()  # f32 boxes, as exported
    isz = torch.as_tensor(sizes / 2.0, device=dev).double()
    res = torch.tensor(grids.shape[1:], device=dev)
    for a in range(T):
        centres = ic[a] + (torch.nonzero(grids[a]).double() + 0.5) / res.double() * isz[a]
        for b in range(T):
            if a != b:
                u = (centres - ic[b]) / isz[b]
                cell = (u[((u >= 0) & (u < 1)).all(-1)] * res).long()
                cell = torch.minimum(cell, res - 1)
                out[b][cell[:, 0], cell[:, 1], cell[:, 2]] = True
    return out


def scene_grid(corners, sizes, grids: torch.Tensor):
    """The tiles' grids rasterised into one city-wide grid at the finest
    cell pitch -> (grid, corner, size), on the grids' device."""
    T, dev = grids.shape[0], grids.device
    ic = (corners + sizes / 4.0).astype(np.float64)
    isz = (sizes / 2.0).astype(np.float64)
    res = np.array(grids.shape[1:], np.float64)
    cell = (isz / res).min(axis=0)
    lo, hi = ic.min(axis=0), (ic + isz).max(axis=0)
    G = np.maximum(np.ceil((hi - lo) / cell - 1e-6).astype(np.int64), 1)
    occ = torch.zeros(tuple(int(g) for g in G), dtype=torch.bool, device=dev)
    for t in range(T):
        i0 = np.clip(np.floor((ic[t] - lo) / cell).astype(np.int64), 0, G - 1)
        i1 = np.clip(np.ceil((ic[t] + isz[t] - lo) / cell).astype(np.int64), 0, G)
        ui = [((lo[d] + (np.arange(i0[d], i1[d]) + 0.5) * cell[d]) - ic[t][d]) / isz[t][d]
              for d in range(3)]
        ci = [torch.as_tensor(np.clip((ui[d] * res[d]).astype(np.int64), 0, int(res[d]) - 1),
                              device=dev) for d in range(3)]
        inb = [torch.as_tensor((ui[d] >= 0) & (ui[d] < 1), device=dev) for d in range(3)]
        sub = grids[t][ci[0][:, None, None], ci[1][None, :, None], ci[2][None, None, :]]
        sub &= inb[0][:, None, None] & inb[1][None, :, None] & inb[2][None, None, :]
        occ[i0[0]:i1[0], i0[1]:i1[1], i0[2]:i1[2]] |= sub
    return occ, lo.astype(np.float32), (G * cell).astype(np.float32)


class City:
    """The tiles of a city on a device: boxes, the union grid, resolutions,
    per-tile tables (views of the [L, T*H*F] stack) and decoders."""

    def __init__(self, corners, sizes, grids, resolutions, tables, decoder_vecs, device):
        corners, sizes = np.asarray(corners, np.float32), np.asarray(sizes, np.float32)
        ug, uc, us = scene_grid(corners, sizes, union_grids(corners, sizes, grids))

        def t(a, dtype=torch.float32):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

        self.corner, self.size = t(corners), t(sizes)
        self.grid, self.grid_corner, self.grid_size = ug.to(device), t(uc), t(us)
        self.res = t(resolutions, torch.int64)
        self.tables, self.decoders = None, None
        if tables is not None:  # without weights the city serves to count rows
            L, T = tables.shape[0], corners.shape[0]
            stack = tables.view(L, T, -1)
            self.tables = [[stack[lvl, k].view(-1, 2) for lvl in range(L)] for k in range(T)]
            self.decoders = [F.unpack_decoder(v) for v in decoder_vecs]

    @property
    def n(self) -> int:
        return self.corner.shape[0]


def _seam(u, inner):
    dis = (0.5 - (u - 0.5).abs()) * inner
    dx, dz = dis[..., 0], dis[..., 2]
    zero = torch.zeros_like(dx)
    return torch.where((dx != 0) & (dz != 0), dx * dz,
                       torch.where(dx != 0, dx, torch.where(dz != 0, dz, zero)))


def _top(score, K):
    """The K largest along the last dim, ties to the lower index."""
    rest, idx = score.clone(), []
    for _ in range(K):
        i = rest.argmax(dim=-1, keepdim=True)
        rest.scatter_(-1, i, float("-inf"))
        idx.append(i)
    idx = torch.cat(idx, dim=-1)
    return torch.gather(score, -1, idx), idx


def _eval(city: City, k: int, x, dirs):
    """Tile k's (sigma, diffuse + tint * specular) [N, 4] at points x in
    its [-2, 2] contraction."""
    out = F.decode(city.decoders[k], F.encode(x, city.tables[k], city.res[k]), dirs)
    return torch.cat([out["sigma"], out["diffuse"] + out["tint"] * out["specular"]], dim=-1)


def _composite(alpha, color, z):
    N = alpha.shape[0]
    trans = torch.cumprod(torch.cat([torch.ones((N, 1), device=alpha.device), 1.0 - alpha],
                                    dim=1), dim=1)[:, :-1]
    return (trans[..., None] * color).sum(1), (trans * alpha * z).sum(1), \
        trans[:, -1] * (1.0 - alpha[:, -1])


def _fg(city: City, rays_o, rays_d, Sf: int, march: int, K: int) -> dict:
    """The fg samples over the union grid and their tile slots: every
    containing tile (at most K, by seam weight), gated by the union
    occupancy on rays that meet occupied cells."""
    inner_c, inner_s = city.corner + city.size / 4.0, city.size / 2.0
    b = F.ray_aabb(rays_o[:, None, :], rays_d[:, None, :], (inner_c + inner_s / 2.0)[None],
                   (inner_s / 2.0)[None])
    hit = b[..., 0] != -1.0
    inf = torch.full_like(b[..., 0], float("inf"))
    tn = torch.where(hit, b[..., 0], inf).amin(1)
    tf = torch.where(hit, b[..., 1], -inf).amax(1)
    anyh = hit.any(1)
    tn = torch.where(anyh, tn, torch.zeros_like(tn))
    tf = torch.where(anyh, tf, torch.ones_like(tf))
    z, total = F.cdf_samples(rays_o, rays_d, tn, tf, Sf, city.grid, city.grid_corner,
                             city.grid_size, march)
    valid = anyh & (total > 0)
    dists = torch.where(valid[:, None], (total[:, None] / Sf).expand_as(z), 0.0)
    z = torch.where(valid[:, None], z, 0.0)
    pts = rays_o[:, None, :] + z[..., None] * rays_d[:, None, :]
    uu = (pts[..., None, :] - inner_c) / inner_s
    contains = ((uu >= 0) & (uu < 1)).all(-1)
    w_all = _seam(uu, inner_s)
    occ = F.grid_occupied(pts, city.grid, city.grid_corner, city.grid_size)
    _, tags = _top(torch.where(contains, w_all, torch.full_like(w_all, -1.0)), K)
    m_any = torch.gather(contains, -1, tags)
    w = torch.where(m_any, torch.gather(w_all, -1, tags), 0.0)
    return {"z": z, "dists": dists, "valid": valid, "pts": pts, "tags": tags, "w": w,
            "m_any": m_any, "m_eval": m_any & occ[..., None] & valid[:, None, None]}


def _bg(city: City, rays_o, rays_d, K: int):
    """The exit tiles, walked in entry order while their boxes overlap ->
    (tiles [N, K], blend weights [N, K], last exit [N], valid [N])."""
    N, T = rays_o.shape[0], city.n
    bb = F.ray_aabb(rays_o[:, None, :], rays_d[:, None, :],
                    (city.corner + city.size / 2.0)[None], (city.size / 2.0)[None])
    bh = bb[..., 0] != -1.0
    inf = torch.full_like(bb[..., 0], float("inf"))
    btn = torch.where(bh, bb[..., 0], inf)
    btf = torch.where(bh, bb[..., 1], -inf)
    order = torch.argsort(btn, dim=1, stable=True)
    tn_s, tf_s, h_s = (torch.gather(a, 1, order) for a in (btn, btf, bh))
    far = torch.full((N,), float("-inf"), device=rays_o.device)
    alive = torch.ones((N,), dtype=torch.bool, device=rays_o.device)
    oks = []
    for i in range(T):
        ok = h_s[:, i] & alive & ((far == float("-inf")) | (tn_s[:, i] <= far))
        far = torch.where(ok, torch.maximum(far, tf_s[:, i]), far)
        alive = ok
        oks.append(ok)
    ok = torch.zeros_like(bh).scatter(1, order, torch.stack(oks, dim=1))
    valid = far > float("-inf")
    far = torch.where(valid, far, torch.full_like(far, 0.1))
    is_exit = ok & ((btf - far[:, None]).abs() <= 1e-5 * far[:, None].abs())
    p = rays_o + far[:, None] * rays_d
    u = ((p[:, None, :] - city.corner[None]) / city.size[None]).clamp(0.0, 1.0)
    score = torch.where(is_exit, _seam(u, city.size[None]).clamp_min(1e-12),
                        torch.full_like(btn, -1.0))
    vals, tiles = _top(score, K)
    used = vals > 0.0
    bw = torch.where(used, vals, torch.zeros_like(vals))
    bw = torch.where(used.sum(-1, keepdim=True) == 1, used.to(bw.dtype), bw)
    return tiles, bw / bw.sum(-1, keepdim=True).clamp_min(1e-12), far, valid


def _contract_bg(city, k, pts):
    x = ((pts - city.corner[k]) / city.size[k]) * 4.0 - 2.0
    linf = x.abs().amax(-1, keepdim=True).clamp_min(1e-9)
    return torch.where(linf > 1.0, x * ((2.0 - 1.0 / linf) / linf), x)


@torch.no_grad()
def needed_rows(city: City, rays_o, rays_d, Sf: int, Sb: int, march: int, max_tiles: int = 4,
                seen=None) -> tuple[int, int]:
    """(rows, rays that meet occupied cells) of rays [N, 3]: one row a (fg
    sample, tile) evaluated, one a (bg sample, exit tile) with a non-zero
    weight. With ``seen`` [T, L, H] bool, marks the table entries the rows
    touch."""
    K = min(max_tiles, city.n)
    fg = _fg(city, rays_o, rays_d, Sf, march, K)
    tiles, bw, far, bvalid = _bg(city, rays_o, rays_d, K)
    live = (bw > 0.0) & bvalid[:, None]
    rows = int(fg["m_eval"].sum()) + Sb * int(live.sum())
    if seen is not None:
        zb, _ = F.inverse_z(far, Sb)
        ptb = rays_o[:, None, :] + zb[..., None] * rays_d[:, None, :]
        for k in range(city.n):
            sel = ((fg["tags"] == k) & fg["m_eval"]).any(-1)
            x = ((fg["pts"][sel] - city.corner[k]) / city.size[k]) * 4.0 - 2.0
            xb = _contract_bg(city, k, ptb[(live & (tiles == k)).any(-1)].reshape(-1, 3))
            F.mark_touched(torch.cat([x, xb]), city.res[k], seen[k])
    return rows, int(fg["valid"].sum())


@torch.no_grad()
def render_rays(city: City, rays_o, rays_d, Sf: int = 128, Sb: int = 128, march: int = 512,
                max_tiles: int = 4) -> dict:
    """rgb [N, 3] and depth [N] of rays [N, 3]."""
    N, T = rays_o.shape[0], city.n
    K = min(max_tiles, T)
    fg = _fg(city, rays_o, rays_d, Sf, march, K)
    z, dists, valid, pts, tags, w = (fg[k] for k in ("z", "dists", "valid", "pts", "tags", "w"))
    m_eval = fg["m_eval"]
    dnorm = torch.linalg.vector_norm(rays_d, dim=-1, keepdim=True)
    dirs = rays_d[:, None, :].expand(N, Sf, 3)
    wa_sum = torch.zeros((N, Sf), device=rays_o.device)
    col_sum = torch.zeros((N, Sf, 3), device=rays_o.device)
    for k in range(T):
        sel = (tags == k) & m_eval  # [N, Sf, K]: at most one slot a tile
        rows = sel.any(-1)
        if not bool(rows.any()):
            continue
        x = ((pts[rows] - city.corner[k]) / city.size[k]) * 4.0 - 2.0
        c = _eval(city, k, x, dirs[rows])
        a = 1.0 - torch.exp(-c[:, 0] * (dists * dnorm)[rows])
        wk = (w * sel).sum(-1)[rows]
        wa_sum[rows] += wk * a
        col_sum[rows] += (wk * a)[:, None] * c[:, 1:4]
    wsafe = (w * fg["m_any"]).sum(-1).clamp_min(1e-8)
    alpha = torch.where(valid[:, None], wa_sum / wsafe, torch.zeros_like(wa_sum))
    rgb_fg, depth_fg, T_left = _composite(alpha, col_sum / wsafe[..., None], z)

    tiles, bw, far, bg_valid = _bg(city, rays_o, rays_d, K)
    zb, db = F.inverse_z(far, Sb)
    ptb = rays_o[:, None, :] + zb[..., None] * rays_d[:, None, :]
    rgb_bg = torch.zeros((N, 3), device=rays_o.device)
    depth_bg = torch.zeros((N,), device=rays_o.device)
    dirs_b = rays_d[:, None, :].expand(N, Sb, 3)
    for j in range(K):
        live = (bw[:, j] > 0.0) & bg_valid
        a = torch.zeros((N, Sb), device=rays_o.device)
        col = torch.zeros((N, Sb, 3), device=rays_o.device)
        for k in range(T):
            rows = live & (tiles[:, j] == k)
            if not bool(rows.any()):
                continue
            x = _contract_bg(city, k, ptb[rows])
            c = _eval(city, k, x.reshape(-1, 3), dirs_b[rows].reshape(-1, 3)).reshape(-1, Sb, 4)
            a[rows] = 1.0 - torch.exp(-c[..., 0] * (db * dnorm)[rows])
            col[rows] = c[..., 1:4]
        a = a * bg_valid.to(a.dtype)[:, None]
        rgb_k, depth_k, _ = _composite(a, a[..., None] * col, zb)
        rgb_bg = rgb_bg + bw[:, j:j + 1] * rgb_k
        depth_bg = depth_bg + bw[:, j] * depth_k
    rgb = (rgb_fg + T_left[:, None] * rgb_bg).clamp(0.0, 1.0)
    return {"rgb": rgb, "depth": depth_fg + T_left * depth_bg}
