"""Multi-tile inference renderer: the windowed sorted-stream backend and
the staged per-tile backend.

Counterpart of ``scanerf_tpu/render/renderer.py``. A frame renders in
chunks of rays; per chunk, one occupancy-proportional CDF sampling pass
over the union of the tiles' occupancy grids (B1,
``ops/kernels/sampler.py``), the background exit-tile slots and their
inverse-z samples. Then, with the **windowed** backend:

1. every fg (sample, tile) slot, up to ``max_blend_tiles`` containing
   tiles per sample picked by seam weight, and every bg (sample, exit
   tile) slot becomes one row of a single window-sorted stream (B2,
   ``ops/kernels/hash_encode.py``);
2. the fused hash + ShallowMLP kernel decodes the stream (B7,
   ``ops/kernels/fused_render.py``) or, with ``fuse_decoder=False``, the
   hash lookup (B3, ``ops/kernels/hash_encode.py``) and each tile's
   decoder in PyTorch; the rows are put back in order;
3. seam-weighted fg blend, front-to-back compositing, and the blend of
   the per-exit-tile background composites.

The **staged** backend (``backend="xla"``, the JAX package's oracle)
evaluates every sample under every tile in turn: each tile's encode
(the global hash in PyTorch, or the windowed hash through B2 + B3 for
CUDA tensors), its decoder in PyTorch, its own occupancy grid and seam
weight, blended per sample. It is the only backend for global-hash tiles
and for tiles whose resolution ladders differ (``shared_res=False``).
``render_image(early_term=True)`` slab-marches the windowed backend
(``render/early_term.py``). ``render_rays_sharded`` spreads a chunk's
rays over the ranks of a ``rays`` axis, the scene replicated on every
rank, and gathers the chunk on every rank; ``render_image(sharded=True)``
renders each chunk so when the process has joined a group of several
ranks, and is the plain render in one process, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import glob
import os

import numpy as np
import torch

from scanerf_tpu_torch import _device
from scanerf_tpu_torch.models import decoder as decoder_lib
from scanerf_tpu_torch.ops import intersect
from scanerf_tpu_torch.ops.hash_encode import hash_encode
from scanerf_tpu_torch.ops.kernels import fused_render as fr
from scanerf_tpu_torch.ops.kernels import hash_encode as hw
from scanerf_tpu_torch.ops.sampling import cdf_sample_from_bounds, inverse_z_vals
from scanerf_tpu_torch.parallel import mesh as mesh_lib
from scanerf_tpu_torch.train.checkpoint import load_tile_export

MAX_PTS_BLOCKS = 4  # most tiles blended per sample
LUT_CAND = 8  # most tiles intersecting one LUT cell


@dataclasses.dataclass
class MultiTileScene:
    """A loaded multi-tile scene; tensors live on ``device``."""

    features_flat: torch.Tensor  # [L, T*H*F] tile-major per level, f32/bf16
    decoders: dict  # stacked decoder params, leaves [T, ...] f32
    dec_slabs: torch.Tensor  # [T, PSLAB] f32 (B7's decoder layout)
    resolutions: torch.Tensor  # [T, L, 3] int32
    block_corner: torch.Tensor  # [T, 3] doubled bbox corner
    block_size: torch.Tensor  # [T, 3] doubled bbox size
    occupied: torch.Tensor  # [T, Rx, Ry, Rz] bool, each tile's grid (the staged backend's)
    union_occ: torch.Tensor  # [Gx, Gy, Gz] bool
    union_corner: torch.Tensor  # [3]
    union_size: torch.Tensor  # [3]
    tile_lut: torch.Tensor  # [Gx*Gy*Gz, LUT_CAND] int32, -1 padded
    lut_corner: torch.Tensor  # [3]
    lut_cell: torch.Tensor  # [3]
    lut_dims: tuple
    table_size: int  # H, entries per level per tile
    hash_layout: str = "windowed"
    shared_res: bool = True

    @property
    def n_tiles(self) -> int:
        return self.block_corner.shape[0]

    @property
    def device(self) -> torch.device:
        return self.block_corner.device


# ---------------------------------------------------------------------------
# scene construction (host side, numpy)
# ---------------------------------------------------------------------------

def _union_occupancy(exports: list[dict]) -> np.ndarray:
    """Cross-tile occupancy union: a voxel occupied in tile A marks the
    covering voxel of every other tile B that contains it."""
    T = len(exports)
    grids = [e["occupied_grid"].copy() for e in exports]
    inner_corner = [e["block_corner"] + e["block_size"] / 4.0 for e in exports]
    inner_size = [e["block_size"] / 2.0 for e in exports]
    centers = []
    for a in range(T):
        locs = np.stack(np.nonzero(exports[a]["occupied_grid"]), -1)
        res = np.array(grids[a].shape, np.float64)
        centers.append(inner_corner[a] + (locs + 0.5) / res * inner_size[a])
    for b in range(T):
        res_b = np.array(grids[b].shape)
        for a in range(T):
            if a == b:
                continue
            u = (centers[a] - inner_corner[b]) / inner_size[b]
            inb = np.all((u >= 0) & (u < 1), axis=-1)
            cell = np.clip((u[inb] * res_b).astype(int), 0, res_b - 1)
            grids[b][cell[:, 0], cell[:, 1], cell[:, 2]] = True
    return np.stack(grids)


def build_union_grid(block_corner, block_size, occupied):
    """Rasterize per-tile occupancy [T, Rx, Ry, Rz] into one scene-wide
    grid at the tiles' finest cell pitch -> (grid, corner, size)."""
    T = occupied.shape[0]
    inner_c = (block_corner + block_size / 4.0).astype(np.float64)
    inner_s = (block_size / 2.0).astype(np.float64)
    res = np.array(occupied.shape[1:], np.float64)
    resi = res.astype(np.int64)
    cell = (inner_s / res).min(axis=0)
    lo = inner_c.min(axis=0)
    hi = (inner_c + inner_s).max(axis=0)
    G = np.maximum(np.ceil((hi - lo) / cell - 1e-6).astype(np.int64), 1)
    occ = np.zeros(tuple(G), bool)
    for t in range(T):
        i0 = np.clip(np.floor((inner_c[t] - lo) / cell).astype(np.int64), 0, G - 1)
        i1 = np.clip(np.ceil((inner_c[t] + inner_s[t] - lo) / cell).astype(np.int64), 0, G)
        axes = [lo[d] + (np.arange(i0[d], i1[d]) + 0.5) * cell[d] for d in range(3)]
        ui = [(np.asarray(axes[d]) - inner_c[t][d]) / inner_s[t][d] for d in range(3)]
        inb = [(ui[d] >= 0) & (ui[d] < 1) for d in range(3)]
        ci = [np.clip((ui[d] * res[d]).astype(np.int64), 0, resi[d] - 1) for d in range(3)]
        sub = occupied[t][np.ix_(ci[0], ci[1], ci[2])]
        sub &= inb[0][:, None, None] & inb[1][None, :, None] & inb[2][None, None, :]
        occ[i0[0]:i1[0], i0[1]:i1[1], i0[2]:i1[2]] |= sub
    return occ, lo.astype(np.float32), (G * cell).astype(np.float32)


def flatten_tables(features: np.ndarray) -> np.ndarray:
    """[T, L, H, F] -> flat [L, T*H*F], tile-major per level."""
    T, L, H, F = features.shape
    return np.ascontiguousarray(np.transpose(features, (1, 0, 2, 3))).reshape(L, T * H * F)


def list_tile_dirs(logdir: str) -> list[str]:
    """``tile-<id>`` export dirs under a run dir, sorted by numeric id."""
    dirs = glob.glob(os.path.join(logdir, "tile-*"))
    return sorted(dirs, key=lambda d: int(d.rsplit("-", 1)[1]))


def build_tile_lut(block_corner, block_size, cells_per_tile: int = 8):
    """Rasterized containing-tile lookup over the inner bboxes: (lut
    [cells, LUT_CAND] int32 with -1 padding, corner [3], cell [3], dims)."""
    T = block_corner.shape[0]
    inner_c = (block_corner + block_size / 4.0).astype(np.float64)
    inner_s = (block_size / 2.0).astype(np.float64)
    lo = inner_c.min(axis=0)
    hi = (inner_c + inner_s).max(axis=0)
    cell = inner_s.min(axis=0) / cells_per_tile
    dims = np.maximum(np.ceil((hi - lo) / cell - 1e-9).astype(np.int64), 1)
    lut = np.full((int(np.prod(dims)), LUT_CAND), -1, np.int32)
    counts = np.zeros(int(np.prod(dims)), np.int64)
    for t in range(T):
        i0 = np.clip(np.floor((inner_c[t] - lo) / cell).astype(np.int64), 0, dims - 1)
        i1 = np.clip(np.ceil((inner_c[t] + inner_s[t] - lo) / cell + 1e-9).astype(np.int64),
                     1, dims)
        gx, gy, gz = np.meshgrid(np.arange(i0[0], i1[0]), np.arange(i0[1], i1[1]),
                                 np.arange(i0[2], i1[2]), indexing="ij")
        flat = ((gx * dims[1] + gy) * dims[2] + gz).reshape(-1)
        n = counts[flat]
        if (n >= LUT_CAND).any():
            raise ValueError(f"tile layout has >{LUT_CAND} tiles overlapping one "
                             "LUT cell; raise cells_per_tile")
        lut[flat, n] = t
        counts[flat] = n + 1
    return lut, lo.astype(np.float32), cell.astype(np.float32), tuple(int(d) for d in dims)


def scene_from_arrays(features, decoder_vecs, resolutions, block_corner,
                      block_size, occupied, hash_layout="windowed",
                      dtype=torch.float32, device="cuda") -> MultiTileScene:
    """Build a scene from numpy arrays: tables [T, L, H, F] (any float
    type), packed decoders [T, 13994] or a stacked param dict, level
    resolutions [T, L, 3], doubled bboxes [T, 3] and per-tile occupancy
    grids [T, Rx, Ry, Rz] already unioned across tiles."""
    dev = _device.resolve(device)
    corners = np.asarray(block_corner, np.float32)
    sizes = np.asarray(block_size, np.float32)
    res = np.asarray(resolutions, np.int32)
    ug, uc, us = build_union_grid(corners, sizes, np.asarray(occupied, bool))
    lut, lc, lcell, ldims = build_tile_lut(corners, sizes)
    if isinstance(decoder_vecs, dict):
        decoders = {n: {k: torch.tensor(np.asarray(v, np.float32), device=dev)
                        for k, v in p.items()} for n, p in decoder_vecs.items()}
    else:
        decoders = decoder_lib.stack_params([
            decoder_lib.unpack_params(torch.tensor(np.asarray(v, np.float32), device=dev))
            for v in decoder_vecs])
    flat = torch.from_numpy(flatten_tables(np.asarray(features)))

    def as_t(a):  # a copy: the inputs may be read-only views
        return torch.tensor(a, device=dev)

    return MultiTileScene(
        features_flat=flat.to(dtype).to(dev).contiguous(),
        decoders=decoders,
        dec_slabs=fr.pack_decoder_slabs(decoders).contiguous(),
        resolutions=as_t(res),
        block_corner=as_t(corners),
        block_size=as_t(sizes),
        occupied=as_t(np.asarray(occupied, bool)),
        union_occ=as_t(ug),
        union_corner=as_t(uc),
        union_size=as_t(us),
        tile_lut=as_t(lut),
        lut_corner=as_t(lc),
        lut_cell=as_t(lcell),
        lut_dims=ldims,
        table_size=int(np.asarray(features).shape[2]),
        hash_layout=hash_layout,
        shared_res=bool((res == res[:1]).all()),
    )


def load_scene(tile_dirs: list[str], dtype=torch.float32, device="cuda") -> MultiTileScene:
    """Load exported tiles (reference layout) into one scene on ``device``.
    ``dtype`` is the table type on the device: f32, or bf16 for half the
    memory and traffic (widened to f32 in the kernel)."""
    _device.resolve(device)
    exports = [load_tile_export(d) for d in tile_dirs]
    layouts = {e["hash_layout"] for e in exports}
    if len(layouts) != 1:
        raise ValueError(f"mixed hash layouts in scene: {layouts}")
    return scene_from_arrays(
        np.stack([e["features"] for e in exports]),
        [e["decoder_params"] for e in exports],
        np.stack([e["resolution"] for e in exports]),
        np.stack([e["block_corner"] for e in exports]),
        np.stack([e["block_size"] for e in exports]),
        _union_occupancy(exports),
        hash_layout=layouts.pop(), dtype=dtype, device=device,
    )


# ---------------------------------------------------------------------------
# sampling, slots, contractions, compositing
# ---------------------------------------------------------------------------

def _union_occupancy_lookup(scene: MultiTileScene, pts: torch.Tensor) -> torch.Tensor:
    G = torch.tensor(scene.union_occ.shape, device=pts.device)
    u = (pts - scene.union_corner) / scene.union_size
    inb = ((u >= 0) & (u < 1)).all(dim=-1)
    cell = torch.minimum((u * G).to(torch.int32).clamp_min(0), (G - 1).to(torch.int32))
    occ = scene.union_occ[cell[..., 0].long(), cell[..., 1].long(), cell[..., 2].long()]
    return occ & inb


def _sample_union(scene, rays_o, rays_d, num_sample: int, num_march: int):
    """CDF sampling against the union occupancy between the first tile
    entry and the last tile exit -> (z_vals, dists, valid)."""
    inner_c = scene.block_corner + scene.block_size / 4.0
    inner_s = scene.block_size / 2.0
    bounds = intersect.ray_aabb_multi(rays_o, rays_d, inner_c + inner_s / 2.0,
                                      inner_s / 2.0)
    hit = bounds[..., 0] != -1.0
    inf = torch.full_like(bounds[..., 0], float("inf"))
    t_near = torch.where(hit, bounds[..., 0], inf).amin(dim=1)
    t_far = torch.where(hit, bounds[..., 1], -inf).amax(dim=1)
    any_hit = hit.any(dim=1)
    t_near = torch.where(any_hit, t_near, torch.zeros_like(t_near))
    t_far = torch.where(any_hit, t_far, torch.ones_like(t_far))
    z_vals, total = cdf_sample_from_bounds(
        rays_o, rays_d, t_near, t_far, num_sample, scene.union_occ,
        scene.union_corner, scene.union_size, num_march)
    valid = any_hit & (total > 0)
    dists = (total[:, None] / num_sample).expand_as(z_vals)
    z_vals = torch.where(valid[:, None], z_vals, torch.zeros_like(z_vals))
    dists = torch.where(valid[:, None], dists, torch.zeros_like(dists))
    return z_vals, dists, valid


def _seam_weight(u: torch.Tensor, inner_size: torch.Tensor) -> torch.Tensor:
    """World-space distance to the boundary in x and z (y ignored): the
    product, or the one that is non-zero."""
    dis = (0.5 - (u - 0.5).abs()) * inner_size
    dx, dz = dis[..., 0], dis[..., 2]
    zero = torch.zeros_like(dx)
    return torch.where((dx != 0) & (dz != 0), dx * dz,
                       torch.where(dx != 0, dx, torch.where(dz != 0, dz, zero)))


def _top_k(score: torch.Tensor, K: int):
    """Largest K along the last dim, ties taken lower index first (as
    ``lax.top_k``): K rounds of argmax, which returns the first maximum.
    For K of 4 over a handful of candidates this beats a segmented sort."""
    rest = score.clone()
    idx = []
    for _ in range(K):
        i = rest.argmax(dim=-1, keepdim=True)
        rest.scatter_(-1, i, float("-inf"))
        idx.append(i)
    idx = torch.cat(idx, dim=-1)
    return torch.gather(score, -1, idx), idx


def _fg_slots_lut(scene: MultiTileScene, pts: torch.Tensor, K: int):
    """Per-sample <= K containing-tile slots from the tile LUT: (tags
    [N,S,K], w, m_any containment, m_eval containment & occupancy)."""
    _, d1, d2 = scene.lut_dims
    dims = torch.tensor(scene.lut_dims, device=pts.device, dtype=torch.int32)
    u = (pts - scene.lut_corner) / scene.lut_cell
    cell = torch.minimum(u.to(torch.int32).clamp_min(0), dims - 1).long()
    flat = (cell[..., 0] * d1 + cell[..., 1]) * d2 + cell[..., 2]
    cand = scene.tile_lut[flat]  # [N, S, C]
    cand_safe = cand.clamp_min(0).long()
    inner_c = (scene.block_corner + scene.block_size / 4.0)[cand_safe]
    inner_s = (scene.block_size / 2.0)[cand_safe]
    uu = (pts[..., None, :] - inner_c) / inner_s
    contains = ((uu >= 0) & (uu < 1)).all(dim=-1) & (cand >= 0)
    w_all = _seam_weight(uu, inner_s)
    occ_any = _union_occupancy_lookup(scene, pts)
    score = torch.where(contains, w_all, torch.full_like(w_all, -1.0))
    _, sel = _top_k(score, K)
    tags = torch.gather(cand_safe, -1, sel)
    w = torch.gather(w_all, -1, sel)
    m_any = torch.gather(contains, -1, sel)
    m_eval = m_any & occ_any[..., None]
    return tags, torch.where(m_any, w, torch.zeros_like(w)), m_any, m_eval


def _fg_slots(scene: MultiTileScene, pts: torch.Tensor, K: int):
    """``_fg_slots_lut`` by testing every tile instead of the LUT's
    candidates: the reference the LUT version is tested against."""
    inner_c = scene.block_corner + scene.block_size / 4.0
    inner_s = scene.block_size / 2.0
    uu = (pts[..., None, :] - inner_c) / inner_s  # [N, S, T, 3]
    c_all = ((uu >= 0) & (uu < 1)).all(dim=-1)
    w_all = _seam_weight(uu, inner_s)
    occ_any = _union_occupancy_lookup(scene, pts)
    _, tags = _top_k(torch.where(c_all, w_all, torch.full_like(w_all, -1.0)), K)
    w = torch.gather(w_all, -1, tags)
    m_any = torch.gather(c_all, -1, tags)
    m_eval = m_any & occ_any[..., None]
    return tags, torch.where(m_any, w, torch.zeros_like(w)), m_any, m_eval


def _exit_slots(scene: MultiTileScene, rays_o, rays_d, K: int):
    """Background exit-tile slots: walk tiles in entry order over the
    doubled bboxes tracking the running max exit ``far`` (stop at a gap),
    keep the tiles whose exit equals ``far``, weight each by the x/z
    boundary distance of the outgoing point. Returns (tiles [N,K], w
    [N,K] normalized, far [N], bg_valid [N])."""
    bounds = intersect.ray_aabb_multi(rays_o, rays_d,
                                      scene.block_corner + scene.block_size / 2.0,
                                      scene.block_size / 2.0)
    hit = bounds[..., 0] != -1.0
    inf = torch.full_like(bounds[..., 0], float("inf"))
    tn = torch.where(hit, bounds[..., 0], inf)
    tf = torch.where(hit, bounds[..., 1], -inf)
    order = torch.argsort(tn, dim=1, stable=True)
    tn_s, tf_s, hit_s = (torch.gather(a, 1, order) for a in (tn, tf, hit))
    N, T = tn.shape
    far = torch.full((N,), float("-inf"), device=tn.device)
    alive = torch.ones((N,), dtype=torch.bool, device=tn.device)
    ok_cols = []
    for i in range(T):
        ok = hit_s[:, i] & alive & ((far == float("-inf")) | (tn_s[:, i] <= far))
        far = torch.where(ok, torch.maximum(far, tf_s[:, i]), far)
        alive = ok
        ok_cols.append(ok)
    ok = torch.zeros_like(hit).scatter(1, order, torch.stack(ok_cols, dim=1))
    bg_valid = far > float("-inf")
    far = torch.where(bg_valid, far, torch.full_like(far, 0.1))
    is_exit = ok & ((tf - far[:, None]).abs() <= 1e-5 * far[:, None].abs())
    p = rays_o + far[:, None] * rays_d
    u = ((p[:, None, :] - scene.block_corner[None]) / scene.block_size[None]).clamp(0.0, 1.0)
    w_all = _seam_weight(u, scene.block_size[None])
    score = torch.where(is_exit, w_all.clamp_min(1e-12), torch.full_like(w_all, -1.0))
    vals, tiles = _top_k(score, K)
    used = vals > 0.0
    w = torch.where(used, vals, torch.zeros_like(vals))
    n_used = used.sum(dim=-1, keepdim=True)
    w = torch.where(n_used == 1, used.to(w.dtype), w)
    w = w / w.sum(dim=-1, keepdim=True).clamp_min(1e-12)
    return tiles, w, far, bg_valid


def _contract_fg(corner, size, pts):
    """Inner bbox of the doubled (corner, size) -> [-1, 1]."""
    return ((pts - corner) / size) * 4.0 - 2.0


def _contract_bg(corner, size, pts):
    x = ((pts - corner) / size) * 4.0 - 2.0
    linf = x.abs().amax(dim=-1, keepdim=True).clamp_min(1e-9)
    ratio = (2.0 - 1.0 / linf) / linf
    return torch.where(linf > 1.0, x * ratio, x)


def _composite_premult(alpha, color, z):
    """Front-to-back compositing of premultiplied colors -> (rgb, depth,
    T_left)."""
    N = alpha.shape[0]
    trans = torch.cumprod(torch.cat([torch.ones((N, 1), device=alpha.device),
                                     1.0 - alpha], dim=1), dim=1)[:, :-1]
    rgb = (trans[..., None] * color).sum(dim=1)
    depth = (trans * alpha * z).sum(dim=1)
    T_left = trans[:, -1] * (1.0 - alpha[:, -1])
    return rgb, depth, T_left


def _bg_mask(scene, tile_k, rays_o, rays_d, z_bg, bg_valid, invalid_underground):
    """[N, 1] float mask on the bg contribution of one exit slot."""
    ok = bg_valid
    if invalid_underground:
        inner_cy = scene.block_corner[tile_k, 1] + scene.block_size[tile_k, 1] / 4.0
        outgoing = rays_o + z_bg[:, :1] * rays_d
        ok = ok & ~((outgoing[:, 1] - inner_cy).abs() < 1e-4)
    return ok.to(z_bg.dtype)[:, None]


# ---------------------------------------------------------------------------
# windowed sorted-stream evaluation
# ---------------------------------------------------------------------------

def _decode_stream(scene: MultiTileScene, stream, chunk_tile, NW: int, fuse: bool):
    """The decoder over the sorted stream -> [Np, 4] (sigma, diffuse +
    tint*specular). Fused: B7. Unfused: B3, then each tile's decoder
    (weight feature 1) on its chunks, which the stream holds in one
    contiguous range (it is sorted by window, windows are tile-major, and
    the sentinel and pad chunks at its end take the last tile), so one
    batched product a tile gives the JAX package's vmap over chunks."""
    res0 = scene.resolutions[0].contiguous()
    if fuse:
        return fr.hash_decode_fused(stream, chunk_tile, scene.features_flat, res0,
                                    scene.decoders, NW, slabs=scene.dec_slabs)
    feats = hw.hash_lookup_sorted(stream.pts, stream.meta, scene.features_flat, res0)
    dirs = stream.pts[:, 4:7, :].permute(0, 2, 1).reshape(-1, 3)
    if not bool((chunk_tile[1:] >= chunk_tile[:-1]).all()):
        raise RuntimeError("the stream's chunks are not in tile order: each tile's decoder "
                           "needs its chunks in one contiguous range")
    counts = torch.bincount(chunk_tile, minlength=scene.n_tiles).tolist()
    parts, c0 = [], 0
    for t, n in enumerate(counts):
        rows = slice(c0 * hw.CHUNK, (c0 + n) * hw.CHUNK)
        dec = {name: {k: v[t] for k, v in p.items()} for name, p in scene.decoders.items()}
        out = decoder_lib.apply_decoder(dec, feats[rows], dirs[rows])
        parts.append(torch.cat([out["sigma"], out["diffuse"] + out["tint"] * out["specular"]],
                               dim=-1))
        c0 += n
    return torch.cat(parts)


def _eval_rows(scene: MultiTileScene, X, TID, DIR, dead, fuse_decoder=True, hook=None):
    """Sorted-stream evaluation of (point, tile) rows: sort + pack (B2),
    the stream's decode (``_decode_stream``), unsort -> [R, 4] (sigma,
    diffuse + tint*specular) in input row order."""
    T, H = scene.n_tiles, scene.table_size
    stream = hw.sort_pack_tables(X, DIR, TID, H, T, dead=dead)
    _mark(hook, "sort_pack")
    NW = (H // hw.W) * T
    chunk_tile = torch.div(stream.meta[:, 0, 0] * hw.WB, H // hw.W,
                           rounding_mode="floor").clamp(0, T - 1).to(torch.int32)
    cols = _decode_stream(scene, stream, chunk_tile.contiguous(), NW, fuse_decoder)
    _mark(hook, "decode")
    rows = hw.unsort_rows(cols, stream.pidp, X.shape[0])
    _mark(hook, "unsort")
    return rows


def _mark(hook, name: str) -> None:
    if hook is not None:
        hook(name)


def _fg_rows(scene, rays_o, rays_d, z_vals, valid, Kf: int):
    """The fg (sample, slot) rows of rays with samples z_vals [N, S], in
    slot-major order ([Kf, N, S]: window ids stay piecewise constant) ->
    (X, TID, DIR, DEAD, (w_fg, m_any, m_eval) [N, S, Kf])."""
    N, S = z_vals.shape
    pts = rays_o[:, None, :] + z_vals[..., None] * rays_d[:, None, :]
    tags, w_fg, m_any, m_eval = _fg_slots_lut(scene, pts, Kf)
    x_fg = _contract_fg(scene.block_corner[tags], scene.block_size[tags], pts[:, :, None, :])
    x_fg = torch.where(m_any[..., None], x_fg, torch.zeros_like(x_fg))
    X = x_fg.permute(2, 0, 1, 3).reshape(-1, 3)
    TID = tags.permute(2, 0, 1).reshape(-1)
    DIR = rays_d[:, None, None, :].expand(N, S, Kf, 3).permute(2, 0, 1, 3).reshape(-1, 3)
    DEAD = (~(m_eval & valid[:, None, None])).permute(2, 0, 1).reshape(-1)
    return X, TID, DIR, DEAD, (w_fg, m_any, m_eval)


def _fg_blend(rows, slots, dists, dnorm, valid):
    """Seam-weighted blend of the fg rows [Kf*N*S, 4] -> (alpha [N, S],
    premultiplied color [N, S, 3])."""
    w_fg, m_any, m_eval = slots
    N, S, Kf = w_fg.shape
    rf = rows.reshape(Kf, N, S, 4).movedim(0, 2)
    alpha_f = 1.0 - torch.exp(-rf[..., 0] * (dists * dnorm)[..., None])
    wa = w_fg * alpha_f * m_eval.to(torch.float32)
    wsafe = (w_fg * m_any).sum(dim=-1).clamp_min(1e-8)
    alpha = wa.sum(dim=-1) / wsafe
    color = (wa[..., None] * rf[..., 1:4]).sum(dim=-2) / wsafe[..., None]
    alpha = torch.where(valid[:, None], alpha, torch.zeros_like(alpha))
    return alpha, color


def _bg_rows(scene, rays_o, rays_d, z_bg, bg_tiles, bg_w, bg_valid):
    """The bg (sample, exit slot) rows, slot-major: every exit slot
    evaluates the same world points under its own tile's L-inf
    contraction -> (X, TID, DIR, DEAD)."""
    N, Sb = z_bg.shape
    Kb = bg_tiles.shape[1]
    pts_bg = rays_o[:, None, :] + z_bg[..., None] * rays_d[:, None, :]
    cor_b = scene.block_corner[bg_tiles][:, None]
    siz_b = scene.block_size[bg_tiles][:, None]
    x_bg = _contract_bg(cor_b, siz_b, pts_bg[:, :, None, :])
    bg_used = (bg_w > 0.0)[:, None, :]
    x_bg = torch.where(bg_used[..., None], x_bg, torch.zeros_like(x_bg))
    X = x_bg.permute(2, 0, 1, 3).reshape(-1, 3)
    TID = bg_tiles[:, None, :].expand(N, Sb, Kb).permute(2, 0, 1).reshape(-1)
    DIR = rays_d[:, None, None, :].expand(N, Sb, Kb, 3).permute(2, 0, 1, 3).reshape(-1, 3)
    DEAD = (~(bg_used & bg_valid[:, None, None])).expand(N, Sb, Kb).permute(2, 0, 1).reshape(-1)
    return X, TID, DIR, DEAD


def _bg_blend(scene, rows, rays_o, rays_d, z_bg, d_bg, bg_tiles, bg_w, bg_valid,
              invalid_underground):
    """Composite each exit slot's bg rows [Kb*N*Sb, 4], then blend the
    slots by their weights -> (rgb_bg [N, 3], depth_bg [N])."""
    N, Sb = z_bg.shape
    Kb = bg_tiles.shape[1]
    dnorm = torch.linalg.vector_norm(rays_d, dim=-1, keepdim=True)
    rb = rows.reshape(Kb, N, Sb, 4).movedim(0, 2)
    alpha_b = 1.0 - torch.exp(-rb[..., 0] * (d_bg * dnorm)[..., None])
    rgb_bg = torch.zeros((N, 3), device=rays_o.device)
    depth_bg = torch.zeros((N,), device=rays_o.device)
    for k in range(Kb):
        bmask = _bg_mask(scene, bg_tiles[:, k], rays_o, rays_d, z_bg, bg_valid,
                         invalid_underground)
        a_k = alpha_b[..., k] * bmask
        rgb_k, depth_k, _ = _composite_premult(a_k, a_k[..., None] * rb[..., k, 1:4], z_bg)
        rgb_bg = rgb_bg + bg_w[:, k:k + 1] * rgb_k
        depth_bg = depth_bg + bg_w[:, k] * depth_k
    return rgb_bg, depth_bg


def _render_windowed(scene, rays_o, rays_d, z_vals, dists, valid, bg_tiles,
                     bg_w, z_bg, d_bg, bg_valid, invalid_underground,
                     max_blend_tiles=MAX_PTS_BLOCKS, fuse_decoder=True, hook=None):
    """Capped-slot evaluation: one sorted stream of all fg and bg slots."""
    Kf = min(max_blend_tiles, scene.n_tiles)
    dnorm = torch.linalg.vector_norm(rays_d, dim=-1, keepdim=True)
    fg = _fg_rows(scene, rays_o, rays_d, z_vals, valid, Kf)
    bg = _bg_rows(scene, rays_o, rays_d, z_bg, bg_tiles, bg_w, bg_valid)
    _mark(hook, "slots")
    rows = _eval_rows(scene, *(torch.cat([f, b]) for f, b in zip(fg[:4], bg)),
                      fuse_decoder, hook)
    n_fg = fg[0].shape[0]
    alpha, color = _fg_blend(rows[:n_fg], fg[4], dists, dnorm, valid)
    rgb_fg, depth_fg, T_left = _composite_premult(alpha, color, z_vals)
    rgb_bg, depth_bg = _bg_blend(scene, rows[n_fg:], rays_o, rays_d, z_bg, d_bg, bg_tiles,
                                 bg_w, bg_valid, invalid_underground)
    return rgb_fg, depth_fg, T_left, rgb_bg, depth_bg, valid


# ---------------------------------------------------------------------------
# staged (per-tile) backend
# ---------------------------------------------------------------------------

def _tile_table(scene: MultiTileScene, t: int) -> torch.Tensor:
    """Tile t's flat [L, H*F] table, a view into the tile-major stack."""
    L = scene.features_flat.shape[0]
    return scene.features_flat.view(L, scene.n_tiles, -1)[:, t]


def _tile_encode(scene: MultiTileScene, t: int, x: torch.Tensor) -> torch.Tensor:
    """Hash encode of [-2, 2] coords [N, 3] under tile t -> [N, L*F] f32,
    by the tiles' layout: the global hash in PyTorch; the windowed hash
    through B2 + B3 on the whole table stack for CUDA tensors, its plain
    gather for CPU tensors."""
    res = scene.resolutions[t]
    if scene.hash_layout == "windowed":
        if x.is_cuda:
            return hw.hash_encode_windowed(x, scene.features_flat, res, tile=t,
                                           n_tables=scene.n_tiles)
        return hw.hash_encode_windowed_ref(x, _tile_table(scene, t), res)
    return hash_encode(x, _tile_table(scene, t), res).to(torch.float32)


def _eval_blended(scene: MultiTileScene, pts, rays_d, dists, exit_tile=None):
    """Every tile's decode of the samples pts [N, S, 3], blended per
    sample -> (diffuse, specular, alpha) [N, S, ...]. fg (``exit_tile``
    None): containing tiles, each gated by its own occupancy grid and
    weighted by its seam weight, normalised by the weight of every
    containing tile (empty ones too). bg: the points of a ray belong to
    its exit tile ``exit_tile`` [N] alone, under the L-inf contraction."""
    N, S = pts.shape[:2]
    dnorm = torch.linalg.vector_norm(rays_d, dim=-1, keepdim=True)
    res = torch.tensor(scene.occupied.shape[1:], device=pts.device)
    acc_d = torch.zeros((N, S, 3), device=pts.device)
    acc_s = torch.zeros((N, S, 3), device=pts.device)
    acc_a = torch.zeros((N, S), device=pts.device)
    acc_w = torch.zeros((N, S), device=pts.device)
    viewdirs = rays_d[:, None, :].expand(N, S, 3)
    for t in range(scene.n_tiles):
        corner, size = scene.block_corner[t], scene.block_size[t]
        inner_c, inner_s = corner + size / 4.0, size / 2.0
        if exit_tile is not None:
            contains = (exit_tile == t)[:, None].expand(N, S)
            xc = _contract_bg(corner, size, pts)
            w = torch.ones((N, S), device=pts.device)
            occ_ok = torch.ones((N, S), dtype=torch.bool, device=pts.device)
        else:
            u = (pts - inner_c) / inner_s
            contains = ((u >= 0) & (u < 1)).all(dim=-1)
            w = _seam_weight(u, inner_s)
            cell = torch.minimum((u * res).to(torch.int32).clamp_min(0),
                                 (res - 1).to(torch.int32)).long()
            occ_ok = scene.occupied[t][cell[..., 0], cell[..., 1], cell[..., 2]]
            xc = _contract_fg(corner, size, pts)
        feats = _tile_encode(scene, t, xc.reshape(-1, 3)).reshape(N, S, -1)
        dec = {name: {k: v[t] for k, v in p.items()} for name, p in scene.decoders.items()}
        out = decoder_lib.apply_decoder(dec, feats, viewdirs)
        alpha_t = 1.0 - torch.exp(-out["sigma"][..., 0] * dists * dnorm)
        spec = out["tint"] * out["specular"]
        m_eval = (contains & occ_ok).to(torch.float32)
        wa = w * alpha_t * m_eval
        acc_d = acc_d + wa[..., None] * out["diffuse"]
        acc_s = acc_s + wa[..., None] * spec
        acc_a = acc_a + wa
        acc_w = acc_w + w * contains.to(torch.float32)
    wsafe = acc_w.clamp_min(1e-8)
    return acc_d / wsafe[..., None], acc_s / wsafe[..., None], acc_a / wsafe


def _render_staged(scene, rays_o, rays_d, z_vals, dists, valid, bg_tiles, bg_w, z_bg, d_bg,
                   bg_valid, invalid_underground, hook=None):
    """Per-tile evaluation of every fg sample, then of every bg sample
    once per exit slot, each composited as the windowed backend does."""
    N = rays_o.shape[0]
    pts = rays_o[:, None, :] + z_vals[..., None] * rays_d[:, None, :]
    diffuse, specular, alpha = _eval_blended(scene, pts, rays_d, dists)
    alpha = torch.where(valid[:, None], alpha, torch.zeros_like(alpha))
    rgb_fg, depth_fg, T_left = _composite_premult(alpha, diffuse + specular, z_vals)
    _mark(hook, "fg")
    pts_bg = rays_o[:, None, :] + z_bg[..., None] * rays_d[:, None, :]
    rgb_bg = torch.zeros((N, 3), device=rays_o.device)
    depth_bg = torch.zeros((N,), device=rays_o.device)
    for k in range(bg_tiles.shape[1]):
        bdiff, bspec, balpha = _eval_blended(scene, pts_bg, rays_d, d_bg,
                                             exit_tile=bg_tiles[:, k])
        bmask = _bg_mask(scene, bg_tiles[:, k], rays_o, rays_d, z_bg, bg_valid,
                         invalid_underground)
        rgb_k, depth_k, _ = _composite_premult(balpha * bmask, (bdiff + bspec) * bmask[..., None],
                                               z_bg)
        rgb_bg = rgb_bg + bg_w[:, k:k + 1] * rgb_k
        depth_bg = depth_bg + bg_w[:, k] * depth_k
    _mark(hook, "bg")
    return rgb_fg, depth_fg, T_left, rgb_bg, depth_bg, valid


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def _resolve_backend(scene: MultiTileScene, backend: str) -> str:
    """``auto`` -> ``windowed`` for windowed tiles with a shared
    resolution ladder, else ``xla`` (staged); ``windowed`` needs both."""
    if backend not in ("auto", "windowed", "xla"):
        raise ValueError(f"unknown backend {backend!r}")
    windowed_ok = scene.hash_layout == "windowed" and scene.shared_res
    if backend == "auto":
        return "windowed" if windowed_ok else "xla"
    if backend == "windowed" and not windowed_ok:
        raise ValueError("the windowed renderer needs windowed-layout tiles "
                         "with a shared resolution ladder")
    return backend


def _check_device(scene: MultiTileScene, device) -> torch.device:
    dev = _device.resolve(device)
    if scene.device.type != dev.type:
        raise ValueError(f"scene lives on {scene.device}, render asked for {dev}")
    return dev


def render_rays(scene: MultiTileScene, rays_o, rays_d, num_sample: int = 128,
                num_bg_sample: int = 128, num_march: int = 512,
                invalid_underground: bool = False, backend: str = "auto",
                max_blend_tiles: int = MAX_PTS_BLOCKS, fuse_decoder: bool = True,
                device="cuda", stage_hook=None) -> dict:
    """Render rays [N, 3] (origin, unnormalized direction) on ``device``,
    which must be the scene's. ``backend``: ``windowed`` (one sorted
    stream: B2, then B7, or B3 and the decoder in PyTorch with
    ``fuse_decoder=False``), ``xla`` (the staged per-tile backend, which
    ignores ``max_blend_tiles`` for fg samples and ``fuse_decoder``) or
    ``auto``. ``stage_hook(name)``, when given, is called after each stage
    (windowed: sample, slots, sort_pack, decode, unsort, blend; staged:
    sample, fg, bg, blend), for timing. Returns rgb [N,3], depth [N,1],
    rgb_fg, T_left, fore_valid."""
    _check_device(scene, device)
    backend = _resolve_backend(scene, backend)
    rays_o = torch.as_tensor(rays_o, dtype=torch.float32, device=scene.device)
    rays_d = torch.as_tensor(rays_d, dtype=torch.float32, device=scene.device)
    z_vals, dists, valid = _sample_union(scene, rays_o, rays_d, num_sample, num_march)
    bg_tiles, bg_w, far, bg_valid = _exit_slots(
        scene, rays_o, rays_d, min(max_blend_tiles, scene.n_tiles))
    z_bg, d_bg = inverse_z_vals(far, num_bg_sample)  # shared by all exit slots
    _mark(stage_hook, "sample")
    args = (scene, rays_o, rays_d, z_vals, dists, valid, bg_tiles, bg_w, z_bg, d_bg,
            bg_valid, invalid_underground)
    if backend == "windowed":
        parts = _render_windowed(*args, max_blend_tiles, fuse_decoder, stage_hook)
    else:
        parts = _render_staged(*args, hook=stage_hook)
    rgb_fg, depth_fg, T_left, rgb_bg, depth_bg, valid = parts
    rgb = rgb_fg + T_left[:, None] * rgb_bg
    depth = depth_fg + T_left * depth_bg
    out = {"rgb": rgb.clamp(0.0, 1.0), "depth": depth[:, None], "rgb_fg": rgb_fg,
           "T_left": T_left, "fore_valid": valid}
    _mark(stage_hook, "blend")
    return out


def render_rays_sharded(scene: MultiTileScene, rays_o, rays_d, mesh, device="cuda",
                        **kwargs) -> dict:
    """``render_rays`` of rays [N, 3] spread over the ``rays`` axis of
    ``mesh`` (N a multiple of its size): each rank renders its contiguous
    slice of the rays with its replica of the scene, and every rank gets
    the whole result (an all_reduce of zero-filled slices, exact), as the
    JAX function's ``shard_map`` with its rays sharded in and out. Both
    backends; ``kwargs`` go to ``render_rays``."""
    axis = mesh.axis("rays")
    n = 1 if axis is None else axis.size
    if rays_o.shape[0] % n:
        raise ValueError(f"{rays_o.shape[0]} rays do not split over {n} ranks")
    if n == 1:
        return render_rays(scene, rays_o, rays_d, device=device, **kwargs)
    k = rays_o.shape[0] // n
    part = slice(axis.index * k, (axis.index + 1) * k)
    out = render_rays(scene, rays_o[part], rays_d[part], device=device, **kwargs)
    whole = {}
    for key, v in out.items():
        g = mesh_lib.gather_slices(v.to(torch.float32).contiguous(), axis, 0)
        whole[key] = g.to(v.dtype) if v.dtype != torch.bool else g > 0.5
    return whole


def render_image(scene: MultiTileScene, K, c2w, H: int, W: int, chunk: int = 2**13,
                 sharded: bool = False, early_term: bool = False,
                 early_kwargs: dict | None = None, device="cuda", mesh=None,
                 **kwargs) -> dict:
    """Full-frame render in chunks of rays -> {"rgb": [H, W, 3],
    "depth": [H, W, 1]} numpy arrays. ``kwargs`` go to ``render_rays``;
    ``early_term=True`` renders each chunk with
    ``early_term.render_rays_early`` instead (windowed tiles), which takes
    ``early_kwargs`` (slab, term_eps, bucket_min, stats).
    ``sharded=True`` spreads each chunk (rounded up to a multiple of the
    ranks) over the ``rays`` axis of ``mesh`` (default: a new mesh of
    every rank of the joined group, made collectively;
    ``render_rays_sharded``), every rank returning the whole frame; in
    one process it is the plain render."""
    from scanerf_tpu_torch.utils import lie, rays as rays_mod

    dev = _check_device(scene, device)
    if sharded and mesh is None and mesh_lib.world()[1] > 1:
        mesh = mesh_lib.make_mesh({"rays": mesh_lib.world()[1]})
    if not sharded or (mesh is not None and mesh.size("rays") == 1):
        mesh = None
    if mesh is not None:
        if early_term:
            raise ValueError("early_term is a one-rank driver")
        n = mesh.size("rays")
        chunk = -(-chunk // n) * n
    xy = rays_mod.pixel_grid(H, W, device=dev)
    pose = lie.invert(torch.as_tensor(np.asarray(c2w), dtype=torch.float32, device=dev))
    rays_o, rays_d = rays_mod.get_center_and_ray(
        xy, pose, torch.as_tensor(np.asarray(K), dtype=torch.float32, device=dev))
    n = rays_o.shape[0]
    pad = (-n) % chunk
    rays_o = torch.nn.functional.pad(rays_o, (0, 0, 0, pad))
    rays_d = torch.nn.functional.pad(rays_d, (0, 0, 0, pad), value=1.0)
    if early_term:
        from scanerf_tpu_torch.render.early_term import render_rays_early

        kw = {k: v for k, v in kwargs.items() if k not in ("backend", "stage_hook")}
        kw.update(early_kwargs or {})
    outs = {"rgb": [], "depth": []}
    for i in range(0, n + pad, chunk):
        ro, rd = rays_o[i:i + chunk], rays_d[i:i + chunk]
        if early_term:
            out = render_rays_early(scene, ro, rd, device=dev, **kw)
        elif mesh is not None:
            out = render_rays_sharded(scene, ro, rd, mesh, device=dev, **kwargs)
        else:
            out = render_rays(scene, ro, rd, device=dev, **kwargs)
        outs["rgb"].append(out["rgb"])
        outs["depth"].append(out["depth"])
    return {k: torch.cat(v)[:n].reshape(H, W, -1).cpu().numpy() for k, v in outs.items()}
