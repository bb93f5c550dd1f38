"""Windowed multiresolution hash: index math, the sorted stream, B2, and
the windowed lookup B3 with its backward B4.

Counterpart of ``scanerf_tpu/ops/pallas/hash_encode.py:130-822`` and
``:1210-1363``. Each level's table of H entries is split into NW = H /
512 windows; a point's window is a raster cell of the warped [0, 1]^3
tile domain, and its 8 corner slots are a folded prime-XOR hash inside
that window. The renderer sorts its (point, tile) rows by window into a
``SortedStream`` whose 1024-row chunks each lie inside one 32-window
block, so that one tile's decoder serves a whole chunk.

B2, the stream pack, replaces the Pallas kernel
``hash_encode.py::_pack_kernel`` (launched by ``_sort_pack_sorted`` at
hash_encode.py:636). One CUDA block per output chunk
(``csrc/pack.cu``) copies the chunk's run of the window-sorted columns
and fills the tail with pad rows. It moves bytes and nothing else, so
device memory bounds it: 32 bytes read and 36 written per stream row.
The window sort itself stays ``torch.sort(stable=True)``, like the
``lax.sort`` before it: a stable sort gives the same order, so the
stream equals the JAX stream field by field. Point ids are int32 here
(the TPU kernel carried them as f32, exact only below 2^24). B2 has a
second mode, a compile-time flag of the same kernel: ``pack_gather``
reads each sorted row's payload through the sort's permutation instead
of from sorted columns, and writes the stream's ``meta`` as it packs.
``sort_pack_keys`` builds the stream so from rows that come keyed (the
windowed render's, ``ops/kernels/row_build.py``); it equals
``sort_pack_tables`` of the same rows field by field.

B3 and B4, the lookup of the unfused configuration, replace the Pallas
kernels ``hash_encode.py::_fwd_kernel`` (launched by ``_run_fwd`` at
hash_encode.py:1231) and ``_bwd_kernel`` (``_run_bwd``, :1268), in
``csrc/hash_encode.cu``. ``hash_lookup_sorted`` is a
``torch.autograd.Function`` whose forward is B3 (the stream's features
[Np, L*2] f32, zero on sentinel rows; f32 or bf16 tables; each chunk's
window span copied level by level into shared memory, where its rows
gather their corners) and whose
backward is B4 (the table gradient summed per chunk and level in shared
memory, then added to a zeroed dense buffer, so unvisited blocks stay
exactly zero, and the analytic dL/du in dpts rows 0-2; f32 tables only).
B6's wrapper launches B4's kernel too, through ``scatter_bwd``, for its
table gradient. B4 has two more modes, compile-time flags of the same
kernel: ``bf16`` rounds each (row, corner, feature) contribution w * g to
bf16 before it is summed (the JAX ``onehot_bf16`` option, whose one-hot
operand is exact in bf16 and whose weighted operand rounds,
hash_encode.py:996-1016; sums and dL/du stay f32), and dL/du alone, which
the autograd backward takes when the tables need no gradient (surface
normals): no table gradient is allocated or written. Device memory bounds
B3 and, by its design, B4 (see the source's note).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from scanerf_tpu_torch import _build
from scanerf_tpu_torch.ops.hash_encode import CORNERS, MASK32, PRIMES, as_3d

W = 512  # entries per window
WB = 32  # windows per block
CHUNK = 1024  # stream rows per chunk
SUBT = CHUNK // 128  # 128-row subtiles per chunk (rows of ``meta``)
BWD_MODES = ("exact", "bf16", "du")  # B4's modes: csrc/hash_encode.cu's BwdMode, in order


@functools.cache
def geometry(H: int):
    """Window grid for a table of H entries: (NW, NB, (Cx, Cy, Cz))."""
    if H < W * WB or H & (H - 1):
        raise ValueError(f"windowed hash needs a power of two >= {W * WB}, got {H}")
    NW = H // W
    bits = int(np.log2(NW))
    return NW, NW // WB, (2 ** ((bits + 2) // 3), 2 ** ((bits + 1) // 3),
                          2 ** (bits // 3))


def expand_warp(u: torch.Tensor) -> torch.Tensor:
    """Piecewise-linear warp giving the fg octant ~42% of the windows."""
    lo = u * 0.5
    mid = 0.125 + (u - 0.25) * 1.5
    hi = 0.875 + (u - 0.75) * 0.5
    return torch.where(u < 0.25, lo, torch.where(u < 0.75, mid, hi))


def window_id(u: torch.Tensor, H: int) -> torch.Tensor:
    """Raster window id of points u [N, 3] in [0, 1]^3 -> int32 [N]."""
    _, _, (cx, cy, cz) = geometry(H)
    dims = torch.tensor([cx, cy, cz], dtype=u.dtype, device=u.device)
    c = torch.floor(expand_warp(u) * dims).to(torch.int32)
    c = torch.minimum(c.clamp_min(0), (dims - 1).to(torch.int32))
    return (c[..., 0] * cy + c[..., 1]) * cz + c[..., 2]


def window_keys(u, tids, H: int, n_tables: int, dead=None):
    """Sort keys of rows u [N, 3] in [0, 1]^3 under tables (tiles) ``tids``
    [N]: window ``tid * NW1 + wid`` of the stacked tables, or their
    sentinel NW where ``dead`` [N] bool -> (int32 [N], NW)."""
    NW1, _, _ = geometry(H)
    NW = NW1 * n_tables
    wid = window_id(u, H) + tids.to(torch.int32) * NW1
    if dead is not None:
        wid = torch.where(dead, torch.full_like(wid, NW), wid)
    return wid, NW


def slot_hash(ix, iy, iz) -> torch.Tensor:
    """In-window slot [0, 512) of integer corner coords. The uint32 wrap of
    the reference is done in int64 with a 32-bit mask."""
    h = ((ix * PRIMES[0]) & MASK32) ^ ((iy * PRIMES[1]) & MASK32) \
        ^ ((iz * PRIMES[2]) & MASK32)
    h = h ^ (h >> 9) ^ (h >> 18)
    return h & (W - 1)


def _level_corners(u, wid, res_l):
    """One level's corners of rows u [N, 3] in [0, 1]^3 in windows ``wid``
    [N] int64 at resolution ``res_l`` [3]: the 8 corner entries' indices
    into the level's [nW*512, F] table [N, 8] and their per-axis trilinear
    factors [N, 8, 3], whose product over the axes is the corner's
    weight."""
    corners = torch.as_tensor(CORNERS, device=u.device)
    cf = corners.to(u.dtype)
    v = u * (res_l.to(u.dtype) - 1.0)
    bl = torch.floor(v)
    off = v - bl
    ic = (bl.to(torch.int64) & MASK32)[:, None, :] + corners[None]
    idx = wid[:, None] * W + slot_hash(ic[..., 0], ic[..., 1], ic[..., 2])
    return idx, cf[None] * off[:, None, :] + (1 - cf[None]) * (1 - off[:, None, :])


def encode_rows(u, wid, features, resolutions) -> torch.Tensor:
    """Windowed hash features of rows u [N, 3] in [0, 1]^3 whose window
    ids ``wid`` [N] index the windows of ``features`` (flat [L, nW*512*F]
    or [L, nW*512, F], f32 or bf16, widened to f32) -> [N, L*F] f32."""
    features = as_3d(features)
    L, _, F = features.shape
    wid = wid.to(torch.int64)
    out = []
    for lvl in range(L):
        idx, fac = _level_corners(u, wid, resolutions[lvl])
        wgt = torch.prod(fac, dim=-1)
        gathered = features[lvl][idx].to(torch.float32)  # [N, 8, F]
        out.append((wgt[..., None] * gathered).sum(dim=1))
    return torch.stack(out, dim=1).reshape(u.shape[0], L * F)


def hash_encode_windowed_ref(points, features, resolutions) -> torch.Tensor:
    """Gather implementation of the windowed hash: points [N, 3] in
    [-2, 2], one tile's features [L, H, F] or flat [L, H*F] (f32 or
    bf16, widened to f32), resolutions [L, 3] -> [N, L*F] f32."""
    u = (points + 2.0) * 0.25
    return encode_rows(u, window_id(u, as_3d(features).shape[1]), features,
                       resolutions)


@dataclasses.dataclass
class SortedStream:
    """Padded, window-sorted row stream (same fields and contents as the
    JAX ``SortedStream`` with ``inv_full=None``)."""

    pts: torch.Tensor  # [NC, 8, CHUNK] f32: rows u0 u1 u2 widf d0 d1 d2 0
    meta: torch.Tensor  # [NC, SUBT, 4] i32: (boc, wmin, span, wbase 0) per subtile
    pidp: torch.Tensor  # [Np] i32 original row index (N for pad rows)
    visited: torch.Tensor  # [NB] bool: block has rows


def padded_size(N: int, H: int, n_tables: int = 1) -> tuple[int, int]:
    """(Np, NC) after worst-case block alignment."""
    _, NB, _ = geometry(H)
    Np = -(-N // CHUNK) * CHUNK + NB * n_tables * CHUNK
    return Np, Np // CHUNK


def _stream_meta(pts: torch.Tensor, NC: int, NW: int) -> torch.Tensor:
    """Per 128-row subtile: (boc, wmin, span, 0). Sentinel rows (window
    NW: dead and pad rows) are left out, so an all-sentinel subtile has
    span 0 and an all-sentinel chunk is skipped by the decode kernel."""
    widp = pts[:, 3, :].to(torch.int32).reshape(NC, SUBT, 128)
    real = widp < NW
    big = torch.full_like(widp, 2**30)
    wmin = torch.where(real, widp, big).amin(dim=2)
    wmax = torch.where(real, widp, torch.full_like(widp, -1)).amax(dim=2)
    span = (wmax - wmin + 1).clamp_min(0)
    wmin = wmin.clamp_max(NW - 1)
    boc = torch.div(wmin.amin(dim=1), WB, rounding_mode="floor").clamp(0, NW // WB - 1)
    return torch.stack([boc[:, None].expand(NC, SUBT), wmin, span,
                        torch.zeros_like(wmin)], dim=-1).to(torch.int32)


def pack_plain(src, pids, desc, NC, pad_wid):
    """Plain PyTorch version of B2. src [7, N] f32 window-sorted columns
    (u0 u1 u2 wid d0 d1 d2), pids [N] i32, desc [NC, 2] i32 (source start,
    real rows) -> pts [NC, 8, CHUNK] f32, pidp [NC*CHUNK] i32."""
    N = src.shape[1]
    t = torch.arange(CHUNK, device=src.device)
    real = t[None, :] < desc[:, 1:2]  # [NC, CHUNK]
    idx = torch.where(real, desc[:, 0:1] + t[None, :], torch.zeros_like(t))
    idx = idx.to(torch.int64)
    pad = torch.tensor([0.5, 0.5, 0.5, float(pad_wid), 0.0, 0.0, 0.0],
                       device=src.device)
    cols = torch.where(real[:, None, :], src[:, idx].permute(1, 0, 2),
                       pad[None, :, None])
    pts = torch.cat([cols, torch.zeros_like(cols[:, :1])], dim=1)
    pidp = torch.where(real, pids[idx], torch.full_like(idx, N).to(pids.dtype))
    return pts, pidp.reshape(NC * CHUNK)


def check_tensor(name, t, dtype, shape, device):
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device`` (what a kernel's pointer arithmetic assumes)."""
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or not t.is_contiguous() \
            or t.device != device:
        raise ValueError(f"{name}: want contiguous {dtype} {tuple(shape)} on {device}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def _pack_fn():
    f = _build.load("pack").scanerf_pack
    f.restype = ctypes.c_int
    f.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_float] \
        + [ctypes.c_void_p] * 3
    return f


def pack(src, pids, desc, NC, pad_wid):
    """B2 wrapper: CPU tensors take ``pack_plain``; CUDA tensors launch
    the kernel. Same arguments and results as ``pack_plain``."""
    if src.device.type == "cpu":
        return pack_plain(src, pids, desc, NC, pad_wid)
    if src.device.type != "cuda":
        raise ValueError(f"unsupported device {src.device}")
    N = src.shape[1]
    if src.dtype != torch.float32 or src.shape[0] != 7 or not src.is_contiguous():
        raise ValueError(f"src must be contiguous f32 [7, N], got {src.dtype} {tuple(src.shape)}")
    if pids.dtype != torch.int32 or tuple(pids.shape) != (N,) or not pids.is_contiguous():
        raise ValueError("pids must be contiguous int32 [N]")
    if desc.dtype != torch.int32 or tuple(desc.shape) != (NC, 2) or not desc.is_contiguous():
        raise ValueError("desc must be contiguous int32 [NC, 2]")
    if pids.device != src.device or desc.device != src.device:
        raise ValueError("src, pids and desc must share a device")
    pts = torch.empty((NC, 8, CHUNK), dtype=torch.float32, device=src.device)
    pidp = torch.empty((NC * CHUNK,), dtype=torch.int32, device=src.device)
    P = _build.ptr
    err = _pack_fn()(P(src), P(pids), P(desc), N, NC, float(pad_wid),
                     P(pts), P(pidp), _build.stream_ptr(src))
    _build.check(err, "scanerf_pack")
    pack.launches += 1
    return pts, pidp


pack.launches = 0


def pack_gather_plain(keys, perm, payload, dirs, desc, NC, pad_wid):
    """Plain PyTorch version of B2's gather mode. keys [N] i32 sorted, perm
    [N] i64 the payload row of each sorted row, payload [N, 4] f32 (u0 u1
    u2, the row's index into dirs), dirs [*, 3] f32, desc as ``pack``'s ->
    (pts, pidp) as ``pack_plain`` gives them for the sorted columns, and
    meta [NC, SUBT, 4] i32 as ``_stream_meta`` computes it."""
    pay = payload[perm]
    src = torch.cat([pay[:, :3].t(), keys[None].to(torch.float32),
                     dirs[pay[:, 3].to(torch.int64)].t()]).contiguous()
    pts, pidp = pack_plain(src, perm.to(torch.int32), desc, NC, pad_wid)
    return pts, pidp, _stream_meta(pts, NC, int(pad_wid))


def _pack_gather_fn():
    f = _build.load("pack").scanerf_pack_gather
    f.restype = ctypes.c_int
    f.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [ctypes.c_float] \
        + [ctypes.c_void_p] * 4
    return f


def pack_gather(keys, perm, payload, dirs, desc, NC, pad_wid):
    """B2 wrapper, gather mode: CPU tensors take ``pack_gather_plain``;
    CUDA tensors launch the kernel. Same arguments and results as
    ``pack_gather_plain``; the payload starts on a 16-byte boundary (the
    kernel loads a row as one float4). Its launches count in
    ``pack_gather.launches``, the copy mode's in ``pack.launches``."""
    if keys.device.type == "cpu":
        return pack_gather_plain(keys, perm, payload, dirs, desc, NC, pad_wid)
    if keys.device.type != "cuda":
        raise ValueError(f"unsupported device {keys.device}")
    N, dev = keys.shape[0], keys.device
    check_tensor("keys", keys, torch.int32, (N,), dev)
    check_tensor("perm", perm, torch.int64, (N,), dev)
    check_tensor("payload", payload, torch.float32, (N, 4), dev)
    check_tensor("dirs", dirs, torch.float32, (dirs.shape[0], 3), dev)
    check_tensor("desc", desc, torch.int32, (NC, 2), dev)
    if payload.data_ptr() % 16:
        raise ValueError("payload must start on a 16-byte boundary (one float4 load a row)")
    pts = torch.empty((NC, 8, CHUNK), dtype=torch.float32, device=dev)
    pidp = torch.empty((NC * CHUNK,), dtype=torch.int32, device=dev)
    meta = torch.empty((NC, SUBT, 4), dtype=torch.int32, device=dev)
    P = _build.ptr
    err = _pack_gather_fn()(P(keys), P(perm), P(payload), P(dirs), P(desc), N, NC,
                            float(pad_wid), P(pts), P(pidp), P(meta), _build.stream_ptr(keys))
    _build.check(err, "scanerf_pack_gather")
    pack_gather.launches += 1
    return pts, pidp, meta


pack_gather.launches = 0


def sort_columns(x, dirs, tids, H: int, n_tables: int, dead=None):
    """Window-sort the rows: returns (src [7, N] f32 sorted columns
    u0 u1 u2 wid d0 d1 d2, pids [N] i32, ws [N] i32 sorted window ids,
    NW of the stacked tables)."""
    u = (x + 2.0) * 0.25
    wid, NW = window_keys(u, tids, H, n_tables, dead)
    ws, perm = torch.sort(wid, stable=True)
    pay = torch.cat([u, dirs], dim=1)[perm].t()  # [6, N]
    src = torch.cat([pay[0:3], ws[None].to(torch.float32), pay[3:6]]).contiguous()
    return src, perm.to(torch.int32), ws, NW


def chunk_descriptors(ws, N: int, H: int, n_tables: int):
    """Per output chunk (source start, real rows) [NC, 2] i32 and the
    per-block populations [NB] (a block's rows start on a chunk)."""
    _, NB1, _ = geometry(H)
    NB = NB1 * n_tables
    NW = NB * WB
    Np, NC = padded_size(N, H, n_tables)
    dev = ws.device
    # last query NW+1: dead-sentinel rows count into the last block
    q = torch.cat([torch.arange(NB, device=dev, dtype=torch.int32) * WB,
                   torch.tensor([NW + 1], device=dev, dtype=torch.int32)])
    bounds = torch.searchsorted(ws, q, side="left")
    pop = bounds[1:] - bounds[:-1]
    padded = -(-pop // CHUNK) * CHUNK
    S = torch.cat([torch.zeros(1, dtype=padded.dtype, device=dev),
                   torch.cumsum(padded, 0)])
    c0 = torch.arange(NC, device=dev, dtype=torch.int64) * CHUNK
    b_of_c = (torch.searchsorted(S, c0, side="right") - 1).clamp(0, NB - 1)
    src_start = (c0 - (S[b_of_c] - bounds[b_of_c])).clamp(0, N)
    n_real = (S[b_of_c] + pop[b_of_c] - c0).clamp(0, CHUNK)
    desc = torch.stack([src_start, n_real], dim=1).to(torch.int32).contiguous()
    return desc, pop


def sort_pack_tables(x, dirs, tids, H: int, n_tables: int, dead=None) -> SortedStream:
    """Multi-table window sort + pad-align of rows x [N, 3] in [-2, 2] with
    view dirs [N, 3] and table (tile) ids [N]: row i lands in window
    ``tid * NW + wid``; tile boundaries coincide with block boundaries,
    so every chunk lies inside one tile's tables. ``dead`` [N] bool sends
    rows whose outputs are discarded to the sentinel window."""
    N = x.shape[0]
    src, pids, ws, NW = sort_columns(x, dirs, tids, H, n_tables, dead)
    desc, pop = chunk_descriptors(ws, N, H, n_tables)
    NC = desc.shape[0]
    pts, pidp = pack(src, pids, desc, NC, NW)
    return SortedStream(pts=pts, meta=_stream_meta(pts, NC, NW), pidp=pidp,
                        visited=pop > 0)


def sort_pack_keys(keys, payload, dirs, H: int, n_tables: int) -> SortedStream:
    """``sort_pack_tables`` of rows that come keyed: keys [N] i32 (window
    ``tid * NW1 + wid``, the sentinel NW for dead rows: ``window_keys``),
    payload [N, 4] f32 (u0 u1 u2 and the row's index into dirs [*, 3]).
    The same stream, field by field, as ``sort_pack_tables`` of the rows
    they were built from: the same stable sort of the same keys, then B2
    in its gather mode, which reads the payload through the permutation
    and writes ``meta``."""
    N = keys.shape[0]
    ws, perm = torch.sort(keys, stable=True)
    desc, pop = chunk_descriptors(ws, N, H, n_tables)
    pts, pidp, meta = pack_gather(ws, perm, payload, dirs, desc, desc.shape[0],
                                  geometry(H)[0] * n_tables)
    return SortedStream(pts=pts, meta=meta, pidp=pidp, visited=pop > 0)


class _SortPack(torch.autograd.Function):
    """Single-table window sort + pack, differentiable in the positions
    and view dirs it carries (the window assignment is piecewise
    constant). Backward (the JAX ``_sp_bwd``, hash_encode.py:708-732):
    each stream row's cotangent of pts rows 0-2, times 0.25 (u = (x+2)/4),
    and of rows 4-6 goes back to its source row; pad rows have no source.
    Dead rows get what their stream rows got, which is zero on the
    training path (their outputs are masked before any loss)."""

    @staticmethod
    def forward(ctx, x, dirs, H, dead):
        tids = torch.zeros(x.shape[0], dtype=torch.int32, device=x.device)
        st = sort_pack_tables(x, dirs, tids, H, 1, dead=dead)
        ctx.save_for_backward(st.pidp)
        ctx.n_rows = x.shape[0]
        ctx.mark_non_differentiable(st.meta, st.pidp, st.visited)
        return st.pts, st.meta, st.pidp, st.visited

    @staticmethod
    def backward(ctx, g_pts, *_):
        (pidp,) = ctx.saved_tensors
        N = ctx.n_rows
        if g_pts is None:
            return None, None, None, None
        cols = g_pts.permute(0, 2, 1).reshape(-1, 8)
        out = cols.new_zeros((N + 1, 6))
        out.index_copy_(0, pidp.to(torch.int64),
                        torch.cat([cols[:, 0:3] * 0.25, cols[:, 4:7]], dim=1))
        return out[:N, 0:3], out[:N, 3:6], None, None


def sort_pack(x, dirs, H: int, dead=None) -> SortedStream:
    """Window-sort + pad-align rows x [N, 3] in [-2, 2] with view dirs
    [N, 3] for one table of H entries; ``dead`` [N] bool sends rows whose
    outputs are discarded to the sentinel window. ``pts`` is
    differentiable in x and dirs."""
    pts, meta, pidp, visited = _SortPack.apply(x, dirs, H, dead)
    return SortedStream(pts=pts, meta=meta, pidp=pidp, visited=visited)


class _UnsortRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, vals, pidp, N):
        ctx.save_for_backward(pidp)
        ctx.n_rows = N
        out = vals.new_empty((N + 1, vals.shape[1]))
        out.index_copy_(0, pidp.to(torch.int64), vals)
        return out[:N]

    @staticmethod
    def backward(ctx, g):
        (pidp,) = ctx.saved_tensors
        gz = torch.cat([g, g.new_zeros((1, g.shape[1]))])
        return gz[pidp.to(torch.int64)], None, None


def unsort_rows(vals: torch.Tensor, pidp: torch.Tensor, N: int) -> torch.Tensor:
    """Padded-sorted [Np, D] -> original row order [N, D] (pad rows, whose
    pid is N, land in a dropped extra row). Differentiable: the backward
    gathers by ``pidp`` (hash_encode.py:804-819), pad rows get zero."""
    return _UnsortRows.apply(vals, pidp, N)


# ---------------------------------------------------------------------------
# B3 / B4: the windowed lookup over the sorted stream and its backward
# ---------------------------------------------------------------------------

def _stream_rows(pts, NW: int, nw_table: int | None = None, wbase=None):
    """Per stream row: u [Np, 3], its window's index in the table of
    ``nw_table`` windows (None: ``NW``) whose window 0 has the global id
    ``wbase`` (per chunk [NC], or None: 0), 0 where the row has none
    there, and whether it has one (a real row, window below ``NW``, of the
    table's range)."""
    nw_table = NW if nw_table is None else nw_table
    u = pts[:, 0:3, :].permute(0, 2, 1).reshape(-1, 3)
    wid = pts[:, 3, :].reshape(-1).to(torch.int64)
    if wbase is not None:
        wid = wid - wbase.to(torch.int64).repeat_interleave(CHUNK)
    real = (wid >= 0) & (wid < min(NW, nw_table))
    return u, torch.where(real, wid, torch.zeros_like(wid)), real


def table_windows(features) -> int:
    """Windows of a flat [L, nW*512*2] or [L, nW*512, 2] table (shard)."""
    return as_3d(features).shape[1] // W


def lookup_fwd_plain(pts, features, resolutions, NW: int, wbase=None) -> torch.Tensor:
    """Plain PyTorch version of B3: [Np, L*2] f32 hash features of every
    row of the stream ``pts`` [NC, 8, CHUNK] (zero on rows in the sentinel
    window ``NW``, so on every row of an all-sentinel chunk). On a table
    shard, ``wbase`` [NC] is each chunk's ``meta[:, 0, 3]``, the global id
    of the shard's window 0, and rows whose window lies outside the shard
    get zeros too (B3 gives chunks of other shards span 0)."""
    u, wid, real = _stream_rows(pts, NW, table_windows(features), wbase)
    feats = encode_rows(u, wid, features, resolutions)
    return torch.where(real[:, None], feats, torch.zeros_like(feats))


def lookup_bwd_plain(pts, features, resolutions, g, NW: int, mode: str = "exact",
                     wbase=None):
    """Plain PyTorch version of B4: the cotangents of ``lookup_fwd_plain``
    under ``g`` [Np, L*2], written out (not by autograd) -> (dpts [NC, 8,
    CHUNK] with dL/du in rows 0-2 and zeros in rows 3-7, d_features like
    ``features``, f32); ``wbase`` as ``lookup_fwd_plain``'s, rows outside
    the shard contributing nothing. The table gradient is an ``index_add_`` of each
    corner's trilinear weight times the row's cotangent pair (``mode``
    "bf16": each such product rounded to bf16 first; "du": no table
    gradient, d_features None); dL/du sums, per level and corner, the
    derivative of the weight along each axis times (resolution - 1) times
    the cotangent's dot with the corner's features."""
    if mode not in BWD_MODES:
        raise ValueError(f"unknown mode {mode!r}")
    f3 = as_3d(features)
    L = f3.shape[0]
    u, wid, real = _stream_rows(pts, NW, f3.shape[1] // W, wbase)
    g3 = torch.where(real[:, None], g, torch.zeros_like(g)).reshape(-1, L, 2)
    sign = 2.0 * torch.as_tensor(CORNERS, device=u.device).to(u.dtype) - 1.0  # [8, 3]
    d3 = None if mode == "du" else torch.zeros(f3.shape, dtype=torch.float32, device=u.device)
    du = torch.zeros_like(u)
    for lvl in range(L):
        idx, fac = _level_corners(u, wid, resolutions[lvl])  # [Np, 8], [Np, 8, 3]
        scale = resolutions[lvl].to(u.dtype) - 1.0
        # x * y * z left to right, as the kernel multiplies: a reduction may
        # take another order on CUDA, and an ulp of w moves w * g's bf16 rounding
        wgt = fac[..., 0] * fac[..., 1] * fac[..., 2]  # [Np, 8]
        gl = g3[:, lvl]  # [Np, 2]
        if d3 is not None:
            contrib = wgt[..., None] * gl[:, None, :]
            if mode == "bf16":
                contrib = contrib.to(torch.bfloat16).to(torch.float32)
            d3[lvl].index_add_(0, idx.reshape(-1), contrib.reshape(-1, 2))
        dot = (f3[lvl][idx].to(torch.float32) * gl[:, None, :]).sum(dim=-1)  # [Np, 8]
        others = torch.stack([fac[..., 1] * fac[..., 2], fac[..., 0] * fac[..., 2],
                              fac[..., 0] * fac[..., 1]], dim=-1)  # d wgt / d off
        du = du + (sign[None] * others * dot[..., None]).sum(dim=1) * scale
    NC = pts.shape[0]
    dpts = torch.zeros_like(pts)
    dpts[:, 0:3, :] = du.reshape(NC, CHUNK, 3).permute(0, 2, 1)
    return dpts, None if d3 is None else d3.reshape(features.shape)


_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _lookup_fn(name, argtypes):
    f = getattr(_build.load("hash_encode"), name)
    f.restype = ctypes.c_int
    f.argtypes = argtypes
    return f


def _check_lookup(pts, meta, features, resolutions, NW: int, shards: int = 1):
    """Raise unless the stream and the table (a shard of ``NW // shards``
    windows, whose first window's global id each chunk's meta carries)
    are what B3 / B4 read."""
    dev = pts.device
    NC, L = pts.shape[0], resolutions.shape[0]
    check_tensor("pts", pts, torch.float32, (NC, 8, CHUNK), dev)
    check_tensor("meta", meta, torch.int32, (NC, SUBT, 4), dev)
    check_tensor("resolutions", resolutions, torch.int32, (L, 3), dev)
    if features.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"features must be f32 or bf16, got {features.dtype}")
    check_tensor("features", features, features.dtype, (L, features.shape[1]), dev)
    if NW % shards or features.shape[1] != NW // shards * W * 2 or not 1 <= L <= 16:
        raise ValueError(f"features {tuple(features.shape)}: want [L <= 16, "
                         f"{NW // shards * W * 2}] ({shards} shards of {NW} windows)")


def lookup_fwd(pts, meta, features, resolutions, NW: int, shards: int = 1) -> torch.Tensor:
    """B3 wrapper -> feats [Np, L*2] f32 in stream order. CPU tensors take
    ``lookup_fwd_plain``; CUDA tensors launch the kernel. ``features`` is
    the flat [L, NW*512*2] f32 or bf16 table (stack), or with ``shards`` >
    1 one shard of it, [L, NW/shards*512*2], whose window 0 each chunk's
    ``meta[:, 0, 3]`` names (``table_parallel.localize_meta``); ``NW`` is
    the whole table's window count, the sentinel window id. ``meta`` must
    be the stream's own (the kernel stages only the windows it names)."""
    if pts.device.type == "cpu":
        return lookup_fwd_plain(pts, features, resolutions, NW, _wbase(meta, shards))
    if pts.device.type != "cuda":
        raise ValueError(f"unsupported device {pts.device}")
    _check_lookup(pts, meta, features, resolutions, NW, shards)
    if features.data_ptr() % 16:
        raise ValueError("features must start on a 16-byte boundary: B3 copies its "
                         "windows in 16-byte pieces")
    NC, L = pts.shape[0], resolutions.shape[0]
    out = torch.empty((NC * CHUNK, 2 * L), dtype=torch.float32, device=pts.device)
    f = _lookup_fn("scanerf_lookup_fwd", [_P, _P, _P, _I, _LL, _I, _P, _I, _I, _P, _P])
    P = _build.ptr
    err = f(P(pts), P(meta), P(features), int(features.dtype == torch.bfloat16),
            features.shape[1], L, P(resolutions), NW, NC, P(out), _build.stream_ptr(pts))
    _build.check(err, "scanerf_lookup_fwd")
    lookup_fwd.launches += 1
    return out


lookup_fwd.launches = 0


def _wbase(meta, shards: int):
    """Each chunk's ``wbase`` for the plain versions (None: a whole table)."""
    return meta[:, 0, 3] if shards > 1 else None


def scatter_bwd(pts, meta, features, resolutions, g, NW: int, dpts, own_rows: int,
                adds=None, g_layout: str = "rows", mode: str = "exact", shards: int = 1):
    """Launch B4's kernel, the table scatter and dL/du, on CUDA tensors ->
    d_features [L, NW*512*2] f32 (None in ``mode`` "du"); writes dL/du
    into dpts rows 0-2 and, with ``own_rows`` 8, zeros into rows 3-7 (with
    3 it leaves them to the caller). ``g`` is the features' cotangent,
    [Np, L*2] (``g_layout`` "rows") or [NC, L*2, CHUNK] ("chunks").
    ``mode``: "exact", "bf16" (each contribution rounded to bf16 before it
    is summed) or "du" (dL/du alone: no table gradient). With ``adds``, an
    int64 [1] tensor, the kernel adds to it the f32 elements it added to
    the table gradient with global atomics. Counts every launch of B4's
    kernel, whichever wrapper calls it (``lookup_bwd``, B6's
    ``train_bwd``), in ``launches[mode]``. ``shards``: as ``lookup_fwd``'s
    (the gradient is the shard's)."""
    if mode not in BWD_MODES:
        raise ValueError(f"unknown mode {mode!r}")
    _check_lookup(pts, meta, features, resolutions, NW, shards)
    NC, L = pts.shape[0], resolutions.shape[0]
    if g_layout == "rows":
        check_tensor("g", g, torch.float32, (NC * CHUNK, 2 * L), pts.device)
        g_row, g_feat = 2 * L, 1
    else:
        check_tensor("g", g, torch.float32, (NC, 2 * L, CHUNK), pts.device)
        g_row, g_feat = 1, CHUNK
    check_tensor("dpts", dpts, torch.float32, tuple(pts.shape), pts.device)
    if adds is not None:
        check_tensor("adds", adds, torch.int64, (1,), pts.device)
    du = mode == "du"
    d_features = None if du else torch.zeros_like(features)
    f = _lookup_fn("scanerf_lookup_bwd", [_P, _P, _P, _LL, _I, _P, _P, _I, _I, _I, _I, _I,
                                          _I, _P, _P, _P, _P])
    P = _build.ptr
    err = f(P(pts), P(meta), P(features), features.shape[1], L, P(resolutions), P(g), g_row,
            g_feat, NW, NC, own_rows, BWD_MODES.index(mode),
            None if du else P(d_features), P(dpts),
            P(adds) if adds is not None and not du else None, _build.stream_ptr(pts))
    _build.check(err, "scanerf_lookup_bwd")
    scatter_bwd.launches[mode] += 1
    return d_features


scatter_bwd.launches = dict.fromkeys(BWD_MODES, 0)


def lookup_bwd(pts, meta, features, resolutions, g, NW: int, adds=None,
               mode: str = "exact", shards: int = 1):
    """B4 wrapper -> (dpts [NC, 8, CHUNK], d_features like ``features``
    f32, or None in ``mode`` "du"). CPU tensors take ``lookup_bwd_plain``;
    CUDA tensors launch the kernel (``adds``, ``mode`` and the launch
    counts: see ``scatter_bwd``; ``shards``: see ``lookup_fwd``).
    Tables must be f32 (bf16 tables are for inference)."""
    if features.dtype != torch.float32:
        raise ValueError(f"the lookup's backward needs f32 tables, got {features.dtype}")
    if pts.device.type == "cpu":
        return lookup_bwd_plain(pts, features, resolutions, g, NW, mode, _wbase(meta, shards))
    if pts.device.type != "cuda":
        raise ValueError(f"unsupported device {pts.device}")
    dpts = torch.empty_like(pts)
    d_features = scatter_bwd(pts, meta, features, resolutions, g, NW, dpts, 8, adds,
                             mode=mode, shards=shards)
    return dpts, d_features


class _HashLookupSorted(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pts, meta, features, resolutions, bwd_bf16, shards):
        NW = features.shape[1] // (2 * W) * shards
        ctx.save_for_backward(pts, meta, features, resolutions)
        ctx.nw, ctx.bwd_bf16, ctx.shards = NW, bwd_bf16, shards
        return lookup_fwd(pts, meta, features, resolutions, NW, shards=shards)

    @staticmethod
    def backward(ctx, g):
        pts, meta, features, resolutions = ctx.saved_tensors
        # tables that need no gradient (surface normals) take B4's dL/du mode:
        # no table gradient is allocated
        mode = ("bf16" if ctx.bwd_bf16 else "exact") if ctx.needs_input_grad[2] else "du"
        dpts, d_features = lookup_bwd(pts, meta, features, resolutions, g.contiguous(),
                                      ctx.nw, mode=mode, shards=ctx.shards)
        return dpts, None, d_features, None, None, None


def hash_lookup_sorted(pts, meta, features, resolutions, bwd_bf16: bool = False,
                       shards: int = 1) -> torch.Tensor:
    """Windowed hash features of a padded sorted stream (``pts``/``meta``
    from ``sort_pack`` or ``sort_pack_tables``) over the flat [L, NW*512*2]
    table (stack) -> [Np, L*2] f32 in stream order: B3 forward, B4
    backward. Differentiable in pts (rows 0-2: dL/du; the view directions
    in rows 4-6 get no cotangent here) and in f32 tables; ``bwd_bf16``
    rounds the table gradient's contributions to bf16 (the JAX
    ``onehot_bf16``). A table that does not require grad gets no gradient
    and B4 runs in its dL/du mode. With ``shards`` > 1, ``features`` is
    one shard of the table and ``meta`` the stream's meta localized to it
    (``table_parallel.localize_meta``): rows of other shards get zero
    features and zero dL/du. Unlike the JAX function it takes no
    ``visited`` blocks: the scatter into a zeroed gradient leaves
    unvisited blocks zero by itself."""
    return _HashLookupSorted.apply(pts, meta, features, resolutions, bwd_bf16, shards)


def hash_encode_windowed(points, features, resolutions, tile: int = 0,
                         n_tables: int = 1) -> torch.Tensor:
    """Original-order windowed hash (``sort_pack`` -> ``hash_lookup_sorted``
    -> ``unsort_rows``): points [N, 3] in [-2, 2], one table flat [L, H*2]
    or [L, H, 2] (H a power of two >= 2^14), resolutions [L, 3] ->
    [N, L*2] f32, differentiable in points and f32 tables. With
    ``n_tables`` > 1, ``features`` is a tile-major stack [L, n_tables*H*2]
    (``MultiTileScene.features_flat``) and every point is encoded under
    table ``tile`` (``sort_pack_tables``, no gradient), so that no tile's
    table is copied out of the stack."""
    N = points.shape[0]
    L = features.shape[0]
    H = as_3d(features).shape[1] // n_tables
    if n_tables == 1:
        stream = sort_pack(points, torch.zeros_like(points), H)
    else:
        tids = torch.full((N,), tile, dtype=torch.int32, device=points.device)
        stream = sort_pack_tables(points, torch.zeros_like(points), tids, H, n_tables)
    feats = hash_lookup_sorted(stream.pts, stream.meta, features.reshape(L, H * n_tables * 2),
                               resolutions)
    return unsort_rows(feats, stream.pidp, N)
