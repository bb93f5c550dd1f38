"""The windowed render's stream rows: one kernel builds a chunk's (sample,
slot) rows, their window sort keys and their payload.

Replaces no TPU kernel: the JAX package builds these rows with XLA ops
inside its ``_render_windowed``, and the port's plain composition builds
them with ~100 PyTorch ops over every row (``renderer._stream_rows_plain``:
the tile LUT's slots, the contractions, expands, permutes and
concatenations of points, tile ids, directions and dead flags; then
``hash_encode.window_keys``). ``build_rows`` computes the same keys, the
same u = (x + 2) / 4 and the same fg slot tables in one launch
(``csrc/row_build.cu``), bit for bit; no point, direction or tile id array
is materialized. The stream is then ``hash_encode.sort_pack_keys``: the
same stable sort, and B2 in its gather mode.

Rows come in the plain composition's order: fg slot-major [Kf, N, S],
then bg [Kb, N, Sb]. Each row's payload is (u0, u1, u2, its ray's index
as f32), and B2's gather mode reads the ray's direction by that index.
Device memory bounds the kernel (20 bytes written a row). Given a
``tally``, a launch adds the rows it built and its live (non-sentinel)
rows to it on the device: the share of the stream a compaction of dead
rows would drop. The render passes none, and then the kernel counts
nothing.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from scanerf_tpu_torch import _build
from scanerf_tpu_torch.ops.kernels import hash_encode as hw

LUT_CAND = 8  # renderer.LUT_CAND; the kernel keeps at most this many fg slots
MAX_RAYS = 2**24  # a row's ray index rides in its f32 payload: exact up to here


@dataclasses.dataclass
class StreamRows:
    """A chunk's stream rows, fg [Kf, N, S] then bg [Kb, N, Sb]."""

    keys: torch.Tensor  # [R] i32: tid * NW1 + window, NW for dead rows
    payload: torch.Tensor  # [R, 4] f32: u0 u1 u2, the row's ray index
    slots: tuple  # (w_fg f32, m_any bool, m_eval bool) [N, S, Kf], as _fg_blend reads them


def check_rays(n_rays: int) -> None:
    """Refuse a chunk of more rays than the payload's f32 ray index holds."""
    if n_rays > MAX_RAYS:
        raise ValueError(f"the payload's f32 ray index takes at most {MAX_RAYS} rays a chunk, "
                         f"got {n_rays}")


def _fn():
    f = _build.load("row_build").scanerf_row_build
    f.restype = ctypes.c_int
    P, I = ctypes.c_void_p, ctypes.c_int
    f.argtypes = [P] * 11 + [I] * 3 + [P] * 3 + [I] * 3 + [P] * 2 + [I] * 10 + [P] * 7
    return f


def build_rows(rays_o, rays_d, z_vals, valid, z_bg, bg_tiles, bg_w, bg_valid, Kf: int, *,
               tile_lut, lut_corner, lut_cell, lut_dims, union_occ, union_corner, union_size,
               block_corner, block_size, table_size: int, tally=None) -> StreamRows:
    """The stream rows of one chunk on a CUDA device: rays [N, 3], fg
    samples z_vals [N, S] and ``valid`` [N], bg samples z_bg [N, Sb] and
    the exit slots bg_tiles, bg_w [N, Kb], bg_valid [N], up to Kf fg slots
    a sample, in a scene of T tiles given by its tile LUT (tile_lut
    [cells, LUT_CAND] i32 over a grid of lut_dims cells of size lut_cell
    from lut_corner), its union occupancy grid (union_occ from
    union_corner over union_size), its tiles' doubled boxes
    (block_corner, block_size [T, 3]) and its tables' size. ``tally``, an
    int64 [2] tensor on the same device, gets the rows built and the live
    rows added to it. The plain version is ``renderer._stream_rows_plain``
    (the renderer's composition, which takes its scene)."""
    check_rays(z_vals.shape[0])
    if rays_o.device.type != "cuda":
        raise ValueError(f"the row kernel runs on CUDA tensors, got {rays_o.device}")
    if not 1 <= Kf <= LUT_CAND:
        raise ValueError(f"the row kernel takes 1 to {LUT_CAND} fg slots, got {Kf}")
    dev = rays_o.device
    N, S = z_vals.shape
    Sb, Kb = z_bg.shape[1], bg_tiles.shape[1]
    T = block_corner.shape[0]
    rays_o, rays_d = rays_o.contiguous(), rays_d.contiguous()
    z_vals, z_bg, bg_w = z_vals.contiguous(), z_bg.contiguous(), bg_w.contiguous()
    bg_tiles = bg_tiles.to(torch.int32).contiguous()
    check = hw.check_tensor
    for name, t, dtype, shape in (
            ("rays_o", rays_o, torch.float32, (N, 3)), ("rays_d", rays_d, torch.float32, (N, 3)),
            ("z_vals", z_vals, torch.float32, (N, S)), ("valid", valid, torch.bool, (N,)),
            ("z_bg", z_bg, torch.float32, (N, Sb)), ("bg_tiles", bg_tiles, torch.int32, (N, Kb)),
            ("bg_w", bg_w, torch.float32, (N, Kb)), ("bg_valid", bg_valid, torch.bool, (N,)),
            ("tile_lut", tile_lut, torch.int32, (tile_lut.shape[0], LUT_CAND)),
            ("lut_corner", lut_corner, torch.float32, (3,)),
            ("lut_cell", lut_cell, torch.float32, (3,)),
            ("union_occ", union_occ, torch.bool, tuple(union_occ.shape)),
            ("union_corner", union_corner, torch.float32, (3,)),
            ("union_size", union_size, torch.float32, (3,)),
            ("block_corner", block_corner, torch.float32, (T, 3)),
            ("block_size", block_size, torch.float32, (T, 3))):
        check(name, t, dtype, shape, dev)
    if tally is not None:
        check("tally", tally, torch.int64, (2,), dev)
    NW1, _, (cx, cy, cz) = hw.geometry(table_size)
    R = N * (Kf * S + Kb * Sb)
    keys = torch.empty((R,), dtype=torch.int32, device=dev)
    payload = torch.empty((R, 4), dtype=torch.float32, device=dev)
    w_fg = torch.empty((N, S, Kf), dtype=torch.float32, device=dev)
    m_any = torch.empty((N, S, Kf), dtype=torch.bool, device=dev)
    m_eval = torch.empty((N, S, Kf), dtype=torch.bool, device=dev)
    P = _build.ptr
    err = _fn()(P(rays_o), P(rays_d), P(z_vals), P(valid), P(z_bg), P(bg_tiles), P(bg_w),
                P(bg_valid), P(tile_lut), P(lut_corner), P(lut_cell), *lut_dims,
                P(union_occ), P(union_corner), P(union_size), *union_occ.shape,
                P(block_corner), P(block_size), N, S, Sb, Kf, Kb, cx, cy, cz, NW1, NW1 * T,
                P(keys), P(payload), P(w_fg), P(m_any), P(m_eval),
                None if tally is None else P(tally), _build.stream_ptr(rays_o))
    _build.check(err, "scanerf_row_build")
    build_rows.launches += 1
    return StreamRows(keys=keys, payload=payload, slots=(w_fg, m_any, m_eval))


build_rows.launches = 0
