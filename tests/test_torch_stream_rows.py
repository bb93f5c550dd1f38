"""The windowed render's stream from its keyed rows (``renderer
._stream_rows``, the row kernel on CUDA, and ``hash_encode
.sort_pack_keys``: the sort and B2's gather mode) against the composition
they replaced (``renderer._fg_rows`` + ``_bg_rows``, then
``sort_pack_tables``).

On the CPU the plain versions: the stream equals field by field. On the
card (marked ``card``, skipped without CUDA): the kernel's keys, payload
and slot tables, its tally of rows and live rows, the stream and its
chunks' tiles, and ``render_rays``' outputs equal that composition's bit
for bit, on 2- and 4-tile scenes, with and without the ground-plane bg
mask, on chunks with dead fg and bg rows, unused exit slots and rays that
meet no tile. This file imports no JAX (the JAX parity of the rows is
tests/test_torch_render.py::test_stream_rows_match_jax).
"""

import numpy as np
import pytest
import torch

from scanerf_tpu_torch.models import decoder as decoder_lib
from scanerf_tpu_torch.ops import sampling
from scanerf_tpu_torch.ops.hash_encode import make_level_resolutions
from scanerf_tpu_torch.ops.kernels import hash_encode as hw
from scanerf_tpu_torch.ops.kernels import row_build
from scanerf_tpu_torch.render import renderer as R

L = 16
H = 2**14


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread while these tests run (the suite runs on
    several workers at once), and the worker's setting back after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_scene(T: int, seed: int, device: str) -> R.MultiTileScene:
    """T tiles side by side along x, overlapping by a quarter, random
    tables, decoders and occupancy (as tests/test_torch_render.py's)."""
    rng = np.random.RandomState(seed)
    inner = np.array([2.0, 2.0, 2.0], np.float32)
    step, grid = 6, 8
    corners = np.stack([np.array([-1.0 + t * 2.0 * step / grid, -1.0, -1.0], np.float32)
                        + inner / 2 - inner for t in range(T)])
    sizes = np.broadcast_to(inner * 2, (T, 3)).copy()
    feats = (rng.randn(T, L, H, 2) * 0.1).astype(np.float32)
    decs = rng.uniform(-0.3, 0.3, (T, decoder_lib.PARAMSIZE)).astype(np.float32)
    res = make_level_resolutions(np.array([32] * 3), np.array([512] * 3), L)
    res = np.broadcast_to(res, (T, L, 3)).copy()
    lattice = rng.rand(step * (T - 1) + grid, grid, grid) < 0.6
    occ = np.stack([lattice[step * t:step * t + grid] for t in range(T)])
    return R.scene_from_arrays(feats, decs, res, corners, sizes, occ, device=device)


def make_rays(T: int, n_rays: int, seed: int, device: str):
    """Rays among and around the tiles; the first eighth start above them
    looking up and meet no tile."""
    rng = np.random.RandomState(seed)
    o = (rng.randn(n_rays, 3) * 0.3).astype(np.float32)
    o[:, 0] += rng.uniform(0, 1.5 * (T - 1), n_rays).astype(np.float32)
    d = rng.randn(n_rays, 3).astype(np.float32)
    o[: n_rays // 8] = [0.0, 9.0, 0.0]
    d[: n_rays // 8, 1] = np.abs(d[: n_rays // 8, 1]) + 0.5
    return torch.from_numpy(o).to(device), torch.from_numpy(d).to(device)


def chunk_inputs(scene, rays_o, rays_d, S: int, Sb: int, M: int):
    """What the render gives the stream rows: sampling and exit slots."""
    z_vals, dists, valid = R._sample_union(scene, rays_o, rays_d, S, M)
    bg_tiles, bg_w, far, bg_valid = R._exit_slots(scene, rays_o, rays_d, min(4, scene.n_tiles))
    z_bg, d_bg = sampling.inverse_z_vals(far, Sb)
    return dict(z_vals=z_vals, dists=dists, valid=valid, bg_tiles=bg_tiles, bg_w=bg_w,
                z_bg=z_bg, d_bg=d_bg, bg_valid=bg_valid)


def row_args(scene, rays_o, rays_d, c):
    return (scene, rays_o, rays_d, c["z_vals"], c["valid"], c["z_bg"], c["bg_tiles"], c["bg_w"],
            c["bg_valid"], min(R.MAX_PTS_BLOCKS, scene.n_tiles))


def composed_stream(scene, rays_o, rays_d, c):
    """The composition the keyed rows replaced: ``_fg_rows`` +
    ``_bg_rows``, ``sort_pack_tables``."""
    Kf = min(R.MAX_PTS_BLOCKS, scene.n_tiles)
    fg = R._fg_rows(scene, rays_o, rays_d, c["z_vals"], c["valid"], Kf)
    bg = R._bg_rows(scene, rays_o, rays_d, c["z_bg"], c["bg_tiles"], c["bg_w"], c["bg_valid"])
    X, TID, DIR, DEAD = (torch.cat([f, b]) for f, b in zip(fg[:4], bg))
    return hw.sort_pack_tables(X, DIR, TID, scene.table_size, scene.n_tiles, dead=DEAD), fg[4]


def composed_render_windowed(scene, rays_o, rays_d, z_vals, dists, valid, bg_tiles, bg_w, z_bg,
                             d_bg, bg_valid, invalid_underground,
                             max_blend_tiles=R.MAX_PTS_BLOCKS, fuse_decoder=True, hook=None):
    """``renderer._render_windowed`` composed as before the row kernel:
    ``_fg_rows`` + ``_bg_rows``, ``_eval_rows``, the blends."""
    Kf = min(max_blend_tiles, scene.n_tiles)
    dnorm = torch.linalg.vector_norm(rays_d, dim=-1, keepdim=True)
    fg = R._fg_rows(scene, rays_o, rays_d, z_vals, valid, Kf)
    bg = R._bg_rows(scene, rays_o, rays_d, z_bg, bg_tiles, bg_w, bg_valid)
    rows = R._eval_rows(scene, *(torch.cat([f, b]) for f, b in zip(fg[:4], bg)), fuse_decoder)
    n_fg = fg[0].shape[0]
    alpha, color = R._fg_blend(rows[:n_fg], fg[4], dists, dnorm, valid)
    rgb_fg, depth_fg, T_left = R._composite_premult(alpha, color, z_vals)
    rgb_bg, depth_bg = R._bg_blend(scene, rows[n_fg:], rays_o, rays_d, z_bg, d_bg, bg_tiles,
                                   bg_w, bg_valid, invalid_underground)
    return rgb_fg, depth_fg, T_left, rgb_bg, depth_bg, valid


def assert_covers_dead_rows(c, keys, NW, Kf):
    """The chunk has what the stream must handle: rays that meet no tile,
    unused exit slots, and dead and live rows among fg and bg alike."""
    n_fg = c["z_vals"].numel() * Kf
    assert not bool(c["valid"].all()) and not bool(c["bg_valid"].all())
    assert bool((c["bg_w"] == 0).any())
    for part in (keys[:n_fg], keys[n_fg:]):
        assert bool((part == NW).any()) and bool((part < NW).any())


def assert_streams_equal(got, want):
    for k in ("pts", "meta", "pidp", "visited"):
        assert torch.equal(getattr(got, k), getattr(want, k)), k


@pytest.mark.parametrize("T,seed", [(2, 1), (4, 2), (4, 3)])
def test_keyed_stream_equals_composed_stream(T, seed):
    """On the CPU: the plain rows (``_stream_rows`` takes
    ``_stream_rows_plain``) through ``sort_pack_keys`` (B2's gather mode,
    plain) give the composed stream field by field, each chunk's tile
    with it."""
    scene = make_scene(T, seed, "cpu")
    rays_o, rays_d = make_rays(T, 48, seed, "cpu")
    c = chunk_inputs(scene, rays_o, rays_d, 16, 8, 32)
    built = R._stream_rows(*row_args(scene, rays_o, rays_d, c))
    NW = H // hw.W * T
    assert_covers_dead_rows(c, built.keys, NW, min(R.MAX_PTS_BLOCKS, T))
    got = hw.sort_pack_keys(built.keys, built.payload, rays_d, H, T)
    want, slots = composed_stream(scene, rays_o, rays_d, c)
    assert_streams_equal(got, want)
    assert torch.equal(R._chunk_tile(scene, got), R._chunk_tile(scene, want))
    for a, b in zip(built.slots, slots):
        assert torch.equal(a, b)


def test_pack_gather_plain_matches_pack():
    """On the CPU: B2's gather mode (plain) packs what the copy mode packs
    from the gathered columns, and its meta is ``_stream_meta``'s; pad
    rows and an all-sentinel chunk included."""
    keys = torch.tensor([0, 3, 3, 40, 96, 96], dtype=torch.int32)  # 96: the sentinel
    perm = torch.tensor([5, 0, 2, 1, 4, 3])
    payload = torch.arange(24, dtype=torch.float32).reshape(6, 4)
    payload[:, 3] = torch.tensor([1.0, 0.0, 1.0, 2.0, 0.0, 2.0])
    dirs = torch.arange(9, dtype=torch.float32).reshape(3, 3) + 100.0
    desc = torch.tensor([[0, 3], [3, 1], [4, 2], [6, 0]], dtype=torch.int32)
    pts, pidp, meta = hw.pack_gather(keys, perm, payload, dirs, desc, 4, 96)
    pay = payload[perm]
    src = torch.cat([pay[:, :3].t(), keys[None].float(), dirs[pay[:, 3].long()].t()])
    want_pts, want_pidp = hw.pack(src.contiguous(), perm.to(torch.int32), desc, 4, 96)
    assert torch.equal(pts, want_pts) and torch.equal(pidp, want_pidp)
    assert torch.equal(meta, hw._stream_meta(want_pts, 4, 96))
    np.testing.assert_array_equal(meta[:, 0].numpy(), [[0, 0, 4, 0], [1, 40, 1, 0],
                                                       [2, 95, 0, 0], [2, 95, 0, 0]])


def test_build_rows_refuses_rays_past_f32_indices():
    """A chunk of more rays than the payload's f32 ray index holds
    exactly is refused before any row is built, by the plain rows and by
    the kernel's wrapper alike (expanded inputs: nothing of that size is
    allocated)."""
    N = row_build.MAX_RAYS + 1
    rays = torch.zeros(1, 3).expand(N, 3)
    z = torch.zeros(1, 1).expand(N, 1)
    flags = torch.ones(1, dtype=torch.bool).expand(N)
    tiles = torch.zeros(1, 1, dtype=torch.int32).expand(N, 1)
    args = (rays, rays, z, flags, z, tiles, z, flags, 1)
    with pytest.raises(ValueError, match="at most 16777216 rays a chunk"):
        R._stream_rows(None, *args)
    with pytest.raises(ValueError, match="at most 16777216 rays a chunk"):
        row_build.build_rows(*args, tile_lut=None, lut_corner=None, lut_cell=None, lut_dims=None,
                             union_occ=None, union_corner=None, union_size=None,
                             block_corner=None, block_size=None, table_size=H)


@pytest.mark.card
@pytest.mark.parametrize("T,underground", [(2, False), (2, True), (4, False), (4, True)])
def test_row_kernel_bit_equal_on_card(T, underground, monkeypatch):
    """On the card: the row kernel's keys, payload and slot tables equal
    the plain composition's, its tally adds its rows and live rows, the
    stream (B2's gather mode) and its chunks' tiles equal the composed
    stream, B2's gather mode refuses a payload off a 16-byte boundary, and
    ``render_rays`` gives the same outputs, bit for bit, as with the
    composition of ``_render_windowed`` the keyed rows replaced, without
    a launch of B2's copy mode."""
    if not torch.cuda.is_available():
        pytest.skip("the row kernel and B2's gather mode run only on a CUDA device")
    scene = make_scene(T, 10 + T, "cuda")
    rays_o, rays_d = make_rays(T, 1024, 20 + T, "cuda")
    c = chunk_inputs(scene, rays_o, rays_d, 32, 16, 64)
    args = row_args(scene, rays_o, rays_d, c)
    launches = row_build.build_rows.launches, hw.pack_gather.launches
    tally = torch.zeros(2, dtype=torch.int64, device="cuda")
    got = row_build.build_rows(*args[1:], tally=tally, **R._row_scene(scene))
    want = R._stream_rows_plain(*args)
    NW = H // hw.W * T
    assert_covers_dead_rows(c, got.keys, NW, min(R.MAX_PTS_BLOCKS, T))
    assert torch.equal(got.keys, want.keys) and torch.equal(got.payload, want.payload)
    for a, b in zip(got.slots, want.slots):
        assert torch.equal(a, b)
    assert tally.tolist() == [got.keys.shape[0], int((got.keys < NW).sum())]

    stream = hw.sort_pack_keys(got.keys, got.payload, rays_d, H, T)
    ref, _ = composed_stream(scene, rays_o, rays_d, c)
    assert_streams_equal(stream, ref)
    assert torch.equal(R._chunk_tile(scene, stream), R._chunk_tile(scene, ref))
    ws, perm = torch.sort(got.keys, stable=True)
    desc, _ = hw.chunk_descriptors(ws, ws.shape[0], H, T)
    off = torch.empty(got.payload.numel() + 1, device="cuda")[1:].view(-1, 4)
    with pytest.raises(ValueError, match="16-byte boundary"):
        hw.pack_gather(ws, perm, off, rays_d, desc, desc.shape[0], NW)

    kw = dict(num_sample=32, num_bg_sample=16, num_march=64, invalid_underground=underground)
    copy_launches = hw.pack.launches
    out = R.render_rays(scene, rays_o, rays_d, device="cuda", **kw)
    assert row_build.build_rows.launches == launches[0] + 2
    assert hw.pack_gather.launches == launches[1] + 2
    assert hw.pack.launches == copy_launches
    monkeypatch.setattr(R, "_render_windowed", composed_render_windowed)
    old = R.render_rays(scene, rays_o, rays_d, device="cuda", **kw)
    assert out.keys() == old.keys()
    for k in out:
        assert torch.equal(out[k], old[k]), k
