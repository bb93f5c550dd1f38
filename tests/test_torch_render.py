"""Parity of the port's multi-tile renderer (scanerf_tpu_torch) with the
JAX package on the CPU: render_rays on a scene built from numpy arrays,
and render_image on tiles written in the reference export layout and
loaded by both packages' load_scene.

The JAX side renders with its staged per-tile backend (backend="xla"):
the JAX package's own test holds its windowed fused path to that oracle
with the tolerances used here (tests/test_renderer_windowed.py::
test_windowed_matches_staged), and it compiles in seconds where the
interpret-mode fused kernel takes over a minute. Tolerances: rgb 2e-5,
depth 2e-4, T_left 2e-5 -- f32 sums taken in other orders (feature
accumulation, matmuls, per-slot blend), nothing looser.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scanerf_tpu.models import decoder as jdec
from scanerf_tpu.ops.hash_encode import make_level_resolutions
from scanerf_tpu.ops.pallas import hash_encode as jhw
from scanerf_tpu.render import renderer as jr
from scanerf_tpu_torch import convert
from scanerf_tpu_torch.ops import sampling as tsampling
from scanerf_tpu_torch.render import renderer as tr

L = 16
TOL = dict(rgb=2e-5, depth=2e-4, T_left=2e-5)

# JAX helpers under jit: one compile each instead of one per op
_j_unpack_all = jax.jit(jax.vmap(jdec.unpack_params))
_j_fg_slots_lut = jax.jit(jr._fg_slots_lut, static_argnums=(2,))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread while these tests run (the suite runs on
    several workers at once), and the worker's setting back after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def scene_arrays(T=2, H=2**14, seed=0, grid=8):
    """T equal tiles side by side along x, random tables, random packed
    decoders: numpy only. The tiles overlap by a quarter (6 of 8 cells
    apart) so that their occupancy grids align and agree where they
    overlap, as the cross-tile union at load makes them (the staged
    oracle reads each tile's grid, the windowed path the union grid)."""
    rng = np.random.RandomState(seed)
    inner = np.array([2.0, 2.0, 2.0], np.float32)
    step = 6
    corners = np.stack([np.array([-1.0 + t * 2.0 * step / grid, -1.0, -1.0],
                                 np.float32) + inner / 2 - inner for t in range(T)])
    sizes = np.broadcast_to(inner * 2, (T, 3)).copy()
    feats = (rng.randn(T, L, H, 2) * 0.1).astype(np.float32)
    decs = (rng.uniform(-0.3, 0.3, (T, jdec.PARAMSIZE))).astype(np.float32)
    res = make_level_resolutions(np.array([32] * 3), np.array([512] * 3), L)
    res = np.broadcast_to(res, (T, L, 3)).copy()
    lattice = rng.rand(step * (T - 1) + grid, grid, grid) < 0.6
    occ = np.stack([lattice[step * t:step * t + grid] for t in range(T)])
    return dict(features=feats, decoders=decs, resolutions=res,
                block_corner=corners, block_size=sizes, occupied=occ)


def jax_scene(a):
    ug, uc, us = jr.build_union_grid(a["block_corner"], a["block_size"], a["occupied"])
    lut, lc, lcell, ldims = jr.build_tile_lut(a["block_corner"], a["block_size"])
    return jr.MultiTileScene(
        features=jnp.asarray(a["features"]),
        decoders=_j_unpack_all(jnp.asarray(a["decoders"])),
        resolutions=jnp.asarray(a["resolutions"]),
        block_corner=jnp.asarray(a["block_corner"]),
        block_size=jnp.asarray(a["block_size"]),
        occupied=jnp.asarray(a["occupied"]),
        union_occ=jnp.asarray(ug), union_corner=jnp.asarray(uc),
        union_size=jnp.asarray(us), hash_layout="windowed",
        tile_lut=jnp.asarray(lut), lut_corner=jnp.asarray(lc),
        lut_cell=jnp.asarray(lcell), lut_dims=ldims,
    )


def assert_render_close(ref, out):
    for k, tol in TOL.items():
        np.testing.assert_allclose(np.asarray(ref[k]), out[k].numpy(), atol=tol,
                                   err_msg=k)


@pytest.mark.parametrize("T", [2, 4, 8])
def test_fg_slots_match_jax(T):
    """Tile-LUT slot assignment equals JAX's, and equals the port's
    exhaustive per-tile loop, on every slot that holds a tile (the
    order of empty slots is free)."""
    a = scene_arrays(T=T, H=2**14, seed=T)
    js = jax_scene(a)
    ts = convert.scene(js, device="cpu")
    rng = np.random.RandomState(T)
    pts = rng.uniform(-1.5, -1.0 + T * 1.5 + 1.5, (40, 9, 3)).astype(np.float32)
    K = min(4, T)
    ref = _j_fg_slots_lut(js, jnp.asarray(pts), K)
    for out in (tr._fg_slots_lut(ts, torch.from_numpy(pts), K),
                tr._fg_slots(ts, torch.from_numpy(pts), K)):
        m = np.asarray(ref[2])
        np.testing.assert_array_equal(m, out[2].numpy())
        np.testing.assert_array_equal(np.asarray(ref[3]), out[3].numpy())
        np.testing.assert_array_equal(np.asarray(ref[0])[m], out[0].numpy()[m])
        np.testing.assert_allclose(np.asarray(ref[1]), out[1].numpy(), rtol=1e-6, atol=1e-7)


@functools.partial(jax.jit, static_argnums=(9, 10))
def _j_stream_rows(js, rays_o, rays_d, z_vals, valid, z_bg, bg_tiles, bg_w, bg_valid, Kf, H):
    """The JAX package's windowed rows (its ``_render_windowed``'s X, TID
    and DEAD, renderer.py:733-790) and their window keys as its
    ``_sort_pack_sorted`` computes them -> (keys, u, w_fg, m_any, m_eval)."""
    T = js.block_corner.shape[0]
    NW1 = jhw.geometry(H)[0]
    N, S = z_vals.shape
    Sb, Kb = z_bg.shape[1], bg_tiles.shape[1]
    pts = rays_o[:, None, :] + z_vals[..., None] * rays_d[:, None, :]
    tags, w_fg, m_any, m_eval = jr._fg_slots_lut(js, pts, Kf)
    x_fg = jr._contract_fg(js.block_corner[tags], js.block_size[tags], pts[:, :, None, :])
    x_fg = jnp.where(m_any[..., None], x_fg, 0.0)
    pts_bg = rays_o[:, None, :] + z_bg[..., None] * rays_d[:, None, :]
    x_bg = jr._contract_bg(js.block_corner[bg_tiles][:, None], js.block_size[bg_tiles][:, None],
                           pts_bg[:, :, None, :])
    bg_used = (bg_w > 0.0)[:, None, :]
    x_bg = jnp.where(jnp.broadcast_to(bg_used[..., None], x_bg.shape), x_bg, 0.0)
    X = jnp.concatenate([x_fg.transpose(2, 0, 1, 3).reshape(-1, 3),
                         x_bg.transpose(2, 0, 1, 3).reshape(-1, 3)])
    TID = jnp.concatenate([tags.transpose(2, 0, 1).reshape(-1),
                           jnp.broadcast_to(bg_tiles[:, None, :], (N, Sb, Kb))
                           .transpose(2, 0, 1).reshape(-1)])
    DEAD = jnp.concatenate([
        (~(m_eval & valid[:, None, None])).transpose(2, 0, 1).reshape(-1),
        jnp.broadcast_to(~(bg_used & bg_valid[:, None, None]), (N, Sb, Kb))
        .transpose(2, 0, 1).reshape(-1)])
    u = (X + 2.0) * 0.25
    wid = jhw.window_id(u, H) + TID.astype(jnp.int32) * NW1
    return jnp.where(DEAD, NW1 * T, wid), u, w_fg, m_any, m_eval


def chunk_inputs(scene, n_rays, seed, S=12, Sb=6, M=32):
    """Rays over the tiles (some meet no tile) and the render's sampling
    and exit slots for them on the CPU: the inputs of the stream rows."""
    T = scene.n_tiles
    rng = np.random.RandomState(seed)
    o = (rng.randn(n_rays, 3) * 0.3).astype(np.float32)
    o[:, 0] += rng.uniform(0, 1.5 * (T - 1), n_rays).astype(np.float32)
    d = rng.randn(n_rays, 3).astype(np.float32)
    o[: n_rays // 8] = [0.0, 9.0, 0.0]  # above the tiles, looking up: they meet no tile
    d[: n_rays // 8, 1] = np.abs(d[: n_rays // 8, 1]) + 0.5
    rays_o, rays_d = torch.from_numpy(o), torch.from_numpy(d)
    z_vals, _, valid = tr._sample_union(scene, rays_o, rays_d, S, M)
    bg_tiles, bg_w, far, bg_valid = tr._exit_slots(scene, rays_o, rays_d, min(4, T))
    z_bg, _ = tsampling.inverse_z_vals(far, Sb)
    return rays_o, rays_d, z_vals, valid, z_bg, bg_tiles, bg_w, bg_valid


@pytest.mark.parametrize("T,n_rays", [(2, 40), (4, 32), (8, 24)])
def test_stream_rows_match_jax(T, n_rays):
    """The render's plain row composition (``renderer._stream_rows_plain``:
    ``_fg_rows``, ``_bg_rows``, ``window_keys``), which the row kernel is
    held to on the card, gives the JAX package's rows: the same sort keys
    (dead rows on the sentinel) and u of every row, and its fg slot
    tables (u and the weights within f32 rounding)."""
    a = scene_arrays(T=T, seed=20 + T)
    js = jax_scene(a)
    ts = convert.scene(js, device="cpu")
    inputs = chunk_inputs(ts, n_rays, seed=30 + T)
    _, _, _, valid, _, _, bg_w, bg_valid = inputs
    assert not bool(valid.all()) and not bool(bg_valid.all()) and bool((bg_w == 0).any())
    Kf = min(tr.MAX_PTS_BLOCKS, T)
    got = tr._stream_rows_plain(ts, *inputs, Kf)
    ref = _j_stream_rows(js, *(jnp.asarray(t.numpy()) for t in inputs), Kf, ts.table_size)
    keys, u, w_fg, m_any, m_eval = (np.asarray(r) for r in ref)
    NW = ts.table_size // 512 * T
    assert 0 < int((keys < NW).sum()) < keys.size  # live and dead rows both
    np.testing.assert_array_equal(keys, got.keys.numpy())
    # jitted XLA fuses (p - c) / s * 4 - 2 and (x + 2) * 0.25 and rounds
    # them otherwise; the port rounds each op as PyTorch does: u within 2
    # ulps of 1 (the keys above are equal all the same)
    np.testing.assert_allclose(u, got.payload[:, :3].numpy(), rtol=0, atol=2.4e-7)
    np.testing.assert_array_equal(m_any, got.slots[1].numpy())
    np.testing.assert_array_equal(m_eval, got.slots[2].numpy())
    # XLA also fuses the sample point o + z * d into one rounding, which
    # moves the seam weight's cancelling 0.5 - |u - 0.5| by a few ulps
    np.testing.assert_allclose(w_fg, got.slots[0].numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("T,n_rays,underground", [(2, 24, False), (4, 16, True)])
def test_render_rays_matches_jax(T, n_rays, underground):
    """(f) windowed fused render_rays == the JAX render of the same scene
    and rays, at T=2 and at T=4 (with the ground-plane bg mask); the
    port's scene is converted from the JAX scene object."""
    a = scene_arrays(T=T, seed=T)
    rng = np.random.RandomState(10 + T)
    o = (rng.randn(n_rays, 3) * 0.3).astype(np.float32)
    o[:, 0] += rng.uniform(0, 1.5 * (T - 1), n_rays).astype(np.float32)
    d = rng.randn(n_rays, 3).astype(np.float32)
    kw = dict(num_sample=12, num_bg_sample=6, num_march=32,
              invalid_underground=underground)
    js = jax_scene(a)
    ref = jr.render_rays(js, jnp.asarray(o), jnp.asarray(d), backend="xla", **kw)
    out = tr.render_rays(convert.scene(js, device="cpu"), o, d, device="cpu", **kw)
    assert bool(out["fore_valid"].any())
    np.testing.assert_array_equal(np.asarray(ref["fore_valid"]), out["fore_valid"].numpy())
    assert_render_close(ref, out)


def write_export(root, a, c2w, K, layout="windowed"):
    """Tiles in the reference export layout, written with numpy."""
    dirs = []
    for t in range(a["features"].shape[0]):
        d = os.path.join(root, f"tile-{t}")
        os.makedirs(d)
        np.savez(os.path.join(d, "feature.npz"),
                 features=a["features"][t].reshape(L, -1).astype(np.float16),
                 occupied_grid=a["occupied"][t], block_corner=a["block_corner"][t],
                 block_size=a["block_size"][t],
                 grid_log2dim=np.log2(a["occupied"].shape[1:]).astype(np.int32),
                 resolution=a["resolutions"][t], hash_layout=np.array(layout))
        np.savez(os.path.join(d, "decoder.npz"), params=a["decoders"][t])
        np.savez(os.path.join(d, "cams.npz"), c2ws=c2w[None], ks=K[None],
                 idxs=np.array([0]))
        dirs.append(d)
    return dirs


def test_export_roundtrip_render_image(tmp_path):
    """(g) a scene exported with numpy in the reference layout, loaded by
    both packages' load_scene and rendered by render_image at 8x8."""
    a = scene_arrays(T=2, seed=7)
    K = np.array([[6.0, 0, 4.0], [0, 6.0, 4.0], [0, 0, 1]], np.float32)
    c2w = np.array([[1, 0, 0, 0.8], [0, 1, 0, 0.1], [0, 0, 1, -3.5]], np.float32)
    dirs = write_export(str(tmp_path), a, c2w, K)
    assert tr.list_tile_dirs(str(tmp_path)) == dirs
    kw = dict(num_sample=12, num_bg_sample=6, num_march=32)
    ref = jr.render_image(jr.load_scene(jr.list_tile_dirs(str(tmp_path))), K, c2w,
                          8, 8, chunk=32, backend="xla", **kw)
    out = tr.render_image(tr.load_scene(dirs, device="cpu"), K, c2w, 8, 8,
                          chunk=32, device="cpu", **kw)
    assert out["rgb"].shape == (8, 8, 3) and out["depth"].shape == (8, 8, 1)
    np.testing.assert_allclose(ref["rgb"], out["rgb"], atol=TOL["rgb"])
    np.testing.assert_allclose(ref["depth"], out["depth"], atol=TOL["depth"])


def test_load_scene_bf16_tables(tmp_path):
    """load_scene(dtype=bf16) keeps the tables half-width, as the JAX
    package does, and both render the same within the f32 tolerances."""
    a = scene_arrays(T=2, seed=3)
    K = np.array([[6.0, 0, 4.0], [0, 6.0, 4.0], [0, 0, 1]], np.float32)
    c2w = np.array([[1, 0, 0, 0.5], [0, 1, 0, 0.0], [0, 0, 1, -3.0]], np.float32)
    dirs = write_export(str(tmp_path), a, c2w, K)
    js = jr.load_scene(dirs, dtype=jnp.bfloat16)
    ts = tr.load_scene(dirs, dtype=torch.bfloat16, device="cpu")
    assert ts.features_flat.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        np.asarray(js.features_flat.astype(jnp.float32)),
        ts.features_flat.float().numpy())
    rng = np.random.RandomState(2)
    o = (rng.randn(16, 3) * 0.3).astype(np.float32)
    d = rng.randn(16, 3).astype(np.float32)
    kw = dict(num_sample=12, num_bg_sample=6, num_march=32)
    ref = jr.render_rays(js, jnp.asarray(o), jnp.asarray(d), backend="xla", **kw)
    out = tr.render_rays(ts, o, d, device="cpu", **kw)
    assert_render_close(ref, out)
