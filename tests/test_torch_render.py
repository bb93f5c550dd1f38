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

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scanerf_tpu.models import decoder as jdec
from scanerf_tpu.ops.hash_encode import make_level_resolutions
from scanerf_tpu.render import renderer as jr
from scanerf_tpu_torch import convert
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
