"""Parity of the port's small modules (scanerf_tpu_torch) with the JAX
package on the CPU: spherical harmonics, pose and ray helpers, the
ray-box test, level resolutions, occupancy lookup, the tile export
reader, decoder activations, and the renderer's host-side scene
builders and per-sample helpers. Same numpy inputs on both sides; each
tolerance is stated where it is used.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scanerf_tpu.models import decoder as jdec
from scanerf_tpu.ops import hash_encode as jhe
from scanerf_tpu.ops import intersect as jint
from scanerf_tpu.ops import sampling as jsampling
from scanerf_tpu.render import renderer as jr
from scanerf_tpu.train import checkpoint as jckpt
from scanerf_tpu.utils import lie as jlie
from scanerf_tpu.utils import rays as jrays
from scanerf_tpu.utils import sh as jsh
from scanerf_tpu_torch.models import decoder as tdec
from scanerf_tpu_torch.ops import hash_encode as the
from scanerf_tpu_torch.ops import intersect as tint
from scanerf_tpu_torch.ops import sampling as tsampling
from scanerf_tpu_torch.render import renderer as tr
from scanerf_tpu_torch.train import checkpoint as tckpt
from scanerf_tpu_torch.utils import lie as tlie
from scanerf_tpu_torch.utils import rays as trays
from scanerf_tpu_torch.utils import sh as tsh


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread while these tests run (the suite runs on
    several workers at once), and the worker's setting back after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _pose(rng):
    """A random rotation (QR of a Gaussian matrix) and translation, [3, 4]."""
    q, r = np.linalg.qr(rng.randn(3, 3))
    q = q * np.sign(np.diag(r))
    return np.concatenate([q, rng.randn(3, 1)], 1).astype(np.float32)


K_CAM = np.array([[50.0, 0, 16.5], [0, 48.0, 12.0], [0, 0, 1]], np.float32)


@pytest.mark.parametrize("deg", [0, 1, 2, 3])
def test_sh_encoding_matches_jax(deg):
    """The SH basis at unit directions equals JAX's within 1e-6 (f32
    products of the same constants; values are at most ~1.1)."""
    rng = np.random.RandomState(deg)
    d = rng.randn(257, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    ref = jax.jit(jsh.sh_encoding, static_argnums=0)(deg, jnp.asarray(d))
    out = tsh.sh_encoding(deg, torch.from_numpy(d))
    assert out.shape == (257, (deg + 1) ** 2)
    np.testing.assert_allclose(np.asarray(ref), out.numpy(), atol=1e-6, rtol=0)


@pytest.mark.parametrize("name", ["invert", "to_hom", "img2cam", "cam2world"])
def test_lie_matches_jax(name):
    """Pose inversion and the camera transforms equal JAX's within 1e-5
    (3x3 matmuls and a 3x3 inverse from another LAPACK; values O(10))."""
    rng = np.random.RandomState(11)
    pose = _pose(rng)
    X = (rng.randn(64, 3) * 3.0).astype(np.float32)
    args = {"invert": (pose,), "to_hom": (X,), "img2cam": (X, K_CAM),
            "cam2world": (X, pose)}[name]
    ref = jax.jit(getattr(jlie, name))(*(jnp.asarray(a) for a in args))
    out = getattr(tlie, name)(*_t(*args))
    assert out.shape == ref.shape
    np.testing.assert_allclose(np.asarray(ref), out.numpy(), atol=1e-5, rtol=0)


@pytest.mark.parametrize("H,W", [(3, 5), (24, 33)])
def test_rays_match_jax(H, W):
    """The pixel-center grid equals JAX's exactly; ray centers and
    directions through a random pose agree within 1e-5."""
    xy_ref = np.asarray(jrays.pixel_grid(H, W))
    xy = trays.pixel_grid(H, W)
    np.testing.assert_array_equal(xy_ref, xy.numpy())
    pose = _pose(np.random.RandomState(H * W))
    o_ref, d_ref = jax.jit(jrays.get_center_and_ray)(
        jnp.asarray(xy_ref), jnp.asarray(pose), jnp.asarray(K_CAM))
    o, d = trays.get_center_and_ray(xy, *_t(pose, K_CAM))
    np.testing.assert_allclose(np.asarray(o_ref), o.numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(np.asarray(d_ref), d.numpy(), atol=1e-5, rtol=0)


def _box_rays(rng, n):
    """Rays from inside and outside the boxes, some with zero direction
    components (the eps branch of the slab test)."""
    o = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    d = rng.randn(n, 3).astype(np.float32)
    d[: n // 8, 0] = 0.0
    d[n // 8: n // 4, 1] = 0.0
    d[n // 4: n // 4 + 4] = [[0.0, 0.0, 1.0]] * 4
    return o, d


@pytest.mark.parametrize("multi", [False, True])
def test_ray_aabb_matches_jax(multi):
    """Slab-test bounds, misses (-1, -1) and the t_near clamp equal
    JAX's bit for bit (the same elementwise f32 operations)."""
    rng = np.random.RandomState(3)
    o, d = _box_rays(rng, 200)
    if multi:
        centers = rng.uniform(-1, 1, (5, 3)).astype(np.float32)
        halves = rng.uniform(0.3, 1.5, (5, 3)).astype(np.float32)
        ref = jax.jit(jint.ray_aabb_multi)(*(jnp.asarray(a) for a in (o, d, centers, halves)))
        out = tint.ray_aabb_multi(*_t(o, d, centers, halves))
    else:
        center = np.array([0.2, -0.1, 0.3], np.float32)
        half = np.array([1.0, 1.5, 0.7], np.float32)
        ref = jax.jit(jint.ray_aabb)(*(jnp.asarray(a) for a in (o, d, center, half)))
        out = tint.ray_aabb(*_t(o, d, center, half))
    ref = np.asarray(ref)
    assert (ref[..., 0] == -1).any() and (ref[..., 0] > 0).any() and (ref[..., 0] == 0).any()
    np.testing.assert_array_equal(ref, out.numpy())


@pytest.mark.parametrize("base,finest,L", [(16, 512, 16), ((32, 16, 24), (2048, 1024, 512), 8)])
def test_level_resolutions_and_as_3d(base, finest, L):
    """Per-level resolutions equal JAX's exactly; a flat [L, H*F] table
    reshapes to JAX's [L, H, F] and a 3-D one passes through."""
    b, f = np.broadcast_to(base, (3,)), np.broadcast_to(finest, (3,))
    ref = jhe.make_level_resolutions(b, f, L)
    out = the.make_level_resolutions(b, f, L)
    assert out.dtype == np.int32
    np.testing.assert_array_equal(np.asarray(ref), out)
    flat = np.arange(L * 64 * 2, dtype=np.float32).reshape(L, 128)
    np.testing.assert_array_equal(np.asarray(jhe.as_3d(jnp.asarray(flat))),
                                  the.as_3d(torch.from_numpy(flat)).numpy())
    three = flat.reshape(L, 64, 2)
    assert the.as_3d(torch.from_numpy(three)).shape == (L, 64, 2)


@pytest.mark.parametrize("res", [(8, 8, 8), (5, 7, 3)])
def test_occupancy_lookup_matches_jax(res):
    """Occupancy at points inside, outside and on the faces of the grid
    equals JAX's exactly."""
    rng = np.random.RandomState(sum(res))
    grid = rng.rand(*res) < 0.5
    corner = np.array([-1.0, -0.5, 0.25], np.float32)
    size = np.array([2.0, 1.5, 0.75], np.float32)
    pts = (corner + rng.uniform(-0.2, 1.2, (300, 3)) * size).astype(np.float32)
    pts[:3] = [corner, corner + size, corner + size / 2]
    ref = jax.jit(jsampling.occupancy_lookup)(*(jnp.asarray(a) for a in (pts, grid, corner, size)))
    out = tsampling.occupancy_lookup(*_t(pts, grid, corner, size))
    ref = np.asarray(ref)
    assert ref.any() and not ref.all()
    np.testing.assert_array_equal(ref, out.numpy())


@pytest.mark.parametrize("layout", ["windowed", None])
def test_load_tile_export_matches_jax(tmp_path, layout):
    """A tile export in the reference layout reads back as JAX reads it:
    flat fp16 tables with a hash layout, and 3-D tables without one
    (which reads as "global")."""
    rng = np.random.RandomState(5)
    L, H = 4, 64
    feats = (rng.randn(L, H, 2) * 0.1).astype(np.float16)
    extra = {} if layout is None else {"hash_layout": np.array(layout)}
    np.savez(tmp_path / "feature.npz",
             features=feats.reshape(L, -1) if layout else feats,
             occupied_grid=rng.rand(4, 4, 4) < 0.5,
             block_corner=np.array([-1.0, -1.0, -1.0], np.float32),
             block_size=np.array([4.0, 4.0, 4.0], np.float32),
             grid_log2dim=np.array([2, 2, 2], np.int32),
             resolution=np.full((L, 3), 16, np.int32), **extra)
    np.savez(tmp_path / "decoder.npz",
             params=rng.randn(tdec.PARAMSIZE).astype(np.float32))
    np.savez(tmp_path / "cams.npz", c2ws=rng.randn(2, 3, 4).astype(np.float32),
             ks=np.stack([K_CAM, K_CAM]), idxs=np.array([3, 7]))
    ref = jckpt.load_tile_export(str(tmp_path))
    out = tckpt.load_tile_export(str(tmp_path))
    assert sorted(ref) == sorted(out)
    assert out["hash_layout"] == (layout or "global")
    assert out["features"].shape == (L, H, 2)
    for k in ref:
        if k == "hash_layout":
            assert ref[k] == out[k]
        else:
            np.testing.assert_array_equal(ref[k], out[k], err_msg=k)
            assert ref[k].dtype == out[k].dtype, k


def test_gaussian_act_matches_jax():
    """The decoder's Gaussian activation equals JAX's within 1e-7 (one
    exp of the same f32 argument), at zero, in the tails and beyond."""
    x = np.linspace(-1.0, 1.0, 401, dtype=np.float32)
    ref = np.asarray(jax.jit(jdec.gaussian_act)(jnp.asarray(x)))
    out = tdec.gaussian_act(torch.from_numpy(x)).numpy()
    assert out[200] == 1.0 and out[0] < 1e-20
    np.testing.assert_allclose(ref, out, atol=1e-7, rtol=0)


# ---------------------------------------------------------------------------
# host-side scene builders (numpy on both sides): exact
# ---------------------------------------------------------------------------

def _tiles(T, grid=6, seed=0):
    """T tiles on an x-z lattice, overlapping, with random occupancy."""
    rng = np.random.RandomState(seed)
    corners, sizes = [], []
    for t in range(T):
        i, k = t % 2, t // 2
        corners.append([-2.0 + 1.5 * i, -2.0, -2.0 + 1.5 * k])
        sizes.append([4.0, 4.0, 4.0])
    corners = np.asarray(corners, np.float32)
    sizes = np.asarray(sizes, np.float32)
    occ = rng.rand(T, grid, grid, grid) < 0.4
    return corners, sizes, occ


@pytest.mark.parametrize("T", [2, 3])
def test_scene_builders_match_jax(T):
    """The cross-tile occupancy union, the scene-wide union grid, the
    tile LUT and the flattened tables equal JAX's exactly."""
    corners, sizes, occ = _tiles(T, seed=T)
    exports = [dict(occupied_grid=occ[t], block_corner=corners[t], block_size=sizes[t])
               for t in range(T)]
    union = jr._union_occupancy(exports)
    np.testing.assert_array_equal(union, tr._union_occupancy(exports))
    assert (union.sum() > occ.sum())  # the overlap added cells
    for r, o in zip(jr.build_union_grid(corners, sizes, union),
                    tr.build_union_grid(corners, sizes, union)):
        np.testing.assert_array_equal(np.asarray(r), np.asarray(o))
    ref_lut, out_lut = jr.build_tile_lut(corners, sizes), tr.build_tile_lut(corners, sizes)
    for r, o in zip(ref_lut[:3], out_lut[:3]):
        np.testing.assert_array_equal(np.asarray(r), np.asarray(o))
    assert tuple(ref_lut[3]) == tuple(out_lut[3])
    feats = np.random.RandomState(T).randn(T, 4, 32, 2).astype(np.float32)
    np.testing.assert_array_equal(jr.flatten_tables(feats), tr.flatten_tables(feats))


def test_list_tile_dirs_numeric_order(tmp_path):
    """Tile dirs sort by numeric id (tile-10 after tile-2), as JAX's."""
    for i in (10, 2, 1, 0):
        os.makedirs(tmp_path / f"tile-{i}")
    ref = jr.list_tile_dirs(str(tmp_path))
    out = tr.list_tile_dirs(str(tmp_path))
    assert out == ref
    assert [os.path.basename(p) for p in out] == ["tile-0", "tile-1", "tile-2", "tile-10"]


# ---------------------------------------------------------------------------
# per-sample renderer helpers
# ---------------------------------------------------------------------------

def _helper_case(name, rng):
    """(JAX function, port function, numpy inputs, tolerance) of one
    renderer helper; the tolerance covers f32 sums and divisions in
    another order (exact where the operations are the same)."""
    corner = np.array([-2.0, -1.0, -3.0], np.float32)
    size = np.array([4.0, 2.0, 6.0], np.float32)
    pts = (corner + rng.uniform(-0.5, 1.5, (64, 9, 3)) * size).astype(np.float32)
    if name == "seam_weight":
        u = rng.uniform(-0.1, 1.1, (64, 9, 3)).astype(np.float32)
        u[:4, 0] = [[0.0, 0.5, 0.3], [0.5, 0.2, 1.0], [0.0, 0.1, 1.0], [0.4, 0.0, 0.6]]
        return jr._seam_weight, tr._seam_weight, (u, size / 2), 0.0
    if name == "contract_fg":
        return jr._contract_fg, tr._contract_fg, (corner, size, pts), 0.0
    if name == "contract_bg":
        return jr._contract_bg, tr._contract_bg, (corner, size, pts), 0.0
    if name == "composite":
        alpha = rng.uniform(0, 1, (32, 20)).astype(np.float32)
        alpha[:, 5] = 1.0
        color = rng.uniform(0, 1, (32, 20, 3)).astype(np.float32) * alpha[..., None]
        z = np.cumsum(rng.uniform(0.01, 0.2, (32, 20)), 1).astype(np.float32)
        return jr._composite_premult, tr._composite_premult, (alpha, color, z), 1e-6
    raise ValueError(name)


@pytest.mark.parametrize("name", ["seam_weight", "contract_fg", "contract_bg", "composite"])
def test_renderer_helpers_match_jax(name):
    """Seam weights, the fg and bg contractions and premultiplied
    compositing equal JAX's (exact; compositing within 1e-6, its
    cumulative product and sums may take another order)."""
    fj, ft, args, tol = _helper_case(name, np.random.RandomState(len(name)))
    ref = jax.jit(fj)(*(jnp.asarray(a) for a in args))
    out = ft(*_t(*args))
    ref, out = (ref, out) if isinstance(out, tuple) else ((ref,), (out,))
    for r, o in zip(ref, out):
        np.testing.assert_allclose(np.asarray(r), o.numpy(), atol=tol, rtol=0)


@pytest.mark.parametrize("Sb", [6, 33])
def test_bg_zvals_match_jax(Sb):
    """Inverse-z background samples from the exit to 1e6 and their
    spacings equal JAX's op-by-op result bit for bit: the port rounds
    its linspace as jnp.linspace does."""
    far = np.random.RandomState(Sb).uniform(0.5, 30.0, 40).astype(np.float32)
    zr, dr = jr._bg_zvals(jnp.asarray(far), Sb)
    z, d = tsampling.inverse_z_vals(torch.from_numpy(far), Sb)
    np.testing.assert_array_equal(np.asarray(zr), z.numpy())
    np.testing.assert_array_equal(np.asarray(dr), d.numpy())
