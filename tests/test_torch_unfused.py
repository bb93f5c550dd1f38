"""Parity of the port's unfused configuration (scanerf_tpu_torch, slice 3)
with the JAX package on the CPU, where each port wrapper takes its plain
PyTorch version: the windowed lookup over the sorted stream (B3 forward,
B4 backward), training with ``fused_decoder=False`` and the multi-tile
render with ``fuse_decoder=False``, and the training package's
evaluation renders. Cheapest first.

The JAX side never runs its B3/B4 Pallas kernels in interpret mode (10-25
s of CPU compile a test). It runs ``hash_encode_windowed_ref`` under
``jax.jit``, the oracle tests/test_pallas_hash.py holds those kernels to;
where a JAX path calls ``hash_lookup_sorted``, the test swaps it (here
only, with pytest's monkeypatch) for the same index math on the stream
rows, and runs that path under a jit of its own so that no trace of the
swap is cached for other tests. Inputs come from numpy with a seed; each
tolerance is stated where it is used.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scanerf_tpu.ops.pallas import hash_encode as jhw
from scanerf_tpu.render import renderer as jr
from scanerf_tpu.train import cameras as jcam
from scanerf_tpu.train import tile as jtile
from scanerf_tpu_torch import convert
from scanerf_tpu_torch.models.decoder import PACK_ORDER
from scanerf_tpu_torch.ops.kernels import hash_encode as thw
from scanerf_tpu_torch.render import renderer as tr
from scanerf_tpu_torch.train import cameras as tcam
from scanerf_tpu_torch.train import tile as ttile
from test_torch_render import TOL, assert_render_close, jax_scene, scene_arrays
from test_torch_train import _full_recipe_setup, _j_encode_rows, _rel_l2

L = 16


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread while these tests run (the suite runs on
    several workers at once), and the worker's setting back after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _j_lookup_sorted(pts, meta, visited, features, resolutions, onehot_bf16=False):
    """Stand-in for the JAX ``hash_lookup_sorted`` (B3/B4 in Pallas): the
    index math of ``hash_encode_windowed_ref`` on every stream row, zero
    features on sentinel rows; JAX differentiates it in pts rows 0-2 and
    the tables, as the kernel pair does."""
    NC = pts.shape[0]
    rows = pts.transpose(0, 2, 1).reshape(NC * jhw.CHUNK, 8)
    NW = features.shape[1] // (2 * jhw.W)
    wid = rows[:, 3].astype(jnp.int32)
    real = wid < NW
    f = _j_encode_rows(rows[:, 0:3], jnp.where(real, wid, 0), features, resolutions)
    return jnp.where(real[:, None], f, 0.0)


def _points(rng, n, spread):
    """Points [n, 3] in [-2, 2]. ``spread``: u's x in [0, 0.3) or [0.7, 1),
    which at H = 2^16 fills windows of blocks 0 and 3 only (blocks 1 and 2
    stay empty); otherwise anywhere."""
    u = rng.rand(n, 3).astype(np.float32)
    if spread:
        x = rng.rand(n).astype(np.float32) * 0.6
        u[:, 0] = np.where(x < 0.3, x, x + 0.4)
    return u * 4.0 - 2.0


# ---------------------------------------------------------------------------
# (a), (b) the lookup: B3 / B4 plain versions
# ---------------------------------------------------------------------------

@jax.jit
def _j_windowed_vjp(x, feats, res, g):
    out, pull = jax.vjp(lambda p, f: jhw.hash_encode_windowed_ref(p, f, res), x, feats)
    return out, pull(g)


@pytest.mark.parametrize("H,n_levels,spread", [(2**14, 4, False), (2**16, 8, True)],
                         ids=["one_block", "blocks_with_empty"])
def test_hash_encode_windowed_matches_jax(H, n_levels, spread):
    """(a) the port's original-order ``hash_encode_windowed`` (sort_pack ->
    hash_lookup_sorted -> unsort_rows) against JAX's
    ``hash_encode_windowed_ref``, on one block (H = 2^14) and on four
    blocks of which two are empty (H = 2^16): values within 1e-6 (the
    same products summed in another order), and the vjp in the points and
    the tables within 1e-5 of each one's largest entry (the scatter's and
    the 8 corners' sums in another order)."""
    rng = np.random.RandomState(H % 97 + n_levels)
    N = 600
    x = _points(rng, N, spread)
    feats = (rng.randn(n_levels, H * 2) * 0.1).astype(np.float32)
    res = np.stack([np.full(3, 16 * 2**i, np.int32) for i in range(n_levels)])
    g = rng.randn(N, 2 * n_levels).astype(np.float32)
    jout, (jdx, jdf) = _j_windowed_vjp(jnp.asarray(x), jnp.asarray(feats), jnp.asarray(res),
                                       jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    ft = torch.from_numpy(feats).requires_grad_()
    out = thw.hash_encode_windowed(xt, ft, torch.from_numpy(res))
    dx, df = torch.autograd.grad(out, (xt, ft), torch.from_numpy(g))
    np.testing.assert_allclose(np.asarray(jout), out.detach().numpy(), atol=1e-6, rtol=0)
    for name, a, b in (("points", jdx, dx), ("tables", jdf, df)):
        a = np.asarray(a)
        np.testing.assert_allclose(a, b.numpy(), atol=1e-5 * np.abs(a).max(), rtol=0,
                                   err_msg=name)
    if spread:  # blocks 1 and 2 are unvisited: exactly zero
        blk = df.reshape(n_levels, -1, jhw.WB * jhw.W * 2)
        assert blk[:, 1:3].abs().max() == 0 and blk[:, 0].abs().max() > 0


def test_lookup_bwd_plain_matches_autograd():
    """(b) the plain B4 (table scatter by index_add_ and the analytic
    dL/du) against torch autograd of the plain B3 on a stream of 16 levels
    at H = 2^16 with dead rows (sentinel rows in live chunks and
    all-sentinel chunks) and two empty blocks: within 1e-5 of each
    output's largest entry (sums in another order); dpts rows 3-7 and the
    unvisited blocks exactly zero in both; ``hash_lookup_sorted`` on CPU
    tensors gives the plain version's results."""
    rng = np.random.RandomState(4)
    H, N = 2**16, 1500
    x = _points(rng, N, True)
    dead = rng.rand(N) < 0.4
    st = thw.sort_pack(torch.from_numpy(x), torch.from_numpy(rng.randn(N, 3).astype(np.float32)),
                       H, torch.from_numpy(dead))
    live = st.meta[:, :, 2].sum(1) > 0
    assert live.any() and (~live).any()
    feats = torch.from_numpy((rng.randn(L, H * 2) * 0.1).astype(np.float32))
    res = torch.from_numpy(np.stack([np.full(3, 16 + 24 * i, np.int32) for i in range(L)]))
    NW = H // thw.W
    g = torch.from_numpy(rng.randn(st.pts.shape[0] * thw.CHUNK, 2 * L).astype(np.float32))

    p = st.pts.detach().clone().requires_grad_()
    f = feats.clone().requires_grad_()
    want_p, want_f = torch.autograd.grad(thw.lookup_fwd_plain(p, f, res, NW), (p, f), g)
    dpts, dfeat = thw.lookup_bwd_plain(st.pts, feats, res, g, NW)
    for name, a, b in (("dpts", want_p, dpts), ("d_features", want_f, dfeat)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5 * float(a.abs().max()),
                                   rtol=0, err_msg=name)
    assert dpts[:, 3:8].abs().max() == 0 and want_p[:, 3:8].abs().max() == 0
    blk = dfeat.reshape(L, -1, jhw.WB * jhw.W * 2)
    assert blk[:, 1:3].abs().max() == 0 and blk[:, 0].abs().max() > 0
    assert dpts[~live].abs().max() == 0

    p2 = st.pts.detach().clone().requires_grad_()
    f2 = feats.clone().requires_grad_()
    out = thw.hash_lookup_sorted(p2, st.meta, f2, res)
    torch.testing.assert_close(out, thw.lookup_fwd_plain(st.pts, feats, res, NW), rtol=0,
                               atol=0)
    gp, gf = torch.autograd.grad(out, (p2, f2), g)
    torch.testing.assert_close(gp, dpts, rtol=0, atol=0)
    torch.testing.assert_close(gf, dfeat, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# (d) the port's unfused step against its fused step
# ---------------------------------------------------------------------------

def _cpu_tile(tc, n_cam=4, step=3000):
    from scanerf_tpu_torch.data import synthetic as tsyn
    from scanerf_tpu_torch.models import field as tfield

    imgs, depths, ks, c2ws = tsyn.make_sphere_dataset(n_cam, 32, 32)
    params, fs = tfield.create_field(torch.Generator().manual_seed(0), [-1.0] * 3, [2.0] * 3,
                                     log2_hashmap_size=14, grid_resolution=(16, 256),
                                     device="cpu")
    state = ttile.create_train_state(params, fs, n_cam, tc, device="cpu")
    state.step = step
    normals = torch.tensor([0.1, 1.0, 0.2]).expand(*imgs.shape[:3], 3).contiguous()
    data = ttile.TileData(images=torch.from_numpy(imgs),
                          occlusions=torch.ones(imgs.shape[:3], dtype=torch.bool),
                          cameras=tcam.make_cameras(torch.from_numpy(ks), torch.from_numpy(c2ws)),
                          mono_depths=torch.from_numpy(depths), mono_normals=normals)
    return state, data


def test_unfused_step_matches_fused_on_cpu():
    """(d) one full-recipe compute_grads (warp 1.0 with its re-render,
    depth, smooth, rho 100; BARF at step 3000) with fused_decoder=False
    against the same step with the fused decoder, same state and rays:
    the samples are identical, only the decode's summation order differs
    (the lookup then the decoder's matmuls, against the fused per-row
    decode). Losses within 1e-5 relative, gradients' relative L2 within
    1e-4 per leaf (measured: 1e-7 and 7e-6). Then one unfused train_step
    moves every group."""
    kw = dict(num_sample=32, num_bg_sample=16, batch_log2=8, num_march=96, w_warp=1.0,
              w_depth=0.01, w_smooth=0.001, rho=100.0, alpha=0.02, gamma=1.0)
    out = {}
    for fused in (True, False):
        tc = ttile.TrainConfig(fused_decoder=fused, **kw)
        state, data = _cpu_tile(tc)
        out[fused] = ttile.compute_grads(state, data, tc, torch.Generator().manual_seed(1))
    (_, a_f), g_f = out[True]
    (_, a_u), g_u = out[False]
    for k in ("total_loss", "rgb_loss", "depth_loss", "smooth_loss", "warp_loss"):
        assert float(a_f[k]) > 0, k
        np.testing.assert_allclose(float(a_f[k]), float(a_u[k]), rtol=1e-5, err_msg=k)
    for name in ("hash", "decoder", "cam"):
        for a, b in zip(g_f[name], g_u[name]):
            if a.norm() > 0:
                assert float((a - b).norm() / a.norm()) < 1e-4, name
            else:
                assert b.norm() == 0, name
    before = {k: [t.clone() for t in v] for k, v in ttile.group_leaves(state.params).items()}
    state, aux = ttile.train_step(state, data, tc, torch.Generator().manual_seed(2),
                                  device="cpu")
    assert all(torch.isfinite(v).all() for v in aux.values())
    for name, leaves in ttile.group_leaves(state.params).items():
        assert all(not torch.equal(a, b) for a, b in zip(before[name], leaves)), name


# ---------------------------------------------------------------------------
# (e) the unfused multi-tile render against JAX's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("T,n_rays", [(1, 24), (4, 16)])
def test_unfused_render_rays_matches_jax(monkeypatch, T, n_rays):
    """(e) render_rays(fuse_decoder=False) against the JAX windowed render
    with fuse_decoder=False (its lookup swapped for the stand-in above),
    at T = 1 and T = 4, at the render tests' tolerances (rgb 2e-5, depth
    2e-4, T_left 2e-5: f32 sums in other orders); and the port's fused
    render of the same rays within the same tolerances."""
    monkeypatch.setattr(jhw, "hash_lookup_sorted", _j_lookup_sorted)
    a = scene_arrays(T=T, seed=20 + T)
    rng = np.random.RandomState(30 + T)
    o = (rng.randn(n_rays, 3) * 0.3).astype(np.float32)
    o[:, 0] += rng.uniform(0, 1.5 * (T - 1), n_rays).astype(np.float32)
    d = rng.randn(n_rays, 3).astype(np.float32)
    kw = dict(num_sample=12, num_bg_sample=6, num_march=32)
    js = jax_scene(a)
    render = jax.jit(jr.render_rays.__wrapped__, static_argnames=(
        "num_sample", "num_bg_sample", "num_march", "backend", "fuse_decoder"))
    ref = render(js, jnp.asarray(o), jnp.asarray(d), backend="windowed", fuse_decoder=False,
                 **kw)
    ts = convert.scene(js, device="cpu")
    out = tr.render_rays(ts, o, d, device="cpu", fuse_decoder=False, **kw)
    assert bool(out["fore_valid"].any())
    np.testing.assert_array_equal(np.asarray(ref["fore_valid"]), out["fore_valid"].numpy())
    assert_render_close(ref, out)
    fused = tr.render_rays(ts, o, d, device="cpu", **kw)
    for k, tol in TOL.items():
        np.testing.assert_allclose(fused[k].numpy(), out[k].numpy(), atol=tol, err_msg=k)


# ---------------------------------------------------------------------------
# (c), (f) the unfused training path against JAX's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def recipe():
    """test_torch_train.py test (g)'s setup: 4 cameras at 32x32, a 75%
    occupied grid, BARF at step 3000, se3_refine and ADMM variables
    nonzero, injected ray_idx and pixel_locs."""
    return _full_recipe_setup()


def _jax_data(data, ks, c2ws):
    return jtile.TileData(
        images=jnp.asarray(data["images"]), occlusions=jnp.asarray(data["occlusions"]),
        cameras=jcam.make_cameras(jnp.asarray(ks), jnp.asarray(c2ws)),
        mono_depths=jnp.asarray(data["mono_depths"]),
        mono_normals=jnp.asarray(data["mono_normals"]))


def _port_data(data, ks, c2ws):
    t = torch.from_numpy
    return ttile.TileData(
        images=t(data["images"]), occlusions=t(data["occlusions"]),
        cameras=tcam.make_cameras(t(ks), t(c2ws)), mono_depths=t(data["mono_depths"]),
        mono_normals=t(data["mono_normals"]))


def test_tile_render_image_and_depth_match_jax(monkeypatch, recipe):
    """(f) ``tile.render_image`` (8x8, two 40-ray chunks) and
    ``render_depth_batch`` (views 0 and 2 at 6x6 with the intrinsics
    scaled by (0.75, 0.5), two chunks) with the unfused decoder, against
    the port's fused decoder and against the JAX functions on the same
    state.

    Unfused against fused: rgb, diffuse and specular within 2e-5, depth
    within 2e-4 (the render tests' tolerances; only the decode's sums
    differ). Against JAX: 95% of the entries within those tolerances and
    every entry within 2e-4 (colours) and 1e-2 (depth). The port's fused
    and unfused renders differ from JAX's at the same pixels by the same
    amounts (up to 3.1e-5 in rgb and 2.4e-3 in depth on 1-3% of the
    entries, measured), so the gap is not the decoder's: the render of a
    training field is not continuous in f32 rounding (a fg sample on a CDF
    tie moves by a march segment when the rays differ by an ulp;
    ROADMAP.md queue C, test_torch_train.py test (g))."""
    monkeypatch.setattr(jhw, "hash_lookup_sorted", _j_lookup_sorted)
    monkeypatch.setattr(jtile, "render_chunk",
                        jax.jit(jtile.render_chunk.__wrapped__, static_argnames=("tc",)))
    jtc, ttc, st, data, ks, c2ws, _, _ = recipe
    jtc = dataclasses.replace(jtc, fused_decoder=False)
    tcs = {fused: dataclasses.replace(ttc, fused_decoder=fused) for fused in (True, False)}
    jd, td = _jax_data(data, ks, c2ws), _port_data(data, ks, c2ws)
    port = convert.train_state(st, device="cpu")
    tols = (("rgb", 2e-5, 2e-4), ("diffuse", 2e-5, 2e-4), ("specular", 2e-5, 2e-4),
            ("depth", 2e-4, 1e-2))

    def check(ref, out, fused, k, tol, bound):
        assert out.shape == ref.shape and out.shape == fused.shape, k
        np.testing.assert_allclose(fused, out, atol=tol, rtol=0, err_msg=k)
        err = np.abs(ref - out)
        assert np.mean(err <= tol) >= 0.95 and err.max() <= bound, (k, err.max())

    ref = jtile.render_image(st, jd.cameras, 1, 8, 8, jtc, chunk=40)
    out = {f: ttile.render_image(port, td.cameras, 1, 8, 8, tc, chunk=40, device="cpu")
           for f, tc in tcs.items()}
    for k, tol, bound in tols:
        check(ref[k], out[False][k], out[True][k], k, tol, bound)
    ref = jtile.render_depth_batch(st, jd.cameras, [0, 2], 6, 6, jtc, chunk=40,
                                   k_scale=(0.75, 0.5))
    out = {f: ttile.render_depth_batch(port, td.cameras, [0, 2], 6, 6, tc, chunk=40,
                                       k_scale=(0.75, 0.5), device="cpu")
           for f, tc in tcs.items()}
    assert out[False].shape == (2, 6, 6)
    check(ref, out[False], out[True], "depth batch", 2e-4, 1e-2)


def test_unfused_compute_grads_matches_jax(monkeypatch, recipe):
    """(c) test_torch_train.py test (g) with fused_decoder=False on both
    sides: the port's compute_grads on the CPU (plain B3/B4, the decoder
    in PyTorch) against JAX's compute_losses under jax.value_and_grad and
    a jit of its own, whose B3/B4 pair is swapped for the stand-in. Test
    (g)'s tolerances, for its reasons (the step is not continuous in f32
    rounding): losses 5e-4 relative (depth and smooth 2e-3, warp 2e-2);
    gradients' relative L2 2e-2 (tables, decoder) and 1e-3 (se3_refine);
    99.5% of table entries within 1e-3 of the table gradient's largest."""
    monkeypatch.setattr(jhw, "hash_lookup_sorted", _j_lookup_sorted)
    jtc, ttc, st, data, ks, c2ws, ray_idx, pixel_locs = recipe
    jtc = dataclasses.replace(jtc, fused_decoder=False)
    ttc = dataclasses.replace(ttc, fused_decoder=False)

    @jax.jit
    def jgrads(state, d, ri, pl):
        return jax.value_and_grad(
            lambda p: jtile.compute_losses(p, state.field_state, state.admm, d, ri, pl,
                                           state.step, jtc), has_aux=True)(state.params)

    (jloss, jaux), jg = jgrads(st, _jax_data(data, ks, c2ws), jnp.asarray(ray_idx, jnp.int32),
                               jnp.asarray(pixel_locs, jnp.int32))
    port = convert.train_state(st, device="cpu")
    (tloss, taux), tg = ttile.compute_grads(port, _port_data(data, ks, c2ws), ttc,
                                            ray_idx=torch.from_numpy(ray_idx),
                                            pixel_locs=torch.from_numpy(pixel_locs))
    rtol = {"depth_loss": 2e-3, "smooth_loss": 2e-3, "warp_loss": 2e-2}
    for k in ("total_loss", "rgb_loss", "depth_loss", "smooth_loss", "warp_loss", "admm_loss"):
        assert float(jaux[k]) > 1e-4, k
        np.testing.assert_allclose(float(jaux[k]), float(taux[k]), rtol=rtol.get(k, 5e-4),
                                   err_msg=k)
    np.testing.assert_allclose(float(jloss), float(tloss), rtol=5e-4)
    table = np.asarray(jg.field.features)
    assert np.mean(np.abs(table - tg["hash"][0].numpy()) <= 1e-3 * np.abs(table).max()) > 0.995
    assert _rel_l2(table, tg["hash"][0]) < 2e-2
    for i, (n, k) in enumerate((n, k) for n in PACK_ORDER for k in ("w", "b")):
        assert _rel_l2(jg.field.decoder[n][k], tg["decoder"][i]) < 2e-2, (n, k)
    assert _rel_l2(jg.se3_refine, tg["cam"][0]) < 1e-3
