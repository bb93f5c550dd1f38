"""Parity of the port's kernel modules (scanerf_tpu_torch) with the JAX
package on the CPU, where each port wrapper takes its plain PyTorch
version: the windowed hash index math, the sorted stream (B2), the CDF
sampler (B1), the decoder and the fused stream decode (B7). Also: the
port imports nothing of JAX or the JAX package, and its entry points
raise without CUDA. Each tolerance is stated where it is used.
"""

import ast
import functools
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scanerf_tpu.models import decoder as jdec
from scanerf_tpu.ops import sampling as jsampling
from scanerf_tpu.ops.hash_encode import make_level_resolutions
from scanerf_tpu.ops.pallas import hash_encode as jhw
from scanerf_tpu.ops.pallas import sampler as jps
from scanerf_tpu_torch import convert
from scanerf_tpu_torch.models import decoder as tdec
from scanerf_tpu_torch.ops import sampling as tsampling
from scanerf_tpu_torch.ops.kernels import fused_render as tfr
from scanerf_tpu_torch.ops.kernels import hash_encode as thw
from scanerf_tpu_torch.render import renderer as tr

REPO = pathlib.Path(__file__).resolve().parent.parent
H = 2**14


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread while these tests run (the suite runs on
    several workers at once), and the worker's setting back after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# The JAX references run under jit: one compile each instead of one per
# op, and the same functions the JAX package runs inside its jitted
# render. Module-level, so tests of equal shapes share the compile.
_j_windowed_ref = jax.jit(jhw.hash_encode_windowed_ref)
_j_ray_aabb = jax.jit(jsampling.ray_aabb)
_j_sample_fused = jax.jit(jps.sample_fused, static_argnums=(4, 8))
_j_unpack = jax.jit(jdec.unpack_params)


@functools.partial(jax.jit, static_argnums=(2, 3))
def _j_sort_pack_tables(x, dirs, H, T, tids, dead):
    return jhw.sort_pack_tables(x, dirs, tids, H, T, dead=dead)


@jax.jit
def _j_encode_decode(u, tables, res, vec, wid_ok, d):
    """JAX reference of the fused decode for rows of one tile: windowed
    gather encode, zero features on sentinel rows, then the decoder;
    [n, 4] = (sigma, diffuse + tint * specular)."""
    f = jhw.hash_encode_windowed_ref(u * 4.0 - 2.0, tables, res)
    f = jnp.where(wid_ok[:, None], f, 0.0)
    o = jdec.apply_decoder(jdec.unpack_params(vec), f, d, jnp.ones(32))
    return jnp.concatenate([o["sigma"], o["diffuse"] + o["tint"] * o["specular"]], -1)


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_no_jax():
    """(a) no file of the port, nor chip_smoke.py, imports jax, flax or
    the JAX package (numpy-only modules of it included)."""
    files = sorted((REPO / "scanerf_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    bad = [(f.name, m) for f in files for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "flax", "scanerf_tpu")]
    assert not bad, bad


def test_entry_points_need_cuda(tmp_path):
    """(a) without CUDA the entry points raise when no device is given;
    the sharded render in one process (no process group) is the plain
    render, as in the JAX package; the staged backend and early
    termination run."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is valid")
    with pytest.raises(RuntimeError, match="cuda"):
        tr.load_scene([str(tmp_path)])
    z = np.zeros((4, 3), np.float32)
    occ = np.ones((1, 4, 4, 4), bool)
    scene = tr.scene_from_arrays(
        np.zeros((1, 16, H, 2), np.float16), np.zeros((1, tdec.PARAMSIZE), np.float32),
        np.full((1, 16, 3), 8, np.int32), np.full((1, 3), -2.0, np.float32),
        np.full((1, 3), 4.0, np.float32), occ, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        tr.render_rays(scene, z, z)
    with pytest.raises(RuntimeError, match="cuda"):
        tr.render_image(scene, np.eye(3), np.eye(3, 4), 2, 2)
    with pytest.raises(RuntimeError, match="cuda"):
        convert.decoder_params(np.zeros(tdec.PARAMSIZE, np.float32))
    small = dict(num_sample=4, num_bg_sample=4, num_march=8)
    out = tr.render_rays(scene, z, np.ones_like(z), device="cpu", backend="xla", **small)
    assert out["rgb"].shape == (4, 3)
    one = tr.render_image(scene, np.eye(3), np.eye(3, 4), 2, 2, device="cpu", backend="xla",
                          **small)
    sharded = tr.render_image(scene, np.eye(3), np.eye(3, 4), 2, 2, device="cpu",
                              sharded=True, backend="xla", **small)
    for k in one:
        np.testing.assert_array_equal(sharded[k], one[k])
    img = tr.render_image(scene, np.eye(3), np.eye(3, 4), 2, 2, device="cpu", early_term=True,
                          early_kwargs=dict(slab=4), **small)
    assert img["rgb"].shape == (2, 2, 3)


# ---------------------------------------------------------------------------
# (b) windowed index math: bitwise
# ---------------------------------------------------------------------------

def _edge_u(rng, n):
    """Points in [0, 1]^3 including the warp's breakpoints and 1 - eps."""
    u = rng.rand(n, 3).astype(np.float32)
    eps = np.float32(1.0) - np.nextafter(np.float32(1.0), np.float32(0.0))
    special = np.array([0.0, 0.25, 0.75, 1.0 - eps, 0.5, 0.125, 0.875],
                       np.float32)
    u[:len(special) * 3].reshape(-1)[:] = np.repeat(special, 9)[:len(special) * 9]
    return u


@pytest.mark.parametrize("table", [2**14, 2**21])
def test_window_math_bitwise(table):
    """(b) expand_warp, window_id and slot_hash equal JAX bit for bit,
    at the warp breakpoints u = 0.25, 0.75 and at 1 - eps too."""
    rng = np.random.RandomState(1)
    u = _edge_u(rng, 200)
    np.testing.assert_array_equal(
        np.asarray(jhw.expand_warp(jnp.asarray(u))),
        thw.expand_warp(torch.from_numpy(u)).numpy())
    np.testing.assert_array_equal(
        np.asarray(jhw.window_id(jnp.asarray(u), table)),
        thw.window_id(torch.from_numpy(u), table).numpy())
    ic = rng.randint(0, 2**12, (3, 500)).astype(np.uint32)
    ic[:, :3] = [[0, 2**12 - 1, 4095], [7, 0, 2**11], [2047, 1, 0]]
    ref = np.asarray(jhw.slot_hash(*(jnp.asarray(c) for c in ic)))
    out = thw.slot_hash(*(torch.from_numpy(c.astype(np.int64)) for c in ic))
    np.testing.assert_array_equal(ref.astype(np.int64), out.numpy())


def test_hash_encode_windowed_ref():
    """(b) the windowed gather encode matches JAX's within 1e-6 (sums of
    8 weighted corners in another order)."""
    rng = np.random.RandomState(2)
    pts = (_edge_u(rng, 150) * 4.0 - 2.0).astype(np.float32)
    feats = (rng.randn(16, H, 2) * 0.1).astype(np.float32)
    res = make_level_resolutions(np.array([16] * 3), np.array([256] * 3), 16)
    ref = _j_windowed_ref(jnp.asarray(pts), jnp.asarray(feats), jnp.asarray(res))
    out = thw.hash_encode_windowed_ref(torch.from_numpy(pts),
                                       torch.from_numpy(feats.reshape(16, -1)),
                                       torch.from_numpy(res))
    np.testing.assert_allclose(np.asarray(ref), out.numpy(), atol=1e-6, rtol=0)


# ---------------------------------------------------------------------------
# (c) the sorted stream (B2 plain version): exact
# ---------------------------------------------------------------------------

def _stream_inputs(seed, N=700, T=2):
    rng = np.random.RandomState(seed)
    x = (rng.rand(N, 3) * 4 - 2).astype(np.float32)
    dirs = rng.randn(N, 3).astype(np.float32)
    tids = rng.randint(0, T, N).astype(np.int32)
    dead = rng.rand(N) < 0.3
    dead[:40] = True  # a run of dead rows
    return x, dirs, tids, dead


def test_sort_pack_tables_matches_jax():
    """(c) sort_pack_tables with dead rows: pts, pidp, meta and visited
    equal JAX's exactly; unsort_rows restores the row order."""
    T = 2
    x, dirs, tids, dead = _stream_inputs(3, T=T)
    js = _j_sort_pack_tables(jnp.asarray(x), jnp.asarray(dirs), H, T, jnp.asarray(tids),
                             jnp.asarray(dead))
    ts = thw.sort_pack_tables(torch.from_numpy(x), torch.from_numpy(dirs),
                              torch.from_numpy(tids), H, T,
                              dead=torch.from_numpy(dead))
    np.testing.assert_array_equal(np.asarray(js.pts), ts.pts.numpy())
    np.testing.assert_array_equal(np.asarray(js.pidp), ts.pidp.numpy())
    np.testing.assert_array_equal(np.asarray(js.meta), ts.meta.numpy())
    np.testing.assert_array_equal(np.asarray(js.visited), ts.visited.numpy())
    # round trip: each stream row's payload goes back to its original row
    N = x.shape[0]
    payload = ts.pts[:, [0, 1, 2, 4, 5, 6], :].permute(0, 2, 1).reshape(-1, 6)
    back = thw.unsort_rows(payload, ts.pidp, N).numpy()
    np.testing.assert_array_equal(back[:, :3], (x + 2.0) * 0.25)
    np.testing.assert_array_equal(back[:, 3:], dirs)


def test_pack_plain_pads():
    """(c) the plain pack fills pad rows with u=0.5, the sentinel window,
    zero dirs and pid N, and copies each chunk's run."""
    src = torch.arange(7 * 5, dtype=torch.float32).reshape(7, 5)
    pids = torch.tensor([4, 3, 2, 1, 0], dtype=torch.int32)
    desc = torch.tensor([[0, 3], [3, 2], [5, 0]], dtype=torch.int32)
    pts, pidp = thw.pack(src, pids, desc, 3, 99)
    assert pts.shape == (3, 8, thw.CHUNK)
    np.testing.assert_array_equal(pts[0, :7, :3].numpy(), src[:, :3].numpy())
    np.testing.assert_array_equal(pts[1, :7, :2].numpy(), src[:, 3:5].numpy())
    np.testing.assert_array_equal(pts[2, :, 0].numpy(), [0.5, 0.5, 0.5, 99, 0, 0, 0, 0])
    assert (pts[:, 7] == 0).all()
    np.testing.assert_array_equal(pidp[:4].numpy(), [4, 3, 2, 5])
    assert (pidp.reshape(3, -1)[2] == 5).all()


# ---------------------------------------------------------------------------
# (e) decoder and the fused stream decode (B7 plain version)
# ---------------------------------------------------------------------------

def test_decoder_matches_jax():
    """(e) unpack_params and the decoder forward match JAX within 1e-5
    (f32 matmuls in another order); pack_params inverts unpack; the JAX
    param pytree converts to the same params."""
    rng = np.random.RandomState(4)
    vec = rng.uniform(-0.3, 0.3, jdec.PARAMSIZE).astype(np.float32)
    feats = (rng.randn(64, 32) * 0.3).astype(np.float32)
    dirs = rng.randn(64, 3).astype(np.float32)
    jparams = _j_unpack(jnp.asarray(vec))
    ref = jax.jit(jdec.apply_decoder)(jparams, jnp.asarray(feats), jnp.asarray(dirs),
                                      jnp.ones(32))
    params = tdec.unpack_params(torch.from_numpy(vec))
    np.testing.assert_array_equal(tdec.pack_params(params).numpy(), vec)
    tree = convert.decoder_params(jparams, device="cpu")
    np.testing.assert_array_equal(tdec.pack_params(tree).numpy(), vec)
    out = tdec.ShallowMLP(params)(torch.from_numpy(feats), torch.from_numpy(dirs))
    for k in ("sigma", "diffuse", "specular", "tint"):
        np.testing.assert_allclose(np.asarray(ref[k]), out[k].detach().numpy(),
                                   atol=1e-5, rtol=0, err_msg=k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stream_decode_matches_jax(dtype):
    """(e) the plain fused decode equals the JAX reference composition on
    the same stream: per row, JAX's windowed gather encode of its tile's
    tables and JAX's decoder of its chunk's tile; zero features for
    sentinel rows of live chunks, zeros for all-sentinel chunks (what
    the fused kernel computes, tests/test_renderer_windowed.py::
    test_fused_decoder_matches_unfused). Tolerance 2e-5: f32 sums in
    another order through three Gaussian layers."""
    T = 2
    x, dirs, tids, dead = _stream_inputs(6, N=900, T=T)
    x = x * 0.5  # fg-like coordinates, inside [-1, 1]
    rng = np.random.RandomState(8)
    feats = (rng.randn(T, 16, H, 2) * 0.1).astype(np.float32)
    vecs = rng.uniform(-0.3, 0.3, (T, jdec.PARAMSIZE)).astype(np.float32)
    res = make_level_resolutions(np.array([32] * 3), np.array([512] * 3), 16)
    flat = tr.flatten_tables(feats)
    tdt = getattr(torch, dtype)
    flat_t = torch.from_numpy(flat).to(tdt)
    decs = tdec.stack_params([tdec.unpack_params(torch.from_numpy(v)) for v in vecs])
    ts = thw.sort_pack_tables(torch.from_numpy(x), torch.from_numpy(dirs),
                              torch.from_numpy(tids), H, T,
                              dead=torch.from_numpy(dead))
    NW1 = H // thw.W
    ct = torch.div(ts.meta[:, 0, 0] * thw.WB, NW1, rounding_mode="floor").clamp(0, T - 1)
    out = tfr.hash_decode_fused(ts, ct.to(torch.int32), flat_t,
                                torch.from_numpy(res), decs, NW1 * T).numpy()

    # JAX reference on the same rows: every row through each tile's
    # tables and decoder (one shape, one compile), then each row takes
    # its chunk's tile; rows of all-sentinel chunks stay zero
    pts = ts.pts.numpy()
    u = jnp.asarray(pts[:, 0:3, :].transpose(0, 2, 1).reshape(-1, 3))
    wid_ok = jnp.asarray(pts[:, 3, :].reshape(-1) < NW1 * T)
    d = jnp.asarray(pts[:, 4:7, :].transpose(0, 2, 1).reshape(-1, 3))
    row_tile = np.repeat(ct.numpy(), thw.CHUNK)
    live = np.repeat(ts.meta.numpy()[:, :, 2].sum(1) > 0, thw.CHUNK)
    tables = jnp.asarray(flat_t.float().numpy()).reshape(16, T, H * 2)
    ref = np.zeros_like(out)
    for t in range(T):
        rows = live & (row_tile == t)
        o = np.asarray(_j_encode_decode(u, tables[:, t], jnp.asarray(res),
                                        jnp.asarray(vecs[t]), wid_ok, d))
        ref[rows] = o[rows]
    assert live.sum() > 0 and (~live).sum() > 0
    np.testing.assert_allclose(ref, out, atol=2e-5, rtol=0)


def test_decoder_slab_layout():
    """B7's shared-memory slab holds every decoder weight and bias at the
    offsets the CUDA kernel reads."""
    rng = np.random.RandomState(9)
    vecs = rng.uniform(-1, 1, (2, tdec.PARAMSIZE)).astype(np.float32)
    decs = tdec.stack_params([tdec.unpack_params(torch.from_numpy(v)) for v in vecs])
    slab = tfr.pack_decoder_slabs(decs)
    assert slab.shape == (2, tfr.PSLAB)
    got = slab[1]
    w = decs["spatial1"]["w"][1]  # [in, out]
    np.testing.assert_array_equal(got[tfr.SP1_W:tfr.SP1_W + 64 * 64].reshape(64, 64).numpy(),
                                  w.t().numpy())
    np.testing.assert_array_equal(got[tfr.HEAD_W + 32 * 4:tfr.HEAD_W + 32 * 5].numpy(),
                                  decs["tint"]["w"][1][:, 0].numpy())
    np.testing.assert_array_equal(got[tfr.B_DIR2:tfr.B_DIR2 + 3].numpy(),
                                  decs["dir2"]["b"][1].numpy())
    # every parameter lands once: slab sums to the packed vector's sum
    np.testing.assert_allclose(float(got.double().sum()), float(vecs[1].astype(np.float64).sum()),
                               rtol=1e-9)


# ---------------------------------------------------------------------------
# (d) the CDF sampler (B1 plain version)
# ---------------------------------------------------------------------------

def _sampler_inputs(seed, N=64, res=(16, 12, 20)):
    rng = np.random.RandomState(seed)
    grid = rng.rand(*res) < 0.35
    corner = np.array([-1.0, -1.2, -0.8], np.float32)
    size = np.array([2.0, 2.4, 1.6], np.float32)
    o = rng.normal(0, 1.0, (N, 3)).astype(np.float32)
    d = rng.normal(0, 1.0, (N, 3)).astype(np.float32)
    return grid, corner, size, o, d


@pytest.mark.parametrize("S,M", [(12, 32), (7, 300)])
def test_sampler_matches_xla(S, M):
    """(d) the plain sampler equals the JAX XLA branch: the scan adds in
    XLA's CPU order, so valid masks, totals and z are bitwise equal
    (M=300: a march that is no power of two, two levels of block totals)."""
    grid, corner, size, o, d = _sampler_inputs(S + M)
    b = _j_ray_aabb(jnp.asarray(o), jnp.asarray(d),
                    jnp.asarray(corner + size / 2), jnp.asarray(size / 2))
    hit = np.asarray(b[:, 0]) != -1
    tn = np.where(hit, np.asarray(b[:, 0]), 0).astype(np.float32)
    tf = np.where(hit, np.asarray(b[:, 1]), 1).astype(np.float32)
    # op by op, as the bitwise claim is made: under jit XLA fuses the
    # scan into another order of f32 sums
    zj, totj = jsampling.cdf_sample_from_bounds(
        *(jnp.asarray(a) for a in (o, d, tn, tf)), S, jnp.asarray(grid),
        jnp.asarray(corner), jnp.asarray(size), M, backend="xla")
    zt, tott = tsampling.cdf_sample_from_bounds(
        *(torch.from_numpy(a) for a in (o, d, tn, tf)), S, torch.from_numpy(grid),
        torch.from_numpy(corner), torch.from_numpy(size), M)
    assert int((np.asarray(totj) > 0).sum()) > 5
    np.testing.assert_array_equal(np.asarray(totj), tott.numpy())
    np.testing.assert_array_equal(np.asarray(zj), zt.numpy())


def test_sampler_matches_pallas_interpret():
    """(d) the plain sampler against the Pallas kernel in interpret mode
    at M=128: identical valid masks, totals to 1e-5 relative, z within
    1e-4 (the Pallas scan adds in another order; the tolerances of
    tests/test_pallas_sampler.py)."""
    grid, corner, size, o, d = _sampler_inputs(5, N=40, res=(16, 16, 16))
    b = _j_ray_aabb(jnp.asarray(o), jnp.asarray(d),
                    jnp.asarray(corner + size / 2), jnp.asarray(size / 2))
    hit = np.asarray(b[:, 0]) != -1
    tn = np.where(hit, np.asarray(b[:, 0]), 0).astype(np.float32)
    tf = np.where(hit, np.asarray(b[:, 1]), 1).astype(np.float32)
    zj, totj = _j_sample_fused(*(jnp.asarray(a) for a in (o, d, tn, tf)), 12,
                               jnp.asarray(grid), jnp.asarray(corner),
                               jnp.asarray(size), 128)
    zt, tott = tsampling.cdf_sample_from_bounds(
        *(torch.from_numpy(a) for a in (o, d, tn, tf)), 12, torch.from_numpy(grid),
        torch.from_numpy(corner), torch.from_numpy(size), 128)
    vj, vt = np.asarray(totj) > 0, tott.numpy() > 0
    assert vt.sum() > 5
    np.testing.assert_array_equal(vj, vt)
    np.testing.assert_allclose(np.asarray(totj), tott.numpy(), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(np.asarray(zj)[vj], zt.numpy()[vt], atol=1e-4)
