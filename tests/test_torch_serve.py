"""Parity of the port's serving path (scanerf_tpu_torch, slice 9) with the
JAX package on the CPU: the staged backend (``backend="xla"``) on windowed
tiles, global-hash tiles and tiles whose resolution ladders differ; early
ray termination (``render_rays_early``, ``render_image(early_term=True)``)
with its row counts; and the render CLI's VAL and DEMO modes on tiles the
port exports. Cheapest first.

The JAX staged render runs under ``jax.jit`` with no Pallas kernel. The
JAX early-termination path runs its stream pack in interpret mode and,
unfused, its hash lookup (B3) swapped for the index math on the stream
rows (tests/test_torch_unfused.py's stand-in), under jits of its own so
that no trace of the swap is cached for other tests. Tolerances as in
tests/test_torch_render.py: rgb 2e-5, depth 2e-4, T_left 2e-5 (f32 sums
in other orders); the row counts of early termination exactly.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scanerf_tpu.ops.pallas import hash_encode as jhw
from scanerf_tpu.render import early_term as jet
from scanerf_tpu.render import renderer as jr
from scanerf_tpu.utils import metrics as jmetrics
from scanerf_tpu_torch import convert
from scanerf_tpu_torch.data import io as tio
from scanerf_tpu_torch.data import png
from scanerf_tpu_torch.models import field as tfield
from scanerf_tpu_torch.models.decoder import unpack_params
from scanerf_tpu_torch.ops.kernels import hash_encode as thw
from scanerf_tpu_torch.render import __main__ as cli
from scanerf_tpu_torch.render import early_term as tet
from scanerf_tpu_torch.render import renderer as tr
from scanerf_tpu_torch.train import cameras as tcam
from scanerf_tpu_torch.train import checkpoint as tckpt
from scanerf_tpu_torch.train import tile as ttile
from scanerf_tpu_torch.utils import lie as tlie
from scanerf_tpu_torch.utils import rays as trays
from test_torch_render import TOL, assert_render_close, jax_scene, scene_arrays
from test_torch_unfused import _j_lookup_sorted

KW = dict(num_sample=16, num_bg_sample=6, num_march=32)
SIGMA_BIAS = 50.0  # raises every tile's density: alpha saturates in a few samples


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread while these tests run (the suite runs on
    several workers at once), and the worker's setting back after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rays(n, T, seed):
    rng = np.random.RandomState(seed)
    o = (rng.randn(n, 3) * 0.3).astype(np.float32)
    o[:, 0] += rng.uniform(0, 1.5 * (T - 1), n).astype(np.float32)
    return o, rng.randn(n, 3).astype(np.float32)


def _opaque(js):
    """The JAX scene with each tile's sigma-head bias raised by SIGMA_BIAS."""
    dec = dict(js.decoders)
    dec["sigma"] = {"w": dec["sigma"]["w"], "b": dec["sigma"]["b"] + SIGMA_BIAS}
    return js.replace(decoders=dec)


def _port_scene(seed, T=2, opaque=False):
    a = scene_arrays(T=T, seed=seed)
    js = jax_scene(a)
    if opaque:
        js = _opaque(js)
    return js, convert.scene(js, device="cpu")


# ---------------------------------------------------------------------------
# cheap: port only
# ---------------------------------------------------------------------------

def test_bucket_matches_jax():
    for n, bmin in ((4096, 64), (24, 4), (2, 64), (512, 512)):
        for cnt in range(0, n + 3, max(n // 97, 1)):
            assert tet._bucket(cnt, n, bmin) == jet._bucket(cnt, n, bmin), (cnt, n, bmin)


def test_tile_encode_on_the_table_stack():
    """The staged backend's windowed encode on CUDA tensors encodes under
    one tile of the stacked tables (B2 + B3 over ``features_flat``); its
    plain path here equals the gather on that tile's own table, within
    1e-6 (the same products summed in another order)."""
    rng = np.random.RandomState(5)
    T, L, H = 3, 4, 2**14
    stack = torch.from_numpy((rng.randn(L, T * H * 2) * 0.1).astype(np.float32))
    res = torch.from_numpy(np.stack([np.full(3, 16 * 2**i, np.int32) for i in range(L)]))
    x = torch.from_numpy(rng.uniform(-2, 2, (300, 3)).astype(np.float32))
    for t in range(T):
        got = thw.hash_encode_windowed(x, stack, res, tile=t, n_tables=T)
        want = thw.hash_encode_windowed_ref(x, stack.view(L, T, -1)[:, t], res)
        torch.testing.assert_close(got, want, atol=1e-6, rtol=0)


def test_windowed_matches_staged_and_options():
    """The port's windowed render equals its staged render on windowed
    tiles (T = 2 <= 4 blended tiles: the same slot sets); ``auto`` picks
    windowed there and staged for global-hash tiles, ``windowed`` raises
    on those, and ``sharded`` in one process is the plain frame."""
    _, ts = _port_scene(seed=11)
    o, d = _rays(24, 2, 12)
    w = tr.render_rays(ts, o, d, device="cpu", backend="windowed", **KW)
    s = tr.render_rays(ts, o, d, device="cpu", backend="xla", **KW)
    for k, tol in TOL.items():
        np.testing.assert_allclose(w[k].numpy(), s[k].numpy(), atol=tol, err_msg=k)
    assert tr._resolve_backend(ts, "auto") == "windowed"
    tg = dataclasses.replace(ts, hash_layout="global")
    assert tr._resolve_backend(tg, "auto") == "xla"
    with pytest.raises(ValueError, match="windowed"):
        tr.render_rays(tg, o, d, device="cpu", backend="windowed", **KW)
    with pytest.raises(ValueError, match="windowed"):
        tet.render_rays_early(tg, o, d, device="cpu", **KW)
    one = tr.render_image(ts, np.eye(3), np.eye(3, 4), 2, 2, device="cpu", **KW)
    sharded = tr.render_image(ts, np.eye(3), np.eye(3, 4), 2, 2, device="cpu", sharded=True,
                              **KW)
    for k in one:
        np.testing.assert_array_equal(sharded[k], one[k])


def test_early_eps0_matches_one_shot():
    """term_eps=0: no ray terminates and every slab runs; the slab-split
    compositing equals the one-shot windowed render within the render
    tolerances, and the fg rows counted are the one-shot budget."""
    _, ts = _port_scene(seed=13)
    o, d = _rays(24, 2, 14)
    a = tr.render_rays(ts, o, d, device="cpu", **KW)
    stats = {}
    b = tet.render_rays_early(ts, o, d, device="cpu", slab=4, term_eps=0.0, bucket_min=4,
                              stats=stats, **KW)
    for k, tol in (*TOL.items(), ("rgb_fg", TOL["rgb"])):
        np.testing.assert_allclose(a[k].numpy(), b[k].numpy(), atol=tol, err_msg=k)
    assert torch.equal(a["fore_valid"], b["fore_valid"])
    n_valid = int(a["fore_valid"].sum())
    assert [c for c, _ in stats["slabs"]] == [n_valid] * 4
    assert stats["full_fg_rows"] == 24 * 16 * 2


def test_render_image_early_term_matches_chunked():
    """render_image(early_term=True) on the opaque scene equals the
    chunked one-shot frame within the T < 1e-5 truncation (rgb 1e-4,
    depth 1e-3) and sheds fg rows; ``stats`` adds up over the chunks."""
    _, ts = _port_scene(seed=15, opaque=True)
    K = np.array([[20.0, 0, 8.0], [0, 20.0, 6.0], [0, 0, 1]], np.float32)
    c2w = np.eye(4, dtype=np.float32)[:3]
    c2w[:, 3] = [0.5, 0.0, -2.5]
    kw = dict(num_sample=8, num_bg_sample=4, num_march=16)
    a = tr.render_image(ts, K, c2w, 12, 16, chunk=64, device="cpu", **kw)
    stats = {}
    b = tr.render_image(ts, K, c2w, 12, 16, chunk=64, device="cpu", early_term=True,
                        early_kwargs=dict(slab=4, bucket_min=8, stats=stats), **kw)
    np.testing.assert_allclose(a["rgb"], b["rgb"], atol=1e-4)
    np.testing.assert_allclose(a["depth"], b["depth"], atol=1e-3)
    assert stats["n_rays"] == 192
    assert stats["fg_rows"] < stats["full_fg_rows"], stats


# ---------------------------------------------------------------------------
# the staged backend against the JAX package's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["windowed", "global", "unshared_res"])
def test_staged_matches_jax(layout):
    """The port's staged render_rays (backend "xla", and "auto" where it
    resolves to staged) against JAX's on the same scene and rays: windowed
    tiles, global-hash tiles, and windowed tiles whose second tile has
    its own resolution ladder (``shared_res=False``, staged only); with
    the ground-plane bg mask."""
    a = scene_arrays(T=2, seed=21)
    if layout == "unshared_res":
        a["resolutions"][1] = (a["resolutions"][1] * 0.75).astype(np.int32)
    js = jax_scene(a).replace(hash_layout="global" if layout == "global" else "windowed",
                              shared_res=layout != "unshared_res")
    ts = convert.scene(js, device="cpu")
    assert ts.shared_res == (layout != "unshared_res") and ts.hash_layout == js.hash_layout
    o, d = _rays(16, 2, 22)
    kw = dict(KW, invalid_underground=True)
    ref = jr.render_rays(js, jnp.asarray(o), jnp.asarray(d), backend="xla", **kw)
    backend = "xla" if layout == "windowed" else "auto"
    out = tr.render_rays(ts, o, d, device="cpu", backend=backend, **kw)
    assert bool(out["fore_valid"].any())
    np.testing.assert_array_equal(np.asarray(ref["fore_valid"]), out["fore_valid"].numpy())
    assert_render_close(ref, out)


# ---------------------------------------------------------------------------
# early termination against the JAX package's
# ---------------------------------------------------------------------------

def _jax_early(monkeypatch):
    """JAX ``render_rays_early`` unfused, its lookup swapped for the
    index math and its jitted helpers re-jitted here."""
    monkeypatch.setattr(jhw, "hash_lookup_sorted", _j_lookup_sorted)
    for name, static in (("_prelude", ("num_sample", "num_march", "max_blend_tiles")),
                         ("_gather_fg", ("slab",)),
                         ("_fg_slab_eval", ("max_blend_tiles", "fuse_decoder")),
                         ("_scatter_fg", ()),
                         ("_bg_eval", ("num_bg_sample", "invalid_underground",
                                       "fuse_decoder"))):
        monkeypatch.setattr(jet, name, jax.jit(getattr(jet, name).__wrapped__,
                                               static_argnames=static))
    return jet.render_rays_early


def test_early_term_matches_jax_and_sheds_rows(monkeypatch):
    """On an opaque scene (the sigma heads' bias raised by SIGMA_BIAS),
    the port's render_rays_early (fused and unfused) against JAX's
    (unfused): outputs at the render tolerances, the row counts and each
    slab's (alive count, batch) equal. Both shed work: fewer fg rows than
    the one-shot budget, a falling alive count, fewer bg rows. The one-shot
    render agrees within the T < 1e-5 truncation (rgb 1e-4, depth 1e-3)."""
    js, ts = _port_scene(seed=17, opaque=True)
    o, d = _rays(32, 2, 18)
    ek = dict(KW, num_sample=8, slab=4, term_eps=1e-5, bucket_min=8)  # 3 batch shapes
    jstats = {}
    ref = _jax_early(monkeypatch)(js, jnp.asarray(o), jnp.asarray(d), fuse_decoder=False,
                                  stats=jstats, **ek)
    for fuse in (False, True):
        stats = {}
        out = tet.render_rays_early(ts, o, d, device="cpu", fuse_decoder=fuse, stats=stats,
                                    **ek)
        assert_render_close(ref, out)
        np.testing.assert_allclose(np.asarray(ref["rgb_fg"]), out["rgb_fg"].numpy(),
                                   atol=TOL["rgb"])
        assert stats == jstats, (stats, jstats)
    assert jstats["fg_rows"] < jstats["full_fg_rows"], jstats
    counts = [c for c, _ in jstats["slabs"]]
    assert counts[-1] < counts[0], jstats["slabs"]
    assert jstats["bg_rows"] < jstats["full_bg_rows"], jstats
    one = tr.render_rays(ts, o, d, device="cpu", **dict(KW, num_sample=8))
    np.testing.assert_allclose(one["rgb"].numpy(), out["rgb"].numpy(), atol=1e-4)
    np.testing.assert_allclose(one["depth"].numpy(), out["depth"].numpy(), atol=1e-3)


# ---------------------------------------------------------------------------
# the render CLI on tiles the port exports
# ---------------------------------------------------------------------------

CLI_T, CLI_H, CLI_W = 2, 12, 16


def _cli_scene(root, layout, num_sample=7):
    """Two tiles exported by ``export_tile`` (the tables and decoders of
    scene_arrays, all-occupied grids as at the start of training), a scene directory with camera.log, GT images and
    renderPath.log, a refined_camera.log and a config yaml -> (config
    path, logdir, arrays, ks, c2ws)."""
    a = scene_arrays(T=CLI_T, seed=31)
    datadir, logdir = os.path.join(root, "scene"), os.path.join(root, "scene", "logs", "run")
    os.makedirs(os.path.join(datadir, "images"))
    os.makedirs(logdir)
    ks = np.tile(np.array([[9.0, 0, 8.3], [0, 9.0, 6.2], [0, 0, 1]], np.float32), (3, 1, 1))
    c2ws = np.zeros((3, 3, 4), np.float32)
    for i, (ax, ay, centre) in enumerate(((0.07, -0.05, [0.5, 0.0, -2.6]),
                                          (-0.04, 0.11, [1.0, 0.2, -2.4]),
                                          (0.05, 0.08, [0.8, -0.1, -2.5]))):
        rx = np.array([[1, 0, 0], [0, np.cos(ax), -np.sin(ax)], [0, np.sin(ax), np.cos(ax)]])
        ry = np.array([[np.cos(ay), 0, np.sin(ay)], [0, 1, 0], [-np.sin(ay), 0, np.cos(ay)]])
        c2ws[i, :, :3] = rx @ ry  # generic directions: no sample on a CDF or cell tie
        c2ws[i, :, 3] = centre
    cams = tcam.make_cameras(torch.from_numpy(ks), torch.from_numpy(c2ws))
    for t in range(CLI_T):
        inner_c = a["block_corner"][t] + a["block_size"][t] / 4.0
        p, fs = tfield.create_field(torch.Generator().manual_seed(t), inner_c,
                                    a["block_size"][t] / 2.0, log2_hashmap_size=14,
                                    grid_resolution=(16, 256), sampler_log2dim=3,
                                    cubic_grid=True, device="cpu")
        p.features.data.copy_(torch.from_numpy(a["features"][t].reshape(16, -1)))
        for name, leaf in unpack_params(torch.from_numpy(a["decoders"][t])).items():
            for k in ("w", "b"):
                p.decoder[name][k].data.copy_(leaf[k])
        state = ttile.create_train_state(p, fs, 3, ttile.TrainConfig(), device="cpu")
        tckpt.export_tile(os.path.join(logdir, f"tile-{t}"), state, cams, [0, 1, 2],
                          hash_layout=layout)
    rng = np.random.RandomState(32)
    for i in range(2):  # the third view has no ground truth
        png.write_png(os.path.join(datadir, "images", f"{i}.png"),
                      rng.randint(0, 256, (CLI_H, CLI_W, 3)).astype(np.uint8))
    tio.write_campara(os.path.join(datadir, "camera.log"), ks, c2ws + 0.5, CLI_H, CLI_W)
    tio.write_campara(os.path.join(logdir, "refined_camera.log"), ks, c2ws, CLI_H, CLI_W)
    tio.write_campara(os.path.join(datadir, "renderPath.log"), ks[:2], c2ws[:2], 1, 1)
    cfg = os.path.join(root, "cfg.yaml")
    with open(cfg, "w") as f:
        f.write(f"DATADIR: {datadir}\nTRAINING:\n  NUM_SAMPLE: {num_sample}\n"
                "  NUM_BG_SAMPLE: 4\n")
    return cfg, logdir, ks, c2ws


def _u8(rgb):
    return (np.clip(np.asarray(rgb), 0, 1) * 255).astype(np.uint8)


_j_render_staged = jax.jit(jr._render_staged, static_argnums=(11,))


def _jax_frame(js, ts, K, c2w, S, Sb):
    """JAX's staged render (``_render_staged``, jitted) of a CLI_H x CLI_W
    view on the port's rays and samples -> rgb [H, W, 3]. The port's plain
    samplers equal the JAX samplers op by op (tests/test_torch_kernels.py),
    but under jit XLA adds the CDF in another order and its rays differ by
    an ulp, and a sample on a CDF tie then moves by a march segment (ROADMAP
    queue C). The ties are fewest where no sample falls on a plane of the
    boxes, the hash lattice or the windows: all-occupied grids and 7
    samples a ray, not 8. At these the JAX frame differs from the port's
    by up to ~1.3e-3 on a few pixels (XLA contracts o + z * d into fused
    multiply-adds, which move a sample on a face of a box by an ulp), so
    frames are held within one 8-bit step."""
    xy = trays.pixel_grid(CLI_H, CLI_W, device="cpu")
    o, d = trays.get_center_and_ray(xy, tlie.invert(torch.from_numpy(c2w)),
                                    torch.from_numpy(np.asarray(K)))
    z, dists, valid = tr._sample_union(ts, o, d, S, 512)
    bg_tiles, bg_w, far, bg_valid = tr._exit_slots(ts, o, d, CLI_T)
    z_bg, d_bg = tr.inverse_z_vals(far, Sb)
    args = [jnp.asarray(a.numpy()) for a in (o, d, z, dists, valid, bg_tiles, bg_w, z_bg, d_bg,
                                              bg_valid)]
    rgb_fg, _, T_left, rgb_bg, _, _ = _j_render_staged(js, *args, False)
    return np.clip(np.asarray(rgb_fg + T_left[:, None] * rgb_bg), 0, 1).reshape(CLI_H, CLI_W, 3)


@pytest.mark.parametrize("layout", ["windowed", "global"])
def test_cli_val_and_demo_match_jax(tmp_path, monkeypatch, layout):
    """``python -m scanerf_tpu_torch.render cfg LOGDIR VAL|DEMO --device
    cpu`` (through ``main``) on two tiles of each layout exported by the
    port: every frame decodes (cv2.imread) to the 8-bit pixels of the
    port's render_image, and lies within one 8-bit step of the JAX staged render
    of the same view (``_jax_frame``); metric.txt has a line for each view
    with a ground truth (views 0, 1 of 3) and the mean, in the JAX line
    format, its PSNR / SSIM within 2e-3 of the JAX metrics on the JAX
    render. DEMO renders renderPath.log with the principal point moved to
    the centre (the frame cut from 720x1280 to 12x16, the chunk from 8192
    to 256 rays here) and writes demo.mp4."""
    import cv2

    monkeypatch.delenv("SCANERF_EARLY_TERM", raising=False)
    monkeypatch.delenv("SCANERF_LPIPS_WEIGHTS", raising=False)
    monkeypatch.setattr(cli, "DEMO_H", CLI_H)
    monkeypatch.setattr(cli, "DEMO_W", CLI_W)
    monkeypatch.setattr(cli, "CHUNK", 256)
    cfg, logdir, ks, c2ws = _cli_scene(str(tmp_path), layout)
    js = jr.load_scene(jr.list_tile_dirs(logdir))
    ts = tr.load_scene(tr.list_tile_dirs(logdir), device="cpu")

    res = cli.main([cfg, logdir, "val", "--device", "cpu"])
    assert len(res["psnr"]) == 2 and not res["early_term"]
    lines = open(os.path.join(logdir, "val", "metric.txt")).read().splitlines()
    assert len(lines) == 3 and lines[2].startswith("mean\tPSNR ")
    datadir = os.path.join(str(tmp_path), "scene")
    for i in range(3):
        path = os.path.join(logdir, "val", f"{i}.png")
        got = cv2.imread(path)
        mine = tr.render_image(ts, ks[i], c2ws[i], CLI_H, CLI_W, chunk=256, device="cpu",
                               num_sample=7, num_bg_sample=4)["rgb"]
        np.testing.assert_array_equal(got, _u8(mine))
        ref = _jax_frame(js, ts, ks[i], c2ws[i], 7, 4)
        assert np.abs(got.astype(int) - _u8(ref).astype(int)).max() <= 1
        if i == 2:
            continue
        gt = cv2.imread(os.path.join(datadir, "images", f"{i}.png")).astype(np.float32) / 255
        p = float(jmetrics.psnr(jnp.asarray(ref), jnp.asarray(gt)))
        s = float(jmetrics.ssim(jnp.asarray(ref), jnp.asarray(gt)))
        name, ps, ss = lines[i].split("\t")
        assert name == str(i)
        assert abs(float(ps.split()[1]) - p) < 2e-3 and abs(float(ss.split()[1]) - s) < 2e-3
        assert ps == f"PSNR {res['psnr'][i]:.4f}"
    assert lines[2] == f"mean\tPSNR {np.mean(res['psnr']):.4f}\tSSIM {np.mean(res['ssim']):.4f}"

    res = cli.main([cfg, logdir, "DEMO", "0", "2", "--device", "cpu"])
    demo = os.path.join(logdir, "demo")
    assert os.path.getsize(os.path.join(demo, "demo.mp4")) > 0
    assert not os.path.exists(os.path.join(demo, "metric.txt"))
    for i in range(2):
        k = ks[i].copy()
        k[0, 2], k[1, 2] = CLI_W / 2.0, CLI_H / 2.0
        got = png.read_png(os.path.join(demo, f"{i}.png"))
        assert np.abs(got.astype(int) - _u8(_jax_frame(js, ts, k, c2ws[i], 7, 4)).astype(int)).max() <= 1


def test_cli_early_term_frames(tmp_path, monkeypatch):
    """SCANERF_EARLY_TERM=1 renders a windowed scene's VAL frames with
    early termination (its stats returned), within one 8-bit step of the
    one-shot frames."""
    monkeypatch.setenv("SCANERF_EARLY_TERM", "1")
    monkeypatch.delenv("SCANERF_LPIPS_WEIGHTS", raising=False)
    monkeypatch.setattr(cli, "CHUNK", 256)
    cfg, logdir, ks, c2ws = _cli_scene(str(tmp_path), "windowed", num_sample=64)
    res = cli.main([cfg, logdir, "VAL", "1", "2", "--device", "cpu"])
    assert res["early_term"] and res["early_stats"]["n_rays"] == 256
    scene = tr.load_scene(tr.list_tile_dirs(logdir), device="cpu")
    one = tr.render_image(scene, ks[1], c2ws[1], CLI_H, CLI_W, chunk=256, device="cpu",
                          num_sample=64, num_bg_sample=4)
    got = png.read_png(os.path.join(logdir, "val", "1.png"))
    assert np.abs(got.astype(int) - _u8(one["rgb"]).astype(int)).max() <= 1
    assert len(open(os.path.join(logdir, "val", "metric.txt")).read().splitlines()) == 2
