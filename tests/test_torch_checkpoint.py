"""Checkpoints and exports between the port (scanerf_tpu_torch, slice 7)
and the JAX package on the CPU: a port checkpoint round trip, a
checkpoint written by either package loaded by the other (with and
without optimized cameras), the [L, H, F] table migration,
``latest_checkpoint``, ``train_n_steps`` against ``train_step``, and a
tile exported by either package rendered by the other. States carry
non-trivial Adam moments and counts filled from a seeded numpy
generator, so no JAX step is compiled; the JAX render is its staged
per-tile backend, as in tests/test_torch_render.py, at that file's
tolerances.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scanerf_tpu.models import field as jfield
from scanerf_tpu.render import renderer as jr
from scanerf_tpu.train import cameras as jcam
from scanerf_tpu.train import checkpoint as jckpt
from scanerf_tpu.train import tile as jtile
from scanerf_tpu_torch import convert
from scanerf_tpu_torch.models import decoder as tdec
from scanerf_tpu_torch.models import field as tfield
from scanerf_tpu_torch.ops.hash_encode import make_level_resolutions
from scanerf_tpu_torch.render import renderer as tr
from scanerf_tpu_torch.train import cameras as tcam
from scanerf_tpu_torch.train import checkpoint as tckpt
from scanerf_tpu_torch.train import tile as ttile
from test_torch_render import assert_render_close

L, LOG2_H, N_CAM = 16, 14, 3
GRID = 8


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread while these tests run (the suite runs on
    several workers at once), and the worker's setting back after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _random(rng, like):
    """A seeded array of ``like``'s shape and dtype: counts from 1 to 999,
    floats in [0, 1) (Adam's second moments stay non-negative), bools."""
    shape, dtype = tuple(like.shape), np.dtype(str(like.dtype).replace("torch.", ""))
    if dtype == np.bool_:
        return rng.rand(*shape) < 0.6
    if np.issubdtype(dtype, np.integer):
        return rng.randint(1, 1000, shape).astype(dtype)
    return rng.rand(*shape).astype(dtype)


def _template(cam_enable: bool, seed: int = 0):
    """A fresh port state on the CPU: H = 2^14, an 8^3 grid, 3 cameras."""
    p, fs = tfield.create_field(torch.Generator().manual_seed(seed), [-1.0] * 3, [2.0] * 3,
                                log2_hashmap_size=LOG2_H, grid_resolution=(32, 512),
                                sampler_log2dim=3, device="cpu")
    return ttile.create_train_state(p, fs, N_CAM, ttile.TrainConfig(cam_enable=cam_enable),
                                    device="cpu")


def _port_state(cam_enable: bool, seed: int):
    """A port state whose every array, Adam moment and count is random."""
    rng = np.random.RandomState(seed)
    like = convert.state_like(_template(cam_enable))
    arrays = {k: _random(rng, v) for k, v in like.items()}
    return convert.state_from_arrays(arrays.__getitem__, cam_enable, "cpu", like=like)


def _jax_state(cam_enable: bool, seed: int):
    """A JAX TrainState of numpy leaves, its optimizer state's structure
    from ``jax.eval_shape`` (nothing compiled) and every leaf random (the
    tables and decoder at tests/test_torch_render.py's scales)."""
    rng = np.random.RandomState(seed)
    params = jtile.TileParams(
        field=jfield.FieldParams(
            features=rng.randn(L, 2 * 2**LOG2_H).astype(np.float32) * 0.1,
            decoder={n: {"w": rng.uniform(-0.3, 0.3, tdec.SHAPES[n]).astype(np.float32),
                         "b": rng.uniform(-0.3, 0.3, tdec.SHAPES[n][1]).astype(np.float32)}
                     for n in tdec.PACK_ORDER}),
        se3_refine=rng.randn(N_CAM, 6).astype(np.float32) * 0.01)
    tx = jtile.build_optimizer(jtile.TrainConfig(cam_enable=cam_enable))
    opt = jax.tree_util.tree_map(lambda a: _random(rng, a), jax.eval_shape(tx.init, params))
    return jtile.TrainState(
        params=params, opt_state=opt,
        field_state=jfield.FieldState(
            resolutions=make_level_resolutions(np.array([32] * 3), np.array([512] * 3), L),
            min_bbox=np.full(3, -2.0, np.float32), bbox_size=np.full(3, 4.0, np.float32),
            occupied_grid=rng.rand(GRID, GRID, GRID) < 0.6),
        admm=jtile.AdmmState(shared_se3=rng.randn(N_CAM, 6).astype(np.float32),
                             delta_se3=rng.randn(N_CAM, 6).astype(np.float32),
                             overlap_flags=rng.rand(N_CAM) < 0.5,
                             rho=rng.rand(6).astype(np.float32)),
        step=np.int32(rng.randint(1, 1000)))


def _assert_states_equal(a, b):
    ta, tb = convert.state_tensors(a), convert.state_tensors(b)
    assert ta.keys() == tb.keys()
    for k in ta:
        assert ta[k].dtype == tb[k].dtype, k
        assert torch.equal(ta[k], tb[k]), k
    assert a.step == b.step
    assert [(g["name"], g["count"]) for g in a.optimizer.param_groups] == \
        [(g["name"], g["count"]) for g in b.optimizer.param_groups]


def _npz(path):
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cam_enable", [True, False], ids=["cam", "no_cam"])
def test_port_checkpoint_roundtrip(tmp_path, cam_enable):
    """save -> load into a fresh template: every array, moment and count
    equal; one update from each with the same gradients stays equal."""
    src = _port_state(cam_enable, seed=1)
    path = tckpt.checkpoint_path(str(tmp_path), src.step, 0)
    tckpt.save_checkpoint(path, src)
    back = tckpt.load_checkpoint(path, _template(cam_enable, seed=5), device="cpu")
    _assert_states_equal(src, back)
    assert [g["name"] for g in back.optimizer.param_groups] == \
        ["hash", "decoder"] + (["cam"] if cam_enable else [])
    rng = np.random.RandomState(2)
    grads = {k: [torch.from_numpy(rng.randn(*t.shape).astype(np.float32)) for t in v]
             for k, v in ttile.group_leaves(src.params).items()}
    tc = ttile.TrainConfig(cam_enable=cam_enable, total_step=4000)
    for st in (src, back):
        ttile.apply_gradients(st, grads, tc)
    _assert_states_equal(src, back)


@pytest.mark.parametrize("cam_enable", [True, False], ids=["cam", "no_cam"])
def test_jax_checkpoint_loads_in_port(tmp_path, cam_enable):
    """A checkpoint the JAX package wrote loads in the port with the
    file's numbers under every key, and equals ``convert.train_state`` of
    the same JAX state (one key mapping serves both)."""
    jstate = _jax_state(cam_enable, seed=3)
    path = str(tmp_path / "checkpoint-7-0.npz")
    jckpt.save_checkpoint(path, jstate)
    back = tckpt.load_checkpoint(path, _template(cam_enable), device="cpu")
    stored = _npz(path)
    got = convert.state_tensors(back)
    assert got.keys() == stored.keys()
    for k, v in stored.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
        assert got[k].numpy().dtype == v.dtype, k
    _assert_states_equal(back, convert.train_state(jstate, device="cpu"))


@pytest.mark.parametrize("cam_enable", [True, False], ids=["cam", "no_cam"])
def test_port_checkpoint_loads_in_jax(tmp_path, cam_enable):
    """A checkpoint the port wrote loads in the JAX package's
    ``load_checkpoint`` into a JAX template, every leaf equal to the
    port state's numbers."""
    src = _port_state(cam_enable, seed=4)
    path = str(tmp_path / "checkpoint-9-0.npz")
    tckpt.save_checkpoint(path, src)
    back = jckpt.load_checkpoint(path, _jax_state(cam_enable, seed=8))
    want = convert.state_tensors(src)
    flat, _ = jax.tree_util.tree_flatten_with_path(back)
    assert len(flat) == len(want)
    for p, leaf in flat:
        key = "/".join(str(q) for q in p)
        np.testing.assert_array_equal(np.asarray(leaf), want[key].numpy(), err_msg=key)


def test_load_checkpoint_migrations(tmp_path):
    """Tables (and their moments) stored as [L, H, F] load flat into the
    template's [L, H*F]; an occupancy grid of another size keeps the
    stored shape (re-split by pruning), as in the JAX package."""
    src = _port_state(True, seed=6)
    arrays = {k: v.numpy() for k, v in convert.state_tensors(src).items()}
    for k in [k for k in arrays if k.endswith(".field/.features")]:
        arrays[k] = arrays[k].reshape(L, -1, 2)
    grid = np.random.RandomState(0).rand(16, 16, 16) < 0.5
    arrays[".field_state/.occupied_grid"] = grid
    path = str(tmp_path / "old.npz")
    np.savez(path, **arrays)
    back = tckpt.load_checkpoint(path, _template(True), device="cpu")
    feats = back.params.field.features
    assert feats.shape == (L, 2 * 2**LOG2_H)
    assert torch.equal(feats, src.params.field.features)
    assert torch.equal(back.optimizer.state[feats]["exp_avg_sq"],
                       src.optimizer.state[src.params.field.features]["exp_avg_sq"])
    assert torch.equal(back.field_state.occupied_grid, torch.from_numpy(grid))
    jback = jckpt.load_checkpoint(path, _jax_state(True, seed=0))
    assert np.asarray(jback.field_state.occupied_grid).shape == (16, 16, 16)


def test_latest_checkpoint_matches_jax(tmp_path):
    for name in ("checkpoint-5-0.npz", "checkpoint-40-0.npz", "checkpoint-100-1.npz",
                 "checkpoint-7-0.npz"):
        (tmp_path / name).write_bytes(b"")
    d = str(tmp_path)
    assert tckpt.latest_checkpoint(d, 0) == jckpt.latest_checkpoint(d, 0) \
        == os.path.join(d, "checkpoint-40-0.npz")
    assert tckpt.latest_checkpoint(d, 1) == os.path.join(d, "checkpoint-100-1.npz")
    assert tckpt.latest_checkpoint(d, 2) is None and jckpt.latest_checkpoint(d, 2) is None
    assert tckpt.checkpoint_path(d, 12, 3) == jckpt.checkpoint_path(d, 12, 3)


# ---------------------------------------------------------------------------
# train_n_steps
# ---------------------------------------------------------------------------

def test_train_n_steps_equals_train_steps():
    """``train_n_steps(n=2)`` from a generator equals two ``train_step``
    calls from a generator of the same seed, on the CPU: every array of
    the state, moments and counts included, and the last step's losses."""
    from scanerf_tpu_torch.data.synthetic import make_sphere_dataset

    imgs, depths, ks, c2ws = make_sphere_dataset(N_CAM, 16, 16)
    tc = ttile.TrainConfig(num_sample=16, num_bg_sample=8, batch_log2=6, num_march=32,
                           w_depth=0.01, total_step=100)

    def T(a):
        return torch.from_numpy(np.array(a))

    data = ttile.TileData(images=T(imgs), occlusions=torch.ones(imgs.shape[:3], dtype=torch.bool),
                          cameras=tcam.make_cameras(T(ks), T(c2ws)), mono_depths=T(depths),
                          mono_normals=torch.zeros(*imgs.shape[:3], 3))
    a, b = _template(True, seed=2), _template(True, seed=2)
    a, aux_a = ttile.train_n_steps(a, data, tc, 2, torch.Generator().manual_seed(4),
                                   device="cpu")
    gen = torch.Generator().manual_seed(4)
    for _ in range(2):
        b, aux_b = ttile.train_step(b, data, tc, gen, device="cpu")
    assert a.step == 2
    _assert_states_equal(a, b)
    for k in aux_a:
        assert torch.equal(aux_a[k], aux_b[k]), k
    with pytest.raises((RuntimeError, ValueError), match="cuda"):  # the default device
        ttile.train_n_steps(a, data, tc, 1, torch.Generator())


# ---------------------------------------------------------------------------
# exports, rendered by the other package
# ---------------------------------------------------------------------------

_j_render_staged = jax.jit(jr._render_staged, static_argnums=(11,))


def _jax_render_rays(jscene, tscene, o, d, S, Sb, M):
    """The JAX ``render_rays`` (staged backend) of rays [N, 3] on
    ``jscene``, its samples taken by the port's plain samplers on
    ``tscene``, which equal the JAX samplers' op by op (tests/
    test_torch_kernels.py); under jit XLA adds the CDF in another order,
    and a fg sample on a tie then moves by a march segment (ROADMAP.md
    queue C). The JAX samplers op by op take seconds of CPU compile."""
    ot, dt = torch.from_numpy(o), torch.from_numpy(d)
    z, dists, valid = tr._sample_union(tscene, ot, dt, S, M)
    bg_tiles, bg_w, far, bg_valid = tr._exit_slots(tscene, ot, dt, 1)
    z_bg, d_bg = tr.inverse_z_vals(far, Sb)
    args = [jnp.asarray(a.numpy()) for a in (z, dists, valid, bg_tiles, bg_w, z_bg, d_bg,
                                              bg_valid)]
    rgb_fg, depth_fg, T_left, rgb_bg, depth_bg, valid = _j_render_staged(
        jscene, jnp.asarray(o), jnp.asarray(d), *args, False)
    return {"rgb": jnp.clip(rgb_fg + T_left[:, None] * rgb_bg, 0.0, 1.0),
            "depth": (depth_fg + T_left * depth_bg)[:, None], "T_left": T_left,
            "fore_valid": valid}


@pytest.fixture(scope="module")
def exports(tmp_path_factory):
    """One JAX state with random tables, decoder and ``se3_refine``
    exported by each package in the windowed layout -> (JAX export dir,
    port export dir)."""
    root = tmp_path_factory.mktemp("exports")
    jstate = _jax_state(True, seed=9)
    port = convert.train_state(jstate, device="cpu")
    rng = np.random.RandomState(10)
    ks = np.tile(np.array([[6.0, 0, 4.0], [0, 6.0, 4.0], [0, 0, 1]], np.float32), (N_CAM, 1, 1))
    c2ws = rng.randn(N_CAM, 3, 4).astype(np.float32)
    c2ws[:, :, :3] = np.eye(3)
    noise = (rng.randn(N_CAM, 6) * 0.01).astype(np.float32)
    jcams = jcam.make_cameras(jnp.asarray(ks), jnp.asarray(c2ws), noise_se3=jnp.asarray(noise))
    tcams = tcam.make_cameras(torch.from_numpy(ks), torch.from_numpy(c2ws),
                              noise_se3=torch.from_numpy(noise))
    jdir, tdir = str(root / "jax" / "tile-0"), str(root / "port" / "tile-0")
    jckpt.export_tile(jdir, jstate, jcams, [0, 1, 2], hash_layout="windowed")
    tckpt.export_tile(tdir, port, tcams, [0, 1, 2], hash_layout="windowed")
    with pytest.raises(ValueError, match="layout"):
        tckpt.export_tile(str(root / "bad"), port, tcams, [0, 1, 2], hash_layout="prime")
    return jdir, tdir


def test_export_files_match_jax(exports):
    """The two packages' exports of one state agree: tables (fp16),
    occupancy, bbox, resolutions, layout, packed decoder, intrinsics and
    view ids exactly, the refined camera-to-world poses within 1e-6 (the
    exp map and inverse in f32, in another order)."""
    jdir, tdir = exports
    for name in ("feature.npz", "decoder.npz", "cams.npz"):
        a, b = _npz(os.path.join(jdir, name)), _npz(os.path.join(tdir, name))
        assert a.keys() == b.keys(), name
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, (name, k)
            if k == "c2ws":
                np.testing.assert_allclose(b[k], a[k], atol=1e-6, rtol=0, err_msg=name)
            else:
                np.testing.assert_array_equal(b[k], a[k], err_msg=f"{name} {k}")
    assert str(tckpt.load_tile_export(tdir)["hash_layout"]) == "windowed"


def test_exports_render_in_the_other_package(exports):
    """The JAX renderer on the port's export and the port's renderer on
    the JAX export render the same rays within tests/test_torch_render.py's
    tolerances (its rays too: origins about the tile's centre, random
    directions), and the render is not empty."""
    jdir, tdir = exports
    rng = np.random.RandomState(11)
    o = (rng.randn(24, 3) * 0.3).astype(np.float32)
    d = rng.randn(24, 3).astype(np.float32)
    tscene = tr.load_scene([jdir], device="cpu")
    ref = _jax_render_rays(jr.load_scene([tdir]), tscene, o, d, 12, 6, 32)
    out = tr.render_rays(tscene, o, d, device="cpu", num_sample=12, num_bg_sample=6,
                         num_march=32)
    assert bool(out["fore_valid"].any())
    np.testing.assert_array_equal(np.asarray(ref["fore_valid"]), out["fore_valid"].numpy())
    assert_render_close(ref, out)
