"""The proxy mesh and BS background mode of the port (scanerf_tpu_torch/
geometry/mesh_engine.py, ops/sampling.py::background_window_sampling)
held against the JAX package on the CPU, cheapest first: the port's
``ProxyMesh`` against the JAX one on the same PLY (the city's boxes and
ground) in the native tracer and in the numpy plain version -- depth,
first entry, mask, background depth, background samples, voxelization --
then ``background_window_sampling``, and one BS-mode ``compute_grads``
against JAX's ``compute_losses`` under ``jax.value_and_grad`` and jit.
Both packages' native tracers compile the same C++ source with the same
flags, and the numpy versions are the same code, so the mesh queries are
held bit for bit."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scanerf_tpu.data import city as jcity
from scanerf_tpu.data import synthetic as jsyn
from scanerf_tpu.geometry import mesh_engine as jmesh
from scanerf_tpu.ops import sampling as jsampling
from scanerf_tpu.train import cameras as jcam
from scanerf_tpu.train import tile as jtile
from scanerf_tpu_torch import convert
from scanerf_tpu_torch.geometry import mesh_engine as tmesh
from scanerf_tpu_torch.geometry.ply import write_ply
from scanerf_tpu_torch.ops import sampling as tsampling
from scanerf_tpu_torch.train import cameras as tcam
from scanerf_tpu_torch.train import tile as ttile
from test_torch_hash_global import _jax_field


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread while these tests run (the suite runs on
    several workers at once), and the worker's setting back after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def city_ply(tmp_path_factory):
    boxes, _, _ = jcity._city_blocks(2, 2, seed=0)
    path = str(tmp_path_factory.mktemp("mesh") / "mesh.ply")
    write_ply(path, *jcity._city_mesh(boxes))
    return path


def _city_rays(n=600, seed=0):
    """Rays from above and beside the city, many meeting the mesh, some
    starting inside the tile box, some missing it."""
    rng = np.random.RandomState(seed)
    o = np.stack([rng.uniform(-1.5, 3.0, n), rng.uniform(0.3, 2.0, n),
                  rng.uniform(-2.5, 2.0, n)], -1).astype(np.float32)
    d = (rng.randn(n, 3) * 0.5 + [0.0, -0.6, 0.6]).astype(np.float32)
    return o, d


@pytest.mark.parametrize("plain", [False, True])
def test_proxy_mesh_matches_jax(city_ply, plain):
    """Native (g++ at first use) and plain: every query of the port's
    ``ProxyMesh`` equals the JAX one's on 600 rays and the voxelization
    of the first city tile's inner box (64^3 without, 16^3 with the
    outside init)."""
    j = jmesh.ProxyMesh(city_ply, force_numpy=plain)
    t = tmesh.ProxyMesh(city_ply, plain=plain)
    assert (j._handle is None) == plain and (t._handle is None) == plain
    for a, b in zip(j.get_sceneinfo(), t.get_sceneinfo()):
        np.testing.assert_array_equal(a, b)
    o, d = _city_rays()
    center, half = np.array([0.0, 0.0, 0.0], np.float32), np.array([1.0] * 3, np.float32)
    j.set(center, half)
    t.set(center, half)
    np.testing.assert_array_equal(j.render_depth(o, d), t.render_depth(o, d))
    np.testing.assert_array_equal(j.first_enter(o, d), t.first_enter(o, d))
    mask = t.render_mask(o, d)
    np.testing.assert_array_equal(j.render_mask(o, d), mask)
    assert 0 < mask.sum() < len(mask)
    j.set(center, 2 * half)
    t.set(center, 2 * half)
    for a, b in zip(j.compute_bgdepth_batch(o, d), t.compute_bgdepth_batch(o, d)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(j.background_sampling(o, d, 8, 0.4), t.background_sampling(o, d, 8, 0.4)):
        np.testing.assert_array_equal(a, b)
    for log2, outside in ((6, False), (4, True)):
        args = (np.array([log2] * 3), np.array([-1.0] * 3), np.array([2.0] * 3), outside)
        for a, b in zip(j.voxelize(*args), t.voxelize(*args)):
            np.testing.assert_array_equal(a, b)
    occ, _ = t.voxelize(np.array([6] * 3), np.array([-1.0] * 3), np.array([2.0] * 3))
    assert 0 < occ.mean() < 0.5


def test_voxelize_mesh_and_failed_build_raises(city_ply, monkeypatch, tmp_path):
    """``voxelize_mesh`` equals the JAX function (an empty path gives an
    all-occupied grid), and a tracer that does not compile raises instead
    of falling back to numpy."""
    args = (np.array([5, 4, 5]), np.array([0.6, -1.0, -1.0]), np.array([2.0] * 3))
    for path in (city_ply, ""):
        for a, b in zip(jmesh.voxelize_mesh(*args, path), tmesh.voxelize_mesh(*args, path)):
            np.testing.assert_array_equal(a, b)
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tmesh, "_SRC", str(bad))
    monkeypatch.setattr(tmesh, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        tmesh.ProxyMesh(city_ply)


def test_background_window_sampling_matches_jax():
    """``background_window_sampling`` of 200 rays (a quarter without a
    mesh depth, some missing the box) equals the JAX function op by op:
    z, dists and valid bit for bit."""
    rng = np.random.RandomState(1)
    o = (rng.randn(200, 3) * 0.5 + [0.0, 0.3, -3.0]).astype(np.float32)
    d = (rng.randn(200, 3) * 0.4 + [0.0, 0.0, 1.0]).astype(np.float32)
    bgd = np.where(rng.rand(200) < 0.75, rng.uniform(3.0, 9.0, 200), 0.0).astype(np.float32)
    c, s = np.array([0.1, 0.0, 0.2], np.float32), np.array([4.0, 4.0, 4.0], np.float32)
    rng_ = jnp.max(jnp.asarray(s)) / 10.0
    ref = jsampling.background_window_sampling(jnp.asarray(o), jnp.asarray(d), jnp.asarray(bgd),
                                               jnp.asarray(c), jnp.asarray(s), 16, rng_)
    out = tsampling.background_window_sampling(
        torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(bgd), torch.from_numpy(c),
        torch.from_numpy(s), 16, torch.from_numpy(s).max() / 10.0)
    assert 0 < int(out[2].sum()) < 200
    for a, b in zip(ref, out):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_bs_mode_compute_grads_matches_jax(tmp_path):
    """BG_MODE "BS" on a 2^10-entry tile of the sphere scene, background
    depths from the port's ``ProxyMesh`` over the scene's own mesh (one
    camera's set to 0: no background), rgb and ADMM rho 100 at step 3000:
    ``compute_grads`` against JAX's ``compute_losses`` (hash_backend
    "xla"), losses within 5e-4 relative and gradients within 2e-3
    relative L2 per leaf, as tests/test_torch_hash_global.py holds the
    IZ mode; the BS samples do change the loss."""
    n_cam, Hi, Wi = 3, 24, 24
    jsyn.write_scene_dir(str(tmp_path), n_cameras=n_cam, H=Hi, W=Wi)
    imgs, depths, ks, c2ws = jsyn.make_sphere_dataset(n_cam, Hi, Wi)
    mesh = tmesh.ProxyMesh(os.path.join(tmp_path, "mesh", "mesh.ply"))
    mesh.set(np.zeros(3, np.float32), np.full(3, 2.0, np.float32))  # the doubled box
    cams = tcam.make_cameras(torch.from_numpy(ks), torch.from_numpy(c2ws))
    from scanerf_tpu_torch.utils.rays import get_all_rays

    bg = np.zeros((n_cam, Hi, Wi), np.float32)
    for i in range(n_cam):
        o, d = get_all_rays(Hi, Wi, cams.rts[i], cams.ks[i])
        z, has, _ = mesh.compute_bgdepth_batch(o.numpy(), d.numpy())
        bg[i] = np.where(has, z, 0.0).reshape(Hi, Wi)
    bg[2] = 0.0
    assert (bg[:2] > 0).mean() > 0.3
    kw = dict(num_sample=16, num_bg_sample=8, batch_log2=7, num_march=64, rho=100.0,
              bg_mode="BS")
    jtc = jtile.TrainConfig(hash_backend="xla", **kw)
    jp, js = _jax_field(seed=6)
    rng = np.random.RandomState(7)
    st = jtile.create_train_state(jp, js, n_cam, jtc)
    st = st.replace(
        step=jnp.asarray(3000, jnp.int32),
        params=st.params.replace(se3_refine=jnp.asarray(rng.randn(n_cam, 6) * 0.01,
                                                        jnp.float32)),
        admm=st.admm.replace(shared_se3=jnp.asarray(rng.randn(n_cam, 6) * 0.01, jnp.float32),
                             overlap_flags=jnp.asarray([True, True, False])))
    num_patch = (2**jtc.batch_log2) // n_cam // 4
    px, py = rng.permutation(Wi - 2)[:num_patch], rng.permutation(Hi - 2)[:num_patch]
    ray_idx = ((py * Wi + px)[:, None] + np.array([0, 1, Wi, Wi + 1])[None]).reshape(-1)
    locs = np.broadcast_to(np.stack([ray_idx % Wi, ray_idx // Wi], -1)[None],
                           (n_cam, ray_idx.size, 2)).copy()
    occl = np.ones((n_cam, Hi, Wi), bool)
    zeros_n = np.zeros((n_cam, Hi, Wi, 3), np.float32)

    def jdata(bg_depths):
        return jtile.TileData(images=jnp.asarray(imgs), occlusions=jnp.asarray(occl),
                              cameras=jcam.make_cameras(jnp.asarray(ks), jnp.asarray(c2ws)),
                              mono_depths=jnp.asarray(depths),
                              mono_normals=jnp.asarray(zeros_n), bg_depths=bg_depths)

    @jax.jit
    def jgrads(state, d, ri, pl):
        return jax.value_and_grad(
            lambda p: jtile.compute_losses(p, state.field_state, state.admm, d, ri, pl,
                                           state.step, jtc), has_aux=True)(state.params)

    ri, pl = jnp.asarray(ray_idx, jnp.int32), jnp.asarray(locs, jnp.int32)
    (_, jaux), jg = jgrads(st, jdata(jnp.asarray(bg)), ri, pl)
    port = convert.train_state(st, device="cpu")
    tdata = ttile.TileData(images=torch.from_numpy(imgs), occlusions=torch.from_numpy(occl),
                           cameras=cams, mono_depths=torch.from_numpy(depths),
                           mono_normals=torch.from_numpy(zeros_n),
                           bg_depths=torch.from_numpy(bg))
    (_, taux), tg = ttile.compute_grads(port, tdata, ttile.TrainConfig(**kw),
                                        ray_idx=torch.from_numpy(ray_idx),
                                        pixel_locs=torch.from_numpy(locs))
    for k in ("total_loss", "rgb_loss", "admm_loss"):
        np.testing.assert_allclose(float(jaux[k]), float(taux[k]), rtol=5e-4, err_msg=k)
    jleaves = ttile.group_leaves(jg)
    for name, leaves in tg.items():
        for i, (a, b) in enumerate(zip(jleaves[name], leaves)):
            a = np.asarray(a)
            err = np.linalg.norm(a - b.numpy()) / np.linalg.norm(a)
            assert err < 2e-3, (name, i, err)
    tdata.bg_depths = None  # IZ samples instead
    (_, iz), _ = ttile.compute_grads(port, tdata, ttile.TrainConfig(**kw),
                                     ray_idx=torch.from_numpy(ray_idx),
                                     pixel_locs=torch.from_numpy(locs))
    assert abs(float(iz["rgb_loss"]) - float(taux["rgb_loss"])) > 1e-4
