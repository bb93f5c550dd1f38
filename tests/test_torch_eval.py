"""Parity of the port's evaluation and math leaves (scanerf_tpu_torch,
slice 7) with the JAX package on the CPU: PSNR and SSIM, the Lie leaves
(log maps, quaternions, NDC, rotation distance, Procrustes with the
Kabsch reflection fix), the Procrustes-aligned pose error, the decoder's
sigma-only path, positional encodings and general MLP (params carried
across), and the ray helpers. Same numpy inputs on both sides; the JAX
references run under ``jax.jit`` (one small compile each); each
tolerance is stated where it is used.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scanerf_tpu.data import synthetic as jsyn
from scanerf_tpu.models import decoder as jdec
from scanerf_tpu.train import cameras as jcam
from scanerf_tpu.utils import lie as jlie
from scanerf_tpu.utils import metrics as jmetrics
from scanerf_tpu.utils import rays as jrays
from scanerf_tpu_torch.models import decoder as tdec
from scanerf_tpu_torch.train import cameras as tcam
from scanerf_tpu_torch.utils import lie as tlie
from scanerf_tpu_torch.utils import metrics as tmetrics
from scanerf_tpu_torch.utils import rays as trays


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread while these tests run (the suite runs on
    several workers at once), and the worker's setting back after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(jax_val, torch_val, atol, rtol=0.0, msg=""):
    np.testing.assert_allclose(np.asarray(jax_val), torch_val.detach().numpy(), atol=atol,
                               rtol=rtol, err_msg=msg)


@functools.lru_cache(maxsize=None)
def _jit(fn, **static):
    return jax.jit(functools.partial(fn, **static))


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(16, 16, 3), (23, 19, 3)])
def test_psnr_ssim_match_jax(shape):
    """PSNR and SSIM of a prediction that overshoots [0, 1] within 1e-5
    of JAX's (f32 sums in another order; SSIM's convolution)."""
    rng = np.random.RandomState(shape[0])
    gt = rng.rand(*shape).astype(np.float32)
    pred = (gt + rng.randn(*shape) * 0.3).astype(np.float32)
    for name in ("psnr", "ssim"):
        want = _jit(getattr(jmetrics, name))(jnp.asarray(pred), jnp.asarray(gt))
        got = getattr(tmetrics, name)(_t(pred), _t(gt))
        _close(want, got, 1e-5, rtol=1e-5, msg=name)


def test_metrics_bounded_and_identity():
    """Mirrors tests/test_extras.py::test_ssim_bounded_and_identity and
    tests/test_checkpoint_render.py::test_metrics on the port."""
    rng = np.random.RandomState(0)
    gt = _t(rng.rand(32, 32, 3).astype(np.float32))
    wild = gt + _t(rng.randn(32, 32, 3).astype(np.float32)) * 5.0
    assert -1.0 <= float(tmetrics.ssim(wild, gt)) <= 1.0
    assert float(tmetrics.ssim(gt, gt)) > 0.999
    assert abs(float(tmetrics.psnr(wild, gt)) - float(tmetrics.psnr(wild.clamp(0, 1), gt))) < 1e-4
    assert float(tmetrics.psnr(gt, gt)) > 60
    noisy = (gt + 0.1).clamp(0, 1)
    assert float(tmetrics.psnr(gt, noisy)) < 25 and float(tmetrics.ssim(gt, noisy)) < 1.0


# ---------------------------------------------------------------------------
# Lie leaves
# ---------------------------------------------------------------------------

def _rotations(rng, n, scale=0.7):
    w = (rng.randn(n, 3) * scale).astype(np.float32)
    return np.asarray(_jit(jlie.so3_to_SO3)(jnp.asarray(w))), w


@pytest.mark.parametrize("name", ["taylor", "SO3_to_so3", "SE3_to_se3", "quaternions",
                                  "convert_ndc", "rotation_distance"])
def test_lie_leaves_match_jax(name):
    """Each leaf on the same inputs as JAX's, within 1e-5 (f32 ops in
    another order), and its closed-form property (tests/test_lie.py,
    tests/test_extras.py:14-40) on the port."""
    rng = np.random.RandomState(7)
    if name == "taylor":
        x = np.linspace(0.0, 3.1, 50).astype(np.float32)
        for f, ref in (("taylor_A", np.sinc(x / np.pi)),
                       ("taylor_B", np.where(x > 1e-4, (1 - np.cos(x)) / np.maximum(x, 1e-8) ** 2,
                                             0.5)),
                       ("taylor_C", np.where(x > 1e-4, (x - np.sin(x)) / np.maximum(x, 1e-8) ** 3,
                                             1 / 6))):
            got = getattr(tlie, f)(_t(x))
            _close(_jit(getattr(jlie, f))(jnp.asarray(x)), got, 1e-6, msg=f)
            np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, err_msg=f)
    elif name == "SO3_to_so3":
        R, w = _rotations(rng, 16)
        got = tlie.SO3_to_so3(_t(R))
        _close(_jit(jlie.SO3_to_so3)(jnp.asarray(R)), got, 1e-5)
        np.testing.assert_allclose(got.numpy(), w, atol=1e-4)  # log of exp
    elif name == "SE3_to_se3":
        wu = (rng.randn(16, 6) * 0.5).astype(np.float32)
        Rt = tlie.se3_to_SE3(_t(wu))
        got = tlie.SE3_to_se3(Rt)
        _close(_jit(jlie.SE3_to_se3)(jnp.asarray(Rt.numpy())), got, 1e-5)
        np.testing.assert_allclose(got.numpy(), wu, atol=1e-4)
    elif name == "quaternions":
        R, _ = _rotations(rng, 8, 0.6)
        q = tlie.R_to_q(_t(R))
        _close(_jit(jlie.R_to_q)(jnp.asarray(R)), q, 1e-6)
        _close(_jit(jlie.q_to_R)(jnp.asarray(q.numpy())), tlie.q_to_R(q), 1e-6)
        np.testing.assert_allclose(tlie.q_to_R(q).numpy(), R, atol=1e-4)
        q2 = _t((rng.randn(8, 4)).astype(np.float32))
        _close(_jit(jlie.q_product)(jnp.asarray(q.numpy()), jnp.asarray(q2.numpy())),
               tlie.q_product(q, q2), 1e-5)
        _close(_jit(jlie.q_invert)(jnp.asarray(q2.numpy())), tlie.q_invert(q2), 1e-6)
        np.testing.assert_allclose(tlie.q_product(q, tlie.q_invert(q)).numpy(),
                                   np.tile([1.0, 0, 0, 0], (8, 1)), atol=1e-4)
    elif name == "convert_ndc":
        K = np.array([[100.0, 0, 50], [0, 90.0, 40], [0, 0, 1]], np.float32)
        center = (rng.randn(12, 3) * 0.3 + [0, 0, 0.5]).astype(np.float32)
        ray = (rng.randn(12, 3) * 0.2 + [0, 0, 1.0]).astype(np.float32)
        want = _jit(jlie.convert_ndc, near=1.0)(jnp.asarray(center), jnp.asarray(ray),
                                                jnp.asarray(K))
        got = tlie.convert_ndc(_t(center), _t(ray), _t(K), near=1.0)
        for a, b in zip(want, got):
            _close(a, b, 1e-5, rtol=1e-5)
        np.testing.assert_allclose(got[0][:, 2].numpy(), -1.0, atol=1e-5)  # on the near plane
    else:
        R1, _ = _rotations(rng, 6)
        R2, _ = _rotations(rng, 6)
        _close(_jit(jlie.rotation_distance)(jnp.asarray(R1), jnp.asarray(R2)),
               tlie.rotation_distance(_t(R1), _t(R2)), 1e-5)
        R0 = tlie.so3_to_SO3(torch.zeros(1, 3))
        np.testing.assert_allclose(
            tlie.rotation_distance(R0, tlie.so3_to_SO3(torch.tensor([[0.3, 0.0, 0.0]]))).numpy(),
            [0.3], atol=1e-4)


@pytest.mark.parametrize("case", ["similarity", "reflected", "identity"])
def test_procrustes_matches_jax(case):
    """``procrustes_analysis`` equals JAX's within 1e-5; on a similarity
    it recovers the transform, and on a reflected point set it returns a
    rotation (det +1, the Kabsch fix) that is the best one, as JAX's."""
    rng = np.random.RandomState(9)
    X0 = rng.randn(30, 3).astype(np.float32)
    if case == "identity":
        X1 = X0
    else:
        R = np.asarray(_jit(jlie.so3_to_SO3)(jnp.asarray([0.2, -0.1, 0.4], jnp.float32)))
        X1 = (2.0 * X0 @ R.T + [1.0, -2.0, 0.5]).astype(np.float32)
        if case == "reflected":
            X1 = (X1 * [1.0, 1.0, -1.0]).astype(np.float32)
    want = _jit(jlie.procrustes_analysis)(jnp.asarray(X0), jnp.asarray(X1))
    got = tlie.procrustes_analysis(_t(X0), _t(X1))
    for k in ("t0", "t1", "s0", "s1", "R"):
        _close(want[k], got[k], 1e-5, rtol=1e-5, msg=k)
    np.testing.assert_allclose(torch.linalg.det(got["R"]).item(), 1.0, atol=1e-5)
    X1to0 = (_t(X1) - got["t1"]) / got["s1"] @ got["R"].T * got["s0"] + got["t0"]
    if case == "reflected":  # no rotation maps a mirror image back: a residual stays
        assert float((X1to0 - _t(X0)).norm()) > 1.0
    else:
        np.testing.assert_allclose(X1to0.numpy(), X0, atol=1e-4)


@pytest.mark.parametrize("height_variation", [0.3, 0.0], ids=["staggered", "coplanar"])
def test_camera_alignment_matches_jax(height_variation):
    """``prealign_cameras`` within 1e-5 of JAX's and
    ``evaluate_camera_alignment`` of noisy poses within 1e-3 degrees and
    1e-6 of JAX's, and of the port's own float64 evaluation: arccos of
    the trace amplifies its f32 rounding by 1 / (2 sin theta), ~30x at
    this rig's 1-degree camera. Exact recovery reports ~0 error also on a
    coplanar rig (mirrors
    tests/test_lie.py::test_pose_eval_exact_recovery_coplanar_safe)."""
    _, _, ks, c2ws = jsyn.make_sphere_dataset(12, 8, 8, height_variation=height_variation)
    noise = (0.05 * np.random.RandomState(0).randn(12, 6)).astype(np.float32)
    se3 = (0.01 * np.random.RandomState(1).randn(12, 6)).astype(np.float32)
    jc = jcam.make_cameras(jnp.asarray(ks), jnp.asarray(c2ws), noise_se3=jnp.asarray(noise),
                           gt_c2ws=jnp.asarray(c2ws))
    tc = tcam.make_cameras(_t(ks), _t(c2ws), noise_se3=_t(noise), gt_c2ws=_t(c2ws))
    want = _jit(jcam.evaluate_camera_alignment)(jc, jnp.asarray(se3))
    got = tcam.evaluate_camera_alignment(tc, _t(se3))
    f64 = tcam.evaluate_camera_alignment(
        tcam.make_cameras(*(_t(a).double() for a in (ks, c2ws)), noise_se3=_t(noise).double(),
                          gt_c2ws=_t(c2ws).double()), _t(se3).double())
    for ref in (np.asarray(want[0]), f64[0].numpy()):
        np.testing.assert_allclose(got[0].numpy(), ref, atol=1e-3, err_msg="rotation error")
    for ref in (np.asarray(want[1]), f64[1].numpy()):
        np.testing.assert_allclose(got[1].numpy(), ref, atol=1e-6, err_msg="translation error")
    np.testing.assert_allclose(np.asarray(want[0]), f64[0].numpy(), atol=1e-3)
    rts = tcam.get_rts(tc, _t(se3))
    aligned = tcam.prealign_cameras(rts, tc.gt_rts)[0]
    _close(_jit(jcam.prealign_cameras)(jnp.asarray(rts.numpy()), jc.gt_rts)[0], aligned, 1e-5)
    corr = tlie.compose([tlie.invert(_t(c2ws)), tlie.invert(tc.rts)])
    r, t = tcam.evaluate_camera_alignment(tc, tlie.SE3_to_se3(corr))
    assert float(r) < 0.1 and float(t) < 1e-3
    assert float(tcam.evaluate_camera_alignment(tc, torch.zeros(12, 6))[0]) > 1.0


# ---------------------------------------------------------------------------
# decoder leaves, params carried across
# ---------------------------------------------------------------------------

def _decoder_params(rng):
    return {n: {"w": (rng.randn(*tdec.SHAPES[n]) * 0.3).astype(np.float32),
                "b": (rng.randn(tdec.SHAPES[n][1]) * 0.1).astype(np.float32)}
            for n in tdec.PACK_ORDER}


@pytest.mark.parametrize("name", ["inference_sigma", "positional_encoding",
                                  "weighted_positional_encoding", "general_mlp"])
def test_decoder_leaves_match_jax(name):
    """Each leaf on the same inputs and params as JAX's, within 1e-5 (f32
    products in another order)."""
    rng = np.random.RandomState(11)
    if name == "inference_sigma":
        p = _decoder_params(rng)
        feats = (rng.randn(40, 32) * 0.5).astype(np.float32)
        jp = jax.tree_util.tree_map(jnp.asarray, p)
        tp = {n: {k: _t(v) for k, v in d.items()} for n, d in p.items()}
        _close(_jit(jdec.inference_sigma)(jp, jnp.asarray(feats)),
               tdec.inference_sigma(tp, _t(feats)), 1e-5, rtol=1e-5)
    elif name == "positional_encoding":
        x = rng.randn(9, 3).astype(np.float32)
        got = tdec.positional_encoding(_t(x), 4)
        _close(_jit(jdec.positional_encoding, L=4)(jnp.asarray(x)), got, 1e-5)
        assert got.shape == (9, 3 + 4 * 2 * 3)
        np.testing.assert_allclose(got[:, 3:6].numpy(), np.sin(x), atol=1e-6)
    elif name == "weighted_positional_encoding":
        x = rng.randn(5, 2).astype(np.float32)
        for step in (0.0, 37.0, 61.5, 100.0):
            want = _jit(jdec.weighted_positional_encoding, L=3, start=0.0, end=100.0)(
                jnp.asarray(x), global_step=jnp.asarray(step))
            _close(want, tdec.weighted_positional_encoding(_t(x), 3, step, 0.0, 100.0), 1e-5,
                   msg=str(step))
        np.testing.assert_allclose(
            tdec.weighted_positional_encoding(_t(x), 3, 0.0, 0.0, 100.0)[:, 2:].numpy(), 0.0)
    else:
        gen = torch.Generator().manual_seed(0)
        for depth, width in ((3, 16), (1, 64), (4, 8)):
            layers = tdec.init_general_mlp(gen, 8, 3, hidden_depth=depth, hidden_width=width)
            assert len(layers) == depth
            fan_in = [8] + [width] * (depth - 1)
            for lay, f in zip(layers, fan_in):  # torch.nn.Linear's default bound
                assert float(lay["w"].abs().max()) <= 1 / np.sqrt(f)
            x = rng.randn(5, 8).astype(np.float32)
            jl = [{k: jnp.asarray(v.numpy()) for k, v in lay.items()} for lay in layers]
            for output_act in (False, True):
                _close(_jit(jdec.apply_general_mlp, output_act=output_act)(jl, jnp.asarray(x)),
                       tdec.apply_general_mlp(layers, _t(x), output_act=output_act), 1e-5,
                       rtol=1e-5)


# ---------------------------------------------------------------------------
# rays
# ---------------------------------------------------------------------------

def test_get_all_rays_and_intrinsics_match_jax():
    """``make_intrinsics`` equal, ``get_all_rays`` within 1e-5 of JAX's
    (the inverse of K and the matrix products in another order)."""
    rng = np.random.RandomState(5)
    K = trays.make_intrinsics(50.0, 48.0, 16.5, 12.0)
    np.testing.assert_array_equal(K.numpy(), np.asarray(jrays.make_intrinsics(50.0, 48.0,
                                                                              16.5, 12.0)))
    pose = np.asarray(_jit(jlie.se3_to_SE3)(jnp.asarray(rng.randn(6) * 0.4, jnp.float32)))
    want = _jit(jrays.get_all_rays, H=7, W=9)(pose_w2c=jnp.asarray(pose),
                                              K=jnp.asarray(K.numpy()))
    got = trays.get_all_rays(7, 9, _t(pose), K)
    for a, b in zip(want, got):
        assert b.shape == (63, 3)
        _close(a, b, 1e-5, rtol=1e-5)
    center, ray = trays.get_center_and_ray(torch.tensor([[16.5, 12.0]]),
                                           torch.eye(3, 4), K)  # the principal point
    np.testing.assert_allclose(ray.numpy(), [[0.0, 0.0, 1.0]], atol=1e-6)


def test_patch_ray_indices():
    """Shape, range, and four rays a patch at offsets 0, 1, W, W+1 whose
    corner keeps the patch inside the image; the same generator state
    draws the same patches."""
    H, W, P = 11, 13, 300
    idx = trays.patch_ray_indices(torch.Generator().manual_seed(3), H, W, P)
    assert idx.shape == (4 * P,) and idx.dtype == torch.int64
    assert int(idx.min()) >= 0 and int(idx.max()) < H * W
    quads = idx.reshape(P, 4)
    base = quads[:, 0]
    np.testing.assert_array_equal((quads - base[:, None]).numpy(),
                                  np.tile([0, 1, W, W + 1], (P, 1)))
    assert int((base % W).max()) <= W - 2 and int((base // W).max()) <= H - 2
    assert int((base % W).max()) == W - 2 and int((base // W).min()) == 0  # all columns drawn
    np.testing.assert_array_equal(
        idx.numpy(), trays.patch_ray_indices(torch.Generator().manual_seed(3), H, W, P).numpy())
