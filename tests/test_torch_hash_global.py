"""The global prime-XOR hash of the port (scanerf_tpu_torch/ops/
hash_encode.py, the ``xla`` backend of tables under 2^14 entries) held
against the JAX package on the CPU, cheapest first: ``hash_index`` bit
for bit, ``hash_encode`` and its gradients against ``jax.grad``,
and ``render_rays`` of a 2^10-entry field against the JAX render (a
step of such a tile is held in tests/test_torch_mesh.py, in BS mode).
The JAX references run under ``jax.jit``. Grids are fully occupied: the
global hash is continuous in the sample positions, so the ulps by which
jit and the port differ in z stay ulps (a partly occupied grid moves a
sample on a CDF tie by a whole march segment; tests/test_torch_train.py
states that case)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scanerf_tpu.models import field as jfield
from scanerf_tpu.ops import hash_encode as jhe
from scanerf_tpu_torch import convert
from scanerf_tpu_torch.models import field as tfield
from scanerf_tpu_torch.ops import hash_encode as the

TOL = dict(pred_color=2e-5, pred_depth=2e-4, T_left=2e-5)  # tests/test_torch_render.py


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread while these tests run (the suite runs on
    several workers at once), and the worker's setting back after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_hash_index_bit_for_bit():
    """``hash_index`` equals the JAX uint32 hash on coordinates up to
    2^31, where every product wraps, at three table sizes."""
    rng = np.random.RandomState(0)
    loc = np.concatenate([rng.randint(0, 4096, (500, 3)),
                          rng.randint(0, 2**31 - 1, (500, 3))]).astype(np.int64)
    for H in (2**10, 2**14, 2**19):
        ref = np.asarray(jax.jit(jhe.hash_index, static_argnums=1)(
            jnp.asarray(loc, jnp.uint32), H)).astype(np.int64)
        np.testing.assert_array_equal(ref, the.hash_index(torch.from_numpy(loc), H).numpy())


def test_hash_encode_and_gradients_match_jax():
    """``hash_encode`` of 300 points over 16 levels at H = 2^10 with
    anisotropic resolutions: features within 1e-6, and the gradient of a
    random linear functional in points and table within 1e-5 of each
    gradient's largest entry of ``jax.grad`` (sums in other orders: the
    table's index_add of the corner weights; dL/dpoints carries the level
    resolutions, up to 768, so its entries reach ~40)."""
    rng = np.random.RandomState(1)
    L, H = 16, 2**10
    pts = rng.uniform(-2.0, 2.0, (300, 3)).astype(np.float32)
    table = (rng.randn(L, H * 2) * 0.1).astype(np.float32)
    res = jhe.make_level_resolutions(np.array([16, 24, 16]), np.array([512, 768, 512]), L)
    cot = rng.randn(300, L * 2).astype(np.float32)

    @jax.jit
    def jfun(p, t):
        def f(p, t):
            out = jhe.hash_encode(p, t, jnp.asarray(res))
            return jnp.sum(out * cot), out
        return jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(p, t)

    (_, jout), (jgp, jgt) = jfun(jnp.asarray(pts), jnp.asarray(table))
    p = torch.from_numpy(pts).requires_grad_()
    t = torch.from_numpy(table).requires_grad_()
    out = the.hash_encode(p, t, torch.from_numpy(res))
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(np.asarray(jout), out.detach().numpy(), atol=1e-6)
    for ref, got in ((jgp, p.grad), (jgt, t.grad)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(ref, got.numpy(), atol=1e-5 * np.abs(ref).max())


def _jax_field(log2_h=10, seed=0):
    return jfield.create_field(jax.random.PRNGKey(seed), bbox_corner=np.array([-1.0] * 3),
                               bbox_size=np.array([2.0, 2.0, 2.0]),
                               log2_hashmap_size=log2_h, grid_resolution=(16, 256),
                               sampler_log2dim=4)


def port_field(jp, js):
    """The port's (FieldParams, FieldState) on the CPU of a JAX field."""
    return (tfield.FieldParams(features=torch.from_numpy(np.array(jp.features)),
                               decoder=convert.decoder_params(jp.decoder, device="cpu")),
            tfield.FieldState(**{k: torch.from_numpy(np.array(getattr(js, k))) for k in
                                 ("resolutions", "min_bbox", "bbox_size", "occupied_grid")}))


def rays(seed, n=48):
    rng = np.random.RandomState(seed)
    o = (rng.randn(n, 3) * 0.3 + [0.0, 0.4, -2.5]).astype(np.float32)
    d = (rng.randn(n, 3) * 0.25 + [0.0, -0.15, 1.0]).astype(np.float32)
    return o, d


@pytest.mark.parametrize("train", [True, False])
def test_render_rays_global_hash_matches_jax(train):
    """``render_rays`` of a 2^10-entry field (the port's default backend
    "windowed" resolves to the global hash) against the JAX render with
    backend "xla", 48 rays with a 20% occlusion mask, at step 2500 (BARF
    with 10 levels on), at tests/test_torch_render.py's tolerances; in
    training mode also the specular regularizer (1e-6 relative)."""
    jp, js = _jax_field()
    tp, ts = port_field(jp, js)
    o, d = rays(2)
    occl = np.random.RandomState(3).rand(48) < 0.8
    kw = dict(occlusion_mask=occl, train=train, num_march=64)
    ref = jax.jit(lambda p, s, o, d: jfield.render_rays(
        p, s, o, d, 16, 8, jnp.float32(2500.0), backend="xla", **kw))(
        jp, js, jnp.asarray(o), jnp.asarray(d))
    assert tfield.effective_backend("windowed", 2**10) == "xla"
    out = tfield.render_rays(tp, ts, torch.from_numpy(o), torch.from_numpy(d), 16, 8,
                             torch.tensor(2500.0), **{**kw, "occlusion_mask":
                                                      torch.from_numpy(occl)})
    for k, tol in TOL.items():
        np.testing.assert_allclose(np.asarray(ref[k]), out[k].numpy(), atol=tol, err_msg=k)
    np.testing.assert_array_equal(np.asarray(ref["fore_valid"]), out["fore_valid"].numpy())
    if train:
        np.testing.assert_allclose(float(ref["l2_reg_specular"]),
                                   float(out["l2_reg_specular"]), rtol=1e-6)
