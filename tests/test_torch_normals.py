"""Surface normals of the port (``models/field.py::compute_normal`` and
``render_normals``) against the JAX package on the CPU, in both table
layouts (H = 2^10, the xla backend's global hash; H = 2^14, the windowed
hash), cheapest first; and the windowed lookup's backward on a table that
needs no gradient, which must compute none.

``compute_normal`` is fed identical points. ``render_normals`` is held
against the JAX function's own steps: its sampler op by op (as
tests/test_torch_hash_global.py holds the XLA sampler), then
``compute_normal`` and the compositing under ``jax.jit``. Jitted as a
whole, the JAX ``render_normals`` places its samples with fused
multiply-adds (o + z * d), an ulp off the port's and off its own op-by-op
samples, and a sample an ulp from a lattice plane changes cell, where the
density's gradient jumps: on these rays up to 0.018 apart on a few
entries. Grids are fully occupied, tables N(0, 0.1), at step 20000 (every
BARF level on)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scanerf_tpu.models import field as jfield
from scanerf_tpu.ops import integrate as jint
from scanerf_tpu.ops import sampling as jsamp
from scanerf_tpu_torch.models import field as tfield
from scanerf_tpu_torch.ops.hash_encode import make_level_resolutions
from scanerf_tpu_torch.ops.kernels import hash_encode as thw

STEP = 20000.0
N_RAYS, N_SAMPLE, N_MARCH = 32, 32, 64
LAYOUTS = [(10, "xla"), (14, "windowed")]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread while these tests run (the suite runs on
    several workers at once), and the worker's setting back after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fields(log2_h):
    """The port's field on the CPU (tables N(0, 0.1) from a seed) and the
    same numbers as the JAX package's FieldParams / FieldState."""
    params, fs = tfield.create_field(torch.Generator().manual_seed(0), [-1.0] * 3,
                                     [2.0] * 3, log2_hashmap_size=log2_h,
                                     grid_resolution=(16, 256), sampler_log2dim=3,
                                     device="cpu")
    feats = (np.random.RandomState(1).randn(*params.features.shape) * 0.1).astype(np.float32)
    params = tfield.FieldParams(features=torch.from_numpy(feats), decoder=params.decoder)
    jp = jfield.FieldParams(
        features=jnp.asarray(feats),
        decoder={n: {k: jnp.asarray(v.numpy()) for k, v in d.items()}
                 for n, d in params.decoder.items()})
    js = jfield.FieldState(**{k: jnp.asarray(getattr(fs, k).numpy()) for k in
                              ("resolutions", "min_bbox", "bbox_size", "occupied_grid")})
    return params, fs, jp, js


def _table(log2_h):
    rng = np.random.RandomState(5)
    table = torch.from_numpy((rng.randn(16, 2**log2_h * 2) * 0.1).astype(np.float32))
    res = torch.from_numpy(make_level_resolutions(
        np.array([16] * 3), np.array([512] * 3), 16))
    return table, res


def _rays(seed=2):
    rng = np.random.RandomState(seed)
    o = (rng.uniform(-0.3, 0.3, (N_RAYS, 3)) + [0.0, 0.0, -3.0]).astype(np.float32)
    d = (rng.randn(N_RAYS, 3) * 0.2 + [0.0, 0.0, 1.0]).astype(np.float32)
    return o, d


def test_table_that_needs_no_gradient_gets_none_on_cpu(monkeypatch):
    """``hash_encode_windowed`` through the stream (B2, B3 and B4's plain
    versions on the CPU): with a table that does not require grad, the
    backward calls the plain B4 in its "du" mode, once, and the points'
    gradient equals the one taken with the table's gradient; with one
    that does, the exact mode."""
    table, res = _table(14)
    modes = []
    plain = thw.lookup_bwd_plain

    def spy(*a, **kw):
        modes.append(a[5] if len(a) > 5 else kw.get("mode", "exact"))
        return plain(*a, **kw)

    monkeypatch.setattr(thw, "lookup_bwd_plain", spy)
    x0 = torch.from_numpy(np.random.RandomState(3).uniform(-1.9, 1.9, (300, 3))
                          .astype(np.float32))
    grads = []
    for needs in (False, True):
        x = x0.clone().requires_grad_()
        t = table.clone().requires_grad_(needs)
        (thw.hash_encode_windowed(x, t, res) ** 2).sum().backward()
        assert (t.grad is None) == (not needs)
        grads.append(x.grad)
    assert modes == ["du", "exact"]
    assert torch.equal(grads[0], grads[1])


@pytest.mark.parametrize("log2_h,backend", LAYOUTS, ids=["xla", "windowed"])
def test_compute_normal_matches_jax(log2_h, backend):
    """500 points inside the tile: normals within 1e-5 and sigma within
    1e-6 of the largest entry of the JAX ``vmap(value_and_grad)`` (the
    same density; its gradient summed in another order), and unit
    length."""
    params, fs, jp, js = _fields(log2_h)
    pts = np.random.RandomState(3).uniform(-0.9, 0.9, (500, 3)).astype(np.float32)
    jn, jsig = jax.jit(lambda p, x: jfield.compute_normal(
        p, js, x, jnp.float32(STEP), backend=backend))(jp, jnp.asarray(pts))
    tn, tsig = tfield.compute_normal(params, fs, torch.from_numpy(pts), torch.tensor(STEP),
                                     backend=backend)
    assert tn.shape == (500, 3) and tsig.shape == (500, 1)
    assert not tn.requires_grad and not tsig.requires_grad
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=0, atol=1e-5)
    jsig = np.asarray(jsig)
    np.testing.assert_allclose(tsig.numpy(), jsig, rtol=0, atol=1e-6 * np.abs(jsig).max())
    np.testing.assert_allclose(np.linalg.norm(tn.numpy(), axis=-1), 1.0, atol=1e-5)


@pytest.mark.parametrize("log2_h,backend", LAYOUTS, ids=["xla", "windowed"])
def test_render_normals_matches_jax(log2_h, backend):
    """32 rays at 32 samples (M 64), some missing the tile: the
    port's ``render_normals`` within 1e-6 of the JAX function's steps (its
    sampler op by op, the rest under jit), in [0, 1], not constant, and
    0.5 on the rays that miss."""
    params, fs, jp, js = _fields(log2_h)
    o, d = _rays()
    z, dist, valid = (np.asarray(a) for a in jsamp.sample_points_grid(
        jnp.asarray(o), jnp.asarray(d), N_SAMPLE, js.occupied_grid, jfield.inner_corner(js),
        jfield.inner_size(js), num_march=N_MARCH))
    zm = np.where(valid[:, None], z, 0.0).astype(np.float32)
    dm = np.where(valid[:, None], dist, 0.0).astype(np.float32)
    samples = (o[:, None, :] + zm[..., None] * d[:, None, :]).astype(np.float32)

    @jax.jit
    def rest(p, samples, dm, valid, d):  # field.py's render_normals after its sampler
        n, sig = jfield.compute_normal(p, js, samples, jnp.float32(STEP), backend=backend)
        w, _ = jint.integrate_weights(sig[..., 0], dm, d, infinity=False)
        w = jnp.where(valid[:, None], w, 0.0)
        return (jint.accumulate(w, jax.lax.stop_gradient(n)) + 1.0) / 2.0

    ref = np.asarray(rest(jp, samples, dm, valid, d))
    got = tfield.render_normals(params, fs, torch.from_numpy(o), torch.from_numpy(d),
                                N_SAMPLE, torch.tensor(STEP), num_march=N_MARCH,
                                backend=backend).numpy()
    assert got.shape == (N_RAYS, 3) and 0 < int(valid.sum()) < N_RAYS
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    assert got.min() >= 0.0 and got.max() <= 1.0 and got.std() > 0.01
    np.testing.assert_allclose(got[~valid], 0.5)
