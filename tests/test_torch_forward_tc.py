"""The decoder forward of the port's B5 and B7 kernels (scanerf_tpu_torch)
as they compute it, held against the JAX package on the CPU, and the
conversion of a JAX training state without camera optimisation.

B5 and B7 run the decoder over warp tiles of 16 rows: the four large
layers (spatial0, spatial1, dir0, dir1) on the tensor cores as three TF32
products of the split x = hi + lo (3xTF32: hi rounded to nearest, lo
truncated as the tensor core reads it, lo*hi + hi*lo + hi*hi summed in
f32), the narrow heads (7 x 32, 3 x 64) on the CUDA cores in f32. A numpy
emulation of that arithmetic on 64 rows, with the port's slab, gives
(b) B5's 8 training columns within 1e-5 of the JAX package's
``_decode_train_chunk`` (under ``jax.jit``), with the step's BARF weights
and with every level on, and (c) B7's 4 outputs within 1e-5 of the JAX
package's ``apply_decoder``. Before them, the cheapest: (a) a JAX
``TrainState`` of the optimizer built with ``cam_enable=False`` (optax's
``set_to_zero`` on the cameras) converts: the hash and decoder Adam
moments and counts equal the JAX ones, and the optimizer has no camera
group.

The 1e-5 bounds 3xTF32's own error (about f32's, see
tests/test_torch_scatter.py (c)) carried through the Gaussian layers,
beside the f32 sums taken in another order. Each test takes well under a
second once JAX has compiled what it calls (the first JAX call of a
process costs a few seconds).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scanerf_tpu.models import decoder as jdec
from scanerf_tpu.models import field as jfield
from scanerf_tpu.ops.pallas import fused_train as jft
from scanerf_tpu.train import tile as jtile
from scanerf_tpu_torch import convert
from scanerf_tpu_torch.models.decoder import PACK_ORDER, SHAPES
from scanerf_tpu_torch.ops.kernels import fused_render as tfr
from scanerf_tpu_torch.ops.kernels import fused_train as tft
from scanerf_tpu_torch.train import tile as ttile
from scanerf_tpu_torch.utils.sh import sh_encoding
from test_torch_scatter import _tf32

ROWS = 64  # four warp tiles of the kernels
GAUSS_K = np.float32(-1.0 / (2.0 * 0.1 * 0.1))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread while these tests run (the suite runs on
    several workers at once), and the worker's setting back after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tc3(x, w):
    """x [rows, in] @ w[out, in].T as the tensor cores take it: 3xTF32,
    the products summed in f32."""
    x_hi, w_hi = _tf32(x), _tf32(w)
    x_lo, w_lo = _tf32(x - x_hi, nearest=False), _tf32(w - w_hi, nearest=False)
    return (x_lo @ w_hi.T + x_hi @ w_lo.T) + x_hi @ w_hi.T


def _gauss(z):
    return np.exp(z * z * GAUSS_K).astype(np.float32)


def _sigmoid(z):
    return (1.0 / (1.0 + np.exp(-z))).astype(np.float32)


def _kernel_forward(pslab, feats, dirs):
    """The tile's decoder forward as B5 and B7 compute it, from a port
    slab [PSLAB] -> head pre-activations [rows, 7] and specular ones
    [rows, 3] (f32)."""
    (w0, w1, wh, wd0, wd1, wd2), (b0, b1, bh, bd0, bd1, bd2) = (
        [t.numpy() for t in part] for part in tft._slab_layers(torch.from_numpy(pslab)))
    h0 = _gauss(_tc3(feats, w0) + b0)
    hh = _tc3(h0, w1) + b1
    heads = hh[:, :32] @ wh.T + bh
    d = torch.from_numpy(dirs)
    n = d / (torch.linalg.vector_norm(d, dim=-1, keepdim=True) + 1e-8)
    din = np.concatenate([hh[:, 32:], sh_encoding(3, n).numpy()], axis=1)
    d1 = _gauss(_tc3(din, wd0) + bd0)
    d2 = _gauss(_tc3(d1, wd1) + bd1)
    spec = d2 @ wd2.T + bd2
    return heads.astype(np.float32), spec.astype(np.float32)


def _tile(seed):
    rng = np.random.default_rng(seed)
    feats = (rng.standard_normal((ROWS, 32)) * 0.5).astype(np.float32)
    dirs = rng.standard_normal((ROWS, 3)).astype(np.float32)
    return feats, dirs


def _port_decoder(params):
    return {n: {k: torch.from_numpy(np.array(params[n][k], np.float32)) for k in ("w", "b")}
            for n in PACK_ORDER}


def test_convert_train_state_without_cam():
    """(a) a JAX state of optax's ``cam_enable=False`` optimizer (the
    camera group's state is ``set_to_zero``'s empty one) converts, with
    the hash and decoder groups' Adam moments random and their counts 2:
    the port's moments equal the JAX ones (exact copies), its counts are
    2, and its optimizer has no camera group, as ``build_optimizer``
    builds it then. Built from numpy arrays, with the optimizer state's
    structure from ``jax.eval_shape``, so that nothing is compiled."""
    rng = np.random.default_rng(3)
    L, H, n_cam = 16, 2**10, 2
    params = jtile.TileParams(
        field=jfield.FieldParams(
            features=rng.standard_normal((L, 2 * H)).astype(np.float32),
            decoder={n: {"w": rng.standard_normal(SHAPES[n]).astype(np.float32),
                         "b": rng.standard_normal(SHAPES[n][1]).astype(np.float32)}
                     for n in PACK_ORDER}),
        se3_refine=np.zeros((n_cam, 6), np.float32))
    tx = jtile.build_optimizer(jtile.TrainConfig(cam_enable=False, total_step=40000))

    def fill(a):
        return (np.full(a.shape, 2, a.dtype) if np.issubdtype(a.dtype, np.integer)
                else rng.standard_normal(a.shape).astype(a.dtype))

    opt = jax.tree_util.tree_map(fill, jax.eval_shape(tx.init, params))
    assert len(opt.inner_states["cam"].inner_state) == 0
    st = jtile.TrainState(
        params=params, opt_state=opt,
        field_state=jfield.FieldState(resolutions=np.full((L, 3), 16, np.int32),
                                      min_bbox=-np.ones(3, np.float32),
                                      bbox_size=np.full(3, 2.0, np.float32),
                                      occupied_grid=np.ones((16, 16, 16), bool)),
        admm=jtile.AdmmState(shared_se3=np.zeros((n_cam, 6), np.float32),
                             delta_se3=np.zeros((n_cam, 6), np.float32),
                             overlap_flags=np.zeros(n_cam, bool),
                             rho=np.zeros(6, np.float32)),
        step=np.int32(2))
    port = convert.train_state(st, device="cpu")
    groups = {grp["name"]: grp for grp in port.optimizer.param_groups}
    assert sorted(groups) == ["decoder", "hash"]
    for name in ("hash", "decoder"):
        adam = next(s for s in opt.inner_states[name].inner_state if hasattr(s, "mu"))
        assert groups[name]["count"] == 2
        mu, nu = ttile.group_leaves(adam.mu)[name], ttile.group_leaves(adam.nu)[name]
        assert len(mu) == len(groups[name]["params"])
        for leaf, m, v in zip(groups[name]["params"], mu, nu):
            state = port.optimizer.state[leaf]
            assert int(state["step"]) == 2
            np.testing.assert_array_equal(state["exp_avg"].numpy(), np.asarray(m))
            np.testing.assert_array_equal(state["exp_avg_sq"].numpy(), np.asarray(v))


@functools.lru_cache(maxsize=None)
def _j_decode_train_chunk():
    return jax.jit(jft._decode_train_chunk)


@pytest.mark.parametrize("step", [3000.0, 20000.0], ids=["step_barf", "all_levels"])
def test_b5_forward_tc_matches_jax(step):
    """(b) B5's 8 columns (sigma, diffuse x3, tint * specular x3, mean
    specular^2) from the emulated tile, with the slab of
    ``pack_train_slab`` at the step's BARF weights (3000: levels 0-10 on,
    11 part, 12-15 off) and with every level on, within 1e-5 of the JAX
    ``_decode_train_chunk``."""
    params = jdec.init_decoder(jax.random.PRNGKey(5))
    wf = jfield.weight_feature(jnp.float32(step))
    assert (float(wf.min()) == 1.0) == (step == 20000.0)
    feats, dirs = _tile(int(step))
    want = np.asarray(_j_decode_train_chunk()(jft.pack_train_slab(params, wf), feats.T,
                                              dirs.T)).T
    pslab = tft.pack_train_slab(_port_decoder(params), torch.from_numpy(np.asarray(wf)))
    heads, spec = _kernel_forward(pslab.numpy(), feats, dirs)
    s = _sigmoid(spec)
    cols = np.concatenate([
        torch.nn.functional.softplus(torch.from_numpy(heads[:, :1])).numpy(),
        _sigmoid(heads[:, 1:4]), _sigmoid(heads[:, 4:7]) * s,
        (s * s).sum(axis=1, keepdims=True) / 3.0], axis=1)
    assert cols.shape == want.shape == (ROWS, 8)
    np.testing.assert_allclose(cols, want, rtol=0, atol=1e-5)


def test_b7_forward_tc_matches_jax():
    """(c) B7's 4 outputs (sigma, diffuse + tint * specular) from the
    emulated tile, with the slab of ``pack_decoder_slabs``, within 1e-5
    of the JAX ``apply_decoder`` (no annealing: every level weighs 1)."""
    params = jdec.init_decoder(jax.random.PRNGKey(7))
    feats, dirs = _tile(7)
    out = jdec.apply_decoder(params, jnp.asarray(feats), jnp.asarray(dirs), jnp.ones(32))
    want = np.concatenate([np.asarray(out["sigma"]),
                           np.asarray(out["diffuse"] + out["tint"] * out["specular"])], axis=1)
    stacked = {n: {k: v[None] for k, v in p.items()} for n, p in _port_decoder(params).items()}
    pslab = tfr.pack_decoder_slabs(stacked)[0].numpy()
    heads, spec = _kernel_forward(pslab, feats, dirs)
    sigma = torch.nn.functional.softplus(torch.from_numpy(heads[:, :1])).numpy()
    rgb = _sigmoid(heads[:, 1:4]) + _sigmoid(heads[:, 4:7]) * _sigmoid(spec)
    got = np.concatenate([sigma, rgb], axis=1)
    assert got.shape == want.shape == (ROWS, 4)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
