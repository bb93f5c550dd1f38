"""The single-device training knobs of the port against the JAX package
on the CPU, cheapest first: where each knob applies (``stochastic_grad``
on the xla backend, ``bwd_onehot_bf16`` on the windowed one, each
ignored by the other; sharded tables raise); sparse Adam
(``train/sparse_adam.py``) against ``scale_by_sparse_adam`` over several
steps and through ``apply_gradients`` against the JAX ``tx.update``;
checkpoints with the sparse state both ways; ``hash_encode_stoch``
against the JAX one; and B4's plain bf16 backward against a jnp
emulation of the JAX kernel's bf16 operand and against the exact
gradient. JAX references run under ``jax.jit``."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from scanerf_tpu.ops import hash_encode as jhe
from scanerf_tpu.ops.pallas import hash_encode as jhw
from scanerf_tpu.train import checkpoint as jckpt
from scanerf_tpu.train import tile as jtile
from scanerf_tpu.train.sparse_adam import scale_by_sparse_adam
from scanerf_tpu_torch import convert
from scanerf_tpu_torch.models import field as tfield
from scanerf_tpu_torch.ops import hash_encode as the
from scanerf_tpu_torch.ops.kernels import hash_encode as thw
from scanerf_tpu_torch.train import checkpoint as tckpt
from scanerf_tpu_torch.train import tile as ttile
from scanerf_tpu_torch.train.sparse_adam import SparseAdam
from test_torch_checkpoint import L, LOG2_H, N_CAM, _jax_state, _random, _template

B1, B2, EPS = 0.9, 0.99, 1e-15  # the tables' Adam (tile.py's build_optimizer)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread while these tests run (the suite runs on
    several workers at once), and the worker's setting back after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(ref, got, rtol):
    """Within ``rtol`` of the reference's largest entry."""
    ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    np.testing.assert_allclose(got, ref, rtol=0, atol=rtol * max(np.abs(ref).max(), 1e-30))


# ---------------------------------------------------------------------------
# sparse Adam
# ---------------------------------------------------------------------------

def test_sparse_adam_matches_jax_transform_over_steps():
    """Four steps of gradients that are exactly 0 on a changing half of
    the entries (one step all 0): SparseAdam with a rate of 1 moves each
    param by the JAX transform's update; its per-element counts equal the
    JAX counts and its moments and params are within 1e-6 relative (the
    same f32 operations; b ** count may round apart by an ulp). Entries
    whose gradient is 0 do not move."""
    rng = np.random.RandomState(0)
    p0 = rng.randn(64, 2).astype(np.float32)
    tx = scale_by_sparse_adam(b1=B1, b2=B2, eps=EPS)
    upd = jax.jit(tx.update)
    js = tx.init(jnp.asarray(p0))
    p = torch.from_numpy(p0.copy())
    opt = SparseAdam([p], lr=1.0, betas=(B1, B2), eps=EPS)
    for step in range(4):
        g = rng.randn(64, 2).astype(np.float32) * (rng.rand(64, 1) < 0.5)
        if step == 2:
            g[:] = 0.0
        steps, js = upd(jnp.asarray(g), js)
        before = p.clone()
        p.grad = torch.from_numpy(g)
        opt.step()
        np.testing.assert_array_equal(np.asarray(js.count), opt.state[p]["count"].numpy())
        _close(js.mu, opt.state[p]["mu"], 1e-6)
        _close(js.nu, opt.state[p]["nu"], 1e-6)
        _close(-np.asarray(steps), (p - before).numpy(), 1e-6)
        assert torch.equal(p[g == 0], before[g == 0])


def _sparse_tc():
    return jtile.TrainConfig(cam_enable=True, sparse_adam=True, total_step=4000)


def test_apply_gradients_sparse_adam_matches_jax_update():
    """A JAX state trained with SPARSE_ADAM (random params, moments and
    counts; per-element table counts) carried to the port; one update
    from identical gradients, the table's exactly 0 on 70% of its
    entries. The port's ``apply_gradients`` (SparseAdam for the tables,
    the fused Adam for decoder and cameras) against the JAX ``tx.update``
    + ``apply_updates``: every count equal, params and moments within
    1e-6 relative of each array's largest entry."""
    tc = _sparse_tc()
    js = _jax_state(True, seed=3)
    tx = jtile.build_optimizer(tc)
    rng = np.random.RandomState(4)
    opt_state = jax.tree_util.tree_map(lambda a: _random(rng, a),
                                       jax.eval_shape(tx.init, js.params))
    js = js.replace(opt_state=opt_state)
    port = convert.train_state(js, device="cpu")
    assert port.hash_optimizer is not None
    assert [g["name"] for g in port.optimizer.param_groups] == ["decoder", "cam"]
    grads = jax.tree_util.tree_map(lambda a: rng.randn(*a.shape).astype(np.float32),
                                   js.params)
    mask = rng.rand(*grads.field.features.shape) < 0.3
    grads = grads.replace(field=grads.field.replace(features=grads.field.features * mask))

    @jax.jit
    def jstep(params, opt_state, grads):
        updates, new_opt = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), new_opt

    new_params, new_opt = jstep(js.params, js.opt_state, grads)
    ref = convert.state_tensors(convert.train_state(
        js.replace(params=new_params, opt_state=new_opt), device="cpu"))
    tgrads = {k: [torch.from_numpy(np.asarray(t)) for t in v]
              for k, v in ttile.group_leaves(grads).items()}
    ttile.apply_gradients(port, tgrads, tc)
    got = convert.state_tensors(port)
    assert ref.keys() == got.keys()
    hash_count = ".opt_state/.inner_states/['hash']/.inner_state/[0]/.count/.field/.features"
    assert got[hash_count].dtype == torch.int32 and got[hash_count].shape == (L, 2 * 2**LOG2_H)
    for k in ref:
        if ref[k].dtype.is_floating_point:
            _close(ref[k].numpy(), got[k].numpy(), 1e-6)
        else:
            assert torch.equal(ref[k], got[k]), k


def test_sparse_adam_checkpoints_both_ways(tmp_path):
    """A JAX checkpoint with the sparse state loaded by the port, and the
    port's written back and loaded by the JAX package: every array equal,
    the per-element counts int32 in both."""
    tc = _sparse_tc()
    js = _jax_state(True, seed=5)
    tx = jtile.build_optimizer(tc)
    rng = np.random.RandomState(6)
    js = js.replace(opt_state=jax.tree_util.tree_map(
        lambda a: _random(rng, a), jax.eval_shape(tx.init, js.params)))
    jpath = str(tmp_path / "checkpoint-7-0.npz")
    jckpt.save_checkpoint(jpath, js)
    p, fs = tfield.create_field(torch.Generator().manual_seed(0), [-1.0] * 3, [2.0] * 3,
                                log2_hashmap_size=LOG2_H, grid_resolution=(32, 512),
                                sampler_log2dim=3, device="cpu")
    template = ttile.create_train_state(p, fs, N_CAM, ttile.TrainConfig(sparse_adam=True),
                                        device="cpu")
    port = tckpt.load_checkpoint(jpath, template, device="cpu")
    with np.load(jpath) as data:
        theirs = {k: data[k] for k in data.files}
    ours = {k: v.numpy() for k, v in convert.state_tensors(port).items()}
    assert ours.keys() == theirs.keys()
    for k in ours:
        np.testing.assert_array_equal(ours[k].reshape(theirs[k].shape), theirs[k], err_msg=k)
        assert ours[k].dtype == theirs[k].dtype, k
    ppath = str(tmp_path / "port.npz")
    tckpt.save_checkpoint(ppath, port)
    back = jckpt.load_checkpoint(ppath, js)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(js)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # a dense template refuses the sparse checkpoint's layout
    with pytest.raises(KeyError):
        tckpt.load_checkpoint(jpath, _template(True), device="cpu")


# ---------------------------------------------------------------------------
# the stochastic-corner gradient
# ---------------------------------------------------------------------------

def test_hash_encode_stoch_matches_jax():
    """``hash_encode_stoch`` of 400 points over 16 levels at H = 2^10:
    the forward within 1e-6 of the JAX one, the corner draws' uniforms
    bit for bit, and the backward of a random linear functional within
    1e-6 of each gradient's largest entry (the same corners; the table's
    scatter-add sums colliding entries in another order)."""
    rng = np.random.RandomState(1)
    H = 2**10
    pts = rng.uniform(-1.9, 1.9, (400, 3)).astype(np.float32)
    table = (rng.randn(L, H * 2) * 0.1).astype(np.float32)
    res = jhe.make_level_resolutions(np.array([16, 24, 16]), np.array([512, 768, 512]), L)
    cot = rng.randn(400, L * 2).astype(np.float32)

    @jax.jit
    def jfun(p, t):
        def f(p, t):
            out = jhe.hash_encode_stoch(p, t, jnp.asarray(res))
            return jnp.sum(out * cot), out
        return jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(p, t)

    (_, jout), (jgp, jgt) = jfun(jnp.asarray(pts), jnp.asarray(table))
    np.testing.assert_array_equal(
        np.asarray(jax.jit(jhe._corner_sample_u)(jnp.asarray(pts))),
        the._corner_sample_u(torch.from_numpy(pts)).numpy())
    p = torch.from_numpy(pts).requires_grad_()
    t = torch.from_numpy(table).requires_grad_()
    out = the.hash_encode_stoch(p, t, torch.from_numpy(res))
    (out * torch.from_numpy(cot)).sum().backward()
    _close(jout, out.detach().numpy(), 1e-6)
    _close(jgp, p.grad.numpy(), 1e-6)
    _close(jgt, t.grad.numpy(), 1e-6)
    # and it is the stochastic gradient, not the exact one
    t2 = torch.from_numpy(table).requires_grad_()
    (the.hash_encode(torch.from_numpy(pts), t2, torch.from_numpy(res))
     * torch.from_numpy(cot)).sum().backward()
    assert (t2.grad != 0).sum() > (t.grad != 0).sum()


# ---------------------------------------------------------------------------
# B4's bf16 mode, plain version
# ---------------------------------------------------------------------------

def _stream(n=600, log2_h=14, seed=2):
    rng = np.random.RandomState(seed)
    H = 2**log2_h
    x = torch.from_numpy(rng.uniform(-1.9, 1.9, (n, 3)).astype(np.float32))
    st = thw.sort_pack(x, torch.zeros_like(x), H)
    table = torch.from_numpy((rng.randn(L, H * 2) * 0.1).astype(np.float32))
    res = torch.from_numpy(jhe.make_level_resolutions(np.array([16] * 3), np.array([512] * 3),
                                                      L))
    g = torch.from_numpy(rng.randn(st.pts.shape[0] * thw.CHUNK, 2 * L).astype(np.float32))
    return st, table, res, g, H // thw.W


def test_bf16_backward_plain_matches_jnp_emulation_and_exact():
    """``lookup_bwd_plain(mode="bf16")`` on a stream of 600 points at H =
    2^14: its table gradient within 1e-6 of the largest entry of a jnp
    emulation of the JAX kernel's bf16 operand (each corner's weight times
    the cotangent cast to bf16, hash_encode.py:996-1016; the one-hot exact;
    f32 sums) built with the JAX package's window and slot hash; within 2%
    of the exact gradient's largest entry (the JAX package's own bound,
    tests/test_pallas_hash.py); dL/du equal to the exact mode's; and the
    "du" mode gives the same dL/du and no table gradient."""
    st, table, res, g, NW = _stream()
    dpts_b, dtab_b = thw.lookup_bwd_plain(st.pts, table, res, g, NW, mode="bf16")
    dpts_x, dtab_x = thw.lookup_bwd_plain(st.pts, table, res, g, NW)
    dpts_u, dtab_u = thw.lookup_bwd_plain(st.pts, table, res, g, NW, mode="du")
    assert dtab_u is None
    assert torch.equal(dpts_b, dpts_x) and torch.equal(dpts_u, dpts_x)

    u = st.pts[:, 0:3, :].permute(0, 2, 1).reshape(-1, 3).numpy()
    wid = st.pts[:, 3, :].reshape(-1).numpy().astype(np.int32)
    real = wid < NW
    corners = jnp.asarray(np.stack(np.meshgrid([0, 1], [0, 1], [0, 1], indexing="ij"),
                                   -1).reshape(8, 3), jnp.uint32)

    @jax.jit
    def emulate(u, wid, g):
        out = []
        for lvl in range(L):
            v = u * (jnp.asarray(res.numpy()[lvl]).astype(u.dtype) - 1.0)
            bl = jnp.floor(v)
            off = v - bl
            ic = bl.astype(jnp.uint32)[:, None, :] + corners[None]
            idx = wid[:, None] * jhw.W + jhw.slot_hash(ic[..., 0], ic[..., 1],
                                                       ic[..., 2]).astype(jnp.int32)
            cf = corners.astype(u.dtype)
            wgt = jnp.prod(cf[None] * off[:, None, :] + (1 - cf[None]) * (1 - off[:, None, :]),
                           axis=-1)
            a = (wgt[..., None] * g[:, None, 2 * lvl:2 * lvl + 2]).astype(jnp.bfloat16)
            out.append(jnp.zeros((NW * jhw.W, 2), jnp.float32).at[idx.reshape(-1)].add(
                a.astype(jnp.float32).reshape(-1, 2)))
        return jnp.stack(out).reshape(L, -1)

    ref = emulate(jnp.asarray(u[real]), jnp.asarray(wid[real]), jnp.asarray(g.numpy()[real]))
    _close(ref, dtab_b.numpy(), 1e-6)
    scale = float(dtab_x.abs().max())
    assert float((dtab_b - dtab_x).abs().max()) <= 0.02 * scale
    assert not torch.equal(dtab_b, dtab_x)


# ---------------------------------------------------------------------------
# where the knobs apply (render_rays)
# ---------------------------------------------------------------------------

def _render_grads(params, fs, o, d, **kw):
    feats = params.features.detach().requires_grad_()
    tracked = tfield.FieldParams(features=feats, decoder=params.decoder)
    out = tfield.render_rays(tracked, fs, o, d, 16, 8, torch.tensor(0.0), **kw)
    (out["pred_color"].sum() + out["pred_depth"].sum()).backward()
    return out["pred_color"].detach(), feats.grad


@pytest.mark.parametrize("log2_h", [10, 14], ids=["xla", "windowed"])
def test_knobs_apply_where_jax_applies_them(log2_h):
    """``render_rays`` on the CPU: at H = 2^10 (the xla backend)
    ``bwd_onehot_bf16`` changes nothing and ``stochastic_grad`` changes
    the table gradient only; at H = 2^14 (windowed) ``stochastic_grad``
    changes nothing and ``bwd_onehot_bf16`` changes the table gradient
    only, within 2% of its largest entry; sharded tables without the
    axis they are sharded over raise (on the xla backend at any rate, as
    the JAX package asserts)."""
    params, fs = tfield.create_field(torch.Generator().manual_seed(0), [-1.0] * 3,
                                     [2.0] * 3, log2_hashmap_size=log2_h,
                                     grid_resolution=(16, 256), sampler_log2dim=3,
                                     device="cpu")
    rng = np.random.RandomState(4)
    o = torch.from_numpy(rng.uniform(-0.5, 0.5, (24, 3)).astype(np.float32))
    d = torch.from_numpy(rng.randn(24, 3).astype(np.float32))
    rgb, grad = _render_grads(params, fs, o, d)
    applies, ignored = (("stochastic_grad", "bwd_onehot_bf16") if log2_h == 10
                        else ("bwd_onehot_bf16", "stochastic_grad"))
    rgb_i, grad_i = _render_grads(params, fs, o, d, **{ignored: True})
    assert torch.equal(rgb_i, rgb) and torch.equal(grad_i, grad)
    rgb_a, grad_a = _render_grads(params, fs, o, d, **{applies: True})
    assert torch.equal(rgb_a, rgb) and not torch.equal(grad_a, grad)
    if applies == "bwd_onehot_bf16":
        assert float((grad_a - grad).abs().max()) <= 0.02 * float(grad.abs().max())
    with pytest.raises(ValueError, match="windowed backend" if log2_h == 10 else "table axis"):
        tfield.render_rays(params, fs, o, d, 16, 8, torch.tensor(0.0), table_shards=2,
                           backend="xla" if log2_h == 10 else "windowed")
