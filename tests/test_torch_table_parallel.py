"""Table parallelism of the port (scanerf_tpu_torch/parallel/table_parallel.py)
on the CPU, cheapest first: ``localize_meta`` against the JAX function;
the plain B3 / B4 on a table shard (the versions the card's kernels are
held to) against the whole table; then, on gloo ranks (tests/torch_ranks.py,
started once for the file), the table-sharded encode's values and
gradients over 2 and 4 ranks against the port's unsharded encode and the
JAX ``hash_encode_windowed_ref`` at tests/test_table_parallel.py's
tolerances, and one table-sharded train step over 2 ranks against the
unsharded step, whose gradients are held against JAX's
``compute_losses`` (its B3 / B4 pair swapped for the jnp stand-in of
tests/test_torch_unfused.py, as there)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ranks as R
from scanerf_tpu.ops.pallas import hash_encode as jhw
from scanerf_tpu.parallel import table_parallel as jtp
from scanerf_tpu.train import tile as jtile
from scanerf_tpu_torch import convert
from scanerf_tpu_torch.ops.kernels import hash_encode as thw
from scanerf_tpu_torch.parallel import table_parallel as ttp
from scanerf_tpu_torch.train import tile as ttile

STEP_KW = dict(num_sample=16, num_bg_sample=8, batch_log2=6, total_step=100, num_march=32,
               fused_decoder=False)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread while these tests run (the suite runs on
    several workers at once), and the worker's setting back after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stream(H=2**17, N=600, seed=1):
    """A port stream of points that fill every block (H = 2^17: 8 blocks)."""
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.uniform(-2, 2, (N, 3)).astype(np.float32))
    return thw.sort_pack(x, torch.zeros_like(x), H)


@pytest.mark.parametrize("n_dev", [2, 4])
def test_localize_meta_matches_jax(n_dev):
    """Every shard's meta and visited blocks equal the JAX function's on
    the same meta, field for field; owned chunks keep their spans and the
    rest get span 0."""
    st = _stream()
    NB = st.visited.shape[0]
    for dev in range(n_dev):
        tm, tv = ttp.localize_meta(st.meta, st.visited, dev, NB // n_dev)
        jm, jv = jtp.localize_meta(jnp.asarray(st.meta.numpy()), jnp.asarray(st.visited.numpy()),
                                   dev, NB // n_dev)
        np.testing.assert_array_equal(np.asarray(jm), tm.numpy())
        np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
        assert int((tm[:, :, 2] > 0).sum()) > 0


def test_plain_lookup_on_a_shard():
    """B3's and B4's plain versions on each of 2 shards (``wbase`` from
    the localized meta; rank 1's is not 0): the features of owned chunks
    equal the whole table's and the rest are 0, so the shards' sum is the
    whole lookup exactly; dL/du likewise sums to the whole one, and the
    table gradients side by side are the whole gradient, in each of B4's
    modes."""
    H, L = 2**17, 4
    st = _stream(H)
    rng = np.random.RandomState(2)
    feats = torch.from_numpy((rng.randn(L, H * 2) * 0.1).astype(np.float32))
    res = torch.from_numpy(np.tile([[65, 129, 257]], (L, 1)).astype(np.int32))
    NW = H // thw.W
    whole = thw.lookup_fwd_plain(st.pts, feats, res, NW)
    g = torch.from_numpy(rng.randn(*whole.shape).astype(np.float32))
    NB = st.visited.shape[0]
    axis = [type("A", (), dict(size=2, index=i))() for i in range(2)]
    parts = []
    for i in range(2):
        meta, _ = ttp.localize_meta(st.meta, st.visited, i, NB // 2)
        shard = ttp.shard_features(feats, axis[i])
        f = thw.lookup_fwd(st.pts, meta, shard, res, NW, shards=2)  # CPU: the plain version
        outs = {m: thw.lookup_bwd(st.pts, meta, shard, res, g, NW, mode=m, shards=2)
                for m in thw.BWD_MODES}
        parts.append((f, outs, int(meta[0, 0, 3])))
    assert parts[0][2] == 0 and parts[1][2] == NB // 2 * thw.WB
    torch.testing.assert_close(parts[0][0] + parts[1][0], whole, rtol=0, atol=0)
    assert bool(((parts[0][0] == 0) | (parts[1][0] == 0)).all())
    for m in thw.BWD_MODES:
        dpts, dtab = thw.lookup_bwd_plain(st.pts, feats, res, g, NW, m)
        torch.testing.assert_close(parts[0][1][m][0] + parts[1][1][m][0], dpts, rtol=0, atol=0)
        if m != "du":
            torch.testing.assert_close(torch.cat([p[1][m][1] for p in parts], 1), dtab,
                                       rtol=0, atol=0)


@pytest.fixture(scope="module")
def ranks():
    """Gloo ranks, one start for each world size: the sharded encode on 2
    and 4 ranks, the table-sharded step on 2."""
    return {2: R.run(2, [("encode", {}), ("table_step", {"tc_kw": STEP_KW})]),
            4: R.run(4, [("encode", {})])}


def _whole_encode():
    x, dirs, feats, res = R.encode_inputs()
    xr, fr = torch.from_numpy(x).requires_grad_(), torch.from_numpy(feats).requires_grad_()
    out = thw.hash_encode_windowed(xr, fr, torch.from_numpy(res))
    (out * out).sum().backward()
    return (x, feats, res), out.detach().numpy(), xr.grad.numpy(), fr.grad.numpy()


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_encode_matches_unsharded(ranks, world):
    """Each rank's features equal the port's unsharded encode exactly (one
    owner a row, zeros elsewhere) and the JAX reference at 1e-5 relative,
    1e-6 absolute (tests/test_table_parallel.py's tolerances)."""
    (x, feats, res), out, _, _ = _whole_encode()
    want = np.asarray(jax.jit(jhw.hash_encode_windowed_ref)(x, feats, res))
    for r in range(world):
        got = ranks[world][r][0]["out"]
        np.testing.assert_array_equal(got, out)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_grads_match_unsharded(ranks, world):
    """Gradients of sum(out^2): dL/dx complete on every rank and the
    shards' table gradients side by side equal the port's unsharded ones
    exactly, and the JAX reference's at 1e-4 relative (1e-5 / 1e-6
    absolute, tests/test_table_parallel.py's); each rank's shard is
    H / world rows."""
    (x, feats, res), _, gx, gf = _whole_encode()

    def loss(x_, f_):
        out = jhw.hash_encode_windowed_ref(x_, f_, res)
        return jnp.sum(out * out)

    jgx, jgf = jax.jit(jax.grad(loss, argnums=(0, 1)))(x, feats)
    outs = ranks[world]
    got_f = np.concatenate([outs[r][0]["gf"] for r in range(world)], axis=1)
    assert {outs[r][0]["gf"].shape[1] for r in range(world)} == {feats.shape[1] // world}
    np.testing.assert_array_equal(got_f, gf)
    np.testing.assert_allclose(got_f, np.asarray(jgf), rtol=1e-4, atol=1e-6)
    for r in range(world):
        np.testing.assert_array_equal(outs[r][0]["gx"], gx)
        np.testing.assert_allclose(outs[r][0]["gx"], np.asarray(jgx), rtol=1e-4, atol=1e-5)


def test_table_sharded_step_matches_unsharded(ranks, monkeypatch):
    """One step at H = 2^15 (2 blocks, one a rank), unfused decoder, on an
    injected batch: 2 table shards against the port's unsharded step. The
    losses, the decoder and pose gradients and the updates equal it
    within 1e-6 relative (the decoder's products sum alike; the features
    are one owner's, exact), the table-gradient shards side by side equal
    the whole gradient exactly. The unsharded gradients are held against
    JAX's ``compute_losses`` on the same state and batch at
    tests/test_torch_unfused.py's tolerances (relative L2 2e-2 tables,
    1e-3 poses; losses 5e-4)."""
    from test_torch_unfused import _j_lookup_sorted

    tc = ttile.TrainConfig(**STEP_KW)
    params, fs, data = R.tiny_tile(tc)
    state = ttile.create_train_state(params, fs, 2, tc, device="cpu")
    jstate = _jax_state(state)
    ray_idx, locs = R.batch(tc, seed=5)
    (_, aux), grads = ttile.compute_grads(state, data, tc, ray_idx=ray_idx, pixel_locs=locs)
    ttile.apply_gradients(state, grads, tc)
    want = R.step_outputs(state, grads, aux)
    outs = [ranks[2][r][1] for r in range(2)]
    np.testing.assert_array_equal(np.concatenate([o["grads"]["hash"][0] for o in outs], 1),
                                  want["grads"]["hash"][0])
    np.testing.assert_array_equal(np.concatenate([o["features"] for o in outs], 1),
                                  want["features"])
    for o in outs:
        for k in ("rgb_loss", "total_loss"):
            np.testing.assert_allclose(o["aux"][k], want["aux"][k], rtol=1e-6)
        for k in ("decoder", "cam"):
            for a, b in zip(o["grads"][k], want["grads"][k]):
                np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(o["decoder"], want["decoder"], rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(o["se3"], want["se3"], rtol=1e-6, atol=1e-9)

    monkeypatch.setattr(jhw, "hash_lookup_sorted", _j_lookup_sorted)
    jtc = jtile.TrainConfig(hash_backend="windowed", **STEP_KW)

    @jax.jit
    def jgrads(st, d, ri, pl):
        return jax.value_and_grad(
            lambda p: jtile.compute_losses(p, st.field_state, st.admm, d, ri, pl, st.step, jtc),
            has_aux=True)(st.params)

    (_, jaux), jg = jgrads(jstate, _jax_data(data), jnp.asarray(ray_idx.numpy(), jnp.int32),
                           jnp.asarray(locs.numpy(), jnp.int32))
    np.testing.assert_allclose(float(jaux["rgb_loss"]), float(aux["rgb_loss"]), rtol=5e-4)
    assert _rel_l2(jg.field.features, grads["hash"][0]) < 2e-2
    assert _rel_l2(jg.se3_refine, grads["cam"][0]) < 1e-3


def _rel_l2(a, b):
    a = np.asarray(a)
    return float(np.linalg.norm(a - b.numpy()) / np.linalg.norm(a))


def _jax_state(state, step_kw=STEP_KW):
    """The JAX TrainState (config ``step_kw``, H = 2^15) holding the port
    state's arrays (fresh moments)."""
    from scanerf_tpu.models import field as jfield

    jp, js = jfield.create_field(jax.random.PRNGKey(0), bbox_corner=np.array([-1.0] * 3),
                                 bbox_size=np.array([2.0] * 3), log2_hashmap_size=15,
                                 grid_resolution=(8, 64), sampler_log2dim=3)
    jst = jtile.create_train_state(jp, js, 2, jtile.TrainConfig(**step_kw))
    arr = {k: v.detach().numpy().copy() for k, v in convert.state_tensors(state).items()}
    dec = {n: {k: jnp.asarray(arr[f".params/.field/.decoder/['{n}']/['{k}']"])
               for k in ("w", "b")} for n in jst.params.field.decoder}
    return jst.replace(params=jst.params.replace(
        field=jst.params.field.replace(features=jnp.asarray(arr[".params/.field/.features"]),
                                       decoder=dec),
        se3_refine=jnp.asarray(arr[".params/.se3_refine"])),
        field_state=jst.field_state.replace(**{
            n: jnp.asarray(arr[".field_state/." + n]) for n in
            ("resolutions", "min_bbox", "bbox_size", "occupied_grid")}))


def _jax_data(data):
    from scanerf_tpu.train import cameras as jcam

    return jtile.TileData(
        images=jnp.asarray(data.images.numpy()), occlusions=jnp.asarray(data.occlusions.numpy()),
        cameras=jcam.Cameras(**{f.name: jnp.asarray(getattr(data.cameras, f.name).numpy())
                                for f in dataclasses.fields(data.cameras)}),
        mono_depths=jnp.asarray(data.mono_depths.numpy()),
        mono_normals=jnp.asarray(data.mono_normals.numpy()))
