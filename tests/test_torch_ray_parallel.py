"""Ray data parallelism of the port (scanerf_tpu_torch/parallel/ray_parallel.py)
on gloo ranks on the CPU (tests/torch_ranks.py, started once for the
file), as tests/test_ray_parallel.py holds the JAX package's: the
2-rank step (``make_ray_mesh``, ``shard_dp``, ``build_dp_step``, each
replica drawing from its own ``batch_generator``) against one update
with the mean of the two replicas' gradients, each computed alone on the
rank's batch (ray_idx injected), with JAX's ``compute_losses`` as the
reference for those gradients; and the (rays 2, table 2) mesh on 4 ranks
against the 2-rank step (tests/test_ray_parallel.py:175)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ranks as R
from scanerf_tpu.ops.pallas import hash_encode as jhw
from scanerf_tpu.train import tile as jtile
from scanerf_tpu_torch.parallel import mesh as tmesh
from scanerf_tpu_torch.parallel import ray_parallel as trp
from scanerf_tpu_torch.train import tile as ttile

STEP_KW = dict(num_sample=16, num_bg_sample=8, batch_log2=6, total_step=100, num_march=32,
               fused_decoder=False)
SEED = 3


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread while these tests run (the suite runs on
    several workers at once), and the worker's setting back after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_one_rank_mesh_and_specs():
    """Without a process group: a rays mesh of one rank, no table axis,
    every array replicated; ``build_dp_step`` checks the config against
    the mesh."""
    mesh = trp.make_ray_mesh()
    assert mesh.shape == {"rays": 1} and mesh.axis("table") is None
    tc = ttile.TrainConfig(**STEP_KW)
    params, fs, data = R.tiny_tile(tc)
    state = ttile.create_train_state(params, fs, 2, tc, device="cpu")
    assert set(trp.state_specs(state, mesh).values()) == {None}
    with pytest.raises(ValueError, match="ray_shards"):
        trp.build_dp_step(mesh, ttile.TrainConfig(ray_shards=2))
    assert tmesh.all_reduce(torch.ones(2), mesh.axis("rays")).tolist() == [1.0, 1.0]


@pytest.fixture(scope="module")
def ranks():
    return {2: R.run(2, [("dp_step", {"tc_kw": STEP_KW, "seed": SEED})]),
            4: R.run(4, [("dp_step", {"tc_kw": STEP_KW, "seed": SEED, "n_table": 2})])}


def _replica_grads(tc, state, data):
    """Each rays replica's batch (its ``batch_generator``) and gradients,
    computed alone."""
    out = []
    for r in range(2):
        mesh = tmesh.Mesh((tmesh.Axis("rays", 2, r),))
        gen = ttile.batch_generator(SEED, mesh)
        ray_idx, locs = ttile.sample_patches(gen, 16, 16, (2**tc.batch_log2) // 2 // 4)
        locs = locs[None].expand(2, *locs.shape)
        out.append(((ray_idx, locs),
                    ttile.compute_grads(state, data, tc, ray_idx=ray_idx, pixel_locs=locs)))
    return out


def test_dp_step_matches_manual_grad_average(ranks, monkeypatch):
    """Both replicas end equal to one update with the mean of the two
    replicas' gradients: the losses' mean within 1e-6 relative, the
    tables, decoder and poses within 1e-6 relative (the mean is summed in
    the same order). Each replica's gradients against JAX's
    ``compute_losses`` on its batch (B3 / B4 swapped for the jnp stand-in
    of tests/test_torch_unfused.py): losses 5e-4 relative, relative L2
    2e-2 (tables) and 1e-3 (poses), tests/test_torch_unfused.py's
    tolerances."""
    from test_torch_table_parallel import _jax_data as jax_data
    from test_torch_table_parallel import _jax_state as jax_state
    from test_torch_unfused import _j_lookup_sorted

    tc = ttile.TrainConfig(**STEP_KW)
    params, fs, data = R.tiny_tile(tc)
    state = ttile.create_train_state(params, fs, 2, tc, device="cpu")
    jst = jax_state(state, STEP_KW)
    reps = _replica_grads(tc, state, data)
    grads = {k: [(a + b) / 2 for a, b in zip(reps[0][1][1][k], reps[1][1][1][k])]
             for k in ("hash", "decoder", "cam")}
    ttile.apply_gradients(state, grads, tc)
    want = R.step_outputs(state, None, {})
    loss = (float(reps[0][1][0][1]["total_loss"]) + float(reps[1][1][0][1]["total_loss"])) / 2
    for r in range(2):
        got = ranks[2][r][0]
        np.testing.assert_allclose(float(got["aux"]["total_loss"]), loss, rtol=1e-6)
        for k in ("features", "decoder", "se3"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-9, err_msg=k)
        assert got["sharded_keys"] == []

    monkeypatch.setattr(jhw, "hash_lookup_sorted", _j_lookup_sorted)
    jtc = jtile.TrainConfig(hash_backend="windowed", **STEP_KW)

    @jax.jit
    def jgrads(st, d, ri, pl):
        return jax.value_and_grad(
            lambda p: jtile.compute_losses(p, st.field_state, st.admm, d, ri, pl, st.step, jtc),
            has_aux=True)(st.params)

    jd = jax_data(data)
    for (ray_idx, locs), ((_, aux), g) in reps:
        (_, jaux), jg = jgrads(jst, jd, jnp.asarray(ray_idx.numpy(), jnp.int32),
                               jnp.asarray(locs.numpy(), jnp.int32))
        np.testing.assert_allclose(float(jaux["rgb_loss"]), float(aux["rgb_loss"]), rtol=5e-4)
        for jv, tv, tol in ((jg.field.features, g["hash"][0], 2e-2),
                            (jg.se3_refine, g["cam"][0], 1e-3)):
            jv = np.asarray(jv)
            assert np.linalg.norm(jv - tv.numpy()) / np.linalg.norm(jv) < tol


def test_dp_composes_with_table_sharding(ranks):
    """(rays 2, table 2) on 4 ranks against the 2-rank step: the table and
    its Adam moments are sharded (``state_specs``), each rank's table
    shard equals its slice of the 2-rank table exactly, the decoder and
    poses within 1e-6 relative, the losses within 1e-6."""
    ref = ranks[2][0][0]
    H2 = ref["features"].shape[1] // 2
    for r in range(4):
        got = ranks[4][r][0]
        t = r % 2  # the table index: the table axis is innermost
        np.testing.assert_array_equal(got["features"], ref["features"][:, t * H2:(t + 1) * H2])
        for k in ("decoder", "se3"):
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-6, atol=1e-9, err_msg=k)
        np.testing.assert_allclose(float(got["aux"]["total_loss"]),
                                   float(ref["aux"]["total_loss"]), rtol=1e-6)
        assert len(got["sharded_keys"]) == 3  # the table and its two moments
