"""The port's tiles mesh, consensus over ranks, sharded render, Trainer
across ranks and the profiling utilities, on the CPU, cheapest first:
``step_cost`` against the JAX function, ``timed`` / ``trace``; then on
gloo ranks (tests/torch_ranks.py, one start of 2 ranks and one of 4 for
the file): ``consensus_update`` over a 2-rank ``tiles`` axis against the
JAX one under ``shard_map`` on 2 virtual devices; ``render_rays_sharded``
and ``render_image(sharded=True)``, both backends, against the one-rank
render; ``build_admm_round`` on (tiles 2, table 2) against the
one-process ``admm_round`` and on (tiles 2, rays 2) against each tile's
averaged-gradient step and the consensus; and ``Trainer`` on (tiles 2,
table 2) whose exports equal the one-process run's."""

import dataclasses
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_ranks as R
from scanerf_tpu.parallel import consensus as jcons
from scanerf_tpu.parallel import tile_parallel as jtp
from scanerf_tpu.utils import roofline as jroof
from scanerf_tpu_torch.config import default_config
from scanerf_tpu_torch.parallel import consensus as tcons
from scanerf_tpu_torch.parallel import mesh as tmesh
from scanerf_tpu_torch.parallel import tile_parallel as ttp
from scanerf_tpu_torch.render import renderer as tr
from scanerf_tpu_torch.train import checkpoint as tckpt
from scanerf_tpu_torch.train import tile as ttile
from scanerf_tpu_torch.train import trainer as ttrainer
from scanerf_tpu_torch.utils import profiling, roofline

STEP_KW = dict(num_sample=16, num_bg_sample=8, batch_log2=6, total_step=100, num_march=32,
               fused_decoder=False, rho=10.0)
RENDER_KW = dict(num_sample=16, num_bg_sample=6, num_march=32)
SEED = 7


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread while these tests run (the suite runs on
    several workers at once), and the worker's setting back after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("kw", [{}, dict(batch=2**12, log2_hashmap_size=24, warp_top_k=5)])
def test_step_cost_matches_jax(kw):
    """Every itemised count equals the JAX function's; the ideal time
    and the summary use the H100's peaks."""
    assert roofline.step_cost(**kw) == jroof.step_cost(**kw)
    cost = roofline.step_cost(**kw)
    ideal = roofline.ideal_time_s(cost)
    assert ideal["t_ideal_s"] == max(cost["flops_total"] / 67e12,
                                     cost["hbm_bytes_total"] / 3.35e12)
    s = roofline.summarize(0.05, **kw)
    assert s["roofline_frac"] == round(ideal["t_ideal_s"] / 0.05, 4)


def test_timed_and_trace(tmp_path):
    """``timed`` measures the block (CPU tensors need no wait) and
    ``trace`` writes a Chrome trace."""
    x = torch.ones(64, 64)
    with profiling.timed("mm", x, log=False) as span:
        y = x @ x
    assert span.elapsed > 0 and float(y[0, 0]) == 64.0
    with profiling.trace(str(tmp_path)) as prof:
        x @ x
    assert os.path.getsize(tmp_path / "trace.json") > 0 and prof.key_averages()


def test_jax_parallel_tiles_to_rank_shards():
    """A JAX ``ParallelTiles`` of two tiles (H = 2^15) carried across by
    ``convert.parallel_tiles``, each tile then cut by
    ``convert.table_shard`` for both ranks of a 2-way table axis: the two
    shards side by side are the JAX tile's table and Adam moments
    exactly, the decoder and poses whole; on a (tiles 2, table 2) mesh
    rank 3 holds tile 1's second half (``tile_parallel.local_tiles``)."""
    from scanerf_tpu.models import field as jfield
    from scanerf_tpu.train import tile as jtile
    from scanerf_tpu_torch import convert

    jst = []
    for seed in range(2):
        jp, js = jfield.create_field(jax.random.PRNGKey(seed), bbox_corner=np.array([-1.0] * 3),
                                     bbox_size=np.array([2.0] * 3), log2_hashmap_size=15,
                                     grid_resolution=(8, 64), sampler_log2dim=3)
        jst.append(jtile.create_train_state(jp, js, 3, jtile.TrainConfig()))
    jt = jtp.stack_tiles(jst, jtp.make_cam_maps([[0, 1], [1, 2]], 3))
    key_mu = ".opt_state/.inner_states/['hash']/.inner_state/[0]/.mu/.field/.features"
    for t in range(2):
        table = np.asarray(jt.state.params.field.features[t])
        halves = []
        for i in range(2):
            states, cam_map, _ = convert.parallel_tiles(jt, device="cpu")
            st = convert.table_shard(states[t], tmesh.Axis("table", 2, i))
            arrays = convert.state_tensors(st)
            halves.append((st.params.field.features.numpy(), arrays[key_mu].numpy()))
            np.testing.assert_array_equal(st.params.se3_refine.numpy(),
                                          np.asarray(jt.state.params.se3_refine[t]))
        np.testing.assert_array_equal(np.concatenate([h[0] for h in halves], 1), table)
        mu = np.asarray(jt.state.opt_state.inner_states["hash"].inner_state[0].mu
                        .field.features[t])
        np.testing.assert_array_equal(np.concatenate([h[1] for h in halves], 1), mu)
        np.testing.assert_array_equal(cam_map.numpy(), np.asarray(jt.cam_map))
    mesh = tmesh.Mesh((tmesh.Axis("tiles", 2, 1), tmesh.Axis("table", 2, 1)))
    assert ttp.local_tiles(mesh, 2) == [1]


def _consensus_arrays(T=4, M=5, G=12, seed=0):
    rng = np.random.RandomState(seed)
    views = [sorted(rng.choice(G, rng.randint(2, M + 1), replace=False)) for _ in range(T)]
    cam_map = jtp.make_cam_maps(views, M)

    def rand(*shape):
        return (rng.randn(*shape) * 0.01).astype(np.float32)

    return dict(se3=rand(T, M, 6), conf=rng.uniform(0.5, 1.0, (T, M)).astype(np.float32),
                cam_map=cam_map, z_old=rand(T, M, 6), delta=rand(T, M, 6),
                rho=np.ones(6, np.float32)), G


def _tiny_city_overrides(root):
    from test_torch_trainer import _city, _overrides

    _city(root)
    o = _overrides(root, total=4, HASHGRID={"LOG2_HASHMAP_SIZE": 15})
    o["TRAINING"] = dict(o["TRAINING"], FUSED_DECODER=False, TABLE_SHARDS=2)
    return o


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """One start of 2 ranks (consensus, render) and one of 4 ((tiles,
    table) and (tiles, rays) rounds, the Trainer); the city's directory."""
    arrays, G = _consensus_arrays()
    from test_torch_render import scene_arrays

    a = scene_arrays(T=2, seed=21)
    scene_kw = dict(features=a["features"], decoder_vecs=a["decoders"],
                    resolutions=a["resolutions"], block_corner=a["block_corner"],
                    block_size=a["block_size"], occupied=a["occupied"])
    rng = np.random.RandomState(3)
    o = (rng.randn(64, 3) * 0.3).astype(np.float32)
    o[:, 0] += rng.uniform(0, 1.5, 64).astype(np.float32)
    c2w = np.array([[1, 0, 0, 0.7], [0, 0, 1, -3.0], [0, -1, 0, 0.2]], np.float32)
    K = np.array([[12.0, 0, 6], [0, 12.0, 5], [0, 0, 1]], np.float32)
    rays = dict(rays=(o, rng.randn(64, 3).astype(np.float32)), K=K, c2w=c2w, H=10, W=12,
                chunk=48)
    root = str(tmp_path_factory.mktemp("multi") / "city")
    overrides = _tiny_city_overrides(root)
    two = R.run(2, [("consensus", dict(arrays=arrays, n_global=G)),
                    ("render", dict(scene_kw=scene_kw, rays_kw=rays, render_kw=RENDER_KW))])
    four = R.run(4, [("admm_round", dict(tc_kw=STEP_KW, n_table=2, seed=SEED)),
                     ("admm_round", dict(tc_kw=STEP_KW, n_rays=2, seed=SEED)),
                     ("trainer", dict(cfg_overrides=overrides))])
    return dict(two=two, four=four, consensus=(arrays, G), scene_kw=scene_kw, rays=rays,
                overrides=overrides)


def test_consensus_over_ranks_matches_jax(ranks):
    """4 tiles over a 2-rank ``tiles`` axis (2 a rank) against the JAX
    ``consensus_update`` under ``shard_map`` on 2 virtual devices: z and
    the dual within 1e-6 of their largest entry, the overlap flags and
    count equal, the residuals within 1e-6 relative, on both ranks."""
    arrays, G = ranks["consensus"]
    mesh = jtp.make_tile_mesh(jax.devices()[:2])

    def fn(se3, conf, cam_map, z_old, delta):
        return jcons.consensus_update(se3, conf, cam_map, z_old, delta, jnp.ones(6), G,
                                      axis_name="tiles")

    spec = P("tiles")
    jz, jdelta, jov, jaux = jax.jit(jax.shard_map(
        fn, mesh=mesh, in_specs=(spec,) * 5, out_specs=(spec, spec, spec, P())))(
        *(jnp.asarray(arrays[k]) for k in ("se3", "conf", "cam_map", "z_old", "delta")))
    for r in range(2):
        got = ranks["two"][r][0]
        part = slice(2 * r, 2 * r + 2)
        for ref, k in ((jz, "z"), (jdelta, "delta")):
            ref = np.asarray(ref)
            np.testing.assert_allclose(got[k], ref[part], atol=1e-6 * np.abs(ref).max())
        np.testing.assert_array_equal(got["overlap"], np.asarray(jov)[part])
        assert got["n_ovl"] == int(jaux.num_overlap) > 0
        np.testing.assert_allclose(got["primal"], float(jaux.primal_residual), rtol=1e-6)
        np.testing.assert_allclose(got["dual"], float(jaux.dual_residual), rtol=1e-6)


def test_sharded_render_matches_one_rank(ranks):
    """``render_rays_sharded`` of 64 rays over 2 ranks and
    ``render_image(sharded=True)`` of a 12x10 frame (chunks of 48), both
    backends, equal the one-rank render on every rank within 1e-6 (each
    ray's samples and decode are its own; the windowed stream of half the
    rays sorts its rows in another order)."""
    scene = tr.scene_from_arrays(**ranks["scene_kw"], device="cpu")
    rk = ranks["rays"]
    o, d = (torch.from_numpy(a) for a in rk["rays"])
    for backend in ("windowed", "xla"):
        want = tr.render_rays(scene, o, d, device="cpu", backend=backend, **RENDER_KW)
        img = tr.render_image(scene, rk["K"], rk["c2w"], rk["H"], rk["W"], chunk=rk["chunk"],
                              device="cpu", backend=backend, **RENDER_KW)
        for r in range(2):
            got = ranks["two"][r][1]
            for k, v in want.items():
                np.testing.assert_allclose(got[backend][k], v.numpy(), atol=1e-6,
                                           err_msg=f"{backend} {k}")
            for k, v in img.items():
                np.testing.assert_allclose(got[backend + "_image"][k], v, atol=1e-6)


def _one_process_round(tc, rays=None):
    """The (tiles, table) reference: one process's ``admm_round`` of the
    two tiles; with ``rays`` (the rays axis size) each tile's step is one
    update with the mean of its replicas' gradients, then the consensus."""
    states, datas, cam_maps = R.admm_tiles(tc)
    cam_map = torch.from_numpy(cam_maps)
    conf = torch.ones(cam_map.shape)
    if rays is None:
        gens = [ttile.batch_generator(SEED, None, t) for t in range(2)]
        losses, aux = ttp.admm_round(states, datas, cam_map, conf, tc, 1, 3, gens, device="cpu")
        return states, losses, aux
    losses = []
    for t, (s, d) in enumerate(zip(states, datas)):
        reps = []
        for r in range(rays):
            gen = ttile.batch_generator(SEED, tmesh.Mesh((tmesh.Axis("rays", rays, r),)), t)
            reps.append(ttile.compute_grads(s, d, tc, gen))
        grads = {k: [sum(g) / rays for g in zip(*(rep[1][k] for rep in reps))]
                 for k in ("hash", "decoder", "cam")}
        ttile.apply_gradients(s, grads, tc)
        s.step += 1
        losses.append(sum(float(rep[0][1]["total_loss"]) for rep in reps) / rays)
    z, delta, ov, aux = tcons.consensus_update(
        torch.stack([s.params.se3_refine for s in states]), conf, cam_map,
        torch.stack([s.admm.shared_se3 for s in states]),
        torch.stack([s.admm.delta_se3 for s in states]), states[0].admm.rho, 3)
    for t, s in enumerate(states):
        s.admm.shared_se3, s.admm.delta_se3 = z[t], delta[t]
    return states, torch.tensor(losses), aux


@pytest.mark.parametrize("axis", ["table", "rays"])
def test_admm_round_over_ranks_matches_one_process(ranks, axis):
    """One round of 2 tiles (one step each, rho 10, tiles sharing camera
    0) on 4 ranks: (tiles 2, table 2) against the one-process
    ``admm_round`` (the table shards side by side equal the tile's table
    exactly; losses, decoder, poses, z and the dual within 1e-6
    relative), and (tiles 2, rays 2) against each tile's update with the
    mean of its two replicas' gradients and one consensus (1e-6
    relative); the residuals within 1e-6 relative."""
    job = 0 if axis == "table" else 1
    tc = ttile.TrainConfig(**STEP_KW)
    states, losses, aux = _one_process_round(tc, None if axis == "table" else 2)
    outs = [ranks["four"][r][job] for r in range(4)]
    for r, out in enumerate(outs):
        (t,) = out["tile_ids"]
        assert t == r // 2  # the tiles axis is outermost
        want = R.step_outputs(states[t], None, {})
        np.testing.assert_allclose(out["losses"][0], float(losses[t]), rtol=1e-6)
        np.testing.assert_allclose(out["primal"], float(aux.primal_residual), rtol=1e-6)
        np.testing.assert_allclose(out["dual"], float(aux.dual_residual), rtol=1e-6)
        got = out["states"][0]
        feats = want["features"]
        if axis == "table":
            h = feats.shape[1] // 2
            np.testing.assert_array_equal(got["features"], feats[:, (r % 2) * h:(r % 2 + 1) * h])
        else:
            np.testing.assert_allclose(got["features"], feats, rtol=1e-6, atol=1e-9)
        for k in ("decoder", "se3"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-9, err_msg=k)
        np.testing.assert_allclose(got["z"], states[t].admm.shared_se3.numpy(), rtol=1e-6,
                                   atol=1e-9)
        np.testing.assert_allclose(got["delta"], states[t].admm.delta_se3.numpy(), rtol=1e-6,
                                   atol=1e-9)


def test_trainer_over_ranks_matches_one_process(ranks):
    """The tiny city (2 tiles, H = 2^15 windowed, unfused decoder, rho
    100, 2 rounds of 2 steps with checkpoints, a prune, the occlusion
    refresh and evals at step 4) by ``Trainer`` on 4 ranks (tiles 2,
    table 2: each tile's table on 2 ranks) and in one process: the same
    files; the exports' tables within 1e-5 of their largest entry,
    decoders and cameras within 1e-5; the same occupancy grids;
    training.log's losses and admm_error.txt within 1e-4 relative
    (the sums are one owner's, but the all_reduce of the tiles' sums
    adds in another order)."""
    logdir = ranks["four"][0][2]["logdir"]
    assert [o[2]["local_ids"] for o in ranks["four"]] == [[0], [0], [1], [1]]
    o = dict(ranks["overrides"])
    o["TRAINING"] = dict(o["TRAINING"], TABLE_SHARDS=1)
    one = ttrainer.Trainer(default_config().deep_update(o), device="cpu")
    one.run()
    names = sorted(os.path.relpath(p, one.logdir) for p in glob.glob(
        os.path.join(one.logdir, "**", "*"), recursive=True))
    assert names == sorted(os.path.relpath(p, logdir) for p in glob.glob(
        os.path.join(logdir, "**", "*"), recursive=True))
    for t in (0, 1):
        a = tckpt.load_tile_export(os.path.join(one.logdir, f"tile-{t}"))
        b = tckpt.load_tile_export(os.path.join(logdir, f"tile-{t}"))
        assert a["hash_layout"] == b["hash_layout"] == "windowed"
        np.testing.assert_allclose(b["features"], a["features"],
                                   atol=1e-5 * np.abs(a["features"]).max())
        np.testing.assert_array_equal(b["occupied_grid"], a["occupied_grid"])
        for k in ("decoder_params", "c2ws"):
            np.testing.assert_allclose(b[k], a[k], atol=1e-5, err_msg=k)

    def numbers(path):
        import re

        return [float(x) for x in re.findall(r"[-+]?\d+\.\d+", open(path).read())]

    for f in ("admm_error.txt", "refined_camera.log"):
        np.testing.assert_allclose(numbers(os.path.join(logdir, f)),
                                   numbers(os.path.join(one.logdir, f)), rtol=1e-4, atol=1e-6)
    lines = [[ln for ln in open(os.path.join(d, "training.log")).read().splitlines()
              if "loss" in ln] for d in (logdir, one.logdir)]
    np.testing.assert_allclose([float(ln.split("\t")[1][5:]) for ln in lines[0]],
                               [float(ln.split("\t")[1][5:]) for ln in lines[1]], rtol=1e-4)
