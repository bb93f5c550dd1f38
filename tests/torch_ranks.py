"""Gloo ranks on the CPU for the port's multi-device tests
(tests/test_torch_table_parallel.py, test_torch_ray_parallel.py,
test_torch_multi.py).

``run(world, jobs)`` starts ``world`` processes that join one gloo group
over localhost, each runs the named jobs of this module in order, and
returns every rank's results, [rank][job]. The ranks import the port
only (no JAX), with one intra-op thread each; a rank that fails fails
the call with its traceback. The jobs' inputs are made from seeds, so
the tests build the same inputs in their own process.
"""

from __future__ import annotations

import os
import pickle
import socket
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run(world: int, jobs: list, timeout: float = 150.0) -> list:
    """Run ``jobs`` ([(name, kwargs)]) on ``world`` gloo ranks -> results
    [rank][job]. A start whose port another process took in the meantime
    is tried once more on a new port. ``timeout`` stays below
    TEST_LIMIT_S of the repo's conftest.py, so ranks that hang fail the test with this
    module's message before the limit ends the worker."""
    try:
        return _run(world, jobs, timeout)
    except RuntimeError as e:
        if "EADDRINUSE" not in str(e) and "address already in use" not in str(e).lower():
            raise
        return _run(world, jobs, timeout)


def _run(world: int, jobs: list, timeout: float) -> list:
    with tempfile.TemporaryDirectory() as tmp:
        with open(os.path.join(tmp, "jobs.pkl"), "wb") as f:
            pickle.dump(jobs, f)
        env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
                   PYTHONPATH=os.pathsep.join([ROOT, HERE, os.environ.get("PYTHONPATH", "")]))
        port = _free_port()
        errs = [open(os.path.join(tmp, f"err{r}.txt"), "w") for r in range(world)]
        procs = [subprocess.Popen(
            [sys.executable, os.path.join(HERE, "torch_ranks.py"), str(r), str(world), str(port),
             tmp], env=env, stdout=subprocess.DEVNULL, stderr=errs[r]) for r in range(world)]
        deadline = time.monotonic() + timeout
        hung = False
        try:
            codes = [p.wait(timeout=max(deadline - time.monotonic(), 0.0)) for p in procs]
        except subprocess.TimeoutExpired:
            hung = True
            codes = [p.poll() for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for f in errs:
                f.close()
        # the tails of the ranks that failed: with a hang, most often the cause
        if hung or any(codes):
            errs = "".join(open(os.path.join(tmp, f"err{r}.txt")).read()[-3000:]
                           for r, c in enumerate(codes) if c)
            if hung:
                raise RuntimeError(f"ranks still running after the {timeout:g} s limit (world "
                                   f"{world}, jobs {[name for name, _ in jobs]}, exit codes "
                                   f"{codes}, None still running):\n{errs}")
            raise RuntimeError(f"ranks exited {codes}:\n{errs}")
        out = []
        for r in range(world):
            with open(os.path.join(tmp, f"out{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out


def _np(t):
    return t.detach().cpu().numpy().copy()


# ---------------------------------------------------------------------------
# inputs, made alike in the ranks and in the tests
# ---------------------------------------------------------------------------

def encode_inputs(L=4, H=2**17, N=500, seed=0):
    """tests/test_table_parallel.py's shapes: a table [L, H*2], points in
    [-2, 2] [N, 3], view dirs [N, 3], resolutions [L, 3]."""
    rng = np.random.RandomState(seed)
    feats = (rng.randn(L, H * 2) * 0.1).astype(np.float32)
    x = rng.uniform(-2.0, 2.0, (N, 3)).astype(np.float32)
    dirs = rng.randn(N, 3).astype(np.float32)
    res = np.tile([[65, 129, 257]], (L, 1)).astype(np.int32)
    return x, dirs, feats, res


def tiny_tile(tc, seed=0, n_cam=2, hw=16, log2_hashmap_size=15):
    """A tile of the sphere scene on the CPU: (state, data), the field
    from ``seed`` (the whole table: ``create_train_state`` with a table
    axis cuts it)."""
    import torch

    from scanerf_tpu_torch.data.synthetic import make_sphere_dataset
    from scanerf_tpu_torch.models import field
    from scanerf_tpu_torch.train import cameras, tile

    imgs, depths, ks, c2ws = make_sphere_dataset(n_cam, hw, hw)
    params, fs = field.create_field(torch.Generator().manual_seed(seed), [-1.0] * 3, [2.0] * 3,
                                    log2_hashmap_size=log2_hashmap_size,
                                    grid_resolution=(8, 64), sampler_log2dim=3, device="cpu")
    data = tile.TileData(images=torch.from_numpy(imgs),
                         occlusions=torch.ones(imgs.shape[:3], dtype=torch.bool),
                         cameras=cameras.make_cameras(torch.from_numpy(ks),
                                                      torch.from_numpy(c2ws)),
                         mono_depths=torch.from_numpy(depths),
                         mono_normals=torch.zeros((*imgs.shape[:3], 3)))
    return params, fs, data


def batch(tc, n_cam=2, hw=16, seed=0):
    """(ray_idx, pixel_locs) of one batch drawn from ``seed``."""
    import torch

    from scanerf_tpu_torch.train import tile

    ray_idx, locs = tile.sample_patches(torch.Generator().manual_seed(seed), hw, hw,
                                        max((2**tc.batch_log2) // n_cam // 4, 1))
    return ray_idx, locs[None].expand(n_cam, *locs.shape)


def step_outputs(state, grads, aux) -> dict:
    """The numpy arrays a step check compares."""
    from scanerf_tpu_torch.models.decoder import pack_params

    p = state.params
    return {"features": _np(p.field.features), "decoder": _np(pack_params(p.field.decoder)),
            "se3": _np(p.se3_refine), "aux": {k: _np(v) for k, v in aux.items()},
            "grads": {k: [_np(g) for g in v] for k, v in grads.items()} if grads else None}


# ---------------------------------------------------------------------------
# jobs: each takes (mesh_lib, rank, world, **kwargs)
# ---------------------------------------------------------------------------

def job_encode(M, rank, world, **kw):
    """The table-sharded encode over every rank: values, dL/dx and this
    rank's table-gradient shard of sum(out^2)."""
    import torch

    from scanerf_tpu_torch.parallel import table_parallel as tp

    x, dirs, feats, res = (torch.from_numpy(a) for a in encode_inputs(**kw))
    axis = M.make_mesh({"table": world}).axis("table")
    local = tp.shard_features(feats, axis).requires_grad_()
    xs = x.clone().requires_grad_()
    out = tp.encode_table_parallel(xs, dirs, local, res, axis)
    (out * out).sum().backward()
    return {"out": _np(out), "gx": _np(xs.grad), "gf": _np(local.grad)}


def job_table_step(M, rank, world, tc_kw, batch_seed=5):
    """One table-sharded step (table axis over every rank) on an injected
    batch: the grads (the table's shard), then the update."""
    from scanerf_tpu_torch.train import tile

    tc = tile.TrainConfig(**tc_kw, table_shards=world)
    axis = M.make_mesh({"table": world}).axis("table")
    params, fs, data = tiny_tile(tc)
    state = tile.create_train_state(params, fs, 2, tc, device="cpu", table_axis=axis)
    ray_idx, locs = batch(tc, seed=batch_seed)
    (_, aux), grads = tile.compute_grads(state, data, tc, ray_idx=ray_idx, pixel_locs=locs,
                                         table_axis=axis)
    tile.apply_gradients(state, grads, tc)
    return step_outputs(state, grads, aux)


def job_dp_step(M, rank, world, tc_kw, n_table=1, log2=15, seed=3):
    """One ray-data-parallel step (``build_dp_step``; ``n_table`` > 1: the
    (rays, table) mesh) from a whole state cut by ``shard_dp``, each rays
    replica drawing from its own ``batch_generator``."""
    from scanerf_tpu_torch.parallel import ray_parallel as rp
    from scanerf_tpu_torch.train import tile

    mesh = rp.make_ray_mesh(n_table=n_table)
    tc = tile.TrainConfig(**tc_kw, ray_shards=mesh.size("rays"), table_shards=n_table)
    params, fs, data = tiny_tile(tc, log2_hashmap_size=log2)
    state = tile.create_train_state(params, fs, 2, tile.TrainConfig(**tc_kw), device="cpu")
    state, data = rp.shard_dp(mesh, state, data)
    specs = rp.state_specs(state, mesh)
    state, aux = rp.build_dp_step(mesh, tc)(state, data, tile.batch_generator(seed, mesh))
    out = step_outputs(state, None, aux)
    out["sharded_keys"] = sorted(k for k, v in specs.items() if v == "table")
    return out


def job_consensus(M, rank, world, arrays, n_global):
    """``consensus_update`` over a ``tiles`` axis of every rank, each rank
    holding its contiguous share of the tiles."""
    import torch

    from scanerf_tpu_torch.parallel import consensus

    axis = M.make_mesh({"tiles": world}).axis("tiles")
    T = arrays["cam_map"].shape[0]
    k = T // world
    mine = {n: torch.from_numpy(a[rank * k:(rank + 1) * k]) for n, a in arrays.items()
            if n != "rho"}
    z, delta, overlap, aux = consensus.consensus_update(
        mine["se3"], mine["conf"], mine["cam_map"], mine["z_old"], mine["delta"],
        torch.from_numpy(arrays["rho"]), n_global, axis=axis)
    return {"z": _np(z), "delta": _np(delta), "overlap": _np(overlap),
            "primal": float(aux.primal_residual), "dual": float(aux.dual_residual),
            "n_ovl": int(aux.num_overlap)}


def admm_tiles(tc, n_tiles=2, log2=15):
    """``n_tiles`` tiles of the sphere scene (tile t from seed t), sharing
    camera 0 of 3 global ones: (states, datas, cam_maps)."""
    from scanerf_tpu_torch.parallel import tile_parallel as tp
    from scanerf_tpu_torch.train import tile

    states, datas = [], []
    for t in range(n_tiles):
        params, fs, data = tiny_tile(tc, seed=t, log2_hashmap_size=log2)
        states.append(tile.create_train_state(params, fs, 2, tc, device="cpu"))
        datas.append(data)
    return states, datas, tp.make_cam_maps([[0, 1], [0, 2]][:n_tiles], 2)


def job_admm_round(M, rank, world, tc_kw, n_table=1, n_rays=1, log2=15, n_inner=1, seed=7):
    """One ``build_admm_round`` over (tiles, rays, table) from whole tiles
    cut by ``shard_parallel``: the rank's tiles' params, ADMM state and
    losses, and the consensus aux."""
    import dataclasses

    from scanerf_tpu_torch.parallel import tile_parallel as tp
    from scanerf_tpu_torch.train import tile

    mesh = tp.make_tile_mesh(n_table=n_table, n_rays=n_rays)
    tc = tile.TrainConfig(**tc_kw)
    states, datas, cam_maps = admm_tiles(tc, log2=log2)
    tiles, datas = tp.shard_parallel(mesh, tp.stack_tiles(states, cam_maps), datas)
    tc = dataclasses.replace(tc, table_shards=n_table, ray_shards=n_rays)
    gens = [tile.batch_generator(seed, mesh, t) for t in tiles.tile_ids]
    losses, aux = tp.build_admm_round(mesh, tc, n_inner, 3)(tiles, datas, gens)
    return {"tile_ids": tiles.tile_ids, "losses": _np(losses),
            "states": [step_outputs(s, None, {}) | {"z": _np(s.admm.shared_se3),
                                                    "delta": _np(s.admm.delta_se3)}
                       for s in tiles.states],
            "primal": float(aux.primal_residual), "dual": float(aux.dual_residual)}


def job_render(M, rank, world, scene_kw, rays_kw, render_kw):
    """``render_rays_sharded`` of a chunk and ``render_image(sharded=True)``
    over a ``rays`` axis of every rank, each backend."""
    import torch

    from scanerf_tpu_torch.render import renderer

    scene = renderer.scene_from_arrays(**scene_kw, device="cpu")
    mesh = M.make_mesh({"rays": world})
    o, d = (torch.from_numpy(a) for a in rays_kw["rays"])
    out = {}
    for backend in ("windowed", "xla"):
        r = renderer.render_rays_sharded(scene, o, d, mesh, device="cpu", backend=backend,
                                         **render_kw)
        out[backend] = {k: _np(v) for k, v in r.items()}
        out[backend + "_image"] = renderer.render_image(
            scene, rays_kw["K"], rays_kw["c2w"], rays_kw["H"], rays_kw["W"],
            chunk=rays_kw["chunk"], sharded=True, device="cpu", backend=backend, **render_kw)
    return out


def job_trainer(M, rank, world, cfg_overrides):
    """``Trainer(cfg).run()`` over every rank -> its logdir (rank 0's)."""
    from scanerf_tpu_torch.config import default_config
    from scanerf_tpu_torch.train.trainer import Trainer

    tr = Trainer(default_config().deep_update(cfg_overrides), device="cpu")
    tr.run()
    M.barrier()
    return {"logdir": tr.logdir, "local_ids": tr.local_ids}


def _main():
    rank, world, port, tmp = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    import torch

    torch.set_num_threads(1)
    from scanerf_tpu_torch.parallel import mesh as M

    M.init_ranks("gloo", rank, world, f"tcp://127.0.0.1:{port}")
    with open(os.path.join(tmp, "jobs.pkl"), "rb") as f:
        jobs = pickle.load(f)
    try:
        out = [globals()[f"job_{name}"](M, rank, world, **kw) for name, kw in jobs]
    except Exception:
        traceback.print_exc()
        sys.exit(1)
    with open(os.path.join(tmp, f"out{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    _main()
