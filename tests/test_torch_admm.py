"""ADMM on one card (scanerf_tpu_torch/parallel/) held against the JAX
package on the CPU, cheapest first: ``make_cam_maps``; a JAX
``ParallelTiles`` carried across by ``convert.parallel_tiles``;
``consensus_update`` -- a plain sum over the tiles on the card --
against the JAX collective under ``shard_map`` on the suite's virtual
CPU devices (tests/conftest.py), with two tiles a device; and one port
round (``admm_round``) equal, bit for bit, to each tile's
``train_step``s followed by one ``consensus_update``."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from scanerf_tpu.models import field as jfield
from scanerf_tpu.parallel import consensus as jcons
from scanerf_tpu.parallel import tile_parallel as jtp
from scanerf_tpu.train import tile as jtile
from scanerf_tpu_torch import convert
from scanerf_tpu_torch.data import synthetic as tsyn
from scanerf_tpu_torch.models import field as tfield
from scanerf_tpu_torch.parallel import consensus as tcons
from scanerf_tpu_torch.parallel import tile_parallel as ttp
from scanerf_tpu_torch.train import cameras as tcam
from scanerf_tpu_torch.train import tile as ttile

T_TILES, M_CAMS, N_GLOBAL = 8, 5, 12


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread while these tests run (the suite runs on
    several workers at once), and the worker's setting back after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_make_cam_maps_matches_jax():
    """Unequal view lists, one longer than the cap, one empty."""
    lists = [[3, 1, 4], [1, 5, 9, 2, 6, 5, 3], [], [7]]
    np.testing.assert_array_equal(jtp.make_cam_maps(lists, 5), ttp.make_cam_maps(lists, 5))


@pytest.fixture(scope="module")
def jax_tiles():
    return _jax_parallel_tiles()


def _jax_parallel_tiles(seed=0):
    """T stacked JAX states (2^10 tables) with random poses, ADMM state
    and confidences, and cam maps whose cameras overlap between tiles."""
    rng = np.random.RandomState(seed)
    jp, js = jfield.create_field(jax.random.PRNGKey(seed), bbox_corner=np.array([-1.0] * 3),
                                 bbox_size=np.array([2.0] * 3), log2_hashmap_size=10,
                                 grid_resolution=(16, 256), sampler_log2dim=3)
    st = jtile.create_train_state(jp, js, M_CAMS, jtile.TrainConfig(rho=100.0))
    views = [sorted(rng.choice(N_GLOBAL, rng.randint(2, M_CAMS + 1), replace=False))
             for _ in range(T_TILES)]
    tiles = jtp.stack_tiles([st] * T_TILES, jtp.make_cam_maps(views, M_CAMS))

    def rand(*shape):
        return jnp.asarray(rng.randn(*shape) * 0.01, jnp.float32)

    state = tiles.state.replace(
        params=tiles.state.params.replace(se3_refine=rand(T_TILES, M_CAMS, 6)),
        admm=tiles.state.admm.replace(shared_se3=rand(T_TILES, M_CAMS, 6),
                                      delta_se3=rand(T_TILES, M_CAMS, 6)))
    conf = jnp.asarray(rng.uniform(0.5, 1.0, (T_TILES, M_CAMS)), jnp.float32)
    return tiles.replace(state=state, confidence=conf)


def test_parallel_tiles_carries_every_tile(jax_tiles):
    """``convert.parallel_tiles``: tile t of the port's list holds the JAX
    stack's slice t in every checkpoint array."""
    jt = jax_tiles
    states, cam_map, conf = convert.parallel_tiles(jt, device="cpu")
    assert len(states) == T_TILES
    np.testing.assert_array_equal(np.asarray(jt.cam_map), cam_map.numpy())
    np.testing.assert_array_equal(np.asarray(jt.confidence), conf.numpy())
    for t in (0, T_TILES - 1):
        one = convert.train_state(jax.tree_util.tree_map(lambda x: x[t], jt.state),
                                  device="cpu")
        a, b = convert.state_tensors(one), convert.state_tensors(states[t])
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), k


def test_consensus_update_matches_jax_shard_map(jax_tiles):
    """The port's ``consensus_update`` over 8 tiles against the JAX one
    under ``shard_map`` over 4 virtual devices (2 tiles a device), both
    from one ParallelTiles: z and the dual within 1e-6 relative to their
    largest entry, the overlap flags and count equal, both residuals
    within 1e-6 relative (f32 sums in other orders)."""
    jt = jax_tiles
    mesh = jtp.make_tile_mesh(jax.devices()[:4])
    s = jt.state

    def fn(se3, conf, cam_map, z_old, delta):
        return jcons.consensus_update(se3, conf, cam_map, z_old, delta, jnp.ones(6),
                                      N_GLOBAL, axis_name="tiles")

    spec = P("tiles")
    jz, jdelta, jov, jaux = jax.jit(jax.shard_map(
        fn, mesh=mesh, in_specs=(spec,) * 5, out_specs=(spec, spec, spec, P())))(
        s.params.se3_refine, jt.confidence, jt.cam_map, s.admm.shared_se3, s.admm.delta_se3)
    states, cam_map, conf = convert.parallel_tiles(jt, device="cpu")
    z, delta, ov, aux = tcons.consensus_update(
        torch.stack([t.params.se3_refine for t in states]), conf, cam_map,
        torch.stack([t.admm.shared_se3 for t in states]),
        torch.stack([t.admm.delta_se3 for t in states]), states[0].admm.rho, N_GLOBAL)
    for ref, got in ((jz, z), (jdelta, delta)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(ref, got.numpy(), atol=1e-6 * np.abs(ref).max())
    np.testing.assert_array_equal(np.asarray(jov), ov.numpy())
    assert int(jaux.num_overlap) == int(aux.num_overlap) > 0
    for k in ("primal_residual", "dual_residual"):
        np.testing.assert_allclose(float(getattr(jaux, k)), float(getattr(aux, k)),
                                   rtol=1e-6, err_msg=k)


def test_admm_round_is_steps_then_consensus():
    """``admm_round`` of 2 tiles x 2 steps on the CPU (rho 100, the
    tiles sharing cameras 0 and 1) equals each tile's two ``train_step``s
    from generators of the same seeds followed by one
    ``consensus_update``: every array of both tile states and the losses
    and residuals bit for bit."""
    imgs, depths, ks, c2ws = tsyn.make_sphere_dataset(3, 16, 16)
    tc = ttile.TrainConfig(num_sample=8, num_bg_sample=4, batch_log2=6, num_march=32,
                           rho=100.0)

    def tile(seed):
        p, fs = tfield.create_field(torch.Generator().manual_seed(seed), [-1.0] * 3,
                                    [2.0] * 3, log2_hashmap_size=10,
                                    grid_resolution=(16, 256), device="cpu")
        return ttile.create_train_state(p, fs, 3, tc, device="cpu")

    data = ttile.TileData(images=torch.from_numpy(imgs),
                          occlusions=torch.ones(imgs.shape[:3], dtype=torch.bool),
                          cameras=tcam.make_cameras(torch.from_numpy(ks),
                                                    torch.from_numpy(c2ws)),
                          mono_depths=torch.from_numpy(depths),
                          mono_normals=torch.zeros(*imgs.shape[:3], 3))
    cam_map = torch.from_numpy(ttp.make_cam_maps([[0, 1, 2], [3, 0, 1]], 3))
    conf = torch.ones(2, 3)
    states = [tile(0), tile(1)]
    for s in states:
        s.params.se3_refine.normal_(0.0, 0.01, generator=torch.Generator().manual_seed(9))
    twins = copy.deepcopy(states)

    def gens():
        return [torch.Generator().manual_seed(100 + t) for t in range(2)]

    losses, aux = ttp.admm_round(states, [data, data], cam_map, conf, tc, 2, 4, gens(),
                                 device="cpu")
    last = []
    for s, g in zip(twins, gens()):
        for _ in range(2):
            s, a = ttile.train_step(s, data, tc, g, device="cpu")
        last.append(a["total_loss"])
    z, delta, ov, caux = tcons.consensus_update(
        torch.stack([s.params.se3_refine for s in twins]), conf, cam_map,
        torch.stack([s.admm.shared_se3 for s in twins]),
        torch.stack([s.admm.delta_se3 for s in twins]), twins[0].admm.rho, 4)
    for t, s in enumerate(twins):
        s.admm.shared_se3, s.admm.delta_se3, s.admm.overlap_flags = z[t], delta[t], ov[t]
    assert torch.equal(losses, torch.stack(last))
    assert float(aux.primal_residual) == float(caux.primal_residual) > 0
    assert float(aux.dual_residual) == float(caux.dual_residual)
    assert ov.sum() == 4 and states[0].step == 2
    for a, b in zip(states, twins):
        ta, tb = convert.state_tensors(a), convert.state_tensors(b)
        for k in ta:
            assert torch.equal(ta[k], tb[k]), k
