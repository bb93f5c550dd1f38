"""Occupancy pruning of the port (scanerf_tpu_torch/models/
occupancy.py) held against the JAX package on the CPU, cheapest first:
``PruningSchedule`` answers over a step range (the multi-rung jump and
the round window of tests/test_occupancy.py:152), the density query
``field_inference_sigma`` in both layouts, and ``prune_occupancy``'s
grids (the global hash at 2^10, the windowed layout at 2^14; one and two
splits). The JAX references run under ``jax.jit``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scanerf_tpu.models import field as jfield
from scanerf_tpu.models import occupancy as jocc
from scanerf_tpu_torch.models import field as tfield
from scanerf_tpu_torch.models import occupancy as tocc
from scanerf_tpu_torch.ops.kernels import hash_encode as thw
from test_torch_hash_global import port_field


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread while these tests run (the suite runs on
    several workers at once), and the worker's setting back after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("ladder", [
    ([4, 5, 6, 7, 8, 9], [0.1, 0.2, 0.3, 0.4], 2000, 40000, 300),
    ([4], [0.1], 2000, 40000, 300),
    ([6, 7], [0.1], 50, 100, 25),
    ([5, 6], [0.05, 0.2], 1000, None, 16),
])
def test_pruning_schedule_matches_jax(ladder):
    """``should_prune`` at every round boundary of 0-40,000 steps and
    ``next_at`` at every event the JAX schedule fires (the ladder's
    multi-rung jumps included), in the same order on both schedules."""
    dims, ths, adjust, total, syn = ladder
    j = jocc.PruningSchedule(dims, ths, adjust, total_step=total)
    t = tocc.PruningSchedule(dims, ths, adjust, total_step=total)
    events = 0
    for step in range(0, 40001, syn):
        fire = j.should_prune(step, round_size=syn)
        assert fire == t.should_prune(step, round_size=syn), step
        assert j.params_at(step) == t.params_at(step), step
        if fire:
            events += 1
            assert j.next_at(step) == t.next_at(step), step
    assert events > 0 or total == 100
    assert j.next_at(5000) == t.next_at(5000)


def _fields(log2_h, seed, grid=None):
    jp, js = jfield.create_field(jax.random.PRNGKey(seed), bbox_corner=np.array([-1.0] * 3),
                                 bbox_size=np.array([2.0, 2.0, 2.0]),
                                 log2_hashmap_size=log2_h, grid_resolution=(16, 256),
                                 sampler_log2dim=3, occupied_grid=grid)
    # tables scaled up, so that densities spread over the cells
    jp = jp.replace(features=jp.features * 300.0)
    return jp, js, *port_field(jp, js)


@pytest.mark.parametrize("backend,log2_h", [("xla", 10), ("windowed", 14)])
def test_field_inference_sigma_matches_jax(backend, log2_h):
    """``field_inference_sigma`` of 400 points of the inner box at step
    2500 within 1e-5 relative of the JAX query; for the windowed layout
    the sorted-stream composition the card runs (``hash_encode_windowed``:
    sort_pack, the lookup, unsort, each in its plain version here) equals
    the gather it replaces within 1e-6."""
    jp, js, tp, ts = _fields(log2_h, seed=1)
    pts = np.random.RandomState(2).uniform(-1, 1, (20, 20, 3)).astype(np.float32)
    ref = jax.jit(jfield.field_inference_sigma, static_argnames="backend")(
        jp, js, jnp.asarray(pts), jnp.float32(2500.0), backend=backend)
    out = tfield.field_inference_sigma(tp, ts, torch.from_numpy(pts), torch.tensor(2500.0),
                                       backend=backend)
    assert out.shape == (20, 20, 1)
    np.testing.assert_allclose(np.asarray(ref), out.numpy(), rtol=1e-5, atol=1e-7)
    if backend == "windowed":
        x = torch.from_numpy(pts.reshape(-1, 3))
        np.testing.assert_allclose(
            thw.hash_encode_windowed_ref(x, tp.features, ts.resolutions).numpy(),
            thw.hash_encode_windowed(x, tp.features, ts.resolutions).numpy(), atol=1e-6)


@pytest.mark.parametrize("backend,log2_h,sub_split", [
    ("xla", 10, 1), ("windowed", 14, 1), ("windowed", 14, 2)])
def test_prune_occupancy_matches_jax(backend, log2_h, sub_split):
    """``prune_occupancy`` from a half-occupied 8^3 grid, split once or
    twice, in chunks of 512 cells, at a threshold in the widest gap
    between the cells' largest alphas from the 10th to the 90th
    percentile: the port's grid equals the JAX grid cell for cell. Every
    cell's alpha (``cell_max_alpha``) lies more than 2e-6 off the
    threshold, beyond the two queries' agreement (at most 1e-6 in a
    development probe of these cases)."""
    grid = np.random.RandomState(3).rand(8, 8, 8) < 0.5
    jp, js, tp, ts = _fields(log2_h, seed=4, grid=grid)
    finest = np.asarray(js.resolutions[-1])
    _, res, alpha = tocc.cell_max_alpha(tp, ts, 2500, finest, sub_split, chunk_cells=512,
                                        backend=backend)
    a = np.sort(alpha)
    mid = slice(len(a) // 10, 9 * len(a) // 10)
    gaps = np.diff(a[mid])
    k = int(np.argmax(gaps))
    assert gaps[k] > 4e-6, gaps[k]
    th = float((a[mid][k] + a[mid][k + 1]) / 2)
    ref = jocc.prune_occupancy(jp, js, 2500, finest, sub_split, th, chunk_cells=512,
                               backend=backend)
    out = tocc.prune_occupancy(tp, ts, 2500, finest, sub_split, th, chunk_cells=512,
                               backend=backend)
    want = np.asarray(ref.occupied_grid)
    assert want.shape == tuple(res) == (8 * 2**sub_split,) * 3
    assert 0 < want.sum() < grid.sum() * 8**sub_split
    np.testing.assert_array_equal(want, out.occupied_grid.numpy())
