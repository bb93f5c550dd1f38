"""Tile parallelism on one card (counterpart of
``scanerf_tpu/parallel/tile_parallel.py``, its one-device half).

The JAX package stacks every tile's state on a leading axis and shards
it over a ``tiles`` mesh; one sync round is a ``shard_map`` of
``n_inner`` train steps per tile followed by the consensus collective.
On one H100 all tiles live on the card: the port keeps a list of tile
states and runs the round as a plain loop, tile after tile (as the
reference time-slices tiles on one GPU), each tile drawing its batches
from its own ``torch.Generator``; then one ``consensus_update`` over all
tiles, whose z, dual and overlap flags are written back into each
tile's ``AdmmState``. The per-camera confidence stays at 1, as the JAX
trainer builds its round with ``update_confidence=False``.

Meshes, sharded placement and table / ray sharding across cards wait
for ROADMAP.md queue A, item 'Multi-device and opt-in knobs'; asking
for them raises.
"""

from __future__ import annotations

import numpy as np
import torch

from scanerf_tpu_torch.parallel import consensus as consensus_lib
from scanerf_tpu_torch.train import tile as tile_lib

_MULTI_DEVICE = ("tile meshes, sharded placement and table / ray sharding are not "
                 "ported yet: ROADMAP.md queue A, item 'Multi-device and opt-in knobs'")


def make_tile_mesh(*args, **kwargs):
    raise NotImplementedError(_MULTI_DEVICE)


def shard_parallel(*args, **kwargs):
    raise NotImplementedError(_MULTI_DEVICE)


def make_cam_maps(tile_view_lists: list[list[int]], max_poses: int) -> np.ndarray:
    """Per-tile global camera ids packed into [T, max_poses] int32, -1
    padded (each list cut at ``max_poses``)."""
    out = np.full((len(tile_view_lists), max_poses), -1, np.int32)
    for t, views in enumerate(tile_view_lists):
        v = np.asarray(views[:max_poses], np.int32)
        out[t, :len(v)] = v
    return out


def admm_round(states: list, datas: list, cam_map: torch.Tensor, confidence: torch.Tensor,
               tc: tile_lib.TrainConfig, n_inner: int, n_global_cams: int,
               generators: list, device="cuda"):
    """One sync round, in place: ``n_inner`` ``train_step``s of each tile
    (its batches from ``generators[t]``), then ``consensus_update`` over
    all tiles (cam_map / confidence [T, M] on the tiles' device) written
    back into each tile's ADMM state -> (the last step's total loss of
    each tile [T], ConsensusAux)."""
    if tc.table_shards > 1 or tc.ray_shards > 1:
        raise NotImplementedError(_MULTI_DEVICE)
    losses = []
    for state, data, gen in zip(states, datas, generators):
        aux = None
        for _ in range(n_inner):
            state, aux = tile_lib.train_step(state, data, tc, gen, device=device)
        losses.append(aux["total_loss"] if aux is not None
                      else torch.zeros((), device=cam_map.device))
    z, delta, overlap, caux = consensus_lib.consensus_update(
        torch.stack([s.params.se3_refine for s in states]), confidence, cam_map,
        torch.stack([s.admm.shared_se3 for s in states]),
        torch.stack([s.admm.delta_se3 for s in states]), states[0].admm.rho, n_global_cams)
    for t, s in enumerate(states):
        s.admm.shared_se3 = z[t]
        s.admm.delta_se3 = delta[t]
        s.admm.overlap_flags = overlap[t]
    return torch.stack(losses), caux
