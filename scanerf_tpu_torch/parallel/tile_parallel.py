"""Tile parallelism: tiles spread over the ranks of a ``tiles`` axis
(counterpart of ``scanerf_tpu/parallel/tile_parallel.py``).

The JAX package stacks every tile's state on a leading axis and shards
it over a ``tiles`` mesh; one sync round is a ``shard_map`` of
``n_inner`` train steps per tile followed by the consensus collective.
The port keeps each rank's tiles in a list (``ParallelTiles``) and runs
a round as a loop, tile after tile (as the reference time-slices tiles
on one GPU), each tile drawing its batches from its own generator; then
one ``consensus_update`` over the tiles of every rank, its sums
all_reduced over the ``tiles`` axis, whose z, dual and overlap flags are
written back into each tile's ``AdmmState``. The per-camera confidence
stays at 1, as the JAX trainer builds its round with
``update_confidence=False``.

``make_tile_mesh`` adds to the ``tiles`` axis a ``rays`` axis (each
tile's batch over ranks: parallel/ray_parallel.py) and / or a ``table``
axis (each tile's table over ranks: parallel/table_parallel.py), in the
JAX order (tiles, rays, table). One process is the mesh of one rank.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from scanerf_tpu_torch.parallel import consensus as consensus_lib
from scanerf_tpu_torch.parallel import mesh as mesh_lib
from scanerf_tpu_torch.parallel import table_parallel
from scanerf_tpu_torch.train import tile as tile_lib


@dataclasses.dataclass
class ParallelTiles:
    """Tiles' training states (a rank's, or all of them) with their
    global camera ids ``cam_map`` [T, M] (-1 padding) and per-camera
    confidence [T, M] (1.0, as the JAX trainer keeps it), and the global
    index of each tile in the stack (``tile_ids`` [T])."""

    states: list
    cam_map: torch.Tensor
    confidence: torch.Tensor
    tile_ids: list


def stack_tiles(states: list, cam_maps: np.ndarray) -> ParallelTiles:
    """Every tile of the run, in order, with its cam map."""
    dev = states[0].params.field.features.device
    cam_map = torch.as_tensor(np.asarray(cam_maps), dtype=torch.int32, device=dev)
    return ParallelTiles(states=list(states), cam_map=cam_map,
                         confidence=torch.ones(cam_map.shape, device=dev),
                         tile_ids=list(range(len(states))))


def make_tile_mesh(n_table: int = 1, n_rays: int = 1, backend: str | None = None):
    """The ``tiles`` mesh over the joined ranks, extended by a ``rays``
    axis of ``n_rays`` and / or a ``table`` axis of ``n_table`` (the
    tiles axis takes the rest of the world)."""
    _, n = mesh_lib.world()
    if n % (n_table * n_rays):
        raise ValueError(f"{n_rays} x {n_table} ranks a tile do not divide {n} ranks")
    shape = {"tiles": n // (n_table * n_rays)}
    if n_rays > 1:
        shape["rays"] = n_rays
    if n_table > 1:
        shape["table"] = n_table
    return mesh_lib.make_mesh(shape, backend)


def state_specs(tiles: ParallelTiles, mesh) -> list:
    """Per tile, which arrays are sharded beyond the ``tiles`` axis (a
    tile lives on the ranks of its slot of the axis): the table and its
    moments over ``table`` when the mesh has it (``ray_parallel.state_specs``)."""
    from scanerf_tpu_torch.parallel import ray_parallel

    return [ray_parallel.state_specs(s, mesh) for s in tiles.states]


def local_tiles(mesh, n_tiles: int) -> list:
    """The global indices of the tiles on this rank's slot of the
    ``tiles`` axis (the axis divides ``n_tiles``)."""
    n = mesh.size("tiles")
    if n_tiles % n:
        raise ValueError(f"{n_tiles} tiles do not split over a tiles axis of {n}")
    k = n_tiles // n
    return list(range(mesh.index("tiles") * k, (mesh.index("tiles") + 1) * k))


def shard_parallel(mesh, tiles: ParallelTiles, datas: list):
    """This rank's tiles of a whole stack, and their data: the tiles of
    its slot on the ``tiles`` axis, each table (with its Adam moments)
    cut to the rank's shard on the ``table`` axis."""
    ids = local_tiles(mesh, len(tiles.states))
    axis = mesh.axis("table")
    states = [table_parallel.shard_state(tiles.states[t], axis) if axis else tiles.states[t]
              for t in ids]
    return (ParallelTiles(states=states, cam_map=tiles.cam_map[ids].contiguous(),
                          confidence=tiles.confidence[ids].contiguous(), tile_ids=ids),
            [datas[t] for t in ids])


def build_admm_round(mesh, tc: tile_lib.TrainConfig, n_inner: int, n_global_cams: int):
    """The sync round over ``mesh``: ``round_fn(tiles, datas, generators)
    -> (local losses [T_local], ConsensusAux)``, in place on this rank's
    ``tiles`` (``shard_parallel``): ``n_inner`` steps of each local tile
    in turn (the gradient mean over ``rays``, the table over ``table``),
    each drawing from its generator (``tile.batch_generator(seed, mesh,
    tile)``), then the consensus over the ``tiles`` axis. The confidence
    stays as it is (the JAX trainer's ``update_confidence=False``)."""
    for name, n in (("rays", tc.ray_shards), ("table", tc.table_shards)):
        if n != mesh.size(name):
            raise ValueError(f"{name} shards {n} against a {name} axis of {mesh.size(name)}")
    rays, table, tiles_axis = mesh.axis("rays"), mesh.axis("table"), mesh.axis("tiles")

    def round_fn(tiles: ParallelTiles, datas: list, generators: list):
        losses = []
        for state, data, gen in zip(tiles.states, datas, generators):
            aux = None
            for _ in range(n_inner):
                state, aux = tile_lib.train_step(
                    state, data, tc, gen, device=state.params.field.features.device,
                    grad_axis=rays, table_axis=table)
            losses.append(aux["total_loss"] if aux is not None
                          else torch.zeros((), device=tiles.cam_map.device))
        states = tiles.states
        z, delta, overlap, caux = consensus_lib.consensus_update(
            torch.stack([s.params.se3_refine for s in states]), tiles.confidence,
            tiles.cam_map, torch.stack([s.admm.shared_se3 for s in states]),
            torch.stack([s.admm.delta_se3 for s in states]), states[0].admm.rho,
            n_global_cams, axis=tiles_axis)
        for t, s in enumerate(states):
            s.admm.shared_se3 = z[t]
            s.admm.delta_se3 = delta[t]
            s.admm.overlap_flags = overlap[t]
        return torch.stack(losses), caux

    return round_fn


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
    """One sync round of the tiles of one process, in place: ``n_inner``
    ``train_step``s of each tile (its batches from ``generators[t]``),
    then ``consensus_update`` over all tiles (cam_map / confidence [T, M]
    on the tiles' device) written back into each tile's ADMM state ->
    (the last step's total loss of each tile [T], ConsensusAux): the
    round of ``build_admm_round`` on a mesh of one rank."""
    tile_lib._check_device(states[0].params.field.features, device)
    one_rank = mesh_lib.Mesh((mesh_lib.Axis("tiles", 1, 0),))
    tiles = ParallelTiles(states=states, cam_map=cam_map, confidence=confidence,
                          tile_ids=list(range(len(states))))
    return build_admm_round(one_rank, tc, n_inner, n_global_cams)(tiles, datas, generators)
