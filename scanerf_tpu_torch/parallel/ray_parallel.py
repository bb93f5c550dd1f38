"""Ray data parallelism: one tile's batch over a ``rays`` axis (counterpart
of ``scanerf_tpu/parallel/ray_parallel.py``).

Every rank on the ``rays`` axis holds a replica of the tile's state,
draws an independent batch of ``2**batch_log2`` rays from its own
generator (``tile.batch_generator``: the seed and the rank's rays
index, where the JAX step folds its key), and the gradients (and the aux
metrics) are averaged over the axis before the replica-identical update,
so the effective batch is ``n_rays * 2**batch_log2`` and the replicas
stay equal without any parameter collective.

Each rank's loss is its own masked mean, so the objective is the mean of
the ranks' means: the global masked mean when the ranks carry equal
valid counts (uniform patches), a fixed reweighting otherwise.

With ``make_ray_mesh(n_table=...)`` the mesh is ``(rays, table)``: the
table and its moments shard over ``table`` (the windowed lookup sums the
features over it, models/field.py) and the rest is replicated over
``rays``; the gradient mean rides ``rays`` only, so a table gradient
stays the shard's.
"""

from __future__ import annotations

from scanerf_tpu_torch.parallel import mesh as mesh_lib
from scanerf_tpu_torch.parallel import table_parallel
from scanerf_tpu_torch.train import tile as tile_lib


def make_ray_mesh(n_table: int = 1, backend: str | None = None) -> mesh_lib.Mesh:
    """A ``rays`` mesh over the joined ranks, or ``(rays, table)`` with
    ``n_table`` > 1 (which must divide the world)."""
    _, n = mesh_lib.world()
    if n % n_table:
        raise ValueError(f"{n_table} table shards do not divide {n} ranks")
    shape = {"rays": n // n_table}
    if n_table > 1:
        shape["table"] = n_table
    return mesh_lib.make_mesh(shape, backend)


def _table_keys(like: dict, feat_shape) -> list:
    return [k for k, t in like.items() if tuple(t.shape) == tuple(feat_shape)]


def state_specs(state: tile_lib.TrainState, mesh: mesh_lib.Mesh) -> dict:
    """Which arrays of ``state`` (under their checkpoint keys,
    ``convert.state_like``) are sharded: ``"table"`` for the table and
    its Adam moments (matched by the table's exact shape, as the JAX
    function matches) when the mesh has that axis, None for the rest
    (replicated)."""
    from scanerf_tpu_torch import convert

    like = convert.state_like(state)
    sharded = set(_table_keys(like, state.params.field.features.shape)) \
        if mesh.axis("table") is not None else set()
    return {k: ("table" if k in sharded else None) for k in like}


def shard_dp(mesh: mesh_lib.Mesh, state: tile_lib.TrainState, data: tile_lib.TileData):
    """This rank's part of a whole state and its data: the table and its
    Adam moments cut to the rank's shard on the ``table`` axis (when the
    mesh has one), everything else kept whole (each rank holds its own
    replica, built from the same seed). ``state`` is changed in place and
    returned with ``data``."""
    axis = mesh.axis("table")
    if axis is None:
        return state, data
    return table_parallel.shard_state(state, axis), data


def build_dp_step(mesh: mesh_lib.Mesh, tc: tile_lib.TrainConfig):
    """The ray-data-parallel step: ``step_fn(state, data, generator) ->
    (state, aux)``, ``tile.train_step`` with the gradient mean over the
    mesh's ``rays`` axis (and the table over its ``table`` axis), drawing
    this rank's batch from ``generator`` (``tile.batch_generator``)."""
    rays, table = mesh.axis("rays"), mesh.axis("table")
    if tc.ray_shards != mesh.size("rays"):
        raise ValueError(f"ray_shards {tc.ray_shards} against a rays axis of "
                         f"{mesh.size('rays')}")
    if tc.table_shards != mesh.size("table"):
        raise ValueError(f"table_shards {tc.table_shards} against a table axis of "
                         f"{mesh.size('table')}")

    def step_fn(state, data, generator, **kw):
        return tile_lib.train_step(state, data, tc, generator, grad_axis=rays,
                                   table_axis=table, device=state.params.field.features.device,
                                   **kw)

    return step_fn
