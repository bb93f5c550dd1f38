"""Table parallelism: one tile's hash table sharded over a ``table`` axis
(counterpart of ``scanerf_tpu/parallel/table_parallel.py``).

The windowed layout splits each level's table into blocks of 32
windows, the sorted stream is block-aligned (every 1024-row chunk lies
inside one block) and block visits are monotone. So:

- the table, its gradient and both Adam moments shard along H into
  contiguous block ranges, ``1 / n`` of each on every rank;
- every rank builds the same (replicated) stream; ``localize_meta`` gives
  the chunks of another rank's blocks span 0, so B3 / B4 skip them and
  write zeros, and carries the global id of the shard's window 0 in the
  meta's 4th field (``wbase``), which B3 and B4 subtract from every
  window id (csrc/hash_encode.cu);
- each point's features come from exactly one rank, and one
  ``all_reduce`` combines them (``psum_one_owner``); the table gradient
  needs no collective (each rank owns its blocks), and the partial
  per-rank dL/du sums on the way back (``complete_on_backward``).

The sorts and the decoder stay replicated: the axis buys memory and
lookup balance, not sort throughput.
"""

from __future__ import annotations

import copy

import torch

from scanerf_tpu_torch.ops.kernels import hash_encode as hw
from scanerf_tpu_torch.parallel import mesh as mesh_lib
from scanerf_tpu_torch.parallel.mesh import Axis


def shard_features(features: torch.Tensor, axis: Axis | None) -> torch.Tensor:
    """This rank's H-shard of a table, flat [L, H*F] or [L, H, F]: whole
    H-row ranges, a contiguous copy (the table itself at size 1)."""
    return mesh_lib.local_slice(features, axis, 1)


def gather_features(local: torch.Tensor, axis: Axis | None) -> torch.Tensor:
    """The whole table from every rank's shard (exact: an all_reduce of
    zero-filled copies)."""
    return mesh_lib.gather_slices(local, axis, 1)


def localize_meta(meta: torch.Tensor, visited: torch.Tensor, dev_idx: int, nb_local: int):
    """A stream's meta [NC, SUBT, 4] and visited blocks [NB] restricted to
    the blocks [dev_idx * nb_local, (dev_idx + 1) * nb_local) -> (meta,
    visited) of the shard. Chunks outside the range get span 0 (the
    kernels skip them and write zeros) and a block-of-chunk clamped into
    range; every chunk carries the global id of the shard's window 0 in
    the 4th field (``wbase``), window ids stay global."""
    b0 = dev_idx * nb_local
    boc = meta[:, :, 0]
    owned = (boc >= b0) & (boc < b0 + nb_local)
    boc_loc = (boc - b0).clamp(0, nb_local - 1)
    span = torch.where(owned, meta[:, :, 2], torch.zeros_like(meta[:, :, 2]))
    wbase = torch.full_like(boc, b0 * hw.WB)
    meta_loc = torch.stack([boc_loc, meta[:, :, 1], span, wbase], dim=-1).contiguous()
    return meta_loc, visited[b0:b0 + nb_local]


class _PsumOneOwner(torch.autograd.Function):
    """Forward: the sum over the axis. Backward: the cotangent unchanged,
    exact because every row is produced by one rank (zeros elsewhere).
    ``torch.distributed.nn``'s all_reduce would sum the replicated
    cotangent again and scale the gradients by the axis size."""

    @staticmethod
    def forward(ctx, x, axis):
        return mesh_lib.all_reduce(x.clone(), axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CompleteOnBackward(torch.autograd.Function):
    """Forward: identity. Backward: the sum of the ranks' partial
    cotangents (each rank's dL/du covers its own chunks)."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return mesh_lib.all_reduce(g.clone(), ctx.axis), None


def psum_one_owner(x: torch.Tensor, axis: Axis | None) -> torch.Tensor:
    if axis is None or axis.size == 1:
        return x
    return _PsumOneOwner.apply(x, axis)


def complete_on_backward(x: torch.Tensor, axis: Axis | None) -> torch.Tensor:
    if axis is None or axis.size == 1:
        return x
    return _CompleteOnBackward.apply(x, axis)


def lookup_sharded(stream: hw.SortedStream, features_local: torch.Tensor, resolutions,
                   axis: Axis, bwd_bf16: bool = False) -> torch.Tensor:
    """The windowed lookup of a replicated stream over the table sharded
    on ``axis`` -> features [Np, L*2] in stream order, the same on every
    rank: the meta localized to this rank's blocks, B3 on its shard (B4
    behind it), the one-owner sum. Differentiable in the stream's points
    (complete dL/du on every rank) and in the shard."""
    H = hw.table_windows(features_local) * hw.W * axis.size
    _, NB, _ = hw.geometry(H)
    if NB % axis.size:
        raise ValueError(f"{NB} window blocks do not split {axis.size} ways")
    meta_loc, _ = localize_meta(stream.meta, stream.visited, axis.index, NB // axis.size)
    pts = complete_on_backward(stream.pts, axis)
    feats = hw.hash_lookup_sorted(pts, meta_loc, features_local, resolutions, bwd_bf16,
                                  shards=axis.size)
    return psum_one_owner(feats, axis)


def encode_table_parallel(x: torch.Tensor, dirs: torch.Tensor, features_local: torch.Tensor,
                          resolutions: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The windowed hash encode of points x [N, 3] in [-2, 2] (view dirs
    [N, 3] ride the stream) with the table sharded over ``axis``, each
    rank holding ``features_local`` (flat [L, H/n*2]) -> [N, L*2] in the
    points' order on every rank, differentiable in x and in the shard
    (whose gradient is the shard's)."""
    H = hw.table_windows(features_local) * hw.W * axis.size
    L = features_local.shape[0]
    stream = hw.sort_pack(x, dirs, H)
    feats = lookup_sharded(stream, features_local.reshape(L, -1), resolutions, axis)
    return hw.unsort_rows(feats, stream.pidp, x.shape[0])


def shard_state(state, axis):
    """``state`` (whole tables) cut in place to this rank's table shard on
    ``axis``: the table, and every optimizer state of the table's shape
    (Adam's moments, a sparse Adam's counts)."""
    full = state.params.field.features
    local = shard_features(full.detach(), axis).requires_grad_(
        full.requires_grad)
    for opt in state.optimizers():
        for group in opt.param_groups:
            group["params"] = [local if p is full else p for p in group["params"]]
        if full in opt.state:
            st = opt.state.pop(full)
            opt.state[local] = {k: (shard_features(v, axis)
                                    if getattr(v, "shape", None) == full.shape else v)
                                for k, v in st.items()}
    state.params.field.features = local
    return state


def gather_state(state, axis):
    """A whole-table copy of a table-sharded ``state`` (every rank of
    ``axis`` calls it; the table and its optimizer states are gathered
    one array at a time, exactly). Other arrays are shared with
    ``state``."""
    if axis is None or axis.size == 1:
        return state
    local = state.params.field.features
    full = gather_features(local.detach(), axis)
    out = copy.copy(state)
    out.params = copy.copy(state.params)
    out.params.field = copy.copy(state.params.field)
    out.params.field.features = full
    opts = []
    for opt in state.optimizers():
        new = copy.copy(opt)
        new.param_groups = [dict(g, params=[full if p is local else p for p in g["params"]])
                            for g in opt.param_groups]
        new.state = {(full if p is local else p): (
            {k: (gather_features(v, axis)
                 if getattr(v, "shape", None) == local.shape else v) for k, v in st.items()}
            if p is local else st) for p, st in opt.state.items()}
        opts.append(new)
    out.optimizer = opts[0]
    out.hash_optimizer = opts[1] if len(opts) > 1 else None
    return out
