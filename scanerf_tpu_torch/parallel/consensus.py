"""ADMM pose consensus over the tiles of every rank (counterpart of
``scanerf_tpu/parallel/consensus.py``).

The JAX package runs one consensus round as ``psum``s over the ``tiles``
axis of its device mesh; the port sums its local tiles (the tiles stacked
on a rank's leading axis) and all_reduces the sums over the ``tiles``
axis's group, the same quantities the JAX code psums: each tile scatters
its confidence-weighted ``se3_refine`` into a table indexed by global
camera id (``cam_map``, -1 padded), the z-update is the weighted mean
per camera, cameras held by more than one tile form the overlap set,
each tile gathers its slice of z back and takes the over-relaxed dual
update ``u += 1.5 (x - z)``; the primal residual is the mean over tiles
of mean |x - z| over a tile's cameras x 6, the dual residual the mean
|z_new - z_old| over all global cameras x 6. A tile whose ``cam_map``
row is all -1 (the padding of a tile count to the ``tiles`` axis) adds
nothing and is not counted among the tiles; the JAX function counts it
in the primal residual's mean.
"""

from __future__ import annotations

import dataclasses

import torch

from scanerf_tpu_torch.parallel import mesh as mesh_lib


@dataclasses.dataclass
class ConsensusAux:
    primal_residual: torch.Tensor  # scalar
    dual_residual: torch.Tensor  # scalar
    num_overlap: torch.Tensor  # scalar int32


def consensus_update(se3_refine, confidence, cam_map, shared_se3_old, delta_se3, rho,
                     n_global: int, axis=None):
    """One consensus round over the tiles stacked on the leading axis:
    se3_refine [T, M, 6], confidence [T, M], cam_map [T, M] (global ids,
    -1 padding), the previous z ``shared_se3_old`` [T, M, 6] and the
    scaled dual ``delta_se3`` [T, M, 6]. ``rho`` [6] is carried for the
    JAX signature (the penalty uses it, not the update). With ``axis``
    (the mesh's ``tiles`` axis) the round covers the tiles of every rank
    on it. Returns (shared_se3 [T, M, 6], new delta [T, M, 6], overlap
    flags [T, M], ConsensusAux), the aux the same on every rank."""
    batch_shape = cam_map.shape
    x = se3_refine.reshape(-1, 6)
    conf = confidence.reshape(-1)
    cmap = cam_map.reshape(-1)
    z_old = shared_se3_old.reshape(-1, 6)
    delta = delta_se3.reshape(-1, 6)

    member = (cmap >= 0).to(x.dtype)
    idx = cmap.clamp(0, n_global - 1).to(torch.int64)
    w = conf * member
    # sum_wx, sum_w, count and the previous z's sum: one [G, 14] all_reduce
    sums = torch.zeros((n_global, 14), dtype=x.dtype, device=x.device).index_add_(
        0, idx, torch.cat([x * w[:, None], w[:, None], member[:, None],
                           z_old * member[:, None]], dim=1))
    sums = mesh_lib.all_reduce(sums, axis)
    sum_wx, sum_w, count, z_old_sum = sums[:, 0:6], sums[:, 6], sums[:, 7], sums[:, 8:14]

    z_global = sum_wx / sum_w.clamp_min(1e-12)[:, None]
    z_local = z_global[idx] * member[:, None]
    overlap = (count > 1.0)[idx] & (cmap >= 0)
    new_delta = delta + 1.5 * (x - z_local)

    M = batch_shape[-1]
    n_local = x.shape[0] // M
    mem_t = member.reshape(n_local, M, 1)
    per_tile = ((x - z_local).abs().reshape(n_local, M, 6) * mem_t).sum(dim=(1, 2)) \
        / (mem_t.sum(dim=(1, 2)) * 6.0).clamp_min(1.0)
    # the tiles, the primal sum and the overlap flags over the axis
    tot = mesh_lib.all_reduce(torch.stack([
        (mem_t.sum(dim=(1, 2)) > 0).sum().to(x.dtype), per_tile.sum(),
        overlap.sum().to(x.dtype)]), axis)
    primal = tot[1] / tot[0].clamp_min(1.0)
    z_old_global = z_old_sum / count.clamp_min(1.0)[:, None]
    dual = (z_global - z_old_global).abs().mean()
    aux = ConsensusAux(primal_residual=primal, dual_residual=dual,
                       num_overlap=tot[2].to(torch.int32))
    return (z_local.reshape(*batch_shape, 6), new_delta.reshape(*batch_shape, 6),
            overlap.reshape(batch_shape), aux)
