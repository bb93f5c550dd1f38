"""ADMM pose consensus over the tiles of one card (counterpart of
``scanerf_tpu/parallel/consensus.py``).

The JAX package runs one consensus round as a ``psum`` pair over the
``tiles`` axis of its device mesh. On one H100 every tile lives on the
card, so the collective becomes a plain sum over the local tiles: each
tile scatters its confidence-weighted ``se3_refine`` into a table
indexed by global camera id (``cam_map``, -1 padded), the z-update is
the weighted mean per camera, cameras held by more than one tile form
the overlap set, each tile gathers its slice of z back and takes the
over-relaxed dual update ``u += 1.5 (x - z)``; the primal residual is
the mean over tiles of mean |x - z| over a tile's cameras x 6, the dual
residual the mean |z_new - z_old| over all global cameras x 6.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class ConsensusAux:
    primal_residual: torch.Tensor  # scalar
    dual_residual: torch.Tensor  # scalar
    num_overlap: torch.Tensor  # scalar int32


def consensus_update(se3_refine, confidence, cam_map, shared_se3_old, delta_se3, rho,
                     n_global: int):
    """One consensus round over the tiles stacked on the leading axis:
    se3_refine [T, M, 6], confidence [T, M], cam_map [T, M] (global ids,
    -1 padding), the previous z ``shared_se3_old`` [T, M, 6] and the
    scaled dual ``delta_se3`` [T, M, 6]. ``rho`` [6] is carried for the
    JAX signature (the penalty uses it, not the update). Returns
    (shared_se3 [T, M, 6], new delta [T, M, 6], overlap flags [T, M],
    ConsensusAux)."""
    batch_shape = cam_map.shape
    x = se3_refine.reshape(-1, 6)
    conf = confidence.reshape(-1)
    cmap = cam_map.reshape(-1)
    z_old = shared_se3_old.reshape(-1, 6)
    delta = delta_se3.reshape(-1, 6)

    member = (cmap >= 0).to(x.dtype)
    idx = cmap.clamp(0, n_global - 1).to(torch.int64)
    w = conf * member
    sum_wx = torch.zeros((n_global, 6), dtype=x.dtype, device=x.device).index_add_(
        0, idx, x * w[:, None])
    sum_w = torch.zeros(n_global, dtype=x.dtype, device=x.device).index_add_(0, idx, w)
    count = torch.zeros(n_global, dtype=x.dtype, device=x.device).index_add_(0, idx, member)

    z_global = sum_wx / sum_w.clamp_min(1e-12)[:, None]
    z_local = z_global[idx] * member[:, None]
    overlap = (count > 1.0)[idx] & (cmap >= 0)
    new_delta = delta + 1.5 * (x - z_local)

    M = batch_shape[-1]
    n_tiles = x.shape[0] // M
    mem_t = member.reshape(n_tiles, M, 1)
    per_tile = ((x - z_local).abs().reshape(n_tiles, M, 6) * mem_t).sum(dim=(1, 2)) \
        / (mem_t.sum(dim=(1, 2)) * 6.0).clamp_min(1.0)
    primal = per_tile.sum() / float(n_tiles)
    z_old_sum = torch.zeros((n_global, 6), dtype=x.dtype, device=x.device).index_add_(
        0, idx, z_old * member[:, None])
    z_old_global = z_old_sum / count.clamp_min(1.0)[:, None]
    dual = (z_global - z_old_global).abs().mean()
    aux = ConsensusAux(primal_residual=primal, dual_residual=dual,
                       num_overlap=overlap.sum().to(torch.int32))
    return (z_local.reshape(*batch_shape, 6), new_delta.reshape(*batch_shape, 6),
            overlap.reshape(batch_shape), aux)
