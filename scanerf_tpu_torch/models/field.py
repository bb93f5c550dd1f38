"""Per-tile neural field: hash tables + ShallowMLP + occupancy grid
(counterpart of ``scanerf_tpu/models/field.py``), for training.

Semantics kept from the JAX package: the tile bbox is doubled to hold a
background shell, whose inner half is the foreground; the fg contraction
maps the inner bbox to [-1, 1], the bg contraction is the L-infinity
mip360 squash over [-2, 2]; BARF anneals the 16 levels with
alpha(step) = clip(step / 10000 * 8 + 8, 0, 16); fg samples follow the
occupancy grid over the inner bbox, bg samples are inverse-z beyond the
doubled bbox, or, in BS mode, a window around the proxy mesh's depth
(``bg_z``). Invalid rays are masked, not compressed.

``render_rays`` runs one of two backends, resolved by
``effective_backend`` from the requested one and the table size:

- ``windowed`` (the production path): the fg and bg points of all rays
  form one sorted stream (``sort_pack``, B2), which the fused hash +
  decoder kernels decode (B5 forward, B6 backward; the default) or, with
  ``fused_decoder=False``, the hash lookup (B3 forward, B4 backward)
  followed by the ShallowMLP in PyTorch (``torch.matmul``, as the JAX
  package leaves it to XLA); only the 8 columns return to ray order.
- ``xla``, the global prime-XOR hash (``ops/hash_encode.py``) of tables
  under 2^14 entries or of ``backend="xla"``: the fg and bg passes
  (``render_fore_rays`` / ``render_bg_rays``) each encode their points
  and decode them in PyTorch, as the JAX package does in XLA.

The training knobs apply where the JAX package applies them:
``stochastic_grad`` (the stochastic-corner table gradient,
``hash_encode_stoch``) on the xla backend only, ``bwd_onehot_bf16`` (the
table gradient's contributions rounded to bf16 in B4's kernel) on the
windowed backend only; each backend ignores the other's. Sharded tables
(``table_shards`` > 1 with the ``table_axis`` they are sharded over, the
windowed backend only, as in the JAX package) hold one shard of the
table on each rank: the replicated stream is localized to the rank's
window blocks, B3 / B4 run on the shard, the features are summed over
the axis, and the unfused decoder follows, even where ``fused_decoder``
asks for B5 / B6 (``parallel/table_parallel.py``).

``field_inference_sigma`` is the density query of occupancy pruning, in
either layout; ``compute_normal`` and ``render_normals`` take its gradient
in the points for surface normals (on the card the windowed layout's
backward is B4 in its dL/du mode: the tables need no gradient).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from scanerf_tpu_torch import _device
from scanerf_tpu_torch.models import decoder as decoder_lib
from scanerf_tpu_torch.ops import hash_encode, integrate, sampling
from scanerf_tpu_torch.ops.kernels import fused_train as ft
from scanerf_tpu_torch.ops.kernels import hash_encode as hw
from scanerf_tpu_torch.parallel import table_parallel

N_LEVELS = 16
N_FEATURES = 2


@dataclasses.dataclass
class FieldParams:
    """Trainable per-tile parameters."""

    features: torch.Tensor  # flat [L, H*F] f32
    decoder: dict  # ShallowMLP params {layer: {"w": [in, out], "b": [out]}}


@dataclasses.dataclass
class FieldState:
    """Non-trainable per-tile field state."""

    resolutions: torch.Tensor  # [L, 3] int32 hash lattice resolutions
    min_bbox: torch.Tensor  # [3] corner of the DOUBLED bbox
    bbox_size: torch.Tensor  # [3] size of the DOUBLED bbox
    occupied_grid: torch.Tensor  # [Rx, Ry, Rz] bool over the INNER bbox


def compute_sampler_log2dim(bbox_size2, sampler_log2dim: int) -> np.ndarray:
    """Anisotropic occupancy grid dims."""
    bbox_size2 = np.asarray(bbox_size2, dtype=np.float64)
    return sampler_log2dim - np.log2(bbox_size2.max() / bbox_size2).astype(np.int32)


def create_field(generator: torch.Generator, bbox_corner, bbox_size,
                 log2_hashmap_size: int = 24, grid_resolution=(32, 2048),
                 sampler_log2dim: int = 4, occupied_grid=None, cubic_grid: bool = False,
                 device="cuda") -> tuple[FieldParams, FieldState]:
    """A tile's field on ``device``; tables and decoder drawn from
    ``generator`` (a generator on ``device``). The occupancy grid is
    ``occupied_grid`` (a bool array of the grid's shape), or all occupied,
    as training starts. ``cubic_grid=True`` gives the grid
    ``sampler_log2dim`` on every axis (the trainer's choice, so that tiles
    of any aspect share one grid shape); else each axis is cut by the
    bbox's aspect."""
    dev = _device.resolve(device)
    bbox_corner = np.asarray(bbox_corner, dtype=np.float32)
    bbox_size = np.asarray(bbox_size, dtype=np.float32)
    center = bbox_corner + bbox_size / 2.0
    size2 = bbox_size * 2.0  # background shell
    min_bbox = center - size2 / 2.0
    finest = (size2 / size2.min() * grid_resolution[1]).astype(np.int32)
    base = (size2 / size2.min() * grid_resolution[0]).astype(np.int32)
    resolutions = hash_encode.make_level_resolutions(base, finest, N_LEVELS)
    log2dims = np.array([sampler_log2dim] * 3) if cubic_grid \
        else compute_sampler_log2dim(size2, sampler_log2dim)
    grid_shape = tuple(int(2**d) for d in log2dims)
    if occupied_grid is None:
        occupied_grid = np.ones(grid_shape, dtype=bool)
    occupied_grid = np.asarray(occupied_grid, dtype=bool)
    if occupied_grid.shape != grid_shape:
        raise ValueError(f"occupied_grid is {occupied_grid.shape}, the field's grid "
                         f"{grid_shape}")
    params = FieldParams(
        features=hash_encode.init_features(generator, N_LEVELS, log2_hashmap_size,
                                           N_FEATURES, device=dev),
        decoder=decoder_lib.init_decoder(generator, device=dev))
    state = FieldState(
        resolutions=torch.tensor(resolutions, device=dev),
        min_bbox=torch.tensor(min_bbox, device=dev),
        bbox_size=torch.tensor(size2, device=dev),
        occupied_grid=torch.tensor(occupied_grid, device=dev))
    return params, state


def inner_corner(state: FieldState) -> torch.Tensor:
    return state.min_bbox + state.bbox_size / 4.0


def inner_size(state: FieldState) -> torch.Tensor:
    return state.bbox_size / 2.0


def effective_backend(backend: str, H: int) -> str:
    """The hash backend of a table of H entries: the windowed layout needs
    at least one 32-window block of 512 entries, so smaller tables take
    the global hash. Pruning and export resolve the backend the same way,
    so that the table is always read with the hash it was trained with."""
    if backend not in ("xla", "windowed"):
        raise ValueError(f"unknown backend {backend!r}")
    if backend == "windowed" and H < hw.W * hw.WB:
        return "xla"
    return backend


def contract_fore(state: FieldState, x: torch.Tensor) -> torch.Tensor:
    """Inner bbox -> [-1, 1]."""
    return (x - state.min_bbox) / state.bbox_size * 4.0 - 2.0


def contract_bg(state: FieldState, x: torch.Tensor) -> torch.Tensor:
    """L-infinity mip360 squash over [-2, 2]."""
    x = (x - state.min_bbox) / state.bbox_size * 4.0 - 2.0
    linf = x.abs().amax(dim=-1, keepdim=True).clamp_min(1e-9)
    return x * ((2.0 - 1.0 / linf) / linf)


def weight_feature(step: torch.Tensor) -> torch.Tensor:
    """BARF per-level annealing weights [16] at ``step`` (an f32 scalar
    tensor)."""
    alpha = (step / 10000.0 * 8.0 + 8.0).clamp(0.0, 16.0)
    k = torch.arange(N_LEVELS, dtype=torch.float32, device=step.device)
    return (1.0 - torch.cos((alpha - k).clamp(0.0, 1.0) * math.pi)) / 2.0


def decode_columns(decoder: dict, feats, dirs, wf) -> torch.Tensor:
    """The unfused decode of hash features [N, 32] with view dirs [N, 3]
    under BARF weights ``wf`` [16] -> the 8 columns the fused kernels
    write: sigma, diffuse x3, tint * specular x3 (premultiplied) and the
    specular square's channel mean."""
    dec = decoder_lib.apply_decoder(decoder, feats, dirs, wf.repeat_interleave(2))
    return torch.cat([dec["sigma"], dec["diffuse"], dec["tint"] * dec["specular"],
                      (dec["specular"] ** 2).mean(dim=-1, keepdim=True)], dim=-1)


def _composite_premul(out: dict, z, d, rays_d, valid, infinity: bool, train: bool) -> dict:
    """Composite of the stream's 8 columns (tint * specular premultiplied,
    the specular square's channel mean carried in one column)."""
    weights, T_left = integrate.integrate_weights(out["sigma"], d, rays_d, infinity=infinity)
    weights = torch.where(valid[:, None], weights, torch.zeros_like(weights))
    T_left = torch.where(valid, T_left, torch.ones_like(T_left))
    depth = integrate.accumulate(weights, z[..., None])
    diffuse = integrate.accumulate(weights, out["diffuse"])
    specular = integrate.accumulate(weights, out["tintspec"])
    res = {"rgb": (diffuse + specular).clamp(0.0, 1.0), "depth": depth,
           "diffuse": diffuse, "specular": specular, "T_left": T_left,
           "weights": weights, "valid": valid}
    if train:
        spec2 = integrate.accumulate(weights.detach(), out["spec2"])[..., 0]
        nvalid = valid.to(spec2.dtype).sum().clamp_min(1.0)
        res["l2_reg_specular"] = (spec2 * valid).sum() / nvalid
    return res


def _compose_fg_bg(fg: dict, bg: dict, rays_o, rays_d, train: bool) -> dict:
    """fg + T_left * bg."""
    T = fg["T_left"][:, None]
    out = {
        "pred_color": fg["rgb"] + T * bg["rgb"],
        "pred_depth": fg["depth"] + T * bg["depth"],
        "pred_specular": fg["specular"] + T * bg["specular"],
        "pred_diffuse": fg["diffuse"] + T * bg["diffuse"],
        "fore_valid": fg["fore_valid"],
        "bg_valid": bg["bg_valid"],
        "fore_depth": fg["depth"],
        "T_left": fg["T_left"],
        "weights": fg["weights"],
        "rays_o": rays_o,
        "rays_d": rays_d,
    }
    if train:
        out["l2_reg_specular"] = fg["l2_reg_specular"] + bg["l2_reg_specular"]
    return out


def _check_options(table_shards, table_axis, backend):
    """Sharded tables need the windowed backend and the axis they are
    sharded over, of their shard count."""
    if table_shards == 1:
        return
    if backend != "windowed":
        raise ValueError("table parallelism requires the windowed backend")
    if table_axis is None or table_axis.size != table_shards:
        raise ValueError(f"{table_shards} table shards need a table axis of that size, "
                         f"got {table_axis}")


def render_batch_rays(params: FieldParams, state: FieldState, rays_o, rays_d, z_vals,
                      dists, valid, step: torch.Tensor, contract, infinity: bool,
                      train: bool, stochastic_grad: bool = False) -> dict:
    """One pass of the global-hash backend: the samples z_vals / dists
    [N, S] of rays [N, 3], masked by ``valid`` [N] (invalid rays
    contribute nothing and keep T_left 1), contracted by ``contract``,
    encoded by ``hash_encode`` (``hash_encode_stoch`` with
    ``stochastic_grad``) and decoded in PyTorch."""
    N, S = z_vals.shape
    zero = torch.zeros((), device=rays_o.device)
    z = torch.where(valid[:, None], z_vals, zero)
    d = torch.where(valid[:, None], dists, zero)
    x = contract(state, (rays_o[:, None, :] + z[..., None] * rays_d[:, None, :])
                 .reshape(-1, 3))
    encode = hash_encode.hash_encode_stoch if stochastic_grad else hash_encode.hash_encode
    feats = encode(x, params.features, state.resolutions)
    dirs = rays_d[:, None, :].expand(N, S, 3).reshape(-1, 3)
    cols = decode_columns(params.decoder, feats, dirs, weight_feature(step))
    return _composite_premul(_as_parts(cols, N, S), z, d, rays_d, valid,
                             infinity=infinity, train=train)


def render_fore_rays(params: FieldParams, state: FieldState, rays_o, rays_d,
                     num_sample: int, step: torch.Tensor, occlusion_mask=None,
                     train: bool = True, num_march: int = 512,
                     stochastic_grad: bool = False) -> dict:
    """The global-hash foreground pass: occupancy-CDF samples (B1 on the
    card) over the inner bbox."""
    z_vals, dists, valid = sampling.sample_points_grid(
        rays_o, rays_d, num_sample, state.occupied_grid, inner_corner(state),
        inner_size(state), num_march=num_march)
    if occlusion_mask is not None:
        valid = valid & occlusion_mask
    out = render_batch_rays(params, state, rays_o, rays_d, z_vals, dists, valid, step,
                            contract_fore, infinity=False, train=train,
                            stochastic_grad=stochastic_grad)
    out["fore_valid"] = valid
    return out


def render_bg_rays(params: FieldParams, state: FieldState, rays_o, rays_d,
                   num_sample: int, step: torch.Tensor, occlusion_mask=None,
                   train: bool = True, invalid_underground: bool = False,
                   bg_z=None, stochastic_grad: bool = False) -> dict:
    """The global-hash background pass: inverse-z samples beyond the
    doubled bbox, or the BS-mode samples ``bg_z`` = (z, dists, valid)."""
    z_vals, dists, valid = bg_z if bg_z is not None else _bg_samples(
        state, rays_o, rays_d, num_sample, invalid_underground)
    if occlusion_mask is not None:
        valid = valid & occlusion_mask
    out = render_batch_rays(params, state, rays_o, rays_d, z_vals, dists, valid, step,
                            contract_bg, infinity=True, train=train,
                            stochastic_grad=stochastic_grad)
    out["bg_valid"] = valid
    return out


def _bg_samples(state, rays_o, rays_d, num_sample, invalid_underground):
    return sampling.inverse_z_sampling(
        rays_o, rays_d, num_sample, state.min_bbox + state.bbox_size / 2.0,
        state.bbox_size, invalid_underground=invalid_underground)


def _as_parts(cols, B, S):
    """The 8 decoded columns of B rays x S samples as the composite's parts."""
    return {"sigma": cols[:, 0:1].reshape(B, S, 1),
            "diffuse": cols[:, 1:4].reshape(B, S, 3),
            "tintspec": cols[:, 4:7].reshape(B, S, 3),
            "spec2": cols[:, 7:8].reshape(B, S, 1)}


def render_rays(params: FieldParams, state: FieldState, rays_o, rays_d,
                num_fg_sample: int, num_bg_sample: int, step: torch.Tensor,
                occlusion_mask=None, train: bool = True, invalid_underground: bool = False,
                num_march: int = 512, stochastic_grad: bool = False, bg_z=None,
                backend: str = "windowed", table_shards: int = 1,
                bwd_onehot_bf16: bool = False, fused_decoder: bool = True,
                compact_dead: bool = True, stage_hook=None, table_axis=None) -> dict:
    """fg + bg render of rays [N, 3] (unnormalized directions). The
    windowed backend decodes one sorted stream, with the fused decoder or,
    for ``fused_decoder=False``, the lookup then the decoder; the xla
    backend (and any table under 2^14 entries) runs the fg and bg passes
    of the global hash. ``step`` is an f32 scalar tensor (BARF annealing).
    ``bg_z`` = (z, dists, valid) replaces the inverse-z background samples
    (BS mode). ``stage_hook(name)``, when given, is called after each stage
    of the windowed path (sample, sort_pack, decode, unsort, composite) for
    timing. Differentiable in the field's params and in rays_o / rays_d
    (through the sample positions and view dirs). ``stochastic_grad``
    applies to the xla backend and ``bwd_onehot_bf16`` to the windowed
    one, each ignored by the other, as in the JAX package. With
    ``table_shards`` > 1, ``params.features`` is this rank's shard of a
    table sharded over ``table_axis`` (``mesh.Axis``)."""
    backend = effective_backend(backend,
                                hash_encode.table_rows(params.features) * table_shards)
    _check_options(table_shards, table_axis, backend)
    if backend == "windowed":
        return _render_rays_windowed(params, state, rays_o, rays_d, num_fg_sample,
                                     num_bg_sample, step, occlusion_mask, train,
                                     invalid_underground, num_march, bg_z, fused_decoder,
                                     compact_dead, stage_hook, bwd_onehot_bf16,
                                     table_axis if table_shards > 1 else None)
    fg = render_fore_rays(params, state, rays_o, rays_d, num_fg_sample, step,
                          occlusion_mask=occlusion_mask, train=train, num_march=num_march,
                          stochastic_grad=stochastic_grad)
    bg = render_bg_rays(params, state, rays_o, rays_d, num_bg_sample, step,
                        occlusion_mask=occlusion_mask, train=train,
                        invalid_underground=invalid_underground, bg_z=bg_z,
                        stochastic_grad=stochastic_grad)
    return _compose_fg_bg(fg, bg, rays_o, rays_d, train)


def _render_rays_windowed(params, state, rays_o, rays_d, num_fg_sample, num_bg_sample,
                          step, occlusion_mask, train, invalid_underground, num_march,
                          bg_z, fused_decoder, compact_dead, stage_hook,
                          bwd_onehot_bf16=False, table_axis=None) -> dict:
    """``render_rays`` through the windowed sorted stream; with
    ``table_axis``, over the table sharded on it."""
    shards = 1 if table_axis is None else table_axis.size
    H = hash_encode.table_rows(params.features) * shards
    B = rays_o.shape[0]
    Sf, Sb = num_fg_sample, num_bg_sample
    zf, df, vf = sampling.sample_points_grid(
        rays_o, rays_d, Sf, state.occupied_grid, inner_corner(state), inner_size(state),
        num_march=num_march)
    zb, db, vb = bg_z if bg_z is not None else _bg_samples(
        state, rays_o, rays_d, Sb, invalid_underground)
    if occlusion_mask is not None:
        vf = vf & occlusion_mask
        vb = vb & occlusion_mask
    zero = torch.zeros((), device=rays_o.device)
    zfm = torch.where(vf[:, None], zf, zero)
    dfm = torch.where(vf[:, None], df, zero)
    zbm = torch.where(vb[:, None], zb, zero)
    dbm = torch.where(vb[:, None], db, zero)
    _mark(stage_hook, "sample")

    xf = contract_fore(state, (rays_o[:, None, :] + zfm[..., None] * rays_d[:, None, :])
                       .reshape(-1, 3))
    xb = contract_bg(state, (rays_o[:, None, :] + zbm[..., None] * rays_d[:, None, :])
                     .reshape(-1, 3))
    x = torch.cat([xf, xb])
    dirs = torch.cat([rays_d[:, None, :].expand(B, Sf, 3).reshape(-1, 3),
                      rays_d[:, None, :].expand(B, Sb, 3).reshape(-1, 3)])
    dead = None
    if compact_dead:
        # masked / missed rays carry zero composite weight: their points go
        # to the sentinel window, so whole-dead chunks skip the kernels
        dead = torch.cat([(~vf)[:, None].expand(B, Sf).reshape(-1),
                          (~vb)[:, None].expand(B, Sb).reshape(-1)])
    stream = hw.sort_pack(x, dirs, H, dead)
    _mark(stage_hook, "sort_pack")
    if table_axis is not None:
        # the shard's lookup, then the unfused decoder (JAX field.py:445)
        feats = table_parallel.lookup_sharded(stream, params.features, state.resolutions,
                                              table_axis, bwd_onehot_bf16)
        dirs_s = stream.pts[:, 4:7, :].permute(0, 2, 1).reshape(feats.shape[0], 3)
        cols = decode_columns(params.decoder, feats, dirs_s, weight_feature(step))
    elif fused_decoder:
        slab = ft.pack_train_slab(params.decoder, weight_feature(step))
        cols = ft.hash_decode_train(stream.pts, stream.meta, params.features,
                                    state.resolutions, slab, bwd_bf16=bwd_onehot_bf16)
    else:
        feats = hw.hash_lookup_sorted(stream.pts, stream.meta, params.features,
                                      state.resolutions, bwd_bf16=bwd_onehot_bf16)
        dirs_s = stream.pts[:, 4:7, :].permute(0, 2, 1).reshape(feats.shape[0], 3)
        cols = decode_columns(params.decoder, feats, dirs_s, weight_feature(step))
    _mark(stage_hook, "decode")
    rows = hw.unsort_rows(cols, stream.pidp, x.shape[0])
    _mark(stage_hook, "unsort")

    Nf = B * Sf
    fg = _composite_premul(_as_parts(rows[:Nf], B, Sf), zfm, dfm, rays_d, vf,
                           infinity=False, train=train)
    bg = _composite_premul(_as_parts(rows[Nf:], B, Sb), zbm, dbm, rays_d, vb,
                           infinity=True, train=train)
    fg["fore_valid"] = vf
    bg["bg_valid"] = vb
    out = _compose_fg_bg(fg, bg, rays_o, rays_d, train)
    _mark(stage_hook, "composite")
    return out


def field_inference_sigma(params: FieldParams, state: FieldState, samples,
                          step: torch.Tensor, backend: str = "xla") -> torch.Tensor:
    """Density of points ``samples`` [..., 3] in contract space under the
    BARF weights of ``step`` -> [..., 1], for pruning. ``backend`` must be
    the layout the table was trained with (``effective_backend``): read
    through the other hash, a table gives garbage densities. The windowed
    layout goes through ``hash_encode_windowed`` (B2, B3) for CUDA tensors
    and through its plain gather for CPU tensors."""
    x = samples.reshape(-1, 3)
    if backend == "windowed":
        encode = hw.hash_encode_windowed if x.is_cuda else hw.hash_encode_windowed_ref
    elif backend == "xla":
        encode = hash_encode.hash_encode
    else:
        raise ValueError(f"unknown backend {backend!r}")
    feats = encode(x, params.features, state.resolutions)
    wf = weight_feature(step).repeat_interleave(2)
    sig = decoder_lib.inference_sigma(params.decoder, feats * wf)
    return sig.reshape(*samples.shape[:-1], 1)


def detached(params: FieldParams) -> FieldParams:
    """``params`` detached: no gradient reaches the tables or the decoder."""
    return FieldParams(features=params.features.detach(),
                       decoder={n: {k: v.detach() for k, v in p.items()}
                                for n, p in params.decoder.items()})


def compute_normal(params: FieldParams, state: FieldState, samples, step: torch.Tensor,
                   backend: str = "xla") -> tuple[torch.Tensor, torch.Tensor]:
    """Surface normals at world points ``samples`` [..., 3]: minus the
    normalised gradient of ``field_inference_sigma`` at the fg-contracted
    points, under the BARF weights of ``step`` -> (normal [..., 3], sigma
    [..., 1]), neither differentiable. The JAX function takes a ``vmap``
    of ``value_and_grad`` point by point; the points are independent, so
    here one ``torch.autograd.grad`` of the summed sigma gives every
    point's gradient. The params enter detached: a table that requires
    grad would make the windowed lookup's backward (B4 on the card) build
    the dense table gradient too, where its dL/du mode is all this needs."""
    shape = samples.shape
    frozen = detached(params)
    with torch.enable_grad():
        p = samples.detach().reshape(-1, 3).requires_grad_()
        sigma = field_inference_sigma(frozen, state, contract_fore(state, p), step,
                                      backend=backend)
        (grads,) = torch.autograd.grad(sigma.sum(), p)
    normal = -grads / (torch.linalg.vector_norm(grads, dim=-1, keepdim=True) + 1e-8)
    return normal.reshape(shape), sigma.detach().reshape(*shape[:-1], 1)


def render_normals(params: FieldParams, state: FieldState, rays_o, rays_d, num_sample: int,
                   step: torch.Tensor, num_march: int = 512, backend: str = "xla"):
    """Accumulated surface normals of rays [N, 3], mapped to [0, 1] -> [N,
    3]: occupancy-CDF samples (B1 on the card), ``compute_normal`` at them,
    and the normals summed under the fg compositing weights (no infinite
    last interval). ``backend`` is the table's layout, as for
    ``field_inference_sigma``; the JAX default is "xla", a windowed tile
    takes "windowed" (``effective_backend``). Not differentiable."""
    z_vals, dists, valid = sampling.sample_points_grid(
        rays_o, rays_d, num_sample, state.occupied_grid, inner_corner(state),
        inner_size(state), num_march=num_march)
    zero = torch.zeros((), device=rays_o.device)
    z = torch.where(valid[:, None], z_vals, zero)
    d = torch.where(valid[:, None], dists, zero)
    samples = rays_o[:, None, :] + z[..., None] * rays_d[:, None, :]
    normals, sigma = compute_normal(params, state, samples, step, backend=backend)
    weights, _ = integrate.integrate_weights(sigma[..., 0], d, rays_d, infinity=False)
    weights = torch.where(valid[:, None], weights, torch.zeros_like(weights))
    return (integrate.accumulate(weights, normals) + 1.0) / 2.0


def _mark(hook, name: str) -> None:
    if hook is not None:
        hook(name)
