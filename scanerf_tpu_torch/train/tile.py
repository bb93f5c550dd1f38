"""One tile's training step (counterpart of ``scanerf_tpu/train/tile.py``).

A tile's trainables are the hash tables, the decoder and the camera
refinements ``se3_refine``, updated by the three param groups of one
``torch.optim.Adam`` that mirror the JAX package's optax
``multi_transform`` (tile.py:236-279):

- hash tables: Adam(b1 0.9, b2 0.99, eps 1e-15);
- decoder: the decay 1e-6 * param added to the gradient, then Adam
  (b1 0.9, b2 0.999, eps 1e-8);
- se3_refine: Adam(b1 0.9, b2 0.999, eps 1e-8), its rate 0 before
  ``cam_start_steps``;

each group's rate an ``exp_window_schedule`` that ends at 0.1x the base
rate at ``total_step``, read at the group's count before the step (as
optax's ``scale_by_learning_rate``), with the bias correction at the count
after it (as ``scale_by_adam``). With ``sparse_adam`` the hash tables
leave the fused Adam for ``train/sparse_adam.py::SparseAdam`` (per-element
counts, zero gradients skipped), the state's ``hash_optimizer``.

The step samples 2x2 pixel patches (one patch set for every camera),
renders fg + bg with ``models/field.py::render_rays`` and applies the loss
registry with its warm-up and decay schedules. The update is in place: the
state's tensors are overwritten, as the JAX step donates its state.

Across ranks (``parallel/mesh.py``): with ``table_shards`` > 1 the state
holds this rank's shard of the table and of both Adam moments
(``create_train_state(table_axis=)``) and the renders, the warp loss's
re-render too, run over the ``table_axis``; with a ``grad_axis`` (ray
data parallelism) ``train_step`` takes the mean of the gradients and of
the aux metrics over it before the update, which every replica then
applies alike. Ranks along the rays axis draw their batches from
generators of their own (``batch_generator``); ranks along the table
axis share one batch.

Entry points (``create_train_state``, ``train_step``, ``train_n_steps``
and the evaluation renders ``render_chunk``, ``render_depth_batch``,
``render_image``) take ``device`` and default to ``"cuda"``; without CUDA
they raise.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from scanerf_tpu_torch import _device
from scanerf_tpu_torch.models import decoder as decoder_lib
from scanerf_tpu_torch.models import field as field_lib
from scanerf_tpu_torch.models.field import FieldParams, FieldState
from scanerf_tpu_torch.ops import sampling
from scanerf_tpu_torch.parallel import mesh as mesh_lib
from scanerf_tpu_torch.parallel import table_parallel
from scanerf_tpu_torch.train import cameras as cam_lib
from scanerf_tpu_torch.train import losses
from scanerf_tpu_torch.train.cameras import Cameras
from scanerf_tpu_torch.train.scheduler import exp_window_schedule
from scanerf_tpu_torch.train.sparse_adam import SparseAdam


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The JAX ``TrainConfig`` (tile.py:47-161) without its TPU-only
    permutation knobs ``permute_mode`` and ``run_cap_frac``, which
    ``from_cfg`` does not read (config keys ``TRAINING.PERMUTE_MODE`` and
    ``RUN_CAP_FRAC``: bitwise-equal ways of sorting the stream on a TPU).
    ``hash_backend`` defaults to "windowed", the production path (the JAX
    dataclass defaults to "xla", the global hash, for its CPU oracles;
    tables under 2^14 entries take the global hash either way). Table and
    ray sharding (``table_shards``, ``ray_shards``) need the mesh axes of
    those sizes in the step."""

    num_sample: int = 128
    num_bg_sample: int = 128
    batch_log2: int = 14
    total_step: int = 40000
    num_march: int = 512
    w_rgb: float = 1.0
    w_warp: float = 0.0
    w_depth: float = 0.0
    w_smooth: float = 0.0
    warp_warming: bool = True
    rgb_start: int = 0
    warp_start: int = 0
    depth_start: int = 0
    smooth_start: int = 0
    alpha: float = 10.0
    gamma: float = 20.0
    warp_top_k: int = 5
    warp_vis_sample: int = 16
    warp_vis_bg_sample: int = 8
    warp_vis_march: int = 64
    rho: float = 0.0
    syn_start: int = 0
    invalid_underground: bool = False
    bg_mode: str = "IZ"
    eta_hash: float = 1e-3
    eta_decoder: float = 1e-3
    eta_cam: float = 1e-4
    cam_enable: bool = True
    cam_start_steps: int = 0
    l2_specular_weight: float = 0.01
    stochastic_hash_grad: bool = False
    sparse_adam: bool = False
    compact_dead_rays: bool = True
    hash_backend: str = "windowed"
    table_shards: int = 1
    ray_shards: int = 1
    hash_bwd_bf16: bool = False
    fused_decoder: bool = True

    @classmethod
    def from_cfg(cls, cfg) -> "TrainConfig":
        """The training config of a ``config.ConfigDict``, read key for key
        as the JAX ``TrainConfig.from_cfg`` reads it."""
        T = cfg.TRAINING
        L = T.LOSS
        return cls(
            num_sample=T.NUM_SAMPLE,
            num_bg_sample=T.NUM_BG_SAMPLE,
            batch_log2=T.BS_LOG2DIM,
            total_step=T.TOTAL_STEP,
            num_march=T.get("NUM_MARCH", 512),
            w_rgb=L.WEIGHT_RGB_LOSS,
            w_warp=L.WEIGHT_WARP_LOSS,
            w_depth=L.WEIGHT_DEPTH_LOSS,
            w_smooth=L.WEIGHT_DEPTH_SMOOTH_LOSS,
            warp_warming=L.WARP_WARPING,
            rgb_start=L.RGB_LOSS_START,
            warp_start=L.WARP_LOSS_START,
            depth_start=L.DEPTH_LOSS_START,
            smooth_start=L.DEPTH_SMOOTH_LOSS_START,
            alpha=L.ALPHA,
            gamma=L.GAMMA,
            rho=cfg.RHO,
            syn_start=cfg.SYN_START,
            invalid_underground=cfg.INVALID_UNDERGROUND,
            bg_mode=T.BG_MODE,
            eta_hash=T.ETA.HASH_FEATURE,
            eta_decoder=T.ETA.DECODER,
            eta_cam=T.ETA.CAM,
            cam_enable=T.CAMOPT.ENABLE,
            cam_start_steps=T.CAMOPT.START_STEPS,
            hash_backend=T.get("HASH_BACKEND", "windowed"),
            table_shards=T.get("TABLE_SHARDS", 1),
            ray_shards=T.get("RAY_SHARDS", 1),
            hash_bwd_bf16=T.get("HASH_BWD_BF16", False),
            fused_decoder=T.get("FUSED_DECODER", True),
            compact_dead_rays=T.get("COMPACT_DEAD_RAYS", True),
            stochastic_hash_grad=T.get("STOCHASTIC_HASH_GRAD", False),
            warp_vis_sample=L.get("WARP_VIS_SAMPLE", 16),
            warp_vis_bg_sample=L.get("WARP_VIS_BG_SAMPLE", 8),
            warp_vis_march=L.get("WARP_VIS_MARCH", 64),
            warp_top_k=L.get("WARP_TOP_K", 5),
        )


@dataclasses.dataclass
class TileParams:
    field: FieldParams
    se3_refine: torch.Tensor  # [N_cam, 6]


@dataclasses.dataclass
class AdmmState:
    """Per-tile ADMM variables."""

    shared_se3: torch.Tensor  # z [N, 6]
    delta_se3: torch.Tensor  # scaled dual u [N, 6]
    overlap_flags: torch.Tensor  # [N] bool
    rho: torch.Tensor  # [6]


@dataclasses.dataclass
class TrainState:
    params: TileParams
    optimizer: torch.optim.Adam  # over ``params``' tensors; see build_optimizer
    field_state: FieldState
    admm: AdmmState
    step: int
    # the tables' SparseAdam with ``sparse_adam`` (then not in ``optimizer``)
    hash_optimizer: SparseAdam | None = None

    def optimizers(self) -> list:
        return [self.optimizer] + ([self.hash_optimizer] if self.hash_optimizer else [])


@dataclasses.dataclass
class TileData:
    """Per-tile training data, on the device."""

    images: torch.Tensor  # [N, H, W, 3] f32
    occlusions: torch.Tensor  # [N, H, W] bool
    cameras: Cameras
    mono_depths: torch.Tensor  # [N, H, W]
    mono_normals: torch.Tensor  # [N, H, W, 3]
    # the proxy mesh's depth behind the tile, per pixel (0 = none), for
    # BG_MODE "BS" (``ProxyMesh.compute_bgdepth_batch``); None in IZ mode
    bg_depths: torch.Tensor | None = None


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

def group_leaves(params: TileParams) -> dict:
    """The trainable tensors of each optimizer group, in a fixed order
    (the decoder's in ``decoder.PACK_ORDER``, weight then bias). Reads
    any tree with TileParams' attribute names (the JAX one too)."""
    dec = params.field.decoder
    return {"hash": [params.field.features],
            "decoder": [dec[n][k] for n in decoder_lib.PACK_ORDER for k in ("w", "b")],
            "cam": [params.se3_refine]}


def _schedules(tc: TrainConfig) -> dict:
    """Each group's learning rate as a function of its update count."""
    return {"hash": exp_window_schedule(tc.eta_hash, 0.1 * tc.eta_hash, tc.total_step),
            "decoder": exp_window_schedule(tc.eta_decoder, 0.1 * tc.eta_decoder,
                                           tc.total_step),
            "cam": exp_window_schedule(tc.eta_cam, 0.1 * tc.eta_cam, tc.total_step,
                                       start_itr=tc.cam_start_steps, end_itr=tc.total_step)}


def build_optimizer(tc: TrainConfig, params: TileParams) -> torch.optim.Adam:
    """The Adam groups of the JAX ``build_optimizer`` over the tensors of
    ``params``, fused (on CUDA and on the CPU): hash (unless
    ``sparse_adam``: ``build_hash_optimizer``), decoder and cam. Each group
    carries its name and ``count``, optax's update count, at which
    ``apply_gradients`` reads its rate; without ``cam_enable`` the cameras
    are not optimized (optax's ``set_to_zero``)."""
    leaves = group_leaves(params)
    groups = [dict(params=leaves["decoder"], name="decoder", betas=(0.9, 0.999), eps=1e-8,
                   weight_decay=1e-6)]
    if not tc.sparse_adam:
        groups.insert(0, dict(params=leaves["hash"], name="hash", betas=(0.9, 0.99),
                              eps=1e-15))
    if tc.cam_enable:
        groups.append(dict(params=leaves["cam"], name="cam", betas=(0.9, 0.999), eps=1e-8))
    for g in groups:
        g["count"] = 0
    return torch.optim.Adam(groups, lr=0.0, fused=True)


def build_hash_optimizer(tc: TrainConfig, params: TileParams) -> SparseAdam | None:
    """With ``sparse_adam``, the tables' ``SparseAdam`` (b1 0.9, b2 0.99,
    eps 1e-15), one group named "hash" with its ``count``; else None."""
    if not tc.sparse_adam:
        return None
    opt = SparseAdam(group_leaves(params)["hash"], betas=(0.9, 0.99), eps=1e-15)
    opt.param_groups[0].update(name="hash", count=0)
    return opt


@torch.no_grad()
def apply_gradients(state: TrainState, grads: dict, tc: TrainConfig) -> None:
    """One update of the state's optimizers in place. ``grads`` maps each
    group to the gradients of ``group_leaves(state.params)``."""
    sched = _schedules(tc)
    for opt in state.optimizers():
        for group in opt.param_groups:
            group["lr"] = sched[group["name"]](group["count"])
            group["count"] += 1
            for p, g in zip(group["params"], grads[group["name"]]):
                p.grad = g.contiguous()  # the fused update wants the param's strides
        opt.step()
        opt.zero_grad(set_to_none=True)


def create_train_state(field_params: FieldParams, field_state: FieldState,
                       num_camera: int, tc: TrainConfig, device="cuda",
                       table_axis=None) -> TrainState:
    """Fresh state: zero pose refinements, zero ADMM variables (rho =
    ``tc.rho``), zero Adam moments; params and field state must already
    live on ``device``. With ``tc.table_shards`` > 1 the whole table of
    ``field_params`` (made from the same seed on every rank) is cut to
    this rank's shard on ``table_axis``, so that the shards together are
    the unsharded state; the moments follow the shard."""
    dev = _device.resolve(device)
    if field_params.features.device.type != dev.type:
        raise ValueError(f"field lives on {field_params.features.device}, asked for {dev}")
    if tc.table_shards > 1:
        _check_axis("table", tc.table_shards, table_axis)
        field_params = dataclasses.replace(
            field_params, features=table_parallel.shard_features(field_params.features,
                                                                 table_axis))
    params = TileParams(field=field_params,
                        se3_refine=cam_lib.init_se3_refine(num_camera, device=dev))
    return TrainState(
        params=params, optimizer=build_optimizer(tc, params), field_state=field_state,
        admm=AdmmState(shared_se3=torch.zeros((num_camera, 6), device=dev),
                       delta_se3=torch.zeros((num_camera, 6), device=dev),
                       overlap_flags=torch.zeros((num_camera,), dtype=torch.bool, device=dev),
                       rho=torch.full((6,), float(tc.rho), device=dev)),
        step=0, hash_optimizer=build_hash_optimizer(tc, params))


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def _gate(step, start, end=10**9):
    """A loss is on when start < step < end."""
    return ((step > start) & (step < end)).to(torch.float32)


def _check_device(t: torch.Tensor, device) -> torch.device:
    dev = _device.resolve(device)
    if t.device.type != dev.type:
        raise ValueError(f"state lives on {t.device}, asked for {dev}")
    return dev


def _check_axis(name: str, n: int, axis) -> None:
    if n > 1 and (axis is None or axis.size != n):
        raise ValueError(f"{n} {name} shards need a {name} axis of that size, got {axis}")


def _check_config(tc: TrainConfig, table_axis=None, grad_axis=None):
    _check_axis("table", tc.table_shards, table_axis)
    _check_axis("rays", tc.ray_shards, grad_axis)


def _render(params, field_state, rays_o, rays_d, n_fg, n_bg, stepf, tc, table_axis=None,
            **kw):
    return field_lib.render_rays(
        params, field_state, rays_o, rays_d, n_fg, n_bg, stepf,
        invalid_underground=tc.invalid_underground,
        stochastic_grad=tc.stochastic_hash_grad, backend=tc.hash_backend,
        table_shards=tc.table_shards, bwd_onehot_bf16=tc.hash_bwd_bf16,
        fused_decoder=tc.fused_decoder, compact_dead=tc.compact_dead_rays,
        table_axis=table_axis, **kw)


def compute_losses(params: TileParams, field_state: FieldState, admm: AdmmState,
                   data: TileData, ray_idx, pixel_locs, step: int, tc: TrainConfig,
                   stage_hook=None, table_axis=None, grad_axis=None):
    """Render the sampled rays and evaluate the loss registry -> (loss,
    aux). ``stage_hook(name)`` is called after each stage, for timing.
    ``table_axis``: the axis of a sharded table (``tc.table_shards``);
    ``grad_axis`` is only checked against ``tc.ray_shards`` here."""
    _check_config(tc, table_axis, grad_axis)
    N_cam, H, W = data.images.shape[:3]
    B = ray_idx.shape[0]
    dev = data.images.device
    stepf = torch.tensor(float(step), dtype=torch.float32, device=dev)
    xy = torch.stack([(ray_idx % W).to(torch.float32) + 0.5,
                      torch.div(ray_idx, W, rounding_mode="floor").to(torch.float32) + 0.5],
                     dim=-1)
    rays_o, rays_d = cam_lib.get_rays(data.cameras, params.se3_refine, xy)
    rays_o, rays_d = rays_o.reshape(-1, 3), rays_d.reshape(-1, 3)
    gt_color = data.images.reshape(N_cam, H * W, 3)[:, ray_idx].reshape(-1, 3)
    occl = data.occlusions.reshape(N_cam, H * W)[:, ray_idx].reshape(-1)
    bg_z = None
    if tc.bg_mode == "BS" and data.bg_depths is not None:
        bgd = data.bg_depths.reshape(N_cam, H * W)[:, ray_idx].reshape(-1)
        bg_z = sampling.background_window_sampling(
            rays_o, rays_d, bgd, field_state.min_bbox + field_state.bbox_size / 2.0,
            field_state.bbox_size, tc.num_bg_sample, field_state.bbox_size.max() / 10.0)

    out = _render(params.field, field_state, rays_o, rays_d, tc.num_sample,
                  tc.num_bg_sample, stepf, tc, table_axis, occlusion_mask=occl, train=True,
                  num_march=tc.num_march, bg_z=bg_z, stage_hook=stage_hook)
    valid = out["fore_valid"] | out["bg_valid"]
    aux = {}
    loss = tc.l2_specular_weight * out["l2_reg_specular"]
    if tc.w_rgb > 0:
        l_rgb = losses.rgb_loss(out["pred_color"], gt_color, valid)
        loss = loss + tc.w_rgb * _gate(stepf, tc.rgb_start) * l_rgb
        aux["rgb_loss"] = l_rgb
    if tc.w_depth > 0:
        mono_d = data.mono_depths.reshape(N_cam, H * W)[:, ray_idx][..., None]
        rend_d = out["pred_depth"].reshape(N_cam, B, 1)
        mask = valid.reshape(N_cam, B, 1).to(torch.float32)
        l_d = losses.depth_consistency_loss(rend_d, mono_d, mask)
        w = losses.depth_weight_decay(tc.w_depth, (stepf - tc.depth_start).clamp_min(0.0))
        loss = loss + w * _gate(stepf, tc.depth_start, tc.total_step) * l_d
        aux["depth_loss"] = l_d
    if tc.w_smooth > 0:
        mono_n = data.mono_normals.reshape(N_cam, H * W, 3)[:, ray_idx]
        rend_d = out["pred_depth"].reshape(N_cam, B, 1)
        mask = valid.reshape(N_cam, B, 1)
        l_s = losses.depth_smooth_loss(data.cameras.ks, pixel_locs, rend_d, mono_n, mask)
        w = losses.depth_weight_decay(tc.w_smooth, (stepf - tc.smooth_start).clamp_min(0.0))
        loss = loss + w * _gate(stepf, tc.smooth_start, tc.total_step) * l_s
        aux["smooth_loss"] = l_s
    _mark(stage_hook, "losses")
    if tc.w_warp > 0:
        l_w = _warp_loss(params, field_state, data, out, gt_color, valid, stepf, tc,
                         table_axis)
        w = losses.warp_warmup(tc.w_warp, (stepf - tc.warp_start).clamp_min(0.0)) \
            if tc.warp_warming else tc.w_warp
        loss = loss + w * _gate(stepf, tc.warp_start) * l_w
        aux["warp_loss"] = l_w
        _mark(stage_hook, "warp")
    if tc.rho > 0:
        l_admm = losses.admm_penalty(params.se3_refine, admm.shared_se3, admm.delta_se3,
                                     admm.overlap_flags, admm.rho)
        loss = loss + _gate(stepf, tc.syn_start, tc.total_step) * l_admm
        aux["admm_loss"] = l_admm
    aux["total_loss"] = loss
    with torch.no_grad():
        aux["psnr_batch"] = -10.0 * torch.log10(
            losses.rgb_loss(out["pred_color"], gt_color, valid).clamp_min(1e-10))
        err = (out["pred_color"] - gt_color).abs().mean(dim=-1)
        vc = valid.reshape(N_cam, B).to(err.dtype)
        aux["confidence_score"] = 1.0 - (err.reshape(N_cam, B) * vc).sum(dim=1) \
            / vc.sum(dim=1).clamp_min(1.0)
    return loss, aux


def _warp_loss(params, field_state, data, out, gt_color, valid, stepf, tc, table_axis=None):
    """Multi-view photometric warp loss, with its no-grad visibility
    re-render along the neighbour rays (over the sharded table too)."""
    N_cam, H, W = data.images.shape[:3]
    rays_o, rays_d = out["rays_o"], out["rays_d"]
    pts = rays_o + out["pred_depth"] * rays_d  # gradients: depth -> field, and poses
    rts = cam_lib.get_rts(data.cameras, params.se3_refine)
    top_k = min(tc.warp_top_k, N_cam)
    nei_views, nei_valid = losses.view_selection(
        pts.detach(), rays_o, rays_d, data.cameras.ks, rts.detach(), H, W, top_k)
    grid, nei_o, nei_d, proj_depth = losses.project_to_neighbors(
        pts, data.cameras.ks, rts, nei_views)
    nei_color, nei_valid = losses.sample_neighbor_color(
        grid, nei_views, nei_valid, data.images, data.occlusions)

    B, K = nei_views.shape
    with torch.no_grad():
        nei_out = _render(field_lib.detached(params.field), field_state,
                          nei_o.reshape(-1, 3), nei_d.reshape(-1, 3), tc.warp_vis_sample,
                          tc.warp_vis_bg_sample, stepf, tc, table_axis, train=False,
                          num_march=tc.warp_vis_march)
    voxel = (field_state.bbox_size
             / field_state.resolutions[-1].max().to(torch.float32)).max()
    vis = torch.exp(-tc.alpha * (nei_out["pred_depth"].reshape(B, K, 1) - proj_depth).abs()
                    / voxel)
    nei_diffuse = losses.soft_diffuse(nei_out["pred_specular"].reshape(B, K, 3), tc.gamma)
    score = torch.where(nei_valid[..., None], vis * nei_diffuse, torch.zeros_like(vis))
    ref_diffuse = losses.soft_diffuse(out["pred_specular"], tc.gamma).detach()
    score = score * ref_diffuse[:, None, :]
    pred_color = (out["pred_diffuse"] + out["pred_specular"]).clamp(0.0, 1.0)
    return losses.warp_loss_value(pred_color, nei_color, score, valid, top_k)


def _mark(hook, name: str) -> None:
    if hook is not None:
        hook(name)


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------

def sample_patches(generator: torch.Generator, H: int, W: int, num_patch: int,
                   device="cpu"):
    """2x2 patches from independent x / y permutations (with replacement
    when there are more patches than columns or rows) -> (ray_idx [4P]
    int64, pixel_locs [4P, 2]). ``generator`` is a CPU generator."""
    def pick(n):
        if num_patch <= n:
            return torch.randperm(n, generator=generator)[:num_patch]
        return torch.randint(0, n, (num_patch,), generator=generator)

    patch_x, patch_y = pick(W - 2), pick(H - 2)
    patch_idx = patch_y * W + patch_x
    offsets = torch.tensor([0, 1, W, W + 1])
    ray_idx = (patch_idx[:, None] + offsets[None, :]).reshape(-1).to(device)
    return ray_idx, torch.stack([ray_idx % W, torch.div(ray_idx, W, rounding_mode="floor")],
                                dim=-1)


def batch_generator(seed: int, mesh=None, tile: int = 0) -> torch.Generator:
    """The CPU generator a rank draws a tile's batches from: seeded from
    ``seed``, the tile and the rank's index on the mesh's ``rays`` axis
    (the JAX step folds its key with that index), so that replicas along
    the rays axis draw independent batches and ranks along the table axis
    the same one."""
    rays = 0 if mesh is None else mesh.index("rays")
    return torch.Generator().manual_seed(seed * 1000 + tile + 1_000_003 * rays)


def compute_grads(state: TrainState, data: TileData, tc: TrainConfig,
                  generator: torch.Generator | None = None, ray_idx=None, pixel_locs=None,
                  stage_hook=None, table_axis=None, grad_axis=None):
    """One batch's ((loss, aux), grads), grads per optimizer group. The
    batch comes from ``sample_patches(generator, ...)`` unless ``ray_idx``
    and ``pixel_locs`` [N_cam, 4P, 2] are given. ``table_axis``: see
    ``compute_losses``; the grads are this rank's (no mean over
    ``grad_axis`` here)."""
    N_cam, H, W = data.images.shape[:3]
    if ray_idx is None:
        num_patch = max((2**tc.batch_log2) // N_cam // 4, 1)
        ray_idx, locs = sample_patches(generator, H, W, num_patch, device=data.images.device)
        pixel_locs = locs[None].expand(N_cam, *locs.shape)
    p = state.params

    def track(t):  # a leaf sharing t's storage
        return t.detach().requires_grad_()

    tracked = TileParams(
        field=FieldParams(features=track(p.field.features),
                          decoder={n: {k: track(v) for k, v in d.items()}
                                   for n, d in p.field.decoder.items()}),
        se3_refine=track(p.se3_refine))
    loss, aux = compute_losses(tracked, state.field_state, state.admm, data, ray_idx,
                               pixel_locs, state.step, tc, stage_hook, table_axis, grad_axis)
    groups = group_leaves(tracked)
    flat = [t for name in ("hash", "decoder", "cam") for t in groups[name]]
    g = torch.autograd.grad(loss, flat)
    n_dec = len(groups["decoder"])
    _mark(stage_hook, "backward")
    aux = {k: v.detach() for k, v in aux.items()}
    return (loss.detach(), aux), {"hash": g[:1], "decoder": g[1:1 + n_dec],
                                  "cam": g[1 + n_dec:]}


def mean_over(grads: dict, aux: dict, axis) -> tuple[dict, dict]:
    """The gradients and the aux metrics averaged over ``axis`` (the JAX
    step's pmean over its ``grad_axis``): each table gradient in one
    all_reduce in place, the rest in one flat all_reduce."""
    if axis is None or axis.size == 1:
        return grads, aux
    for g in grads["hash"]:
        mesh_lib.all_reduce(g, axis).div_(axis.size)
    small = [(k, i) for k in ("decoder", "cam") for i in range(len(grads[k]))]
    keys = list(aux)
    means = mesh_lib.all_reduce_mean([grads[k][i] for k, i in small]
                                     + [aux[k] for k in keys], axis)
    out = {"hash": grads["hash"], "decoder": list(grads["decoder"]), "cam": list(grads["cam"])}
    for (k, i), m in zip(small, means):
        out[k][i] = m
    return out, dict(zip(keys, means[len(small):]))


def train_step(state: TrainState, data: TileData, tc: TrainConfig,
               generator: torch.Generator | None = None, ray_idx=None, pixel_locs=None,
               device="cuda", stage_hook=None, grad_axis=None, table_axis=None):
    """One optimizer step, in place -> (state, aux). The batch is drawn
    from ``generator`` (a CPU generator) unless ``ray_idx`` and
    ``pixel_locs`` are given. With ``grad_axis`` (ray data parallelism,
    ``tc.ray_shards``) the gradients and aux are averaged over it before
    the update; ``table_axis`` carries a sharded table
    (``tc.table_shards``)."""
    _check_device(state.params.field.features, device)
    (loss, aux), grads = compute_grads(state, data, tc, generator, ray_idx, pixel_locs,
                                       stage_hook, table_axis, grad_axis)
    grads, aux = mean_over(grads, aux, grad_axis)
    apply_gradients(state, grads, tc)
    state.step += 1
    _mark(stage_hook, "optimizer")
    return state, aux


def train_n_steps(state: TrainState, data: TileData, tc: TrainConfig, n: int,
                  generator: torch.Generator, device="cuda"):
    """``n`` steps of ``train_step`` in a host loop, each batch drawn from
    ``generator`` -> (state, the last step's aux)."""
    aux = None
    for _ in range(n):
        state, aux = train_step(state, data, tc, generator, device=device)
    return state, aux


# ---------------------------------------------------------------------------
# evaluation renders
# ---------------------------------------------------------------------------

@torch.no_grad()
def render_chunk(params: TileParams, field_state: FieldState, rays_o, rays_d, step,
                 tc: TrainConfig, device="cuda") -> dict:
    """Evaluation render of one chunk of rays (no gradient, no training
    outputs) with the tile's field at ``step``, in the configuration of
    ``tc`` (fused or unfused decoder)."""
    _check_device(params.field.features, device)
    stepf = torch.as_tensor(step, dtype=torch.float32, device=rays_o.device)
    return _render(params.field, field_state, rays_o, rays_d, tc.num_sample,
                   tc.num_bg_sample, stepf, tc, train=False, num_march=tc.num_march)


def _render_rays_chunked(state: TrainState, rays_o, rays_d, tc, chunk, keys, device):
    """``render_chunk`` over rays in chunks of at most ``chunk`` (the last
    one padded with rays of direction 1) -> {key: numpy [n, ...]}."""
    n = rays_o.shape[0]
    chunk = min(chunk, n)
    pad = (-n) % chunk
    rays_o = torch.nn.functional.pad(rays_o, (0, 0, 0, pad))
    rays_d = torch.nn.functional.pad(rays_d, (0, 0, 0, pad), value=1.0)
    outs = {k: [] for k in keys}
    for i in range(0, n + pad, chunk):
        out = render_chunk(state.params, state.field_state, rays_o[i:i + chunk],
                           rays_d[i:i + chunk], state.step, tc, device=device)
        for k in keys:
            outs[k].append(out[k])
    return {k: torch.cat(v)[:n].cpu().numpy() for k, v in outs.items()}


def render_depth_batch(state: TrainState, cams: Cameras, view_idxs: list[int], H: int,
                       W: int, tc: TrainConfig, chunk: int = 2**14, k_scale=1.0,
                       device="cuda") -> np.ndarray:
    """Depth maps [V, H, W] f32 of several views rendered as one chunked
    ray stream. ``k_scale`` (scalar or (sx, sy)) scales the intrinsics'
    rows so that a downscaled H x W render covers the native camera's
    field of view."""
    from scanerf_tpu_torch.utils import rays as rays_mod

    dev = _check_device(state.params.field.features, device)
    sx, sy = (k_scale, k_scale) if np.isscalar(k_scale) else k_scale
    xy = rays_mod.pixel_grid(H, W, device=dev)
    rts = cam_lib.get_rts(cams, state.params.se3_refine)
    scale = torch.tensor([[sx] * 3, [sy] * 3, [1.0] * 3], dtype=torch.float32, device=dev)
    rays = [rays_mod.get_center_and_ray(xy, rts[v], cams.ks[v] * scale) for v in view_idxs]
    depth = _render_rays_chunked(state, torch.cat([o for o, _ in rays]),
                                 torch.cat([d for _, d in rays]), tc, chunk,
                                 ("pred_depth",), dev)["pred_depth"]
    return depth.reshape(len(view_idxs), H, W)


def render_image(state: TrainState, cams: Cameras, view_idx: int, H: int, W: int,
                 tc: TrainConfig, chunk: int = 2**14, device="cuda") -> dict:
    """Full-image evaluation render in chunks -> {"rgb", "depth",
    "diffuse", "specular"}: numpy [H, W, C]."""
    from scanerf_tpu_torch.utils import rays as rays_mod

    dev = _check_device(state.params.field.features, device)
    xy = rays_mod.pixel_grid(H, W, device=dev)
    pose = cam_lib.get_rts(cams, state.params.se3_refine)[view_idx]
    rays_o, rays_d = rays_mod.get_center_and_ray(xy, pose, cams.ks[view_idx])
    keys = {"rgb": "pred_color", "depth": "pred_depth", "diffuse": "pred_diffuse",
            "specular": "pred_specular"}
    out = _render_rays_chunked(state, rays_o, rays_d, tc, chunk, tuple(keys.values()), dev)
    return {k: out[v].reshape(H, W, -1) for k, v in keys.items()}
