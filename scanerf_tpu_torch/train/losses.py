"""Training losses (counterpart of ``scanerf_tpu/train/losses.py``): RGB,
monocular depth consistency and smoothness, the multi-view warp loss and
the ADMM consensus penalty. Boolean ray compression is replaced by masked
reductions whose denominators match the reference's (mean over the
selected rays).
"""

from __future__ import annotations

import torch


def masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """sum(x * mask) / sum(mask), 0 when the mask is empty."""
    return (x * mask).sum() / mask.sum().clamp_min(1.0)


def rgb_loss(pred, target, valid) -> torch.Tensor:
    """MSE over the valid rays (mean over rays and channels)."""
    per_ray = ((pred - target) ** 2).mean(dim=-1)
    return masked_mean(per_ray, valid.to(per_ray.dtype))


def compute_scale_and_shift(prediction, target, mask):
    """Closed-form per-camera least squares; shapes [N, B, 1] -> ([N], [N]).
    A camera whose system is singular (an all-masked camera) gets 0, 0."""
    a_00 = (mask * prediction * prediction).sum(dim=(1, 2))
    a_01 = (mask * prediction).sum(dim=(1, 2))
    a_11 = mask.sum(dim=(1, 2))
    b_0 = (mask * prediction * target).sum(dim=(1, 2))
    b_1 = (mask * target).sum(dim=(1, 2))
    det = a_00 * a_11 - a_01 * a_01
    ok = det != 0
    safe_det = torch.where(ok, det, torch.ones_like(det))
    zero = torch.zeros_like(det)
    x_0 = torch.where(ok, (a_11 * b_0 - a_01 * b_1) / safe_det, zero)
    x_1 = torch.where(ok, (-a_01 * b_0 + a_00 * b_1) / safe_det, zero)
    return x_0, x_1


def depth_consistency_loss(rendered_depth, monocular_depth, mask) -> torch.Tensor:
    """Scale/shift-aligned masked MSE against the mono depth."""
    h0, h1 = compute_scale_and_shift(rendered_depth, monocular_depth, mask)
    scaled = rendered_depth * h0[:, None, None] + h1[:, None, None]
    return masked_mean((scaled - monocular_depth) ** 2, mask)


def _normalize(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True).clamp_min(eps)


def depth_smooth_loss(ks, pixel_locs, rendered_depth, monocular_normal, mask):
    """2x2-patch depth gradients against the mono normals: ks [N,3,3],
    pixel_locs [N,B,2], rendered_depth [N,B,1], monocular_normal [N,B,3],
    mask [N,B,1]; B = 4 * patches."""
    N = ks.shape[0]
    locs_h = torch.cat([pixel_locs.to(rendered_depth.dtype),
                        torch.ones_like(pixel_locs[..., :1], dtype=rendered_depth.dtype)], -1)
    pts_cam = torch.einsum("nij,nbj->nbi", torch.linalg.inv(ks), locs_h) * rendered_depth
    pts_cam = pts_cam.reshape(N, -1, 2, 2, 3)
    normal = monocular_normal.reshape(N, -1, 2, 2, 3)
    m = mask.reshape(N, -1, 4)
    mean_normal = normal.mean(dim=(2, 3))
    sim = (normal * mean_normal[:, :, None, None, :]).sum(dim=-1)
    valid = (sim.reshape(N, -1, 4) > 0.9).all(dim=-1) & m.bool().all(dim=-1)
    mean_n = _normalize(mean_normal)
    grad_y = _normalize(pts_cam[:, :, 1, :, :] - pts_cam[:, :, 0, :, :])
    grad_x = _normalize(pts_cam[:, :, :, 1, :] - pts_cam[:, :, :, 0, :])
    cos = 0.5 * (mean_n[:, :, None, :] * grad_y).sum(dim=-1).abs().mean(dim=-1) \
        + 0.5 * (mean_n[:, :, None, :] * grad_x).sum(dim=-1).abs().mean(dim=-1)
    return masked_mean(cos, valid.to(cos.dtype))


def view_cost(pts, rays_o, rays_d, ks, rts, H: int, W: int, gamma: float = 0.1):
    """Per-(camera, ray) neighbour cost [N_cam, B]:
    0.9 (1 - cos(ray, neighbour ray)) + 0.1 max(0, 1 - d_ref / d_nei);
    1 when the point is behind the camera or projects out of frame."""
    R, t = rts[..., :3], rts[..., 3]
    centers = -torch.einsum("nij,ni->nj", R, t)
    x_cam = torch.einsum("nij,bj->nbi", R, pts) + t[:, None, :]
    uvz = torch.einsum("nij,nbj->nbi", ks, x_cam)
    z = uvz[..., 2]
    zs = torch.where(z == 0, torch.ones_like(z), z)
    x, y = uvz[..., 0] / zs, uvz[..., 1] / zs
    out_of_view = (z <= 0.001) | (x <= 0) | (x >= W - 1) | (y <= 0) | (y >= H - 1)
    direction = _normalize(rays_d)[None]
    nei_dir = _normalize(pts[None] - centers[:, None, :])
    angle_cost = 1.0 - (direction * nei_dir).sum(dim=-1)
    d_ref = torch.linalg.vector_norm(pts[None] - rays_o[None], dim=-1)
    d_nei = torch.linalg.vector_norm(pts[None] - centers[:, None, :], dim=-1).clamp_min(1e-8)
    dis_cost = (1.0 - d_ref / d_nei).clamp_min(0.0)
    cost = (1.0 - gamma) * angle_cost + gamma * dis_cost
    return torch.where(out_of_view, torch.ones_like(cost), cost)


@torch.no_grad()
def view_selection(pts, rays_o, rays_d, ks, rts, H: int, W: int, top_k: int = 10,
                   cost_thresh: float = 0.176):
    """The top_k lowest-cost neighbour views per ray -> (nei_views [B, K]
    int64, nei_valid [B, K] bool); ties go to the lower camera index, as
    ``lax.top_k`` takes them (a stable sort). No gradient."""
    cost = view_cost(pts, rays_o, rays_d, ks, rts, H, W).t()  # [B, N]
    vals, idx = torch.sort(cost, dim=-1, stable=True)
    return idx[:, :top_k], vals[:, :top_k] <= cost_thresh


def project_to_neighbors(pts, ks, rts, nei_views):
    """Projection of pts [B, 3] into the neighbour views (gradients reach
    pts and the poses) -> grid [B,K,2] (pixel coords, the +0.5 centre
    removed), and, without gradient, the neighbour centres [B,K,3], the
    unit-z camera rays through the points [B,K,3] and the depths [B,K,1]."""
    rts_k, ks_k = rts[nei_views], ks[nei_views]
    R, t = rts_k[..., :3], rts_k[..., 3]
    x_cam = torch.einsum("bkij,bj->bki", R, pts) + t
    uvz = torch.einsum("bkij,bkj->bki", ks_k, x_cam)
    z = uvz[..., 2:]
    grid = uvz[..., :2] / (z + 1e-8) - 0.5
    centers = -torch.einsum("bkij,bki->bkj", R, t)
    dir_cam = x_cam / (x_cam[..., 2:] + 1e-8)
    nei_direction = torch.einsum("bkij,bki->bkj", R, dir_cam)
    return grid, centers.detach(), nei_direction.detach(), z.detach()


def sample_neighbor_color(grid, nei_views, nei_valid, images, occlusions):
    """Bilinear fetch of neighbour colours: corner colours carry no
    gradient, the weights do (through grid). images [N, H, W, 3],
    occlusions [N, H, W] bool or None."""
    H, W = images.shape[1:3]
    lt = torch.floor(grid).to(torch.int64)
    offset = grid - lt.to(grid.dtype)
    nearest = torch.floor(grid + 0.5).to(torch.int64)

    def fetch(ix, iy):
        return images[nei_views, iy.clamp(0, H - 1), ix.clamp(0, W - 1)].detach()

    lt_c = fetch(lt[..., 0], lt[..., 1])
    rt_c = fetch(lt[..., 0] + 1, lt[..., 1])
    lb_c = fetch(lt[..., 0], lt[..., 1] + 1)
    rb_c = fetch(lt[..., 0] + 1, lt[..., 1] + 1)
    ox, oy = offset[..., 0:1], offset[..., 1:2]
    color = (1 - ox) * (1 - oy) * lt_c + ox * (1 - oy) * rt_c \
        + (1 - ox) * oy * lb_c + ox * oy * rb_c
    inb = (lt[..., 0] >= 0) & (lt[..., 0] + 1 <= W - 1) & (lt[..., 1] >= 0) \
        & (lt[..., 1] + 1 <= H - 1)
    valid = nei_valid & inb
    if occlusions is not None:
        valid = valid & occlusions[nei_views, nearest[..., 1].clamp(0, H - 1),
                                   nearest[..., 0].clamp(0, W - 1)]
    return color, valid


def soft_vis(depth_diff, alpha: float, voxel_size: float):
    """exp(-alpha * |depth diff| / voxel)."""
    return torch.exp(-alpha * depth_diff / voxel_size)


def soft_diffuse(specular, gamma: float):
    """exp(-gamma * mean(specular))."""
    return torch.exp(-gamma * specular.mean(dim=-1, keepdim=True))


def warp_loss_value(pred_color, neighbor_color, warping_score, ray_valid, top_k: int):
    """Weighted MSE over (valid rays x K): invalid neighbours add 0 but
    count in the denominator, as in the reference."""
    mse = ((pred_color[:, None, :] - neighbor_color) ** 2).mean(dim=-1, keepdim=True)
    num = (mse * warping_score * ray_valid[:, None, None]).sum()
    return num / (ray_valid.to(mse.dtype).sum().clamp_min(1.0) * top_k)


def admm_penalty(se3_refine, shared_se3, delta_se3, overlap_flags, rho):
    """mean over the overlapping cameras' [n, 6] block of
    rho * (se3 - z + u)^2."""
    weighted = rho[None, :] * (se3_refine - shared_se3 + delta_se3) ** 2
    mask = overlap_flags.to(weighted.dtype)
    return (weighted * mask[:, None]).sum() / (mask.sum() * 6.0).clamp_min(1.0)


def warp_warmup(weight: float, step):
    return weight * (step / 10000.0).clamp(0.0, 1.0)


def depth_weight_decay(weight: float, step):
    return weight * 0.1 ** (step / 30000.0)
