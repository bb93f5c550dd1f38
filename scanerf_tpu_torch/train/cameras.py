"""Bundle-adjusting camera model (counterpart of
``scanerf_tpu/train/cameras.py:20-72``): base world-to-camera poses, a
learnable ``se3_refine`` [N, 6] composed through the exp map, and ray
generation differentiable in ``se3_refine``."""

from __future__ import annotations

import dataclasses

import torch

from scanerf_tpu_torch.utils import lie, rays


@dataclasses.dataclass
class Cameras:
    """Static (not trained) camera data of one tile."""

    ks: torch.Tensor  # [N, 3, 3]
    rts: torch.Tensor  # [N, 3, 4] base w2c poses (noise already applied)
    gt_rts: torch.Tensor  # [N, 3, 4] ground-truth w2c poses


def make_cameras(ks, c2ws, noise_se3=None, gt_c2ws=None) -> Cameras:
    ori_rts = lie.invert(c2ws)
    rts = lie.compose([lie.se3_to_SE3(noise_se3), ori_rts]) if noise_se3 is not None \
        else ori_rts
    gt_rts = lie.invert(gt_c2ws) if gt_c2ws is not None else ori_rts
    return Cameras(ks=ks, rts=rts, gt_rts=gt_rts)


def init_se3_refine(num_camera: int, device="cpu") -> torch.Tensor:
    return torch.zeros((num_camera, 6), dtype=torch.float32, device=device)


def get_rts(cams: Cameras, se3_refine: torch.Tensor) -> torch.Tensor:
    """Refined w2c poses: exp(se3) o base."""
    return lie.compose([lie.se3_to_SE3(se3_refine), cams.rts])


def get_rays(cams: Cameras, se3_refine: torch.Tensor, xy: torch.Tensor):
    """Rays [N, B, 3] (origins, directions) for pixel coords xy [B, 2]
    shared by all cameras, or [N, B, 2] per camera; differentiable in
    ``se3_refine``."""
    return rays.get_center_and_ray(xy, get_rts(cams, se3_refine), cams.ks)
