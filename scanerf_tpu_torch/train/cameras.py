"""Bundle-adjusting camera model (counterpart of
``scanerf_tpu/train/cameras.py``): base world-to-camera poses, a learnable
``se3_refine`` [N, 6] composed through the exp map, ray generation
differentiable in ``se3_refine``, and the pose error against ground
truth after a Procrustes alignment of the camera centres."""

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


def prealign_cameras(pose: torch.Tensor, pose_gt: torch.Tensor):
    """Poses [N, 3, 4] aligned to ``pose_gt`` by the similarity transform
    that best maps their camera centres onto the ground truth's ->
    (aligned poses, the transform)."""
    center = torch.zeros((1, 3), dtype=pose.dtype, device=pose.device)
    center_pred = lie.cam2world(center, pose)[:, 0]
    center_gt = lie.cam2world(center, pose_gt)[:, 0]
    sim3 = lie.procrustes_analysis(center_gt, center_pred)
    center_aligned = ((center_pred - sim3["t1"]) / sim3["s1"] @ sim3["R"].T * sim3["s0"]
                      + sim3["t0"])
    R_aligned = pose[..., :3] @ sim3["R"].T
    t_aligned = (-R_aligned @ center_aligned[..., None])[..., 0]
    return lie.make_pose(R_aligned, t_aligned), sim3


@torch.no_grad()
def evaluate_camera_alignment(cams: Cameras, se3_refine: torch.Tensor):
    """(mean rotation error in degrees, mean translation error) of the
    refined poses against ``cams.gt_rts``, after ``prealign_cameras``."""
    rts = get_rts(cams, se3_refine)
    aligned, _ = prealign_cameras(rts, cams.gt_rts)
    R_err = lie.rotation_distance(aligned[..., :3], cams.gt_rts[..., :3])
    t_err = torch.linalg.vector_norm(aligned[..., 3] - cams.gt_rts[..., 3], dim=-1)
    return torch.rad2deg(R_err.mean()), t_err.mean()
