"""Pose helpers that ray generation needs: ``invert`` and the camera
transforms (counterpart of ``scanerf_tpu/utils/lie.py:142-200``).
Poses are [..., 3, 4] ``[R | t]``."""

from __future__ import annotations

import torch


def make_pose(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return torch.cat([R, t[..., None]], dim=-1)


def invert(pose: torch.Tensor) -> torch.Tensor:
    """Invert a [..., 3, 4] pose via R^T."""
    R, t = pose[..., :3], pose[..., 3:]
    R_inv = R.transpose(-1, -2)
    t_inv = (-R_inv @ t)[..., 0]
    return make_pose(R_inv, t_inv)


def to_hom(X: torch.Tensor) -> torch.Tensor:
    return torch.cat([X, torch.ones_like(X[..., :1])], dim=-1)


def img2cam(X: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    return X @ torch.linalg.inv(K).transpose(-1, -2)


def cam2world(X: torch.Tensor, pose: torch.Tensor) -> torch.Tensor:
    return to_hom(X) @ invert(pose).transpose(-1, -2)
