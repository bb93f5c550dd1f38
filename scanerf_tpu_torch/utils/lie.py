"""SE(3)/SO(3) exp maps and [R | t] pose algebra (counterpart of
``scanerf_tpu/utils/lie.py:25-200``). Poses are [..., 3, 4] world-to-camera
matrices ``[R | t]``.

The exp maps use the reference's 10-term Taylor series of
A = sin(x)/x, B = (1-cos(x))/x^2 and C = (x-sin(x))/x^3, evaluated in
theta^2: the series hold only even powers, so no norm is taken and the
gradient at theta = 0 (where every training run starts) is finite.
"""

from __future__ import annotations

import torch


def _taylor_A2(x2: torch.Tensor, nth: int = 10) -> torch.Tensor:
    ans = torch.zeros_like(x2)
    denom = 1.0
    for i in range(nth + 1):
        if i > 0:
            denom *= (2 * i) * (2 * i + 1)
        ans = ans + (-1) ** i * x2**i / denom
    return ans


def _taylor_B2(x2: torch.Tensor, nth: int = 10) -> torch.Tensor:
    ans = torch.zeros_like(x2)
    denom = 1.0
    for i in range(nth + 1):
        denom *= (2 * i + 1) * (2 * i + 2)
        ans = ans + (-1) ** i * x2**i / denom
    return ans


def _taylor_C2(x2: torch.Tensor, nth: int = 10) -> torch.Tensor:
    ans = torch.zeros_like(x2)
    denom = 1.0
    for i in range(nth + 1):
        denom *= (2 * i + 2) * (2 * i + 3)
        ans = ans + (-1) ** i * x2**i / denom
    return ans


def skew(w: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> [..., 3, 3] skew-symmetric matrix."""
    w0, w1, w2 = w[..., 0], w[..., 1], w[..., 2]
    O = torch.zeros_like(w0)
    return torch.stack([
        torch.stack([O, -w2, w1], dim=-1),
        torch.stack([w2, O, -w0], dim=-1),
        torch.stack([-w1, w0, O], dim=-1),
    ], dim=-2)


def so3_to_SO3(w: torch.Tensor) -> torch.Tensor:
    """Axis-angle [..., 3] -> rotation [..., 3, 3]."""
    wx = skew(w)
    theta2 = (w * w).sum(dim=-1)[..., None, None]
    I = torch.eye(3, dtype=w.dtype, device=w.device)
    return I + _taylor_A2(theta2) * wx + _taylor_B2(theta2) * (wx @ wx)


def se3_to_SE3(wu: torch.Tensor) -> torch.Tensor:
    """Twist [..., 6] (w | u) -> pose [..., 3, 4]."""
    w, u = wu[..., :3], wu[..., 3:]
    wx = skew(w)
    theta2 = (w * w).sum(dim=-1)[..., None, None]
    I = torch.eye(3, dtype=wu.dtype, device=wu.device)
    A, B, C = _taylor_A2(theta2), _taylor_B2(theta2), _taylor_C2(theta2)
    R = I + A * wx + B * (wx @ wx)
    V = I + B * wx + C * (wx @ wx)
    return torch.cat([R, V @ u[..., None]], dim=-1)


def make_pose(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return torch.cat([R, t[..., None]], dim=-1)


def invert(pose: torch.Tensor) -> torch.Tensor:
    """Invert a [..., 3, 4] pose via R^T."""
    R, t = pose[..., :3], pose[..., 3:]
    R_inv = R.transpose(-1, -2)
    t_inv = (-R_inv @ t)[..., 0]
    return make_pose(R_inv, t_inv)


def compose_pair(pose_a: torch.Tensor, pose_b: torch.Tensor) -> torch.Tensor:
    """pose_new(x) = pose_b(pose_a(x))."""
    R_a, t_a = pose_a[..., :3], pose_a[..., 3:]
    R_b, t_b = pose_b[..., :3], pose_b[..., 3:]
    return make_pose(R_b @ R_a, (R_b @ t_a + t_b)[..., 0])


def compose(pose_list) -> torch.Tensor:
    pose_new = pose_list[0]
    for p in pose_list[1:]:
        pose_new = compose_pair(pose_new, p)
    return pose_new


def to_hom(X: torch.Tensor) -> torch.Tensor:
    return torch.cat([X, torch.ones_like(X[..., :1])], dim=-1)


def world2cam(X: torch.Tensor, pose: torch.Tensor) -> torch.Tensor:
    return to_hom(X) @ pose.transpose(-1, -2)


def cam2img(X: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    return X @ K.transpose(-1, -2)


def img2cam(X: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    return X @ torch.linalg.inv(K).transpose(-1, -2)


def cam2world(X: torch.Tensor, pose: torch.Tensor) -> torch.Tensor:
    return to_hom(X) @ invert(pose).transpose(-1, -2)
