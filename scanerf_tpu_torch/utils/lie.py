"""SE(3)/SO(3) exp and log maps, [R | t] pose algebra, quaternions, NDC
and pose evaluation (counterpart of ``scanerf_tpu/utils/lie.py``). Poses
are [..., 3, 4] world-to-camera matrices ``[R | t]``.

The exp maps use the reference's 10-term Taylor series of
A = sin(x)/x, B = (1-cos(x))/x^2 and C = (x-sin(x))/x^3, evaluated in
theta^2: the series hold only even powers, so no norm is taken and the
gradient at theta = 0 (where every training run starts) is finite.
"""

from __future__ import annotations

import math

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


def taylor_A(x: torch.Tensor, nth: int = 10) -> torch.Tensor:
    """sin(x)/x as a truncated Taylor series."""
    return _taylor_A2(x * x, nth)


def taylor_B(x: torch.Tensor, nth: int = 10) -> torch.Tensor:
    """(1-cos(x))/x^2 as a truncated Taylor series."""
    return _taylor_B2(x * x, nth)


def taylor_C(x: torch.Tensor, nth: int = 10) -> torch.Tensor:
    """(x-sin(x))/x^3 as a truncated Taylor series."""
    return _taylor_C2(x * x, nth)


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


def SO3_to_so3(R: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Rotation [..., 3, 3] -> axis-angle [..., 3]."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    theta = torch.arccos(((trace - 1) / 2).clamp(-1 + eps, 1 - eps))
    theta = torch.remainder(theta, math.pi)[..., None, None]
    lnR = 1.0 / (2 * taylor_A(theta) + 1e-8) * (R - R.transpose(-2, -1))
    return torch.stack([lnR[..., 2, 1], lnR[..., 0, 2], lnR[..., 1, 0]], dim=-1)


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


def SE3_to_se3(Rt: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Pose [..., 3, 4] -> twist [..., 6] (w | u)."""
    R, t = Rt[..., :3], Rt[..., 3:]
    w = SO3_to_so3(R)
    wx = skew(w)
    theta = torch.linalg.vector_norm(w, dim=-1)[..., None, None]
    I = torch.eye(3, dtype=Rt.dtype, device=Rt.device)
    A, B = taylor_A(theta), taylor_B(theta)
    invV = I - 0.5 * wx + (1 - A / (2 * B)) / (theta**2 + eps) * (wx @ wx)
    return torch.cat([w, (invV @ t)[..., 0]], dim=-1)


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


def q_to_R(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion [..., 4] (w, x, y, z) -> rotation [..., 3, 3]."""
    qa, qb, qc, qd = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([1 - 2 * (qc**2 + qd**2), 2 * (qb * qc - qa * qd),
                     2 * (qa * qc + qb * qd)], -1),
        torch.stack([2 * (qb * qc + qa * qd), 1 - 2 * (qb**2 + qd**2),
                     2 * (qc * qd - qa * qb)], -1),
        torch.stack([2 * (qb * qd - qa * qc), 2 * (qa * qb + qc * qd),
                     1 - 2 * (qb**2 + qc**2)], -1),
    ], dim=-2)


def R_to_q(R: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Rotation -> quaternion, branch-free (valid away from trace = -1)."""
    def half_sqrt(x):
        return 0.5 * torch.sqrt(x.clamp_min(0.0) + eps)

    t = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    qa = half_sqrt(1 + t)
    qb = torch.sign(R[..., 2, 1] - R[..., 1, 2]) * half_sqrt(
        1 + R[..., 0, 0] - R[..., 1, 1] - R[..., 2, 2])
    qc = torch.sign(R[..., 0, 2] - R[..., 2, 0]) * half_sqrt(
        1 - R[..., 0, 0] + R[..., 1, 1] - R[..., 2, 2])
    qd = torch.sign(R[..., 1, 0] - R[..., 0, 1]) * half_sqrt(
        1 - R[..., 0, 0] - R[..., 1, 1] + R[..., 2, 2])
    return torch.stack([qa, qb, qc, qd], dim=-1)


def q_invert(q: torch.Tensor) -> torch.Tensor:
    conj = q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype, device=q.device)
    return conj / (q * q).sum(dim=-1, keepdim=True)


def q_product(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    a1, b1, c1, d1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    a2, b2, c2, d2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    return torch.stack([
        a1 * a2 - b1 * b2 - c1 * c2 - d1 * d2,
        a1 * b2 + b1 * a2 + c1 * d2 - d1 * c2,
        a1 * c2 - b1 * d2 + c1 * a2 + d1 * b2,
        a1 * d2 + b1 * c2 - c1 * b2 + d1 * a2,
    ], dim=-1)


def convert_ndc(center: torch.Tensor, ray: torch.Tensor, K: torch.Tensor, near: float = 1.0):
    """Shift origins to the near plane and project to NDC (+z forward)."""
    center = center + (near - center[..., 2:]) / ray[..., 2:] * ray
    cx, cy, cz = center[..., 0], center[..., 1], center[..., 2]
    rx, ry, rz = ray[..., 0], ray[..., 1], ray[..., 2]
    scale_x = K[..., 0, 0] / K[..., 0, 2]
    scale_y = K[..., 1, 1] / K[..., 1, 2]
    center_ndc = torch.stack([scale_x * (cx / cz), scale_y * (cy / cz), 1 - 2 * near / cz], -1)
    ray_ndc = torch.stack([scale_x * (rx / rz - cx / cz), scale_y * (ry / rz - cy / cz),
                           2 * near / cz], -1)
    return center_ndc, ray_ndc


def rotation_distance(R1: torch.Tensor, R2: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Geodesic angle between rotations."""
    R_diff = R1 @ R2.transpose(-2, -1)
    trace = R_diff[..., 0, 0] + R_diff[..., 1, 1] + R_diff[..., 2, 2]
    return torch.arccos(((trace - 1) / 2).clamp(-1 + eps, 1 - eps))


def procrustes_analysis(X0: torch.Tensor, X1: torch.Tensor) -> dict:
    """Similarity transform aligning points X1 [N, 3] to X0 [N, 3]:
    {t0, t1, s0, s1, R}. Where the raw solution is a reflection, the
    direction of the smallest singular value is flipped (Kabsch), which
    gives the best rotation; the reference flips the last row of R."""
    t0, t1 = X0.mean(dim=0, keepdim=True), X1.mean(dim=0, keepdim=True)
    X0c, X1c = X0 - t0, X1 - t1
    s0 = torch.sqrt((X0c**2).sum(dim=-1).mean())
    s1 = torch.sqrt((X1c**2).sum(dim=-1).mean())
    U, _, Vh = torch.linalg.svd((X0c / s0).T @ (X1c / s1), full_matrices=False)
    V = Vh.T
    d = torch.linalg.det(U @ V.T)
    one = torch.ones_like(d)
    R = U @ torch.diag(torch.stack([one, one, d])) @ V.T
    return dict(t0=t0[0], t1=t1[0], s0=s0, s1=s1, R=R)
