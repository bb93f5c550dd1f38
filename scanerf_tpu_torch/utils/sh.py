"""Real spherical harmonics basis, degrees 0-3 (the decoder uses degree 3,
16 coefficients). Counterpart of ``scanerf_tpu/utils/sh.py``."""

from __future__ import annotations

import torch

C0 = 0.28209479177387814
C1 = 0.4886025119029199
C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
      -1.0925484305920792, 0.5462742152960396)
C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
      0.3731763325901154, -0.4570457994644658, 1.445305721320277,
      -0.5900435899266435)


def sh_encoding(deg: int, dirs: torch.Tensor) -> torch.Tensor:
    """SH basis at unit directions ``[..., 3]`` -> ``[..., (deg+1)**2]``."""
    if not 0 <= deg <= 3:
        raise ValueError(f"degree {deg} not in 0..3")
    result = [torch.ones_like(dirs[..., :1]) * C0]
    if deg > 0:
        x, y, z = dirs[..., 0:1], dirs[..., 1:2], dirs[..., 2:3]
        result += [C1 * y, C1 * z, C1 * x]
        if deg > 1:
            xx, yy, zz = x * x, y * y, z * z
            xy, yz, xz = x * y, y * z, x * z
            result += [
                C2[0] * xy, C2[1] * yz, C2[2] * (2.0 * zz - xx - yy),
                C2[3] * xz, C2[4] * (xx - yy),
            ]
            if deg > 2:
                result += [
                    C3[0] * y * (3 * xx - yy),
                    C3[1] * xy * z,
                    C3[2] * y * (4 * zz - xx - yy),
                    C3[3] * z * (2 * zz - 3 * xx - 3 * yy),
                    C3[4] * x * (4 * zz - xx - yy),
                    C3[5] * z * (xx - yy),
                    C3[6] * x * (xx - 3 * yy),
                ]
    return torch.cat(result, dim=-1)
