"""LPIPS perceptual distance, AlexNet variant (counterpart of
``scanerf_tpu/eval/lpips.py``), in PyTorch on an explicit device.

As in Zhang et al. 2018: images in [0, 1] RGB are mapped to [-1, 1] and
shifted and scaled per channel; the AlexNet feature stack (conv1-conv5
with ReLU taps, a 3x3 stride-2 max-pool before conv2 and conv3) runs on
both images; each tap is normalised to unit length over channels, the
squared difference is weighed by a learned non-negative 1x1 head, averaged
over the image and summed over the five taps.

The weights are not part of the repository: they load from an ``.npz``
(``convN_w``, ``convN_b``, ``linN_w``; ``scripts/export_lpips_weights.py``
writes one from the official package) named by ``SCANERF_LPIPS_WEIGHTS``
or a path. Without it ``LPIPSMetric.available`` is false and callers
report PSNR and SSIM only. The convolutions run in full f32: on the GPU
cuDNN's TF32 is switched off for the call only.
"""

from __future__ import annotations

import contextlib
import os

import numpy as np
import torch
import torch.nn.functional as F

from scanerf_tpu_torch import _device

ENV_VAR = "SCANERF_LPIPS_WEIGHTS"

# the LPIPS scaling layer's per-channel shift and scale
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)

# AlexNet feature stack: (out channels, kernel, stride, padding, max-pool before)
_ALEX = [
    (64, 11, 4, 2, False),
    (192, 5, 1, 2, True),
    (384, 3, 1, 1, True),
    (256, 3, 1, 1, False),
    (256, 3, 1, 1, False),
]


def weights_available(path: str | None = None) -> bool:
    p = path or os.environ.get(ENV_VAR, "")
    return bool(p) and os.path.exists(p)


def load_weights(path: str | None = None) -> dict | None:
    """{convN_w, convN_b, linN_w} numpy arrays; None when there is no file."""
    p = path or os.environ.get(ENV_VAR, "")
    if not p or not os.path.exists(p):
        return None
    with np.load(p) as data:
        return {k: data[k] for k in data.files}


@contextlib.contextmanager
def _full_f32():
    """cuDNN convolutions in f32 rather than TF32 inside the block; the
    caller's setting comes back after it."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def _features(params: dict, x: torch.Tensor) -> list[torch.Tensor]:
    """The five ReLU taps of x [N, 3, H, W] (LPIPS-normalised)."""
    taps = []
    h = x
    for i, (_, _, stride, pad, pool) in enumerate(_ALEX):
        if pool:
            h = F.max_pool2d(h, 3, stride=2)
        h = F.relu(F.conv2d(h, params[f"conv{i}_w"], params[f"conv{i}_b"], stride=stride,
                            padding=pad))
        taps.append(h)
    return taps


def lpips(params: dict, img0, img1) -> torch.Tensor:
    """LPIPS distance of two [H, W, 3] (or [N, H, W, 3]) RGB images in
    [0, 1], on the device of ``params`` (tensors, ``convert.lpips_params``)
    -> a scalar (or [N]) tensor."""
    dev = params["conv0_w"].device
    shift = torch.as_tensor(_SHIFT, device=dev)
    scale = torch.as_tensor(_SCALE, device=dev)

    def prep(im):
        im = torch.as_tensor(np.ascontiguousarray(im) if isinstance(im, np.ndarray) else im,
                             dtype=torch.float32, device=dev)
        if im.ndim == 3:
            im = im[None]
        return ((im * 2.0 - 1.0 - shift) / scale).permute(0, 3, 1, 2)

    with _full_f32():
        t0 = _features(params, prep(img0))
        t1 = _features(params, prep(img1))
    total = 0.0
    for i, (a, b) in enumerate(zip(t0, t1)):
        na = a / torch.sqrt((a * a).sum(dim=1, keepdim=True) + 1e-10)
        nb = b / torch.sqrt((b * b).sum(dim=1, keepdim=True) + 1e-10)
        w = params[f"lin{i}_w"].reshape(1, -1, 1, 1)
        total = total + ((na - nb) ** 2 * w).sum(dim=1).mean(dim=(1, 2))
    return total[0] if total.shape == (1,) else total


class LPIPSMetric:
    """LPIPS with the weights of ``SCANERF_LPIPS_WEIGHTS``, of ``path``, or
    of the numpy dict ``params``, on ``device``; ``available`` is false,
    and a call gives NaN, when there are none."""

    def __init__(self, path: str | None = None, device="cuda", params: dict | None = None):
        from scanerf_tpu_torch import convert

        self.device = _device.resolve(device)
        arrays = params if params is not None else load_weights(path)
        self.available = arrays is not None
        self.params = convert.lpips_params(arrays, self.device) if self.available else None

    def __call__(self, img0, img1) -> float:
        if not self.available:
            return float("nan")
        return float(lpips(self.params, img0, img1))
