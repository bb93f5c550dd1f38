"""ShallowMLP radiance decoder (counterpart of
``scanerf_tpu/models/decoder.py``).

Spatial MLP 32 -> 64 (Gaussian act, sigma 0.1) -> 64; heads on the first
32 hidden channels: sigma (softplus), diffuse and tint (sigmoid); the
directional MLP on the last 32 channels plus the degree-3 SH of the
normalized view direction: 48 -> 64 -> 64 (Gaussian acts) -> 3 (sigmoid)
gives the specular base color. Parameters are a plain dict
``{layer: {"w": [in, out], "b": [out]}}`` (the JAX pytree's layout);
``ShallowMLP`` wraps one such dict as an ``nn.Module``.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from scanerf_tpu_torch.utils.sh import sh_encoding

GAUSS_SIGMA = 0.1
# export order of the packed vector: per layer bias, then W as [out, in]
PACK_ORDER = ("spatial0", "spatial1", "sigma", "diffuse", "tint", "dir0",
              "dir1", "dir2")
SHAPES = {  # (fan_in, fan_out)
    "spatial0": (32, 64), "spatial1": (64, 64), "sigma": (32, 1),
    "diffuse": (32, 3), "tint": (32, 3), "dir0": (48, 64), "dir1": (64, 64),
    "dir2": (64, 3),
}
PARAMSIZE = 13994


def gaussian_act(x: torch.Tensor) -> torch.Tensor:
    return torch.exp(x * x * (-1.0 / (2.0 * GAUSS_SIGMA**2)))


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) without torch's linear cut-off above 20."""
    return x.clamp_min(0.0) + torch.log1p(torch.exp(-x.abs()))


def _linear(p: dict, x: torch.Tensor) -> torch.Tensor:
    return x @ p["w"] + p["b"]


def apply_decoder(params: dict, features, viewdirs, weight_feature=None) -> dict:
    """Decoder forward. features [..., 32], viewdirs [..., 3] (not
    normalized), optional annealing weights [32]. Params may carry a
    leading batch dim matching the features' first dim (one decoder per
    chunk). Returns sigma [..., 1] and diffuse / tint / specular [..., 3]."""
    viewdirs = viewdirs / (torch.linalg.vector_norm(viewdirs, dim=-1, keepdim=True) + 1e-8)
    if weight_feature is not None:
        features = features * weight_feature
    h = gaussian_act(_linear(params["spatial0"], features))
    H = _linear(params["spatial1"], h)
    h_geo, h_dir = H[..., :32], H[..., 32:]
    sigma = softplus(_linear(params["sigma"], h_geo))
    diffuse = torch.sigmoid(_linear(params["diffuse"], h_geo))
    tint = torch.sigmoid(_linear(params["tint"], h_geo))
    d = torch.cat([h_dir, sh_encoding(3, viewdirs)], dim=-1)
    d = gaussian_act(_linear(params["dir0"], d))
    d = gaussian_act(_linear(params["dir1"], d))
    specular = torch.sigmoid(_linear(params["dir2"], d))
    return {"sigma": sigma, "diffuse": diffuse, "specular": specular, "tint": tint}


def init_decoder(generator: torch.Generator, device="cpu") -> dict:
    """torch.nn.Linear's default init, U(-1/sqrt(fan_in), 1/sqrt(fan_in)),
    for every layer's weight and bias. ``generator`` lives on ``device``."""
    out = {}
    for name in PACK_ORDER:
        fan_in, fan_out = SHAPES[name]
        bound = 1.0 / float(np.sqrt(fan_in))
        out[name] = {k: (torch.rand(shape, generator=generator, device=device) * 2 - 1) * bound
                     for k, shape in (("w", (fan_in, fan_out)), ("b", (fan_out,)))}
    return out


def pack_params(params: dict) -> torch.Tensor:
    """Param dict -> packed [13994] vector (bias, then W as [out, in])."""
    chunks = []
    for name in PACK_ORDER:
        chunks.append(params[name]["b"].reshape(-1))
        chunks.append(params[name]["w"].t().reshape(-1))
    return torch.cat(chunks)


def unpack_params(vec: torch.Tensor) -> dict:
    """Packed [13994] vector -> param dict."""
    if vec.shape != (PARAMSIZE,):
        raise ValueError(f"packed decoder must be [{PARAMSIZE}], got {tuple(vec.shape)}")
    out, i = {}, 0
    for name in PACK_ORDER:
        fan_in, fan_out = SHAPES[name]
        b = vec[i:i + fan_out]
        i += fan_out
        w = vec[i:i + fan_in * fan_out].reshape(fan_out, fan_in).t()
        i += fan_in * fan_out
        out[name] = {"w": w, "b": b}
    return out


def stack_params(decoders: list[dict]) -> dict:
    """Per-tile param dicts -> one dict with leaves [T, ...]."""
    return {name: {k: torch.stack([d[name][k] for d in decoders])
                   for k in ("w", "b")} for name in PACK_ORDER}


class ShallowMLP(nn.Module):
    """``nn.Module`` wrapper of one decoder's param dict."""

    def __init__(self, params: dict):
        super().__init__()
        self.layers = nn.ModuleDict({
            name: nn.ParameterDict({k: nn.Parameter(v.detach().clone())
                                    for k, v in params[name].items()})
            for name in PACK_ORDER})

    def params(self) -> dict:
        return {name: {"w": self.layers[name]["w"], "b": self.layers[name]["b"]}
                for name in PACK_ORDER}

    def forward(self, features, viewdirs, weight_feature=None) -> dict:
        return apply_decoder(self.params(), features, viewdirs, weight_feature)
