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


def spatial_hidden(params: dict, features: torch.Tensor) -> torch.Tensor:
    return _linear(params["spatial1"], gaussian_act(_linear(params["spatial0"], features)))


def apply_decoder(params: dict, features, viewdirs, weight_feature=None) -> dict:
    """Decoder forward. features [..., 32], viewdirs [..., 3] (not
    normalized), optional annealing weights [32]. Params may carry a
    leading batch dim matching the features' first dim (one decoder per
    chunk). Returns sigma [..., 1] and diffuse / tint / specular [..., 3]."""
    viewdirs = viewdirs / (torch.linalg.vector_norm(viewdirs, dim=-1, keepdim=True) + 1e-8)
    if weight_feature is not None:
        features = features * weight_feature
    H = spatial_hidden(params, features)
    h_geo, h_dir = H[..., :32], H[..., 32:]
    sigma = softplus(_linear(params["sigma"], h_geo))
    diffuse = torch.sigmoid(_linear(params["diffuse"], h_geo))
    tint = torch.sigmoid(_linear(params["tint"], h_geo))
    d = torch.cat([h_dir, sh_encoding(3, viewdirs)], dim=-1)
    d = gaussian_act(_linear(params["dir0"], d))
    d = gaussian_act(_linear(params["dir1"], d))
    specular = torch.sigmoid(_linear(params["dir2"], d))
    return {"sigma": sigma, "diffuse": diffuse, "specular": specular, "tint": tint}


def _linear_init(generator: torch.Generator, fan_in: int, fan_out: int, device) -> dict:
    """torch.nn.Linear's default init, U(-1/sqrt(fan_in), 1/sqrt(fan_in)),
    of a weight [fan_in, fan_out] and then a bias [fan_out]."""
    bound = 1.0 / float(np.sqrt(fan_in))
    return {k: (torch.rand(shape, generator=generator, device=device) * 2 - 1) * bound
            for k, shape in (("w", (fan_in, fan_out)), ("b", (fan_out,)))}


def init_decoder(generator: torch.Generator, device="cpu") -> dict:
    """Every layer at torch.nn.Linear's default init. ``generator`` lives
    on ``device``."""
    return {name: _linear_init(generator, *SHAPES[name], device) for name in PACK_ORDER}


def inference_sigma(params: dict, features: torch.Tensor) -> torch.Tensor:
    """Density alone, [..., 1], of features [..., 32] (annealing weights
    already applied)."""
    return softplus(_linear(params["sigma"], spatial_hidden(params, features)[..., :32]))


def positional_encoding(x: torch.Tensor, L: int) -> torch.Tensor:
    """[x, sin(2^i x), cos(2^i x)] for i < L."""
    outs = [x]
    for i in range(L):
        outs.append(torch.sin(2.0**i * x))
        outs.append(torch.cos(2.0**i * x))
    return torch.cat(outs, dim=-1)


def weighted_positional_encoding(x: torch.Tensor, L: int, global_step, start: float,
                                 end: float) -> torch.Tensor:
    """BARF's coarse-to-fine encoding: band k weighs
    (1 - cos(clip(alpha - k, 0, 1) * pi)) / 2 at
    alpha = (step - start) / (end - start) * L."""
    emb = positional_encoding(x, L)
    step = torch.as_tensor(global_step, dtype=x.dtype, device=x.device)
    alpha = ((step - start) / (end - start) * L).clamp(0.0, L)
    k = torch.arange(L, dtype=x.dtype, device=x.device)
    w = (1.0 - torch.cos((alpha - k).clamp(0.0, 1.0) * np.pi)) / 2.0
    C = x.shape[-1]
    band_w = w.repeat_interleave(2 * C)  # sin and cos of each band, per channel
    return torch.cat([emb[..., :C], emb[..., C:] * band_w], dim=-1)


def init_general_mlp(generator: torch.Generator, num_in: int, num_out: int,
                     hidden_depth: int = 4, hidden_width: int = 64,
                     device="cpu") -> list[dict]:
    """A general MLP's layers at torch.nn.Linear's default init: depth 1
    is one linear layer, else in -> width, (depth - 2) x width -> width,
    width -> out."""
    if hidden_depth == 1:
        return [_linear_init(generator, num_in, num_out, device)]
    dims = [num_in] + [hidden_width] * (hidden_depth - 1) + [num_out]
    return [_linear_init(generator, a, b, device) for a, b in zip(dims[:-1], dims[1:])]


def apply_general_mlp(layers: list[dict], x: torch.Tensor, activation=gaussian_act,
                      output_act: bool = False) -> torch.Tensor:
    for i, p in enumerate(layers):
        x = _linear(p, x)
        if i < len(layers) - 1 or output_act:
            x = activation(x)
    return x


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
