"""Hash-table helpers of the windowed layout (counterpart of
``scanerf_tpu/ops/hash_encode.py:40,89,301``). The global prime-XOR hash
waits for the staged backend."""

from __future__ import annotations

import numpy as np
import torch


def as_3d(features: torch.Tensor, n_features: int = 2) -> torch.Tensor:
    """Normalize a hash table to [L, H, F] (exports may be flat [L, H*F])."""
    if features.ndim == 2:
        L, HF = features.shape
        return features.reshape(L, HF // n_features, n_features)
    return features


def make_level_resolutions(
    base_resolution, finest_resolution, n_levels: int = 16
) -> np.ndarray:
    """Geometric per-level per-axis resolutions [L, 3] int32."""
    base = np.asarray(base_resolution, dtype=np.float64).reshape(3)
    finest = np.asarray(finest_resolution, dtype=np.float64).reshape(3)
    b = np.exp((np.log(finest) - np.log(base)) / (n_levels - 1))
    levels = [(base * b**i).astype(np.int32) for i in range(n_levels)]
    return np.stack(levels, axis=0)


def init_features(generator: torch.Generator, n_levels: int, log2_hashmap_size: int,
                  n_features: int = 2, device="cpu") -> torch.Tensor:
    """Xavier-normal table init (the reference default), flat [L, H*F] f32:
    std = sqrt(2 / (H*F + L)). ``generator`` lives on ``device``."""
    H = 2**log2_hashmap_size
    std = float(np.sqrt(2.0 / (H * n_features + n_levels)))
    return std * torch.randn((n_levels, H * n_features), generator=generator,
                             dtype=torch.float32, device=device)
