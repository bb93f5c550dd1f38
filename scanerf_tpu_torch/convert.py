"""Carry parameters from the JAX package's layout to the port's.

Inputs are numpy arrays (or anything ``np.asarray`` reads, such as the
JAX package's arrays): this module imports neither JAX nor the JAX
package. Exports on disk need no conversion: ``render.renderer.load_scene``
reads the reference layout directly.
"""

from __future__ import annotations

import numpy as np
import torch

from scanerf_tpu_torch import _device
from scanerf_tpu_torch.models import decoder as decoder_lib
from scanerf_tpu_torch.render import renderer


def decoder_params(params, device="cuda") -> dict:
    """A decoder as the JAX package holds it -- the packed [13994] vector,
    or the param pytree ``{layer: {"w": [in, out], "b": [out]}}`` (leaves
    may carry a leading tile dim) -- as the port's param dict."""
    device = _device.resolve(device)
    if isinstance(params, dict):
        return {name: {k: torch.tensor(np.asarray(params[name][k], np.float32),
                                       device=device) for k in ("w", "b")}
                for name in decoder_lib.PACK_ORDER}
    return decoder_lib.unpack_params(
        torch.tensor(np.asarray(params, np.float32), device=device))


def scene(jax_scene, dtype=torch.float32, device="cuda") -> renderer.MultiTileScene:
    """The port's scene from a JAX ``MultiTileScene`` (read through
    ``np.asarray``): tables, stacked decoders, resolutions, bboxes and the
    (already unioned) per-tile occupancy."""
    features = np.asarray(jax_scene.features)
    if features.ndim == 3:  # flat [T, L, H*F]
        features = features.reshape(*features.shape[:2], -1, 2)
    decoders = {name: {k: np.asarray(jax_scene.decoders[name][k]) for k in ("w", "b")}
                for name in decoder_lib.PACK_ORDER}
    return renderer.scene_from_arrays(
        features.astype(np.float32), decoders, np.asarray(jax_scene.resolutions),
        np.asarray(jax_scene.block_corner), np.asarray(jax_scene.block_size),
        np.asarray(jax_scene.occupied), hash_layout=jax_scene.hash_layout,
        dtype=dtype, device=device)
