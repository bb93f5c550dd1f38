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
from scanerf_tpu_torch.models import field as field_lib
from scanerf_tpu_torch.render import renderer
from scanerf_tpu_torch.train import tile as tile_lib


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


def train_state(jax_state, device="cuda") -> tile_lib.TrainState:
    """The port's ``TrainState`` from a JAX ``TrainState`` (read through
    ``np.asarray``): the field's flat tables and decoder, ``se3_refine``,
    the field state, the ADMM state, the step, and each optimizer group's
    Adam moments and counts (from optax's ``multi_transform`` state) in the
    state of the port's ``torch.optim.Adam``. Training resumed from it
    continues the JAX run. A state trained with ``cam_enable=False`` holds
    no Adam state for the cameras (optax's ``set_to_zero``): its optimizer
    is built as ``build_optimizer`` builds it then, with no camera group.
    Any other group without an Adam state raises."""
    dev = _device.resolve(device)

    def T(a, dtype=None):
        return torch.tensor(np.asarray(a), dtype=dtype, device=dev)

    p = jax_state.params
    params = tile_lib.TileParams(
        field=field_lib.FieldParams(
            features=T(p.field.features, torch.float32),
            decoder={n: {k: T(p.field.decoder[n][k], torch.float32) for k in ("w", "b")}
                     for n in decoder_lib.PACK_ORDER}),
        se3_refine=T(p.se3_refine, torch.float32))
    chains = {name: s.inner_state for name, s in jax_state.opt_state.inner_states.items()}
    # set_to_zero keeps an empty state: the cameras are not optimized
    cam_enable = len(chains["cam"]) > 0
    opt = tile_lib.build_optimizer(tile_lib.TrainConfig(cam_enable=cam_enable), params)
    for group in opt.param_groups:
        chain = chains[group["name"]]
        adam = [s for s in chain if hasattr(s, "mu")]
        if len(adam) != 1:
            raise ValueError(f"optimizer group {group['name']!r} holds no Adam state")
        group["count"] = int(chain[-1].count)
        mu = tile_lib.group_leaves(adam[0].mu)[group["name"]]
        nu = tile_lib.group_leaves(adam[0].nu)[group["name"]]
        for leaf, m, v in zip(group["params"], mu, nu):
            opt.state[leaf] = {"step": torch.tensor(float(adam[0].count), device=dev),
                               "exp_avg": T(m, torch.float32),
                               "exp_avg_sq": T(v, torch.float32)}
    fs, admm = jax_state.field_state, jax_state.admm
    return tile_lib.TrainState(
        params=params, optimizer=opt,
        field_state=field_lib.FieldState(
            resolutions=T(fs.resolutions, torch.int32), min_bbox=T(fs.min_bbox, torch.float32),
            bbox_size=T(fs.bbox_size, torch.float32), occupied_grid=T(fs.occupied_grid, torch.bool)),
        admm=tile_lib.AdmmState(
            shared_se3=T(admm.shared_se3, torch.float32),
            delta_se3=T(admm.delta_se3, torch.float32),
            overlap_flags=T(admm.overlap_flags, torch.bool), rho=T(admm.rho, torch.float32)),
        step=int(jax_state.step))
