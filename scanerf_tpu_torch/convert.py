"""Carry parameters from the JAX package's layout to the port's.

Inputs are numpy arrays (or anything ``np.asarray`` reads, such as the
JAX package's arrays): this module imports neither JAX nor the JAX
package. Exports on disk need no conversion: ``render.renderer.load_scene``
reads the reference layout directly. A training state maps to the JAX
package's checkpoint keys in one place (below), which both
``train_state`` and ``train/checkpoint.py`` use.
"""

from __future__ import annotations

import numpy as np
import torch

from scanerf_tpu_torch import _device
from scanerf_tpu_torch.models import decoder as decoder_lib
from scanerf_tpu_torch.models import field as field_lib
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
    # imported here: the renderer imports train/checkpoint.py, which imports this module
    from scanerf_tpu_torch.render import renderer

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


# ---------------------------------------------------------------------------
# a tile's training state under the JAX package's checkpoint keys
# ---------------------------------------------------------------------------
# The JAX ``save_checkpoint`` writes each leaf of its TrainState under its
# pytree path: ".params/.field/.features", ".admm/.rho", ".step", and for
# optax's ``multi_transform`` state
# ".opt_state/.inner_states/['hash']/.inner_state/[0]/.mu/.field/.features".
# Each group's chain (tile.py:236-280) holds its Adam state (count, mu, nu)
# and, last, its schedule's count: hash (Adam, schedule), decoder (decayed
# weights, which keep no state, then Adam, schedule), cam (Adam, schedule;
# with cam_enable=False optax's set_to_zero, which keeps nothing). The
# port's TrainState holds Adam's count as each tensor's ``step`` and the
# schedule's as its group's ``count``. With sparse Adam the hash chain's
# first state is a SparseAdamState whose count is per element, a tree like
# mu's (".../[0]/.count/.field/.features", int32); the port holds it as
# the SparseAdam state's ``count``, beside ``mu`` and ``nu``.

# paths of ``tile.group_leaves``' tensors, in its order, below .params / .mu / .nu
_GROUP_PATHS = {
    "hash": [".field/.features"],
    "decoder": [f".field/.decoder/['{n}']/['{k}']"
                for n in decoder_lib.PACK_ORDER for k in ("w", "b")],
    "cam": [".se3_refine"],
}
_CHAIN = {"hash": (0, 1), "decoder": (1, 2), "cam": (0, 1)}  # (Adam, schedule) index
_FIELD_STATE = ("resolutions", "min_bbox", "bbox_size", "occupied_grid")
_ADMM = ("shared_se3", "delta_se3", "overlap_flags", "rho")


def _chain(group: str, part: str) -> str:
    """Key prefix of a group's Adam state (``part="adam"``) or schedule state."""
    at = _CHAIN[group][0 if part == "adam" else 1]
    return f".opt_state/.inner_states/['{group}']/.inner_state/[{at}]"


def _state_items(state: tile_lib.TrainState, missing_moment):
    """(key, tensor) of every array of ``state``: its own tensors, and new
    int32 CPU scalars for the counts and the step. A moment that Adam has
    not made yet (before the first step) is ``missing_moment(param)``."""
    leaves = tile_lib.group_leaves(state.params)
    for group, paths in _GROUP_PATHS.items():
        for path, t in zip(paths, leaves[group]):
            yield ".params/" + path, t
    for opt in state.optimizers():
        yield from _opt_items(opt, missing_moment)
    for n in _FIELD_STATE:
        yield ".field_state/." + n, getattr(state.field_state, n)
    for n in _ADMM:
        yield ".admm/." + n, getattr(state.admm, n)
    yield ".step", torch.tensor(state.step, dtype=torch.int32)


def _opt_items(opt, missing_moment):
    """(key, tensor) of one optimizer's groups: the Adam (or sparse Adam)
    state and the schedule's count of each."""
    sparse = isinstance(opt, tile_lib.SparseAdam)
    for grp in opt.param_groups:
        name = grp["name"]
        adam = _chain(name, "adam")
        if sparse:
            for path, p in zip(_GROUP_PATHS[name], grp["params"]):
                for part in ("count", "mu", "nu"):
                    yield f"{adam}/.{part}/{path}", opt.state[p][part]
            yield _chain(name, "schedule") + "/.count", torch.tensor(grp["count"],
                                                                      dtype=torch.int32)
            continue
        held = [opt.state.get(p, {}) for p in grp["params"]]
        steps = {int(s["step"]) for s in held if "step" in s} or {0}
        if len(steps) != 1:
            raise ValueError(f"group {name!r} holds Adam counts {sorted(steps)}")
        yield adam + "/.count", torch.tensor(steps.pop(), dtype=torch.int32)
        for path, p, s in zip(_GROUP_PATHS[name], grp["params"], held):
            yield adam + "/.mu/" + path, s["exp_avg"] if s else missing_moment(p)
            yield adam + "/.nu/" + path, s["exp_avg_sq"] if s else missing_moment(p)
        yield _chain(name, "schedule") + "/.count", torch.tensor(grp["count"],
                                                                  dtype=torch.int32)


def state_tensors(state: tile_lib.TrainState) -> dict:
    """Every array of a port ``TrainState`` under the key the JAX package's
    ``save_checkpoint`` gives it: the state's own tensors, Adam's moments
    (zeros before the first step) and counts, the schedules' counts, the
    field and ADMM state and the step."""
    return dict(_state_items(state, torch.zeros_like))


def state_like(state: tile_lib.TrainState) -> dict:
    """{key: tensor} of ``state`` whose shapes and dtypes are those of its
    arrays (a moment not made yet stands as its param): what
    ``load_checkpoint`` reads of its template, with nothing allocated."""
    return dict(_state_items(state, lambda p: p))


def state_from_arrays(get, cam_enable: bool, device, like=None,
                      sparse_adam: bool = False) -> tile_lib.TrainState:
    """A port ``TrainState`` on ``device`` from ``get(key)``, an array under
    each JAX checkpoint key, with the tables under sparse Adam if
    ``sparse_adam``. With ``like`` ({key: tensor}), each array takes
    its entry's dtype, and its shape where only the layout differs (tables
    stored as [L, H, F] before the flat [L, H*F] form); where the sizes
    differ the stored shape wins (an occupancy grid re-split by pruning).
    Without ``like``, floats are read as f32 and the rest as stored."""
    dev = _device.resolve(device)

    def T(key):
        a = np.asarray(get(key))
        if like is None:
            return torch.tensor(a.astype(np.float32) if a.dtype.kind == "f" else a, device=dev)
        ref = like[key]
        if a.shape != tuple(ref.shape) and a.size == ref.numel():
            a = a.reshape(ref.shape)
        return torch.tensor(a, dtype=ref.dtype, device=dev)

    leaves = {g: [T(".params/" + p) for p in paths] for g, paths in _GROUP_PATHS.items()}
    dec = iter(leaves["decoder"])
    params = tile_lib.TileParams(
        field=field_lib.FieldParams(
            features=leaves["hash"][0],
            decoder={n: {k: next(dec) for k in ("w", "b")} for n in decoder_lib.PACK_ORDER}),
        se3_refine=leaves["cam"][0])
    tc = tile_lib.TrainConfig(cam_enable=cam_enable, sparse_adam=sparse_adam)
    opt = tile_lib.build_optimizer(tc, params)
    hash_opt = tile_lib.build_hash_optimizer(tc, params)
    for o in [opt] + ([hash_opt] if hash_opt else []):
        for grp in o.param_groups:
            name = grp["name"]
            grp["count"] = int(get(_chain(name, "schedule") + "/.count"))
            adam = _chain(name, "adam")
            for path, p in zip(_GROUP_PATHS[name], grp["params"]):
                if o is hash_opt:
                    o.state[p] = {part: T(f"{adam}/.{part}/{path}")
                                  for part in ("count", "mu", "nu")}
                    continue
                o.state[p] = {"step": torch.tensor(float(get(adam + "/.count")),
                                                   dtype=torch.float32, device=dev),
                              "exp_avg": T(adam + "/.mu/" + path),
                              "exp_avg_sq": T(adam + "/.nu/" + path)}
    return tile_lib.TrainState(
        params=params, optimizer=opt,
        field_state=field_lib.FieldState(**{n: T(".field_state/." + n) for n in _FIELD_STATE}),
        admm=tile_lib.AdmmState(**{n: T(".admm/." + n) for n in _ADMM}),
        step=int(get(".step")), hash_optimizer=hash_opt)


def _resolve(tree, key: str):
    """The leaf of a live JAX pytree at a checkpoint key: ".name" is an
    attribute, "['name']" an item, "[i]" an index."""
    for part in key.split("/"):
        if part.startswith("."):
            tree = getattr(tree, part[1:])
        elif part.startswith("['"):
            tree = tree[part[2:-2]]
        else:
            tree = tree[int(part[1:-1])]
    return tree


def train_state(jax_state, device="cuda") -> tile_lib.TrainState:
    """The port's ``TrainState`` from a JAX ``TrainState`` (read through
    ``np.asarray``) under the same key mapping as ``load_checkpoint``: the
    field's flat tables and decoder, ``se3_refine``, the field state, the
    ADMM state, the step, and each optimizer group's Adam moments and
    counts in the state of the port's ``torch.optim.Adam``. Training
    resumed from it continues the JAX run. A state trained with
    ``cam_enable=False`` holds no Adam state for the cameras (optax's
    ``set_to_zero``): its optimizer is built as ``build_optimizer`` builds
    it then, with no camera group."""
    _device.resolve(device)
    return state_from_arrays(lambda key: np.asarray(_resolve(jax_state, key)),
                             _cam_enabled(jax_state), device,
                             sparse_adam=_sparse_adam(jax_state))


def _has(jax_state, key: str) -> bool:
    try:
        _resolve(jax_state, key)
        return True
    except (AttributeError, IndexError, KeyError, TypeError):
        return False


def _cam_enabled(jax_state) -> bool:
    """Whether a JAX state holds an Adam state for the cameras (not under
    optax's ``set_to_zero``, whose chain is empty)."""
    return _has(jax_state, _chain("cam", "adam") + "/.count")


def _sparse_adam(jax_state) -> bool:
    """Whether a JAX state's tables are under sparse Adam (a per-element
    count tree instead of one count)."""
    return _has(jax_state, _chain("hash", "adam") + "/.count/" + _GROUP_PATHS["hash"][0])


def parallel_tiles(jax_tiles, device="cuda"):
    """A JAX ``ParallelTiles`` (every tile's state stacked on a leading
    axis, ``cam_map`` and ``confidence`` [T, M]) as the port holds tiles
    on one card: (a list of ``TrainState``s, each as ``train_state`` reads
    it; cam_map int32 [T, M]; confidence f32 [T, M]), on ``device``. A
    rank of a mesh takes its tiles (``tile_parallel.local_tiles``) and
    their table shards (``table_shard``) from them."""
    dev = _device.resolve(device)
    stacked = jax_tiles.state
    cam_enable, sparse = _cam_enabled(stacked), _sparse_adam(stacked)
    cam_map = np.asarray(jax_tiles.cam_map)
    states = [state_from_arrays(lambda key, t=t: np.asarray(_resolve(stacked, key))[t],
                                cam_enable, dev, sparse_adam=sparse)
              for t in range(cam_map.shape[0])]
    return (states, torch.tensor(cam_map, dtype=torch.int32, device=dev),
            torch.tensor(np.asarray(jax_tiles.confidence, np.float32), device=dev))


def table_shard(state: tile_lib.TrainState, table_axis) -> tile_lib.TrainState:
    """A port state with whole tables (``train_state`` of a JAX state, a
    loaded checkpoint, one slice of ``parallel_tiles``) cut in place to a
    rank's shard on ``table_axis`` (``mesh.Axis``): the table and its Adam
    moments, as ``create_train_state(table_axis=)`` holds them."""
    from scanerf_tpu_torch.parallel import table_parallel

    return table_parallel.shard_state(state, table_axis)


def lpips_params(params: dict, device="cuda") -> dict:
    """LPIPS weights (``convN_w``, ``convN_b``, ``linN_w``) as numpy
    arrays -> f32 tensors on ``device``."""
    device = _device.resolve(device)
    return {k: torch.tensor(np.asarray(v, np.float32), device=device) for k, v in params.items()}
