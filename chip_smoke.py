#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (scanerf_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Seven phases, driven through the port's entry points, with the kernels'
launch counts set to 0 just before each counted run and read just after:
render and training, each in both decoder configurations, fused (the
default) and unfused (slice 3: ``fuse_decoder=False`` /
``fused_decoder=False``); then one tile from a scene directory to an
export; then a city of tiles through the multi-tile ADMM trainer; then
serving the city's exports; then the single-device extras of slice 10;
then the multi-device paths of slice 11 on two ranks that share the card.

Render (slice 1). Builds the port's CUDA kernels from csrc/, writes a
4-tile scene in the reference export layout (16 levels x 2 features, H =
2^21 entries per tile, 64^3 occupancy shells, random decoders at the
real widths; all from a fixed seed), loads it with
``load_scene(device="cuda")`` and renders a 256x128 frame (4 chunks of
8192 rays, 128 fg + 128 bg samples, a 512-step march, up to 4 blended
tiles) with ``render_image`` from two views: one from outside the tile
grid, where few rays meet occupied cells, and one from inside it looking
down, where all do; each view fused (B1, B2, B7) and unfused (B1, B2, B3
and each tile's decoder in PyTorch), the unfused frame held against the
fused one. Then it holds every kernel of that path against its plain
PyTorch version on the card at the render's shapes (B1 bit for bit; B3
and B7 with f32 and bf16 tables, B3 also on a stream whose chunks span up
to a whole block of windows, so that every pass of its staging runs),
holds the card's render of a few hundred rays of each view in each
configuration against the plain render on the CPU, and times the kernels
and the render's stages with CUDA events (B1 also its kernel alone, with
torch.profiler).

Training (slice 2). bench.py's workload (the synthetic sphere scene, 16
cameras at 256x256; 2^14 rays a step in 2x2 patches; 128 fg + 128 bg
samples and a 512-step march; 16 levels x 2 features at H = 2^21, f32;
a 64^3 occupancy grid) through ``create_field`` -> ``create_train_state``
-> ``train_step``, rgb-only and the full recipe (warp 1.0 at K=5 with the
16/8/64 visibility re-render, depth 0.01, smooth 0.001, rho 100), each
fused (B1, B2, B5, B6) and unfused (B1, B2, B3, B4): 2 warm-up and 5
timed steps of each, training rays/s from the host clock, one step's
stages from CUDA events, the idle share of a profiled step. Holds one
full-recipe step fused against the same step unfused (losses and
gradients), B5, B6, B3 and B4 against their plain versions on the middle
256 chunks of a step's own stream (B4 with the unfused decoder's feature
cotangent, under the step's BARF weights and with every level on; B3 also
bit for bit against the features B5 keeps), times them on the whole
stream, holds B1 bit for bit at each of the step's shapes and times it
there, and holds one full-recipe step of 512 rays on the card against the
same step on the CPU (losses and gradients). B6 is
two launches, B6a (the decoder backward, its large products on the
tensor cores) and B4's kernel (the table scatter, summed per chunk in
shared memory); the script also holds and times B6a alone, prints how
many windows each live chunk of the stream spans, the f32 elements the
step's B6 and B4 add to the table gradient with global atomics, the
blocks an SM holds of B5, B6a and B7, and, where the toolkit has
cuobjdump, the tensor-core (HMMA) instructions of B5, B6a and B7, whose
large products run on the tensor cores in 3xTF32.

Tile (slice 7). One tile from a scene directory to an export, at
bench.py's width, in a temporary directory: ``write_scene_dir`` (16
cameras at 256x256, one tile, mono priors; tile_info rewritten at
resolution (32, 2048)), a config from ``default_config().deep_update``
(H = 2^21, a 64^3 grid, 2^14 rays, 128 + 128 samples, M 512, the
reference's full loss recipe, pose noise 0.02) and
``TrainConfig.from_cfg``, ``load_scene`` / ``read_tile_info`` /
``read_training_views``, ``create_field(cubic_grid=True)`` and 200 fused
steps of ``train_n_steps`` in blocks of 100 (B1, B2, B5, B6). At step 0
and after each block: the eval PSNR and SSIM of ``tile.render_image`` of
the blocks/test.txt view (also a training view), the pose error of
``evaluate_camera_alignment`` and the block's training rays/s. At step
100 it saves a checkpoint, loads it into a fresh state, holds every array
of the two equal, takes one step from each on the same batch and holds
their losses and updated params together, and goes on from the restored
state. After step 200 the PSNR must have risen 3 dB; ``export_tile``
(windowed), ``load_scene`` and the renderer's ``render_image`` (B7) give
the export's render of the same view, held to the training-side render
(1 dB PSNR, 0.1 mean |difference|). It prints the phase's launches of
B1, B2, B5, B6 and B7 on a line of its own.

City (slice 8). The port's ``Trainer`` on a city scene directory at
bench.py's width, in a temporary directory: ``write_city_scene_dir`` (2 x
2 tiles, 96 cameras at 128x128; the tile boxes rewritten at resolution
(32, 2048) and raised 0.2, so that the drone path passes through them), a
config from ``default_config().deep_update`` (H = 2^21 windowed, 2^14
rays, 128 + 128 samples, M 512, rho 100, SYN_ITERS 25, the full loss
recipe, pose noise 0.01, GRID_LOG2DIM [6, 7]) and ``Trainer(cfg).run()``:
4 ADMM rounds of 4 tiles x 25 steps (B1, B2, B5, B6), the occlusion
refresh and evals at steps 50 and 100, checkpoints at 50, exports at
100. Then the trainer's own ``_prune`` at the next rung (64^3 -> 128^3;
the pruning query runs B2 and B3), one more round on the pruned grids
and ``_export``, and the renderer (B7) on the four exports. Gates: a log
line for every round with finite losses, the run's last mean loss below
its first; a finite admm_error.txt line a round and shared cameras; the
last round's consensus against the plain ``consensus_update`` on the
CPU (1e-6); each tile's eval PSNR at step 100 at least 2 dB above step
0's; the occlusion refresh run from at least one shared depth; one chunk
of the pruning query against the CPU (1e-5 of its largest entry) and
tile 0's pruned grid equal to the CPU prune outside a 1e-4 band around
the threshold; four exports and ``refined_camera.log``, the renderer's
image finite. It prints each round's seconds and training rays/s, the
phase's launches ("city launches:"), seconds, checkpoint size and peak
device memory.

Serve (slice 9), on the city phase's directory and four exports before
it is removed: the render CLI's ``main`` (``python -m
scanerf_tpu_torch.render``) in VAL mode over views 0-7 at 128x128 (each
metric.txt PSNR within the bounds that the 8-bit truncation of its
frame allows around the frame's PSNR on the CPU, SSIM within 0.01; the
mean at least 2 dB above the city's highest step-0 eval PSNR;
``evaluate_dirs`` on the frames equal to the CPU's within 1e-4), view
0 staged (``backend="xla"``: B2 + B3 on the table stack, the decoder in
PyTorch) against windowed on all-occupied grids (the tiles' own grids
are not aligned, and the two backends gate samples by different grids;
the gap with them is printed), a ``pose_paths`` path between two city
cameras and two 720x1280 DEMO frames, one CLI call each, frame 1 again
with SCANERF_EARLY_TERM=1 (within one 8-bit step) and through
``render_image(early_term=True)`` against the one-shot frame (rgb 1e-4,
depth 1e-3), and early termination on the render phase's scene with
every sigma head's bias raised by 50, which must shed fg and bg rows.
Launches are read there ("serve launches:"); then B7 at an
early-termination slab's shape and B3 at the staged encode's against
their plain versions, 256 rays of the staged render on the card against
the CPU, and LPIPS with random weights on a frame and its ground truth
on the card (with cuDNN's TF32 switched on around the call, which LPIPS
must switch off) against the CPU (1e-5 relative).

Extras (slice 10), after serve: ``render_normals`` of the tile phase's
trained tile (windowed, H = 2^21) on 512 rays of its eval view at 128
samples (M 512), counted (B1, B2, B3 and B4 in its dL/du-only mode),
timed, its device-memory rise held below one table gradient's 256 MiB
and its normals held against the same call on the CPU (1e-4); bench.py's
fused full-recipe step dense, with HASH_BWD_BF16 (B6 with B4's bf16
mode) and with SPARSE_ADAM, 2 warm-up and 3 counted, timed steps each,
one SparseAdam update against the CPU's (counts equal, 1e-6), and B6 in
its bf16 mode on the middle 256 chunks of a step's stream against its
plain version (dL/du, dirs and slab 1e-4 of each one's largest entry,
the table gradient 5e-6 of each level's against the plain bf16 scatter
of B6a's own cotangent); B4's two modes against their plain versions on
those chunks (dL/du 1e-4; the bf16 table gradient 5e-6 of each level's
largest entry, and from 1e-5 to 2% of it away from exact B4), then timed
on the whole stream; a global-hash tile (H = 2^12,
the xla backend) trained 3 steps with STOCHASTIC_HASH_GRAD and one
``hash_encode_stoch`` backward against the CPU's (1e-5); ``build_tiles``
on two copies of the city's scene directory, on the card and on the
CPU, whose tile_info.txt, training_views.txt and tiles.obj must be
identical.

Multi (slice 11), last: two ranks spawned with ``torch.multiprocessing``
(spawn), both on cuda:0 over the ``gloo`` backend (NCCL refuses two ranks
on one device), after the kernels are built in this process. (a) One
tile's table sharded over the two ranks at config/paper_2p24_2chip.yaml's
operating point (bench.py's sphere scene, H = 2^24, TABLE_SHARDS 2, 2^14
rays, 128 + 128 samples, M 512, the full recipe, windowed, the unfused
decode the sharded lookup takes): the first step against the unsharded
2^24 step on the same batch, which each rank computes alone (losses,
pose and decoder gradients, its table-gradient shard against its slice
of the whole gradient, at the train phase's fused-against-unfused
limits); one warm-up and three timed steps (rays/s and the seconds in
collectives); B3 and B4 (exact, and bf16 as HASH_BWD_BF16 launches it in
the sharded step) on the rank's localized stream against their plain
versions (rank 1's ``wbase`` is not 0), the other rank's chunks exactly
zero, and timed. (b) Ray data parallelism at bench.py's width (H = 2^21,
full recipe, fused): each rank's gradients alone on its batch, then one
``build_dp_step`` step whose averaged gradients are held against their
mean and whose replicas must end equal bit for bit. (c) The tiles mesh:
the city phase's 2 x 2 city by ``Trainer`` on the two ranks, two tiles
each, one round of 5 steps; its consensus against one process's
``consensus_update`` over the four tiles' poses (1e-6). (d) The render
phase's overhead view at 256x128, ``render_image(sharded=True)`` over the
two ranks, fused and unfused, against the one-rank frame (RENDER_TOL).
A failed check in any rank ends the script non-zero; the parent checks
every rank's exit code.

It prints the card's name and power limit (nvidia-smi), each phase's
seconds, and, before the last line, one JSON line ``{"kernels": [...]}``
with B1-B7: per kernel, its launches in the counted runs, max error
against the plain version, times, and the bound (least time the card
could take for the same work); B1's row also has its kernel's time alone
and each training shape's numbers, every row its launches in the city
phase (``city_launches``) and in the serve phase (``serve_launches``),
B3's row its numbers at the pruning query's shape (``pruning_query``)
and at the staged encode's (``staged``), B7's at an
early-termination slab's (``early_slab``), every row its launches in the
extras phase (``extras_launches``), and B4's row its dL/du-only and bf16
modes on a training step's stream (``du_only``, ``bf16``), every row its
launches over both ranks of the multi phase (``multi_launches``), and
B3's and B4's rows their numbers on a table shard (``sharded``: rank 1's
times, the bound over the owned chunks' bytes). The last line is
``{"ok": true, "device": {...}}``.

Any failed build, launch or comparison ends the script with a non-zero
exit code before the last line. Without CUDA it exits 1 and prints no
result.
"""

from __future__ import annotations

import copy
import dataclasses
import itertools
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
TF32_OPS_PER_S = 495e12

T_TILES, LEVELS, TABLE = 4, 16, 2**21
GRID = 64
IMG_H, IMG_W = 128, 256
CHUNK = 8192
RENDER_KW = dict(num_sample=128, num_bg_sample=128, num_march=512, max_blend_tiles=4)
N_PARITY_RAYS = 256
RENDER_TOL = (("rgb", 1e-4), ("depth", 1e-3), ("T_left", 1e-4))


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def timed(fn, iters: int) -> float:
    """Mean ms per call over ``iters`` calls, after one warm-up call."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_ms(fn, name: str, iters: int):
    """Mean device time (ms) of the kernel whose name holds ``name``, one
    launch a call, over ``iters`` calls of ``fn`` under torch.profiler
    after one warm-up call: the kernel alone, without its wrapper's host
    work. None if the profiler recorded no such kernel in three tries."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    for _ in range(3):  # the profiler now and then records no kernel: try again
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = [ev.time_range.elapsed_us() for ev in prof.events()
              if ev.device_type.name == "CUDA" and name in ev.name]
        if us:
            return sum(us) / len(us) / 1e3
    return None


def fmt_ms(t) -> str:
    return "not measured" if t is None else f"{t:.4f} ms"


def wide_span_stream(NW: int, seed: int = 3):
    """A sorted stream [NC, 8, CHUNK] and its meta over windows [0, NW)
    whose chunks span 1, 2, 3, 5, 32 (a whole block) and 32 windows with a
    sentinel tail, then one all-sentinel chunk: B3 stages a chunk's windows
    in passes of a few, and real streams rarely take more than one pass. u
    from a seed; each chunk's rows sorted by window, as ``sort_pack``
    leaves them."""
    from scanerf_tpu_torch.ops.kernels import hash_encode as hw

    rng = np.random.default_rng(seed)
    spans = [(40, 1), (70, 2), (101, 3), (130, 5), (160, 32), (192, 32), (None, 0)]
    NC = len(spans)
    pts = np.zeros((NC, 8, hw.CHUNK), np.float32)
    pts[:, 0:3] = rng.random((NC, 3, hw.CHUNK), dtype=np.float32)
    for c, (w0, n) in enumerate(spans):
        if w0 is None:
            pts[c, 3] = NW
            continue
        w = np.sort(w0 + rng.integers(0, n, hw.CHUNK))
        w[:n] = w0 + np.arange(n)  # every window of the span is met
        w = np.sort(w)
        if c == NC - 2:
            w[700:] = NW  # a sentinel tail
        pts[c, 3] = w
    if max(w0 + n for w0, n in spans if w0 is not None) > NW:
        raise ValueError(f"the wide-span stream needs {NW} >= 224 windows")
    pts_t = torch.from_numpy(pts).cuda()
    return pts_t, hw._stream_meta(pts_t, NC, NW), [n for _, n in spans]


# ---------------------------------------------------------------------------
# the scene, in the reference export layout
# ---------------------------------------------------------------------------

def write_scene(root: str, seed: int = 0) -> list[str]:
    """2x2 tiles in x-z, inner boxes 2.0 wide with 0.2 overlap; the
    occupancy is a spherical shell sampled at each tile's cell centres."""
    from scanerf_tpu_torch.models import decoder as dec
    from scanerf_tpu_torch.ops.hash_encode import make_level_resolutions

    rng = np.random.default_rng(seed)
    inner = np.float32(2.0)
    res = make_level_resolutions([32] * 3, [2048] * 3, LEVELS)
    centre = np.array([1.8, 1.0, 1.8])
    dirs = []
    for t in range(T_TILES):
        ic = np.array([1.6 * (t % 2), 0.0, 1.6 * (t // 2)], np.float32)
        corner = ic - inner / 2
        size = np.full(3, 2 * inner, np.float32)
        axis = (np.arange(GRID) + 0.5) / GRID * inner
        X, Y, Z = np.meshgrid(ic[0] + axis, ic[1] + axis, ic[2] + axis, indexing="ij")
        r = np.sqrt((X - centre[0]) ** 2 + (Y - centre[1]) ** 2 + (Z - centre[2]) ** 2)
        occ = np.abs(r - 0.9) < 0.25
        feats = (rng.standard_normal((LEVELS, TABLE * 2), dtype=np.float32) * 0.5)
        params = {}
        for name in dec.PACK_ORDER:
            fan_in, fan_out = dec.SHAPES[name]
            bound = 1.0 / np.sqrt(fan_in)
            params[name] = {
                "w": torch.from_numpy(rng.uniform(-bound, bound, (fan_in, fan_out)).astype(np.float32)),
                "b": torch.from_numpy(rng.uniform(-bound, bound, fan_out).astype(np.float32))}
        d = os.path.join(root, f"tile-{t}")
        os.makedirs(d)
        np.savez(os.path.join(d, "feature.npz"), features=feats.astype(np.float16),
                 occupied_grid=occ, block_corner=corner, block_size=size,
                 grid_log2dim=np.full(3, 6, np.int32), resolution=res,
                 hash_layout=np.array("windowed"))
        np.savez(os.path.join(d, "decoder.npz"), params=dec.pack_params(params).numpy())
        np.savez(os.path.join(d, "cams.npz"), c2ws=np.eye(3, 4, dtype=np.float32)[None],
                 ks=np.eye(3, dtype=np.float32)[None], idxs=np.array([0]))
        dirs.append(d)
    return dirs


def cameras():
    """Intrinsics (90 degree horizontal field of view) and two views:
    ``outside``, from beyond the 2x2 tile grid, where most rays pass the
    occupied shells by; ``overhead``, from inside the tile grid's boxes
    looking down, where every ray meets occupied cells."""
    K = np.array([[IMG_W * 0.5, 0, IMG_W / 2], [0, IMG_W * 0.5, IMG_H / 2], [0, 0, 1]],
                 np.float32)
    views = {
        "outside": np.array([[1, 0, 0, 1.8], [0, 1, 0, 1.0], [0, 0, 1, -3.5]], np.float32),
        "overhead": np.array([[1, 0, 0, 1.8], [0, 0, -1, 2.5], [0, 1, 0, 1.8]], np.float32),
    }
    return K, views


# ---------------------------------------------------------------------------
# capture of each kernel's inputs during one chunk's render
# ---------------------------------------------------------------------------

class Capture:
    """Swap kernel wrappers, given as (module, name, key), for recorders
    that keep the first call's arguments under ``args[key]`` and call
    through; restore them on exit. A wrapper counts its launches on the
    name it is bound to in its module, so each recorder carries its own
    count and these launches stay out of the wrapper's."""

    def __init__(self, *targets):
        self.targets, self.args, self.saved = targets, {}, []

    def __enter__(self):
        for mod, name, key in self.targets:
            orig = getattr(mod, name)

            def rec(*a, _orig=orig, _key=key, **kw):
                self.args.setdefault(_key, (a, kw))
                return _orig(*a, **kw)

            rec.launches = 0
            setattr(mod, name, rec)
            self.saved.append((mod, name, orig))
        return self

    def __exit__(self, *exc):
        for mod, name, orig in self.saved:
            setattr(mod, name, orig)


def render_targets(sp, hw, fr):
    """The render's kernel wrappers for ``Capture``: B1, B2, B3 and B7."""
    return ((sp, "sample_fused", "B1"), (hw, "pack", "B2"), (hw, "lookup_fwd", "B3"),
            (fr, "hash_decode_fused", "B7"))


class B4Launches:
    """B4's launches in one mode, as a counter like the wrappers' own:
    ``hash_encode.scatter_bwd`` counts each launch of B4's kernel by mode,
    whichever wrapper (``lookup_bwd``, B6's ``train_bwd``) calls it."""

    def __init__(self, mode: str):
        from scanerf_tpu_torch.ops.kernels import hash_encode as hw

        self.counts, self.mode = hw.scatter_bwd.launches, mode

    @property
    def launches(self) -> int:
        return self.counts[self.mode]

    @launches.setter
    def launches(self, n: int) -> None:
        self.counts[self.mode] = n


# ---------------------------------------------------------------------------
# training: one tile's step at bench.py's width
# ---------------------------------------------------------------------------

TRAIN_CAMS, TRAIN_HW = 16, 256
TRAIN_KW = dict(num_sample=128, num_bg_sample=128, batch_log2=14, total_step=40000,
                num_march=512)
ARMS = {"rgb_only": dict(w_warp=0.0, w_depth=0.0, w_smooth=0.0, rho=0.0),
        "full_recipe": dict(w_warp=1.0, w_depth=0.01, w_smooth=0.001, rho=100.0,
                            warp_start=0)}
WARM_STEPS, TIMED_STEPS = 2, 5
N_SUB_CHUNKS = 256  # B5/B6 against their plain versions on this many middle chunks
N_CHECK_RAYS = 512  # the card's step against the CPU's
MACS = 32 * 64 + 64 * 64 + 7 * 32 + 48 * 64 + 64 * 64 + 3 * 64  # decoder per row
TC_MACS = 32 * 64 + 64 * 64 + 48 * 64 + 64 * 64  # of them, on the tensor cores (B5-B7)
# fused against unfused, one full-recipe step from the same state and rays
# at the 512-ray check's loss weights (below): the same samples, only the
# decode's sums (B5/B6 per row against B3/B4 and torch.matmul) and the
# atomics in another order. On an H100 80GB HBM3 at 700 W two runs agreed
# within 2e-7 relative in the losses but the warp loss, which differed by
# 1.7e-5 and 1.0e-5 (its visibility re-render decodes with B5 against B3),
# and within 5.5e-7 (tables), 1.7e-5 (decoder) and 1.7e-5 (se3_refine)
# relative L2 in the gradients. The limits are 6-200 times those; se3_refine
# keeps test (g)'s 1e-3, as the pose gradient moves with f32 rounding in
# neighbour selection (ROADMAP.md queue C).
FVU_LOSS_RTOL = {"*": 1e-5, "warp_loss": 1e-3}
FVU_GRAD_RTOL = {"hash": 1e-4, "decoder": 1e-4, "cam": 1e-3}


def decoder_bounds(rows: int, products: int, other_ops: int) -> tuple[float, float, float]:
    """Least ms for ``rows`` live rows of ``products`` decoder products (1:
    the forward; 3: forward, input and weight gradients) and ``other_ops``
    CUDA-core operations a row: (the four large matrices as 3xTF32 on the
    tensor cores, the rest on the CUDA cores, all of it in f32 on the CUDA
    cores)."""
    tc = rows * 3 * 2 * products * TC_MACS / TF32_OPS_PER_S * 1e3
    cc = rows * (2 * products * (MACS - TC_MACS) + other_ops) / F32_OPS_PER_S * 1e3
    f32 = rows * (2 * products * MACS + other_ops) / F32_OPS_PER_S * 1e3
    return tc, cc, f32


def to_device(obj, dev):
    """A copy of a (nested) dataclass / dict / list of tensors on ``dev``."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to(dev, copy=True)
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{f.name: to_device(getattr(obj, f.name), dev)
                                           for f in dataclasses.fields(obj)})
    if isinstance(obj, dict):
        return {k: to_device(v, dev) for k, v in obj.items()}
    if isinstance(obj, list):
        return [to_device(v, dev) for v in obj]
    return obj


def train_setup(tc, log2_h: int = 21):
    """bench.py's workload: the synthetic sphere scene (16 cameras at
    256x256), a field with 16 levels x 2 features at H = 2^log2_h (2^21,
    f32), resolutions 32 -> 2048, a 64^3 occupancy grid; weights from a
    seed."""
    from scanerf_tpu_torch.data.synthetic import make_sphere_dataset
    from scanerf_tpu_torch.models import field
    from scanerf_tpu_torch.train import cameras, tile

    imgs, depths, ks, c2ws = make_sphere_dataset(TRAIN_CAMS, TRAIN_HW, TRAIN_HW)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params, fs = field.create_field(gen, [-1.0] * 3, [2.0] * 3, log2_hashmap_size=log2_h,
                                    grid_resolution=(32, 2048), sampler_log2dim=6,
                                    device="cuda")
    state = tile.create_train_state(params, fs, TRAIN_CAMS, tc, device="cuda")

    def dev(a):
        return torch.tensor(a, device="cuda")

    data = tile.TileData(
        images=dev(imgs), occlusions=torch.ones(imgs.shape[:3], dtype=torch.bool, device="cuda"),
        cameras=cameras.make_cameras(dev(ks), dev(c2ws)), mono_depths=dev(depths),
        mono_normals=torch.zeros((*imgs.shape[:3], 3), device="cuda"))
    return state, data


def profiled_idle(fn, label):
    """Device busy and idle share of one call of ``fn`` under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    dev_us = {}
    for ev in prof.events():
        # device kernels only: a user annotation (the optimizer's step) spans
        # kernels that are counted already
        kernel = ev.device_type.name == "CUDA" and not getattr(ev, "is_user_annotation", False)
        t_us = ev.time_range.elapsed_us() if kernel else 0
        if t_us > 0:
            dev_us[ev.name] = dev_us.get(ev.name, 0.0) + t_us
    busy = sum(dev_us.values()) / 1e3
    if busy <= 0:
        print(f"profiled {label}: the profiler recorded no device time (not measured)")
        return
    print(f"profiled {label}: {wall:.1f} ms wall, {busy:.1f} ms device busy "
          f"({100 * busy / wall:.1f}%), idle {100 * (1 - busy / wall):.1f}%")
    for name, t_us in sorted(dev_us.items(), key=lambda kv: -kv[1])[:10]:
        print(f"  {t_us / 1e3:8.3f} ms  {name[:100]}")


def rel_l2(a, b) -> float:
    return float((a.double() - b.double()).norm() / a.double().norm().clamp_min(1e-30))


def check_parts(what: str, parts, all_on: bool, tol: float = 1e-4) -> list[float]:
    """Hold each (name, kernel, plain) part of a backward kernel's output
    within ``tol`` (1e-4) of the plain part's own largest entry (the
    atomics add in an order that changes from run to run); with ``all_on``
    (every level weighted 1) no part may be zero in the plain version.
    Returns the max errors."""
    errs, worst = [], (0.0, "")
    for name, a, b in parts:
        a, b = a.detach(), b.detach()
        scale = float(b.abs().max())
        e = float((a - b).abs().max())
        errs.append(e)
        ratio = e / scale if scale > 0 else (0.0 if e == 0 else float("inf"))
        worst = max(worst, (ratio, name))
        if all_on and scale == 0:
            fail(f"{what} {name} is zero in the plain version: the check is empty")
        if not (torch.isfinite(a).all() and e <= tol * scale):
            fail(f"{what} {name} differs from its plain version: max err {e:.3g}, "
                 f"largest entry {scale:.3g} (tol {tol:g} of it)")
        if not name.startswith("d_tables level") or name.endswith((" 0", " 15")):
            print(f"{what} {name}: max err {e:.3g}, {ratio:.3g} of its largest "
                  f"entry {scale:.3g} (tol {tol:g} of it), rel L2 {rel_l2(b, a):.3g}")
    print(f"{what}: worst part {worst[1]} at {worst[0]:.3g} of its largest entry (tol {tol:g})")
    return errs


def train_arm(arm, kw, fused, counters, launches):
    """One arm of bench.py's step in one decoder configuration: 2 warm-up
    steps, then the counted main path (5 timed steps, each kernel's count
    set to 0 just before and read just after), a step's stages from CUDA
    events and a profiled step. Returns (state, data, tc, generator)."""
    from scanerf_tpu_torch.models.decoder import pack_params
    from scanerf_tpu_torch.train import tile

    t_arm = time.perf_counter()
    label = f"{arm}{'' if fused else ' unfused'}"
    tc = tile.TrainConfig(**TRAIN_KW, **kw, fused_decoder=fused)
    state, data = train_setup(tc)
    gen = torch.Generator().manual_seed(1)
    rays_per_step = (2**tc.batch_log2 // TRAIN_CAMS) // 4 * 4 * TRAIN_CAMS
    p = state.params
    before = (p.field.features.clone(), pack_params(p.field.decoder).clone(),
              p.se3_refine.clone())
    losses = []
    for _ in range(WARM_STEPS):
        state, aux = tile.train_step(state, data, tc, gen, device="cuda")
        losses.append(aux["total_loss"])
    # --- the counted main path: the timed steps
    for c in counters.values():
        c.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TIMED_STEPS):
        state, aux = tile.train_step(state, data, tc, gen, device="cuda")
        losses.append(aux["total_loss"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = {k: c.launches for k, c in counters.items()}
    print(f"train {label}: {TIMED_STEPS} steps of {rays_per_step} rays in {wall * 1e3:.1f} ms: "
          f"{rays_per_step * TIMED_STEPS / wall:.0f} training rays/s; launches {got}")
    for k, n in got.items():
        if n <= 0:
            fail(f"kernel {k} was not launched on the training path ({label})")
        launches[k] += n
    if not torch.isfinite(torch.stack(losses)).all():
        fail(f"non-finite loss in the {label} steps")
    print(f"train {label}: " + ", ".join(f"{k} {float(v):.5g}" for k, v in aux.items()
                                         if v.ndim == 0))

    # --- where a step's time goes: CUDA events at the stage marks
    events = []

    def hook(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append((name, ev))

    start = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    state, aux = tile.train_step(state, data, tc, gen, device="cuda", stage_hook=hook)
    torch.cuda.synchronize()
    split, prev = {}, start
    for name, ev in events:
        split[name] = split.get(name, 0.0) + prev.elapsed_time(ev)
        prev = ev
    print(f"stages {label} (ms, one step): "
          + json.dumps({k: round(v, 3) for k, v in split.items()})
          + f" sum {sum(split.values()):.2f}")
    profiled_idle(lambda: tile.train_step(state, data, tc, gen, device="cuda"),
                  f"step {label}")
    p = state.params
    after = (p.field.features, pack_params(p.field.decoder), p.se3_refine)
    for name, a, b in zip(("tables", "decoder", "se3_refine"), before, after):
        if torch.equal(a, b):
            fail(f"{name} did not change over the {label} steps")
    print(f"phase train {label}: {time.perf_counter() - t_arm:.1f} s")
    return state, data, tc, gen


def fused_vs_unfused(state, data, tc):
    """One full-recipe step on the card from the same state and ray_idx
    with the fused decoder (B5/B6) and the unfused one (B3, the decoder in
    PyTorch, B4): the samples are identical, only the decode's summation
    order (and the atomics' order) differs."""
    from scanerf_tpu_torch.train import tile

    ray_idx, locs = tile.sample_patches(torch.Generator().manual_seed(5), TRAIN_HW, TRAIN_HW,
                                        2**tc.batch_log2 // TRAIN_CAMS // 4, device="cuda")
    pix = locs[None].expand(TRAIN_CAMS, *locs.shape)
    out = {f: tile.compute_grads(state, data, dataclasses.replace(tc, fused_decoder=f),
                                 ray_idx=ray_idx, pixel_locs=pix) for f in (True, False)}
    (_, a_f), g_f = out[True]
    (_, a_u), g_u = out[False]
    for k in ("total_loss", "rgb_loss", "depth_loss", "smooth_loss", "warp_loss", "admm_loss"):
        a, b = float(a_u[k]), float(a_f[k])
        tol = FVU_LOSS_RTOL.get(k, FVU_LOSS_RTOL["*"]) * abs(b)
        print(f"fused vs unfused {k}: fused {b:.7g} unfused {a:.7g} (tol {tol:.3g})")
        if not b > 1e-4:
            fail(f"the check's {k} is {b:.3g}, not above 1e-4: it carries no weight")
        if not (np.isfinite(a) and abs(a - b) <= tol):
            fail(f"the unfused step's {k} differs from the fused step's")
    for name in ("hash", "decoder", "cam"):
        worst = max(rel_l2(b, a) for a, b in zip(g_u[name], g_f[name]) if b.abs().max() > 0)
        print(f"fused vs unfused grad {name}: worst relative L2 {worst:.3g} "
              f"(tol {FVU_GRAD_RTOL[name]})")
        if not worst <= FVU_GRAD_RTOL[name]:
            fail(f"the unfused step's {name} gradient differs from the fused step's")


def lookup_kernels(state, pts, meta, table, res, NW, g, sub_range, launches, render_b3):
    """B3 and B4 on the stream of a training step: against their plain
    versions on the middle chunks ``sub_range``, with the feature
    cotangent that the unfused decoder's autograd gives for the step's
    column cotangent ``g`` under the step's BARF weights and under weights
    of 1 on every level; then timed on the whole stream. Returns the two
    rows of the ``kernels`` line; B3's launches and error include the
    unfused render's (``render_b3``)."""
    from scanerf_tpu_torch.models import field
    from scanerf_tpu_torch.ops.kernels import hash_encode as hw

    NC = pts.shape[0]
    dirs = pts[:, 4:7, :].permute(0, 2, 1).reshape(-1, 3)
    wf_step = field.weight_feature(torch.tensor(float(state.step), device="cuda"))
    wf_all = field.weight_feature(torch.tensor(20000.0, device="cuda"))

    def d_feats(feats, rows, wf):
        f = feats.detach().requires_grad_()
        with torch.enable_grad():
            cols = field.decode_columns(state.params.field.decoder, f, dirs[rows], wf)
        return torch.autograd.grad(cols, f, g[rows])[0].contiguous()

    c0, c1 = sub_range
    sub = (pts[c0:c1].contiguous(), meta[c0:c1].contiguous())
    rows = slice(c0 * hw.CHUNK, c1 * hw.CHUNK)
    live_c = sub[1][:, :, 2].sum(dim=1) > 0
    _, NB, _ = hw.geometry(NW * hw.W)
    unvisited = torch.ones(NB, dtype=torch.bool, device="cuda")
    unvisited[sub[1][live_c, 0, 0].long()] = False
    f_k = hw.lookup_fwd(*sub, table, res, NW)
    f_p = hw.lookup_fwd_plain(sub[0], table, res, NW)
    err_b3 = [float((f_k - f_p).abs().max())]
    scale = float(f_p.abs().max())
    print(f"B3 training stream, chunks {c0}-{c1}: max err {err_b3[0]:.3g}, largest entry "
          f"{scale:.3g} (tol 1e-5 of it)")
    if not (torch.isfinite(f_k).all() and err_b3[0] <= 1e-5 * scale):
        fail("B3 differs from its plain version on the training stream")
    err_b4 = []
    for label, wf in (("step weights", wf_step), ("all levels", wf_all)):
        gf = d_feats(f_p, rows, wf)
        dpts_k, dtab_k = hw.lookup_bwd(*sub, table, res, gf, NW)
        dpts_p, dtab_p = hw.lookup_bwd_plain(sub[0], table, res, gf, NW)
        if dpts_k[:, 3:].count_nonzero() or dpts_p[:, 3:].count_nonzero():
            fail(f"B4 ({label}) dpts rows 3-7 are not zero")
        for name, d in (("kernel", dtab_k), ("plain", dtab_p)):
            if d.reshape(LEVELS, NB, -1)[:, unvisited].count_nonzero():
                fail(f"B4 ({label}) {name} table gradient is not zero on unvisited blocks")
        parts = [("dpts u", dpts_k[:, 0:3], dpts_p[:, 0:3])]
        parts += [(f"d_tables level {lv}", dtab_k[lv], dtab_p[lv]) for lv in range(LEVELS)]
        err_b4 += check_parts(f"B4 ({label})", parts, label == "all levels")
        print(f"B4 ({label}): rows 3-7 and {int(unvisited.sum())} unvisited blocks exactly 0")
        del dpts_k, dtab_k, dpts_p, dtab_p, gf
    torch.cuda.empty_cache()

    # times on the whole stream, with the step's feature cotangent
    feats = hw.lookup_fwd(pts, meta, table, res, NW)
    gf = d_feats(feats, slice(None), wf_step)
    live = int((meta[:, :, 2].sum(dim=1) > 0).sum())
    real_rows = int((pts[:, 3, :] < NW).sum())
    visited = int(torch.unique(meta[meta[:, :, 2].sum(dim=1) > 0, 0, 0]).numel())
    tab_bytes = visited * LEVELS * hw.WB * hw.W * 2 * 4
    # what each function needs: B3 reads pts rows 0-3 (u, window id), the
    # meta and the visited table blocks and writes the features; B4 reads
    # the same and the feature cotangent and writes dpts (all 8 rows) and
    # the dense table gradient once
    u_wid_bytes = pts[:, 0:4].numel() * 4
    b3 = dict(name="hash_lookup_fwd", route="cuda", source="scanerf_tpu_torch/csrc/hash_encode.cu",
              replaces="scanerf_tpu/ops/pallas/hash_encode.py:1033",
              launches=launches["B3"] + render_b3["launches"],
              max_abs_err=max(err_b3 + [render_b3["err"]]),
              ms=timed(lambda: hw.lookup_fwd(pts, meta, table, res, NW), 10),
              plain_ms=timed(lambda: hw.lookup_fwd_plain(pts, table, res, NW), 1),
              bytes=u_wid_bytes + meta.numel() * 4 + feats.numel() * 4 + tab_bytes,
              ops=real_rows * LEVELS * 8 * 6, library_ms=None)
    b4 = dict(name="hash_lookup_bwd", route="cuda", source="scanerf_tpu_torch/csrc/hash_encode.cu",
              replaces="scanerf_tpu/ops/pallas/hash_encode.py:1104", launches=launches["B4"],
              max_abs_err=max(err_b4),
              ms=timed(lambda: hw.lookup_bwd(pts, meta, table, res, gf, NW), 5),
              plain_ms=timed(lambda: hw.lookup_bwd_plain(pts, table, res, gf, NW), 1),
              bytes=(u_wid_bytes + pts.numel() * 4 + meta.numel() * 4 + gf.numel() * 4
                     + tab_bytes + table.numel() * 4),
              ops=real_rows * LEVELS * 8 * 14, library_ms=None)
    counts = {}
    for label, wf in (("step weights", wf_step), ("all levels", wf_all)):
        adds = torch.zeros(1, dtype=torch.int64, device="cuda")
        hw.lookup_bwd(pts, meta, table, res, gf if label == "step weights"
                      else d_feats(feats, slice(None), wf), NW, adds=adds)
        counts[label] = int(adds)
    print(f"B3 {b3['ms']:.3f} ms (plain {b3['plain_ms']:.1f}), B4 {b4['ms']:.3f} ms (plain "
          f"{b4['plain_ms']:.1f}) on the whole stream: {NC} chunks, {live} live, {real_rows} "
          f"real rows, {visited} visited blocks")
    print(f"global atomics into the table gradient, one step's B4: {counts['step weights']} f32 "
          f"elements with the step's BARF weights, {counts['all levels']} with every level on "
          f"(a per-corner scatter: {real_rows * LEVELS * 8 * 2})")
    return b3, b4


def train_phase(render_b3: dict) -> list[dict]:
    """Both arms of bench.py's step on the card, fused and unfused; one
    step fused against unfused; B3-B6 against their plain versions; a
    512-ray step on the card against the CPU's."""
    from scanerf_tpu_torch.models import field
    from scanerf_tpu_torch.ops.kernels import fused_train as ft
    from scanerf_tpu_torch.ops.kernels import hash_encode as hw
    from scanerf_tpu_torch.ops.kernels import sampler as sp
    from scanerf_tpu_torch.train import tile

    counters = {True: {"B1": sp.sample_fused, "B2": hw.pack, "B5": ft.train_fwd,
                       "B6": ft.train_bwd},
                False: {"B1": sp.sample_fused, "B2": hw.pack, "B3": hw.lookup_fwd,
                        "B4": B4Launches("exact")}}
    launches = dict.fromkeys(["B1", "B2", "B3", "B4", "B5", "B6"], 0)
    kept = {}
    for fused in (True, False):
        for arm, kw in ARMS.items():
            kept[arm, fused] = train_arm(arm, kw, fused, counters[fused], launches)
    print(f"launches in the counted training steps (both arms of both configurations, "
          f"{TIMED_STEPS} steps each): {launches}")

    state, data, tc, gen = kept[("full_recipe", True)]
    kept.clear()
    torch.cuda.empty_cache()

    # --- B5 and B6 inputs from one full-recipe step
    t_cmp = time.perf_counter()

    # B1's calls of the step by shape (N, S, M): the batch's fg samples and
    # the warp loss's visibility re-render
    b1_calls: dict[tuple, list] = {}

    def b1_recorder(*a, **kw):
        b1_calls.setdefault((a[0].shape[0], a[4], a[8]), []).append((a, kw))
        return b1_orig(*a, **kw)

    b1_recorder.launches = 0
    b1_orig, sp.sample_fused = sp.sample_fused, b1_recorder
    try:
        with Capture((ft, "train_fwd", "B5"), (ft, "train_bwd", "B6")) as cap:
            (_, _), _ = tile.compute_grads(state, data, tc, gen)
    finally:
        sp.sample_fused = b1_orig
    pts, meta, table, res, pslab, NW = cap.args["B5"][0]
    pts, table, pslab, g = pts.detach(), table.detach(), pslab.detach(), cap.args["B6"][0][6]
    NC = pts.shape[0]
    live_c = meta[:, :, 2].sum(dim=1) > 0
    live, visited = int(live_c.sum()), int(torch.unique(meta[live_c, 0, 0]).numel())
    print(f"training stream: {NC} chunks, {live} live, {visited} visited blocks")
    # the windows each live chunk spans: B4's kernel sums a chunk's table
    # gradient in a shared slab over them, 8 windows a pass
    span = meta[:, :, 2]
    wlo = torch.where(span > 0, meta[:, :, 1], torch.full_like(span, 2**30)).amin(dim=1)
    whi = torch.where(span > 0, meta[:, :, 1] + span - 1, torch.full_like(span, -1)).amax(dim=1)
    n_win, count = torch.unique((whi - wlo + 1)[live_c], return_counts=True)
    print("windows spanned per live chunk (windows: chunks): "
          + json.dumps({int(k): int(v) for k, v in zip(n_win, count)}))
    # the kernels against their plain versions on the middle chunks, with
    # the step's slab and with one packed where BARF weighs every level 1
    # (at this early step levels 9-15 weigh 0, so their feature cotangents,
    # table scatter and dL/du are 0 in both versions)
    c0 = max(NC // 2 - N_SUB_CHUNKS // 2, 0)
    c1 = min(c0 + N_SUB_CHUNKS, NC)
    sub = (pts[c0:c1].contiguous(), meta[c0:c1].contiguous())
    g_sub = g[c0 * hw.CHUNK:c1 * hw.CHUNK].contiguous()
    slab_all = ft.pack_train_slab(state.params.field.decoder,
                                  field.weight_feature(torch.tensor(20000.0, device="cuda")))
    err_b5, err_b6 = [], []
    for label, slab in (("step slab", pslab), ("all levels", slab_all.detach())):
        cols_k, feats_k = ft.train_fwd(*sub, table, res, slab, NW)
        cols_p, feats_p = ft.train_fwd_plain(*sub, table, res, slab, NW)
        err_b5 += [float((cols_k - cols_p).abs().max()), float((feats_k - feats_p).abs().max())]
        print(f"B5 {label}, chunks {c0}-{c1}: max |cols| err {err_b5[-2]:.3g} (tol 1e-4), "
              f"max |feats| err {err_b5[-1]:.3g} (tol 1e-5)")
        if not (err_b5[-2] <= 1e-4 and err_b5[-1] <= 1e-5 and torch.isfinite(cols_k).all()):
            fail(f"B5 ({label}) differs from its plain version")
        if label == "step slab":
            # B3 and B5 gather alike (decoder.cuh::corner_sum), so B3's
            # features are, bit for bit, those B5 keeps for its backward
            f3 = hw.lookup_fwd(*sub, table, res, NW)
            f5 = feats_k.permute(0, 3, 1, 2).reshape(f3.shape)
            n_diff = int((f3 != f5).sum())
            print(f"B3 against B5's kept features, chunks {c0}-{c1}: {n_diff} of {f3.numel()} "
                  f"entries differ (must be 0)")
            if n_diff or not torch.equal(f3, f5):
                fail("B3's features differ from those B5 keeps: they must be equal bit for bit")
            del f3, f5
        dpts_k, dtab_k, dslab_k = ft.train_bwd(*sub, table, res, slab, feats_k, g_sub, NW)
        dpts_p, dtab_p, dslab_p = ft.train_bwd_plain(*sub, table, res, slab, feats_p, g_sub, NW)
        if dpts_k[:, 3::4].count_nonzero() or dpts_p[:, 3::4].count_nonzero():
            fail(f"B6 ({label}) dpts rows 3 and 7 are not zero")
        # each part against its own largest entry: dL/du (rows 0-2), dL/d
        # dirs (rows 4-6), the table gradient level by level, the slab's
        parts = [("dpts u", dpts_k[:, 0:3], dpts_p[:, 0:3]),
                 ("dpts dirs", dpts_k[:, 4:7], dpts_p[:, 4:7]),
                 ("d_slab", dslab_k, dslab_p)]
        parts += [(f"d_tables level {lv}", dtab_k[lv], dtab_p[lv]) for lv in range(LEVELS)]
        # and B6a's own output, the features' cotangent, on the live chunks
        live_rows = (sub[1][:, :, 2].sum(dim=1) > 0).repeat_interleave(hw.CHUNK)
        df_k = ft.decoder_bwd(*sub, slab, feats_k, g_sub)[0].permute(0, 2, 1).reshape(-1, 32)
        df_p = ft.decoder_bwd_plain(*sub, slab, feats_p, g_sub)[0]
        parts.append(("d_feats (B6a)", df_k[live_rows], df_p[live_rows]))
        err_b6 += check_parts(f"B6 ({label})", parts, label == "all levels")
        del dpts_k, dtab_k, dslab_k, dpts_p, dtab_p, dslab_p, cols_p, feats_p, df_k, df_p
    torch.cuda.empty_cache()

    # times on the whole stream of the step
    _, feats_full = ft.train_fwd(pts, meta, table, res, pslab, NW)
    rows_b5 = NC * hw.CHUNK
    tab_bytes = visited * 16 * hw.WB * hw.W * 2 * 4
    # B5 and B6 read pts rows 0-6 (u, window id, dirs); B6 writes all of dpts
    rows_in = pts[:, 0:7].numel() * 4
    b5_bytes = (rows_in + meta.numel() * 4 + rows_b5 * 8 * 4 + feats_full.numel() * 4
                + tab_bytes + pslab.numel() * 4)
    b6_bytes = (rows_in + meta.numel() * 4 + feats_full.numel() * 4 + rows_b5 * 8 * 4
                + pts.numel() * 4 + tab_bytes + table.numel() * 4 + 2 * pslab.numel() * 4)
    # B5's operations: the decoder forward (2 x MACS a row) and the
    # trilinear sums (16 levels x 8 corners x 6); B6's: the decoder's three
    # products (forward, input and weight gradients: 6 x MACS a row), the
    # scatter and dL/du (16 levels x 8 corners x 16). Both run the four
    # large matrices (TC_MACS of MACS a row) as three TF32 products each on
    # the tensor cores and the rest on the CUDA cores; the two units run
    # side by side, so the bound is the larger of their times. Beside it,
    # the same work all in f32 on the CUDA cores (the bound before the
    # kernel used the tensor cores).
    rows_live = live * hw.CHUNK
    b5_tc, b5_cc, b5_f32 = decoder_bounds(rows_live, 1, 16 * 8 * 6)
    b5 = dict(name="fused_train_fwd", route="cuda", source="scanerf_tpu_torch/csrc/fused_train.cu",
              replaces="scanerf_tpu/ops/pallas/fused_train.py:139", launches=launches["B5"],
              max_abs_err=max(err_b5),
              ms=timed(lambda: ft.train_fwd(pts, meta, table, res, pslab, NW), 5),
              plain_ms=timed(lambda: ft.train_fwd_plain(pts, meta, table, res, pslab, NW), 1),
              bytes=b5_bytes, ops_ms=max(b5_tc, b5_cc), library_ms=None)
    b5_nofeat_ms = timed(lambda: ft.train_fwd(pts, meta, table, res, pslab, NW, want_feats=False), 5)
    torch.cuda.empty_cache()
    tc_ms, cc_ms, f32_ms = decoder_bounds(rows_live, 3, 16 * 8 * 16)
    adds = torch.zeros(1, dtype=torch.int64, device="cuda")
    ft.train_bwd(pts, meta, table, res, pslab, feats_full, g, NW, adds=adds)
    b6_adds = int(adds)
    b6 = dict(name="fused_train_bwd", route="cuda", source="scanerf_tpu_torch/csrc/fused_train.cu",
              replaces="scanerf_tpu/ops/pallas/fused_train.py:222", launches=launches["B6"],
              max_abs_err=max(err_b6),
              ms=timed(lambda: ft.train_bwd(pts, meta, table, res, pslab, feats_full, g, NW), 3),
              plain_ms=timed(lambda: ft.train_bwd_plain(pts, meta, table, res, pslab, feats_full,
                                                        g, NW), 1),
              bytes=b6_bytes, ops_ms=max(tc_ms, cc_ms), library_ms=None)
    b6a_ms = timed(lambda: ft.decoder_bwd(pts, meta, pslab, feats_full, g), 3)
    real_rows = int((pts[:, 3, :] < NW).sum())
    print(f"B5 {b5['ms']:.3f} ms (without the features residual {b5_nofeat_ms:.3f}; operation "
          f"bound {max(b5_tc, b5_cc):.3f} ms with the tensor cores (3xTF32 {b5_tc:.3f}, CUDA "
          f"cores {b5_cc:.3f}), {b5_f32:.3f} ms all in f32 on the CUDA cores)")
    print(f"B5 {b5['ms']:.3f} ms (plain {b5['plain_ms']:.1f}), B6 {b6['ms']:.3f} ms "
          f"(plain {b6['plain_ms']:.1f}; of it B6a {b6a_ms:.3f} ms, then B4's kernel) on the "
          f"whole stream; B6's operation bound {max(tc_ms, cc_ms):.3f} ms with the tensor cores "
          f"(3xTF32 {tc_ms:.3f}, CUDA cores {cc_ms:.3f}), {f32_ms:.3f} ms all in f32 on the CUDA "
          f"cores")
    print(f"global atomics into the table gradient, one step's B6: {b6_adds} f32 elements "
          f"(a per-corner scatter: {real_rows * LEVELS * 8 * 2})")
    del feats_full
    torch.cuda.empty_cache()
    b3, b4 = lookup_kernels(state, pts, meta, table, res, NW, g, (c0, c1), launches, render_b3)
    # B1 at the step's shapes. The counted steps launched it per step once
    # at the batch's shape in the rgb-only arm and as recorded above in the
    # full recipe, in both configurations
    b1_train = {}
    for shape, calls in sorted(b1_calls.items()):
        a, kw = calls[0]
        batch = shape[1:] == (TRAIN_KW["num_sample"], TRAIN_KW["num_march"])
        b1_train[shape] = dict(b1_shape(f"training {shape[0]} rays", a, kw, 20),
                               launches=2 * TIMED_STEPS * (len(calls) + batch))
    if sum(v["launches"] for v in b1_train.values()) != launches["B1"]:
        fail(f"B1's training launches by shape {[v['launches'] for v in b1_train.values()]} "
             f"do not add up to the {launches['B1']} counted")
    del b1_calls
    del cap, pts, meta, g
    torch.cuda.empty_cache()
    print(f"phase train kernels: {time.perf_counter() - t_cmp:.1f} s")

    # --- one full-recipe step fused against the same step unfused, then
    # one of 512 rays on the card against the CPU. As in
    # tests/test_torch_train.py test (g), every compared loss carries
    # weight: alpha / gamma 0.02 / 1.0 (at 10 / 20 the visibility weights
    # of this untrained field underflow and the warp loss is ~1e-7), mono
    # normals that pass the smooth loss's similarity test (bench.py's are
    # 0) and ADMM variables with overlapping cameras (a fresh state's flags
    # are all off)
    t_cpu = time.perf_counter()
    tc_w = dataclasses.replace(tc, alpha=0.02, gamma=1.0)
    tc_chk = dataclasses.replace(tc_w, batch_log2=int(np.log2(N_CHECK_RAYS)))
    rng = np.random.default_rng(13)

    def small(*shape):
        return torch.tensor(rng.standard_normal(shape) * 0.01, dtype=torch.float32,
                            device="cuda")

    normals = np.float32([0.1, 1.0, 0.2]) + rng.standard_normal(
        (TRAIN_CAMS, TRAIN_HW, TRAIN_HW, 3)).astype(np.float32) * 0.02
    data = dataclasses.replace(data, mono_normals=torch.tensor(normals, device="cuda"))
    state = dataclasses.replace(state, admm=tile.AdmmState(
        shared_se3=small(TRAIN_CAMS, 6), delta_se3=small(TRAIN_CAMS, 6),
        overlap_flags=torch.arange(TRAIN_CAMS, device="cuda") % 4 != 1, rho=state.admm.rho))
    fused_vs_unfused(state, data, tc_w)
    print(f"phase train fused-vs-unfused: {time.perf_counter() - t_cpu:.1f} s")
    t_cpu = time.perf_counter()
    ray_idx, locs = tile.sample_patches(torch.Generator().manual_seed(7), TRAIN_HW, TRAIN_HW,
                                        N_CHECK_RAYS // TRAIN_CAMS // 4)
    pix = locs[None].expand(TRAIN_CAMS, *locs.shape)
    cpu_state, cpu_data = to_device(state, "cpu"), to_device(data, "cpu")
    # the CPU against itself with se3_refine moved by 1e-7 (rays by about
    # as many ulps as the card's differ from the CPU's)
    nudge = torch.tensor(rng.standard_normal((TRAIN_CAMS, 6)) * 1e-7, dtype=torch.float32)
    cpu_nudged = dataclasses.replace(cpu_state, params=tile.TileParams(
        field=cpu_state.params.field, se3_refine=cpu_state.params.se3_refine + nudge))
    # test (g)'s tolerances: the step is not continuous in f32 rounding (a
    # sample on a CDF tie or a window boundary moves when the rays differ
    # by an ulp, and the card's rays do), and neighbour selection and the
    # visibility re-render are discontinuous
    rtol = {"depth_loss": 2e-3, "smooth_loss": 2e-3, "warp_loss": 2e-2}
    # The full recipe's gradients are the depth loss's (the sky's 1e3 mono
    # depths), so the warp loss is also held alone: its path (view
    # selection, projection, the re-render through B1/B2/B5, B6) then
    # carries the whole gradient.
    warp_alone = dataclasses.replace(tc_chk, w_rgb=0.0, w_depth=0.0, w_smooth=0.0, rho=0.0)
    for recipe, tcx, names in (
            ("full recipe", tc_chk, ("total_loss", "rgb_loss", "depth_loss", "smooth_loss",
                                     "warp_loss", "admm_loss")),
            ("warp loss alone", warp_alone, ("total_loss", "warp_loss"))):
        (_, a_k), g_k = tile.compute_grads(state, data, tcx, ray_idx=ray_idx.cuda(),
                                           pixel_locs=pix.cuda())
        (_, a_p), g_p = tile.compute_grads(cpu_state, cpu_data, tcx, ray_idx=ray_idx,
                                           pixel_locs=pix)
        (_, _), g_n = tile.compute_grads(cpu_nudged, cpu_data, tcx, ray_idx=ray_idx,
                                         pixel_locs=pix)
        for k in names:
            a, b = float(a_k[k]), float(a_p[k])
            tol = rtol.get(k, 5e-4) * abs(b)
            print(f"step parity ({recipe}) {k}: card {a:.7g} cpu {b:.7g} (tol {tol:.3g})")
            if not b > 1e-4:
                fail(f"the check's {k} is {b:.3g}, not above 1e-4: it carries no weight")
            if not (np.isfinite(a) and abs(a - b) <= tol):
                fail(f"the card's {k} differs from the CPU's ({recipe})")
        # gradients: test (g)'s limits, or twice the CPU's own change under
        # the nudge where that is larger
        for name, floor in (("hash", 2e-2), ("decoder", 2e-2), ("cam", 1e-3)):
            worst = max(rel_l2(b, a.cpu()) for a, b in zip(g_k[name], g_p[name]))
            own = max(rel_l2(b, n) for n, b in zip(g_n[name], g_p[name]))
            tol = max(floor, 2 * own)
            print(f"step parity ({recipe}) grad {name}: worst relative L2 {worst:.3g} (tol "
                  f"{tol:.3g}: the larger of {floor} and twice the CPU's own change {own:.3g})")
            if not worst <= tol:
                fail(f"the card's {name} gradient differs from the CPU's ({recipe})")
    print(f"phase train card-vs-cpu: {time.perf_counter() - t_cpu:.1f} s")
    return [b3, b4, b5, b6], b1_train, launches["B1"]


# ---------------------------------------------------------------------------
# tile: one tile from a scene directory to an export (slice 7)
# ---------------------------------------------------------------------------

# 200 steps since the city phase was added (400 before), to keep the script's time
TILE_STEPS, TILE_BLOCK, TILE_RESUME_AT = 200, 100, 100
# bench.py's width: 16 cameras at 256x256, 2^14 rays a step, 128 + 128
# samples, a 512-step march, H = 2^21
TILE_CAMS, TILE_HW, TILE_BATCH_LOG2, TILE_LOG2_H = 16, 256, 14, 21
TILE_SAMPLES, TILE_MARCH = 128, 512
# Limits of the tile phase:
# - training must show in the eval render: its PSNR after the last step at
#   least 3 dB above step 0's (a random field renders a near-flat grey, so
#   any fit of the sky, the ground and the sphere clears it; a broken
#   gradient or update does not);
TILE_MIN_PSNR_RISE = 3.0
# - the state restored from a checkpoint equals the saved one exactly
#   (save and load copy numbers, nothing is computed between);
# - one step from the saved state and one from the restored state, on the
#   same batch, agree within FVU_LOSS_RTOL's 1e-5 relative in every loss
#   and, in each group's params after the update, within 1e-5 relative
#   L2: the forward is the same computation on the same numbers, but B4's
#   atomics (inside B6) add the table gradient in an order that changes
#   from run to run, so the update differs in its last bits. A loss that
#   underflows to ~0 is held to 1e-11 absolute;
TILE_RESUME_RTOL, TILE_RESUME_ATOL = 1e-5, 1e-11
# - the export's render (B7; fp16 tables, the renderer's own union-grid
#   sampling, every BARF level on) within 1 dB PSNR of the training-side
#   render (B5) of the same view, and the two images within 0.1 mean
#   |difference|, the limit of the JAX package's own
#   tests/test_checkpoint_render.py::test_export_matches_field_render.
TILE_EXPORT_DB, TILE_EXPORT_MAD = 1.0, 0.1


def tile_phase() -> dict:
    """One tile trained from a scene directory through the port's entry
    points: ``write_scene_dir`` (16 cameras at 256x256, one tile, mono
    priors), a config from ``default_config`` and ``TrainConfig.from_cfg``,
    ``load_scene`` with seeded pose noise, ``create_field(cubic_grid=True)``
    at H = 2^21, ``train_n_steps`` for 200 full-recipe fused steps in
    blocks of 100 with the eval PSNR / SSIM, the pose error and the rays/s
    of each block; a checkpoint at step 100 saved, loaded into a fresh
    state and held against the saved one, one step from each; then
    ``export_tile`` and the export rendered by the renderer. Returns the
    phase's launches of each kernel ("launches") and, for the extras
    phase, the trained tile ("ctx": its state, cameras, eval view and
    image size)."""
    from scanerf_tpu_torch.config import default_config
    from scanerf_tpu_torch import convert
    from scanerf_tpu_torch.data import io as dio
    from scanerf_tpu_torch.data.synthetic import write_scene_dir
    from scanerf_tpu_torch.models import field
    from scanerf_tpu_torch.ops.kernels import fused_render as fr
    from scanerf_tpu_torch.ops.kernels import fused_train as ft
    from scanerf_tpu_torch.ops.kernels import hash_encode as hw
    from scanerf_tpu_torch.ops.kernels import sampler as sp
    from scanerf_tpu_torch.render import renderer
    from scanerf_tpu_torch.train import cameras, checkpoint, tile
    from scanerf_tpu_torch.utils import metrics

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    counters = {"B1": sp.sample_fused, "B2": hw.pack, "B5": ft.train_fwd,
                "B6": ft.train_bwd, "B7": fr.hash_decode_fused}
    for c in counters.values():
        c.launches = 0
    with tempfile.TemporaryDirectory() as root:
        # --- scene, config, tile
        t0 = time.perf_counter()
        write_scene_dir(root, n_cameras=TILE_CAMS, H=TILE_HW, W=TILE_HW, n_tiles=1)
        infos = dio.read_tile_info(os.path.join(root, "tiles", "tile_info.txt"))
        infos[0].resolution = (32, 2048)  # bench.py's; write_scene_dir writes (16, 256)
        dio.write_tile_info(os.path.join(root, "tiles", "tile_info.txt"), list(infos.values()))
        cfg = default_config().deep_update({
            "DATADIR": root, "HASHGRID": {"LOG2_HASHMAP_SIZE": TILE_LOG2_H},
            "TRAINING": {"GRID_LOG2DIM": [6, 7, 8, 9], "BS_LOG2DIM": TILE_BATCH_LOG2,
                         "NUM_SAMPLE": TILE_SAMPLES, "NUM_BG_SAMPLE": TILE_SAMPLES,
                         "NUM_MARCH": TILE_MARCH, "TOTAL_STEP": TILE_STEPS,
                         "CAMOPT": {"NOISE": 0.02}}})
        tc = tile.TrainConfig.from_cfg(cfg)
        info = dio.read_tile_info(os.path.join(root, "tiles", "tile_info.txt"))[0]
        train_views = dio.read_training_views(
            os.path.join(root, "tiles", "training_views.txt"))[0]
        with open(os.path.join(root, "blocks", "test.txt")) as f:
            test_views = {int(p[0]): [int(v) for v in p[1:]]
                          for p in (line.split() for line in f) if p}[0]
        views = list(dict.fromkeys(train_views[:cfg.MAX_POSES] + test_views))
        sc = dio.load_scene(root, views, mono_depth=True, mono_normal=True)
        views = sc.idx_list
        # the trainer's pose noise: a seeded table over all cameras, the
        # clean poses as ground truth
        noise = float(cfg.TRAINING.CAMOPT.NOISE) * np.random.RandomState(cfg.SEED).randn(
            sc.ks.shape[0], 6).astype(np.float32)

        def dev(a):
            return torch.tensor(a, device="cuda")

        cams = cameras.make_cameras(dev(sc.ks), dev(sc.c2ws), noise_se3=dev(noise),
                                    gt_c2ws=dev(sc.c2ws))
        data = tile.TileData(
            images=dev(sc.images),
            occlusions=torch.ones(sc.images.shape[:3], dtype=torch.bool, device="cuda"),
            cameras=cams, mono_depths=dev(sc.mono_depths), mono_normals=dev(sc.mono_normals))

        def new_state(seed):
            p, fs = field.create_field(
                torch.Generator(device="cuda").manual_seed(seed), info.corner, info.size,
                log2_hashmap_size=cfg.HASHGRID.LOG2_HASHMAP_SIZE,
                grid_resolution=info.resolution,
                sampler_log2dim=int(cfg.TRAINING.GRID_LOG2DIM[0]), cubic_grid=True,
                device="cuda")
            return tile.create_train_state(p, fs, len(views), tc, device="cuda")

        state = new_state(cfg.SEED)
        eval_view = views.index(test_views[0])
        gt = dev(sc.images[eval_view])
        print(f"tile: scene of {len(views)} views at {sc.H}x{sc.W}, tile {info.index} "
              f"resolution {info.resolution}, H = 2^{cfg.HASHGRID.LOG2_HASHMAP_SIZE}, grid "
              f"{tuple(state.field_state.occupied_grid.shape)}, config: {tc}; set up in "
              f"{time.perf_counter() - t0:.1f} s")
        print(f"tile: eval view {test_views[0]} of blocks/test.txt, also a training view")

        def evaluate(state, label, rays_s=None):
            img = tile.render_image(state, cams, eval_view, sc.H, sc.W, tc, device="cuda")
            rgb = dev(img["rgb"])
            ps, ss = float(metrics.psnr(rgb, gt)), float(metrics.ssim(rgb, gt))
            r_err, t_err = (float(x) for x in
                            cameras.evaluate_camera_alignment(cams, state.params.se3_refine))
            if not (np.isfinite(ps) and np.isfinite(ss) and np.isfinite(img["rgb"]).all()):
                fail(f"tile: non-finite eval render at {label}")
            print(f"tile {label}: eval PSNR {ps:.4f} dB, SSIM {ss:.5f}, pose error "
                  f"{r_err:.5f} deg / {t_err:.6f}"
                  + ("" if rays_s is None else f"; block {rays_s:.0f} training rays/s"))
            return ps, rgb

        gen = torch.Generator().manual_seed(cfg.SEED + 1)
        rays_per_step = (2**tc.batch_log2 // len(views)) // 4 * 4 * len(views)

        def block(state, n, label):
            torch.cuda.synchronize()
            t = time.perf_counter()
            state, aux = tile.train_n_steps(state, data, tc, n, gen, device="cuda")
            torch.cuda.synchronize()
            rays_s = rays_per_step * n / (time.perf_counter() - t)
            if not all(bool(torch.isfinite(v).all()) for v in aux.values()):
                fail(f"tile: non-finite loss in the steps to {label}")
            print(f"tile {label}: " + ", ".join(f"{k} {float(v):.5g}" for k, v in aux.items()
                                               if v.ndim == 0))
            return state, evaluate(state, label, rays_s)[0]

        psnr0, _ = evaluate(state, "step 0")
        curve = [psnr0]
        while state.step < TILE_RESUME_AT:
            state, ps = block(state, TILE_BLOCK, f"step {state.step + TILE_BLOCK}")
            curve.append(ps)

        # --- resume: save, load into a fresh state, one step from each
        t0 = time.perf_counter()
        path = checkpoint.checkpoint_path(root, state.step, info.index)
        checkpoint.save_checkpoint(path, state)
        t_save = time.perf_counter() - t0
        restored = checkpoint.load_checkpoint(checkpoint.latest_checkpoint(root, info.index),
                                              new_state(cfg.SEED + 7), device="cuda")
        torch.cuda.synchronize()
        print(f"tile resume: {os.path.getsize(path) / 2**20:.1f} MiB saved in {t_save:.1f} s, "
              f"loaded in {time.perf_counter() - t0 - t_save:.1f} s")
        saved, back = convert.state_tensors(state), convert.state_tensors(restored)
        if saved.keys() != back.keys():
            fail(f"tile resume: the restored state's arrays differ: "
                 f"{sorted(saved.keys() ^ back.keys())}")
        differ = [k for k in saved if not (saved[k].dtype == back[k].dtype
                                           and torch.equal(saved[k].cpu(), back[k].cpu()))]
        if differ:
            fail(f"tile resume: {len(differ)} arrays differ after the round trip: {differ[:4]}")
        print(f"tile resume: all {len(saved)} arrays (tables, decoder, se3_refine, Adam "
              f"moments and counts, schedule counts, field and ADMM state, step) equal")
        del saved, back
        fork = gen.get_state()
        state, a_saved = tile.train_step(state, data, tc, gen, device="cuda")
        restored, a_back = tile.train_step(restored, data, tc,
                                           torch.Generator().set_state(fork), device="cuda")
        for k, v in a_saved.items():
            if v.ndim:
                continue
            a, b = float(a_back[k]), float(v)
            tol = max(TILE_RESUME_RTOL * abs(b), TILE_RESUME_ATOL)
            print(f"tile resume step {k}: saved {b:.8g} restored {a:.8g} (tol {tol:.3g})")
            if not (np.isfinite(a) and abs(a - b) <= tol):
                fail(f"tile resume: the restored state's step differs in {k}")
        leaves_a = tile.group_leaves(state.params)
        leaves_b = tile.group_leaves(restored.params)
        for name in ("hash", "decoder", "cam"):
            worst = max(rel_l2(x, y) for x, y in zip(leaves_a[name], leaves_b[name]))
            print(f"tile resume step params {name}: worst relative L2 {worst:.3g} "
                  f"(tol {TILE_RESUME_RTOL})")
            if not worst <= TILE_RESUME_RTOL:
                fail(f"tile resume: the restored state's {name} params differ after a step")
        # the run goes on from the restored state
        state = restored
        del leaves_a, leaves_b
        torch.cuda.empty_cache()
        state, ps = block(state, TILE_BLOCK - 1, f"step {state.step + TILE_BLOCK - 1} "
                          f"(resumed; {TILE_BLOCK - 1} steps timed)")
        curve.append(ps)
        while state.step < TILE_STEPS:
            state, ps = block(state, TILE_BLOCK, f"step {state.step + TILE_BLOCK}")
            curve.append(ps)
        rise = curve[-1] - curve[0]
        print(f"tile: eval PSNR curve {[round(c, 4) for c in curve]} dB, rise {rise:.4f} dB "
              f"(limit >= {TILE_MIN_PSNR_RISE})")
        if not rise >= TILE_MIN_PSNR_RISE:
            fail(f"tile: the eval PSNR rose {rise:.3f} dB in {TILE_STEPS} steps")

        # --- export, and the export rendered by the renderer (B7)
        _, train_rgb = evaluate(state, f"step {state.step} (training-side render)")
        t0 = time.perf_counter()
        tile_dir = os.path.join(root, f"tile-{info.index}")
        checkpoint.export_tile(tile_dir, state, cams, views, hash_layout=tc.hash_backend)
        ex = checkpoint.load_tile_export(tile_dir)
        scene = renderer.load_scene([tile_dir], device="cuda")
        img = renderer.render_image(scene, ex["ks"][eval_view], ex["c2ws"][eval_view], sc.H,
                                    sc.W, device="cuda", num_sample=tc.num_sample,
                                    num_bg_sample=tc.num_bg_sample, num_march=tc.num_march)
        ex_rgb = dev(img["rgb"])
        ps_ex, ps_tr = float(metrics.psnr(ex_rgb, gt)), float(metrics.psnr(train_rgb, gt))
        mad = float((ex_rgb - train_rgb).abs().mean())
        print(f"tile export: {ex['hash_layout']} tables, rendered by the renderer in "
              f"{time.perf_counter() - t0:.1f} s with export: PSNR {ps_ex:.4f} dB against "
              f"{ps_tr:.4f} training-side (gap {ps_ex - ps_tr:+.4f}, limit {TILE_EXPORT_DB}); "
              f"mean |difference| {mad:.5f} (limit {TILE_EXPORT_MAD})")
        if not (np.isfinite(ps_ex) and abs(ps_ex - ps_tr) <= TILE_EXPORT_DB
                and mad < TILE_EXPORT_MAD):
            fail("tile export: the export's render is off the training-side render")
    got = {k: c.launches for k, c in counters.items()}
    print(f"tile launches: {json.dumps(got)}")
    for k, n in got.items():
        if n <= 0:
            fail(f"kernel {k} was not launched in the tile phase")
    print(f"phase tile: {time.perf_counter() - t_phase:.1f} s")
    return {"launches": got, "ctx": {"state": state, "cams": cams, "eval_view": eval_view,
                                     "H": sc.H, "W": sc.W,
                                     "table_rows": state.params.field.features.shape[1] // 2}}


# ---------------------------------------------------------------------------
# city: the multi-tile ADMM trainer from a city scene directory (slice 8)
# ---------------------------------------------------------------------------

# a 2x2 city (4 tiles), 96 cameras at 128x128, at bench.py's width: 2^14
# rays a step, 128 + 128 samples, M 512, H = 2^21 (windowed), the
# reference's full loss recipe; 4 ADMM rounds of 25 steps
CITY_NX, CITY_NZ, CITY_CAMS, CITY_HW = 2, 2, 96, 128
CITY_STEPS, CITY_SYN = 100, 25
CITY_KIND = {"B1": "cdf_sampler", "B2": "stream_pack", "B3": "hash_lookup_fwd",
             "B5": "fused_train_fwd", "B6": "fused_train_bwd", "B7": "fused_hash_decode"}
# Limits of the city phase:
# - each tile's eval PSNR after step 100 at least 2 dB above its step-0
#   PSNR (the tile phase's single tile rises 7 dB in 100 steps; four tiles
#   sharing cameras through ADMM at the same rates must rise too);
CITY_MIN_PSNR_RISE = 2.0
# - the last round's consensus on the card against the plain
#   consensus_update on the CPU from the same inputs: z and the dual
#   within 1e-6 of their largest entry, both residuals within 1e-6
#   absolute (the same f32 operations; the scatter's atomics add in
#   another order; the dual residual of a round whose poses no longer
#   move is ~0, so a relative limit would hold rounding to itself);
CITY_CONSENSUS_TOL = 1e-6
# - one chunk of the pruning query (field_inference_sigma through B2 and
#   B3) within 1e-5 of its largest entry of the plain gather on the CPU,
#   B3's tolerance on the training stream;
CITY_SIGMA_TOL = 1e-5
# - tile 0's pruned grid equal to the CPU prune of the same state, except
#   in cells whose largest alpha lies within 1e-4 of the threshold (a
#   density within 1e-5 relative moves alpha by less than that).
CITY_PRUNE_BAND = 1e-4


def city_phase(serve=None) -> dict:
    """The port's ``Trainer`` on a city scene directory, on the card:
    ``write_city_scene_dir`` (2 x 2 tiles, 96 cameras at 128x128; tile
    boxes at resolution (32, 2048), raised 0.2 so that the drone path
    passes through them and the occlusion refresh publishes depths),
    ``Trainer(cfg).run()`` (4 ADMM rounds of 25 full-recipe steps a tile,
    the refresh and evals at step 50 and 100, checkpoints at step 50,
    exports at step 100), then the trainer's own ``_prune`` at the
    ladder's next rung (64^3 -> 128^3), one more round on the pruned
    grids and ``_export``; the exports rendered by the renderer (B7).
    Returns the phase's launches of each kernel and B3's numbers at the
    pruning query's shape; ``serve(root, trainer, evals)``, when given,
    runs on the city's directory and exports before it is removed, and
    its result comes back under "serve"."""
    from scanerf_tpu_torch.config import default_config
    from scanerf_tpu_torch.data import io as dio
    from scanerf_tpu_torch.data.city import write_city_scene_dir
    from scanerf_tpu_torch.models import field, occupancy
    from scanerf_tpu_torch.ops.kernels import fused_render as fr
    from scanerf_tpu_torch.ops.kernels import fused_train as ft
    from scanerf_tpu_torch.ops.kernels import hash_encode as hw
    from scanerf_tpu_torch.ops.kernels import sampler as sp
    from scanerf_tpu_torch.parallel import consensus
    from scanerf_tpu_torch.parallel import tile_parallel as tp
    from scanerf_tpu_torch.render import renderer
    from scanerf_tpu_torch.train import checkpoint, tile
    from scanerf_tpu_torch.train.trainer import Trainer
    from scanerf_tpu_torch.utils import metrics

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    counters = {"B1": sp.sample_fused, "B2": hw.pack, "B3": hw.lookup_fwd,
                "B5": ft.train_fwd, "B6": ft.train_bwd, "B7": fr.hash_decode_fused}
    for c in counters.values():
        c.launches = 0
    round_s: list[float] = []
    rays_per_step = [0]
    build_round = tp.build_admm_round

    def timed_build(mesh, tc, n_inner, *a, **kw):  # the Trainer's rounds, each timed
        round_fn = build_round(mesh, tc, n_inner, *a, **kw)

        def timed_round(tiles, datas, generators):  # steps and consensus, synchronised
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = round_fn(tiles, datas, generators)
            torch.cuda.synchronize()
            round_s.append(time.perf_counter() - t)
            n = len(tiles.states) * n_inner * rays_per_step[0]
            print(f"city round {len(round_s)}: {round_s[-1]:.2f} s, {n / round_s[-1]:.0f} "
                  f"training rays/s ({len(tiles.states)} tiles x {n_inner} steps x "
                  f"{rays_per_step[0]} rays)")
            return out

        return timed_round

    tp.build_admm_round = timed_build
    served = None
    try:
        with tempfile.TemporaryDirectory() as root:
            got, b3, tr, evals = _city_run(root, counters, rays_per_step, default_config, dio,
                                           write_city_scene_dir, field, occupancy, hw,
                                           consensus, renderer, checkpoint, tile, Trainer,
                                           metrics)
            print(f"city: peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
                  f"GiB; phase city: {time.perf_counter() - t_phase:.1f} s")
            if serve is not None:
                served = serve(root, tr, evals)
    finally:
        tp.build_admm_round = build_round
    return {"launches": got, "b3": b3, "serve": served}


def _city_run(root, counters, rays_per_step, default_config, dio, write_city_scene_dir, field,
              occupancy, hw, consensus, renderer, checkpoint, tile, Trainer, metrics):
    t0 = time.perf_counter()
    summary = write_city_scene_dir(root, nx_tiles=CITY_NX, nz_tiles=CITY_NZ,
                                   n_cameras=CITY_CAMS, H=CITY_HW, W=CITY_HW)
    path = os.path.join(root, "tiles", "tile_info.txt")
    infos = list(dio.read_tile_info(path).values())
    for info in infos:
        info.resolution = (32, 2048)  # bench.py's; the city writer writes (16, 1024)
        info.corner = info.corner + np.array([0.0, 0.2, 0.0], np.float32)
    dio.write_tile_info(path, infos)
    cfg = default_config().deep_update({
        "DATADIR": root, "TILES": list(range(CITY_NX * CITY_NZ)), "RHO": 100.0,
        "SYN_ITERS": CITY_SYN, "EVAL_STEP": 50, "UPDATE_MASK_STEP": 50, "CKPT_STEP": 50,
        "HASHGRID": {"LOG2_HASHMAP_SIZE": 21},
        "TRAINING": {"TOTAL_STEP": CITY_STEPS, "BS_LOG2DIM": 14, "NUM_SAMPLE": 128,
                     "NUM_BG_SAMPLE": 128, "NUM_MARCH": 512, "GRID_LOG2DIM": [6, 7],
                     "PRUNING_TH": [0.1], "ADJUST_STEP": 50, "CAMOPT": {"NOISE": 0.01}}})
    print(f"city: scene {summary} written in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    tr = Trainer(cfg, device="cuda")
    torch.cuda.synchronize()
    n_cams = tr.cam_maps.shape[1]
    shared = int((np.bincount(tr.cam_maps[tr.cam_maps >= 0]) > 1).sum())
    print(f"city: Trainer built in {time.perf_counter() - t0:.1f} s: {len(tr.states)} tiles, "
          f"views {[len(v) for v in tr.view_lists]} (padded to {n_cams}), {shared} cameras "
          f"shared between tiles, first grids occupied "
          f"{[round(float(s.field_state.occupied_grid.float().mean()), 4) for s in tr.states]}"
          f", config: {tr.tc}")
    rays_per_step[0] = (2**tr.tc.batch_log2 // n_cams) // 4 * 4 * n_cams

    evals: dict[int, dict] = {}
    published: list[int] = []
    ev, refresh = tr._eval, tr._refresh_occlusion_masks

    def eval_(step):
        evals[step] = ev(step)
        print(f"city eval step {step}: " + ", ".join(
            f"tile {t} PSNR {p:.4f} dB SSIM {s:.5f}" for t, (p, s) in evals[step].items()))
        return evals[step]

    def refresh_():
        published.append(refresh())
        return published[-1]

    tr._eval, tr._refresh_occlusion_masks = eval_, refresh_
    duty_s: dict[str, float] = {}
    for name in ("_eval", "_refresh_occlusion_masks", "_save_round_checkpoints", "_export"):
        def timed_duty(*a, _fn=getattr(tr, name), _name=name, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = _fn(*a, **kw)
            torch.cuda.synchronize()
            duty_s[_name] = duty_s.get(_name, 0.0) + time.perf_counter() - t
            return out
        setattr(tr, name, timed_duty)
    eval_(0)
    t0 = time.perf_counter()
    tr.run()
    print(f"city: Trainer.run() {time.perf_counter() - t0:.1f} s, of it "
          + ", ".join(f"{k} {v:.1f} s" for k, v in duty_s.items()))
    ckpt = checkpoint.checkpoint_path(tr.logdir, CITY_STEPS, tr.tile_idxs[0])
    ckpt_mib = os.path.getsize(ckpt) / 2**20
    for f in os.listdir(tr.logdir):  # disk: drop the step-50 generation
        if f.startswith("checkpoint-50-"):
            os.remove(os.path.join(tr.logdir, f))

    # --- the pruning query: one chunk on the card against the CPU, B3 timed
    s0 = tr.states[0]
    cpu_params = field.FieldParams(
        features=s0.params.field.features.detach().cpu(),
        decoder={n: {k: v.detach().cpu() for k, v in p.items()}
                 for n, p in s0.params.field.decoder.items()})
    cpu_fs = field.FieldState(**{k: getattr(s0.field_state, k).cpu() for k in
                                 ("resolutions", "min_bbox", "bbox_size", "occupied_grid")})
    finest = s0.field_state.resolutions[-1].cpu().numpy()
    n_split, th = copy.copy(tr.pruning).next_at(CITY_STEPS)  # what _prune will apply
    b3 = _pruning_query_check(s0, cpu_params, cpu_fs, finest, n_split, counters, field,
                              occupancy, hw)

    t0 = time.perf_counter()
    tr._prune(CITY_STEPS)
    torch.cuda.synchronize()
    t_prune = time.perf_counter() - t0
    locs, res, alpha = occupancy.cell_max_alpha(cpu_params, cpu_fs, CITY_STEPS, finest,
                                                n_split, backend="windowed")
    want = np.zeros(tuple(res), bool)
    want[tuple(locs[alpha > th].T)] = True
    card = tr.states[0].field_state.occupied_grid.cpu().numpy()
    if card.shape != want.shape:
        fail(f"city prune: the card's grid is {card.shape}, the CPU's {want.shape}")
    differ = card != want
    band = np.zeros(tuple(res), bool)
    band[tuple(locs[np.abs(alpha - th) < CITY_PRUNE_BAND].T)] = True
    print(f"city prune: {t_prune:.1f} s on the card for {len(tr.states)} tiles; tile 0 "
          f"{len(locs)} cells queried at {tuple(int(r) for r in res)}, {int(want.sum())} kept on the CPU, "
          f"{int(card.sum())} on the card, {int(differ.sum())} differ, {int(band.sum())} "
          f"within {CITY_PRUNE_BAND} of the threshold {th}; occupied "
          f"{[round(float(s.field_state.occupied_grid.float().mean()), 4) for s in tr.states]}")
    if (differ & ~band).any():
        fail(f"city prune: {int((differ & ~band).sum())} cells of tile 0's grid differ from "
             f"the CPU prune away from the threshold")

    # --- one more round on the pruned grids; its consensus against the CPU
    before = [(s.admm.shared_se3.clone(), s.admm.delta_se3.clone()) for s in tr.states]
    aux = tr.train_round()
    x = torch.stack([s.params.se3_refine.detach() for s in tr.states]).cpu()
    z, delta, ov, caux = consensus.consensus_update(
        x, tr.confidence.cpu(), tr.cam_map.cpu(), torch.stack([b[0] for b in before]).cpu(),
        torch.stack([b[1] for b in before]).cpu(), tr.states[0].admm.rho.cpu(),
        tr.num_global_cams)
    errs = {}
    for name, ref, got in (("z", z, [s.admm.shared_se3 for s in tr.states]),
                           ("delta", delta, [s.admm.delta_se3 for s in tr.states])):
        got = torch.stack(got).cpu()
        errs[name] = float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30))
    for k in ("primal_residual", "dual_residual"):  # absolute: the dual can be ~0
        errs[k] = abs(float(getattr(aux, k)) - float(getattr(caux, k)))
    n_ovl = int(aux.num_overlap)
    same_ov = torch.equal(torch.stack([s.admm.overlap_flags for s in tr.states]).cpu(), ov)
    print(f"city consensus (last round) card against CPU: errors (z, delta relative to "
          f"their largest entry; residuals absolute) {errs} (tol {CITY_CONSENSUS_TOL}); "
          f"residuals on the card {float(aux.primal_residual):.6g} / "
          f"{float(aux.dual_residual):.6g}; overlap flags equal {same_ov}, {n_ovl} overlap "
          f"slots")
    if not (all(e <= CITY_CONSENSUS_TOL for e in errs.values()) and same_ov and n_ovl > 0):
        fail("city consensus: the card's round differs from the plain consensus_update")
    t0 = time.perf_counter()
    tr._export()
    print(f"city: the second _export {time.perf_counter() - t0:.1f} s")

    # --- logs
    log = open(os.path.join(tr.logdir, "training.log")).read().splitlines()
    rounds = [line.split("\t") for line in log if "\tloss " in line]
    losses = [float(r[1][5:]) for r in rounds]
    admm = [line for line in open(os.path.join(tr.logdir, "admm_error.txt"))]
    res_vals = [float(v.split(": ")[1]) for line in admm for v in line.strip().split("\t")]
    n_rounds = CITY_STEPS // CITY_SYN + 1
    print(f"city training.log rounds: {[(r[0], r[1]) for r in rounds]}")
    print(f"city admm_error.txt: {[line.strip() for line in admm]}")
    if not (len(rounds) == n_rounds and np.isfinite(losses).all()
            and losses[CITY_STEPS // CITY_SYN - 1] < losses[0]):
        fail(f"city: training.log has {len(rounds)} round lines (want {n_rounds}), finite "
             f"{np.isfinite(losses).all()}, the run's last mean loss below its first "
             f"{losses[CITY_STEPS // CITY_SYN - 1] if len(losses) >= 4 else None} < "
             f"{losses[0] if losses else None}")
    if not (len(admm) == n_rounds and np.isfinite(res_vals).all()):
        fail(f"city: admm_error.txt has {len(admm)} lines (want {n_rounds}) or a non-finite "
             f"residual")
    if not (published and max(published) > 0):
        fail(f"city: the occlusion refresh published no depth ({published})")
    print(f"city occlusion refresh: ran {len(published)} times, shared depths {published}")
    rise = {t: evals[CITY_STEPS][t][0] - evals[0][t][0] for t in evals[0]}
    print(f"city eval PSNR rise step 0 -> {CITY_STEPS}: "
          + ", ".join(f"tile {t} {r:+.4f} dB" for t, r in rise.items())
          + f" (limit >= {CITY_MIN_PSNR_RISE})")
    if not all(r >= CITY_MIN_PSNR_RISE for r in rise.values()):
        fail("city: a tile's eval PSNR rose less than the limit")

    # --- exports: files, and the renderer on them (B7)
    tile_dirs = sorted(os.path.join(tr.logdir, d) for d in os.listdir(tr.logdir)
                       if d.startswith("tile-"))
    if len(tile_dirs) != len(tr.states) or not os.path.exists(
            os.path.join(tr.logdir, "refined_camera.log")):
        fail(f"city: exports {tile_dirs} and refined_camera.log not all written")
    ex = checkpoint.load_tile_export(tile_dirs[0])
    scene = renderer.load_scene(tile_dirs, device="cuda")
    view = tr.test_idxs[tr.tile_idxs[0]][0]
    li = list(ex["idxs"]).index(view)
    t0 = time.perf_counter()
    img = renderer.render_image(scene, ex["ks"][li], ex["c2ws"][li], CITY_HW, CITY_HW,
                                device="cuda", num_sample=128, num_bg_sample=128,
                                num_march=512)
    torch.cuda.synchronize()
    t_render = time.perf_counter() - t0
    gt = tr.datas[0].images[li]
    rgb = torch.tensor(img["rgb"], device="cuda")
    train_img = tile.render_image(tr.states[0], tr.datas[0].cameras, li, CITY_HW, CITY_HW,
                                  tr.tc, device="cuda")
    ps_ex = float(metrics.psnr(rgb, gt))
    ps_tr = float(metrics.psnr(torch.tensor(train_img["rgb"], device="cuda"), gt))
    print(f"city export: {len(tile_dirs)} tiles ({ex['hash_layout']}), refined_camera.log; "
          f"the renderer's render of view {view} (tile {tr.tile_idxs[0]}'s test view) from all "
          f"{len(tile_dirs)} exports in {t_render:.2f} s: PSNR {ps_ex:.4f} dB, tile 0's "
          f"training-side render {ps_tr:.4f} dB; checkpoint {ckpt_mib:.1f} MiB a tile")
    if not (np.isfinite(img["rgb"]).all() and np.isfinite(ps_ex)):
        fail("city export: the renderer's image is not finite")
    got = {k: c.launches for k, c in counters.items()}
    print(f"city launches: {json.dumps(got)}")
    for k, n in got.items():
        if n <= 0:
            fail(f"kernel {k} was not launched in the city phase")
    return got, b3, tr, evals


def _pruning_query_check(state, cpu_params, cpu_fs, finest, n_split, counters, field,
                         occupancy, hw):
    """The first chunk of tile 0's pruning query at the next rung:
    ``field_inference_sigma`` through B2 and B3 on the card against the
    plain gather on the CPU; B3 captured there and timed at that shape.
    These launches are restored out of the phase's counts."""
    saved = {k: c.launches for k, c in counters.items()}
    _, res, corners, lattice = occupancy.query_lattice(
        state.field_state.occupied_grid.cpu().numpy(), CITY_STEPS, finest, n_split)
    pts = torch.from_numpy((corners[:4096, None, :] + lattice[None]) * 2.0 - 1.0)
    step = torch.tensor(float(CITY_STEPS))
    with Capture((hw, "lookup_fwd", "B3")) as cap:
        card = field.field_inference_sigma(state.params.field, state.field_state,
                                           pts.cuda(), step.cuda(), backend="windowed").cpu()
    plain = field.field_inference_sigma(cpu_params, cpu_fs, pts, step, backend="windowed")
    err, scale = float((card - plain).abs().max()), float(plain.abs().max())
    row = dict(points=int(pts.shape[0] * pts.shape[1]), **_b3_entry(cap.args["B3"][0], iters=20))
    for k, c in counters.items():
        c.launches = saved[k]
    print(f"city pruning query, one chunk of {pts.shape[0]} cells x {pts.shape[1]} points at "
          f"the {tuple(int(r) for r in res)} rung: field_inference_sigma on the card against the CPU max err "
          f"{err:.3g}, largest entry {scale:.3g} (tol {CITY_SIGMA_TOL} of it); B3 at this shape "
          f"({row['chunks']} chunks, {row['live_chunks']} live, {row['visited_blocks']} visited "
          f"blocks, {row['real_rows']} real rows): max err {row['max_abs_err']:.3g} against its "
          f"plain version, {row['ms']:.4f} ms (plain {row['plain_ms']:.3f})")
    if not (torch.isfinite(card).all() and err <= CITY_SIGMA_TOL * scale and row.pop("finite")
            and row["max_abs_err"] <= CITY_SIGMA_TOL * row.pop("scale")):
        fail("city: the pruning query on the card differs from its plain version")
    return row


# ---------------------------------------------------------------------------
# serve: rendering and evaluating the city's exports (slice 9)
# ---------------------------------------------------------------------------

SERVE_VAL_VIEWS = 8  # VAL views 0-7 of the city's 96, at 128x128
SERVE_KIND = dict(CITY_KIND, B4="hash_lookup_bwd")
# Limits of the serve phase:
# - VAL's mean PSNR at least 2 dB above the highest step-0 eval PSNR of the
#   city phase (the exports were trained 125 steps from there);
SERVE_MIN_PSNR_RISE = 2.0
# - metric.txt's PSNR / SSIM are of the float render, evaluate_dirs' of the
#   written 8-bit frames, which truncate each channel by less than q =
#   1/255: a frame's MSE against the ground truth then lies within
#   2 q mean|frame - gt| + 3 q^2 of the render's, and metric.txt's PSNR
#   within the PSNRs of those two ends; SSIM within 0.01. evaluate_dirs'
#   mean PSNR equal to the CPU's from the same PNGs within 1e-4 dB;
SERVE_QUANT_SSIM, SERVE_PSNR_TOL = 0.01, 1e-4
# - renders held together at RENDER_TOL (rgb 1e-4, depth 1e-3, the
#   fused-vs-unfused limits): staged against windowed, early termination
#   against one-shot, the staged card render against the CPU;
# - LPIPS on the card against the CPU within 1e-5 relative.
SERVE_LPIPS_RTOL = 1e-5
SERVE_SIGMA_BIAS = 50.0  # the opaque scene: every sigma head's bias raised by this
N_STAGED_CHECK_RAYS = 256


def _lpips_random_params(seed: int = 0) -> dict:
    """LPIPS weights at the AlexNet variant's shapes, random from a seed
    (no weights file is on the card)."""
    from scanerf_tpu_torch.eval import lpips

    rng = np.random.default_rng(seed)
    params, c_in = {}, 3
    for i, (c_out, k, _, _, _) in enumerate(lpips._ALEX):
        params[f"conv{i}_w"] = (rng.standard_normal((c_out, c_in, k, k)) * 0.05).astype(np.float32)
        params[f"conv{i}_b"] = (rng.standard_normal(c_out) * 0.01).astype(np.float32)
        params[f"lin{i}_w"] = np.abs(rng.standard_normal(c_out)).astype(np.float32)
        c_in = c_out
    return params


def _b7_entry(a, kw, iters: int = 5) -> dict:
    """B7 at a captured call's shape: max error against its plain version,
    ms, plain ms, and what its bound counts (as the render chunk's row)."""
    from scanerf_tpu_torch.ops.kernels import fused_render as fr
    from scanerf_tpu_torch.ops.kernels import hash_encode as hw

    stream, feats = a[0], a[2]
    out_k = fr.hash_decode_fused(*a, **kw)
    out_p = fr.hash_decode_fused_plain(*a)
    NC = stream.pts.shape[0]
    live = int((stream.meta[:, :, 2].sum(1) > 0).sum())
    visited = int(stream.visited.sum())
    b7_tc, b7_cc, _ = decoder_bounds(live * hw.CHUNK, 1, LEVELS * 8 * 6)
    return dict(chunks=NC, live_chunks=live, visited_blocks=visited,
                max_abs_err=float((out_k - out_p).abs().max()), finite=bool(torch.isfinite(out_k).all()),
                ms=timed(lambda: fr.hash_decode_fused(*a, **kw), iters),
                plain_ms=timed(lambda: fr.hash_decode_fused_plain(*a), 1),
                bytes=(stream.pts[:, 0:7].numel() * 4 + stream.meta.numel() * 4 + NC * 4
                       + NC * hw.CHUNK * 16
                       + visited * LEVELS * hw.WB * hw.W * 2 * feats.element_size()
                       + kw["slabs"].numel() * 4),
                ops_ms=max(b7_tc, b7_cc))


def _b3_entry(a, iters: int = 10) -> dict:
    """B3 at a captured call's shape: max error against its plain version
    and the largest entry, ms, plain ms, and what its bound counts (as the
    training stream's row)."""
    from scanerf_tpu_torch.ops.kernels import hash_encode as hw

    pts, meta, table, res, NW = a
    f_k = hw.lookup_fwd(*a)
    f_p = hw.lookup_fwd_plain(pts, table, res, NW)
    live = meta[:, :, 2].sum(dim=1) > 0
    visited = int(torch.unique(meta[live, 0, 0]).numel())
    real_rows = int((pts[:, 3, :] < NW).sum())
    return dict(chunks=int(pts.shape[0]), live_chunks=int(live.sum()), visited_blocks=visited,
                real_rows=real_rows, max_abs_err=float((f_k - f_p).abs().max()),
                scale=float(f_p.abs().max()), finite=bool(torch.isfinite(f_k).all()),
                ms=timed(lambda: hw.lookup_fwd(*a), iters),
                plain_ms=timed(lambda: hw.lookup_fwd_plain(pts, table, res, NW), 1),
                bytes=(pts[:, 0:4].numel() * 4 + meta.numel() * 4 + f_k.numel() * 4
                       + visited * LEVELS * hw.WB * hw.W * 2 * table.element_size()),
                ops=real_rows * LEVELS * 8 * 6)


def _max_diffs(a: dict, b: dict) -> dict:
    return {k: float(np.abs(np.asarray(a[k]) - np.asarray(b[k])).max()) for k, _ in RENDER_TOL
            if k in a and k in b}


def _check_close(what: str, a: dict, b: dict) -> dict:
    errs = _max_diffs(a, b)
    print(f"{what}: max |difference| {errs} (tol {dict(RENDER_TOL)})")
    for k, tol in RENDER_TOL:
        if k in errs and not errs[k] <= tol:
            fail(f"{what}: {k} differs by {errs[k]} > {tol}")
    return errs


def serve_phase(root: str, tr, city_evals: dict, synth_scene, synth_view) -> dict:
    """Serving the city's four exports through the port's entry points, on
    the card: the render CLI's VAL over 8 views at 128x128 (``main``, in
    process; metric.txt, then ``evaluate_dirs`` on its frames), one VAL
    view staged (``backend="xla"``) against windowed, two DEMO frames at
    720x1280 on a ``pose_paths`` path, one of them again with
    SCANERF_EARLY_TERM=1 and with ``render_image(early_term=True)``
    against the one-shot frame, and early termination on the render
    phase's scene made opaque. Launches counted over those; then B7 at an
    early-termination slab's shape, B3 at the staged encode's, the staged
    render on the card against the CPU and LPIPS on the card against the
    CPU. Returns the launches, B7's and B3's numbers."""
    from scanerf_tpu_torch.data import io as dio
    from scanerf_tpu_torch.data import png
    from scanerf_tpu_torch.eval import lpips
    from scanerf_tpu_torch.eval.evaluation import evaluate_dirs
    from scanerf_tpu_torch.ops.kernels import fused_render as fr
    from scanerf_tpu_torch.ops.kernels import fused_train as ft
    from scanerf_tpu_torch.ops.kernels import hash_encode as hw
    from scanerf_tpu_torch.ops.kernels import sampler as sp
    from scanerf_tpu_torch.render import __main__ as cli
    from scanerf_tpu_torch.render import early_term, renderer
    from scanerf_tpu_torch.utils import lie, metrics, pose_paths
    from scanerf_tpu_torch.utils import rays as rays_mod

    t_phase = time.perf_counter()
    counters = {"B1": sp.sample_fused, "B2": hw.pack, "B3": hw.lookup_fwd,
                "B4": B4Launches("exact"), "B5": ft.train_fwd, "B6": ft.train_bwd, "B7": fr.hash_decode_fused}
    for c in counters.values():
        c.launches = 0
    logdir = tr.logdir
    cfg_path = os.path.join(root, "serve.yaml")
    with open(cfg_path, "w") as f:  # JSON is YAML: read without PyYAML
        json.dump({"DATADIR": root, "INVALID_UNDERGROUND": bool(tr.cfg.INVALID_UNDERGROUND),
                   "TRAINING": {"NUM_SAMPLE": 128, "NUM_BG_SAMPLE": 128}}, f)
    os.environ.pop("SCANERF_EARLY_TERM", None)
    os.environ.pop(lpips.ENV_VAR, None)
    kw = dict(num_sample=128, num_bg_sample=128, num_march=512)

    # --- VAL through the CLI
    t0 = time.perf_counter()
    val = cli.main([cfg_path, logdir, "VAL", "0", str(SERVE_VAL_VIEWS)])
    t_val = time.perf_counter() - t0
    val_dir = os.path.join(logdir, "val")
    lines = open(os.path.join(val_dir, "metric.txt")).read().splitlines()
    print(f"serve VAL: {SERVE_VAL_VIEWS} views at {CITY_HW}x{CITY_HW} in {t_val:.2f} s "
          f"(scene load included), frames "
          + ", ".join(f"{t * 1e3:.1f}" for t in val["times"]) + " ms; metric.txt: "
          + " | ".join(lines))
    if not (len(lines) == SERVE_VAL_VIEWS + 1 and lines[-1].startswith("mean\tPSNR ")
            and len(val["psnr"]) == SERVE_VAL_VIEWS and np.isfinite(val["psnr"]).all()):
        fail(f"serve VAL: metric.txt has {len(lines)} lines (want {SERVE_VAL_VIEWS} and a mean)")
    gt_dir = os.path.join(root, "images")
    png_psnr, png_ssim = [], []
    q = 1.0 / 255.0
    for i in range(SERVE_VAL_VIEWS):
        pred = torch.from_numpy(png.read_png(os.path.join(val_dir, f"{i}.png")).astype(np.float32)
                                / 255.0)
        gt = torch.from_numpy(png.read_png(os.path.join(gt_dir, f"{i}.png")).astype(np.float32)
                              / 255.0)
        png_psnr.append(float(metrics.psnr(pred, gt)))
        png_ssim.append(float(metrics.ssim(pred, gt)))
        mse = float(((pred - gt) ** 2).mean())
        slack = 2 * q * float((pred - gt).abs().mean()) + 3 * q * q
        lo, hi = (-10 * np.log10(m) for m in (mse + slack, max(mse - slack, 1e-12)))
        line_p, line_s = (float(v.split()[1]) for v in lines[i].split("\t")[1:3])
        print(f"serve VAL view {i}: metric.txt PSNR {line_p:.4f} SSIM {line_s:.4f}; its 8-bit "
              f"frame {png_psnr[i]:.4f} / {png_ssim[i]:.4f}, truncation bounds on PSNR "
              f"[{lo:.4f}, {hi:.4f}]")
        if not (lo - 5e-5 <= line_p <= hi + 5e-5 and abs(line_s - png_ssim[i]) <= SERVE_QUANT_SSIM):
            fail(f"serve VAL view {i}: metric.txt's PSNR / SSIM disagree with its 8-bit frame")
    ev = evaluate_dirs(val_dir, gt_dir, device="cuda")
    mean_line = lines[-1].split("\t")
    mean_p, mean_s = float(mean_line[1].split()[1]), float(mean_line[2].split()[1])
    step0 = max(p for p, _ in city_evals[0].values())
    print(f"serve VAL: mean PSNR {mean_p:.4f} dB SSIM {mean_s:.4f} (step-0 eval PSNR at most "
          f"{step0:.4f}, limit +{SERVE_MIN_PSNR_RISE}); evaluate_dirs on the frames: PSNR "
          f"{ev['psnr']:.4f} SSIM {ev['ssim']:.4f} over {ev['count']}; the CPU from the same PNGs "
          f"{np.mean(png_psnr):.4f} (tol {SERVE_PSNR_TOL})")
    if not mean_p >= step0 + SERVE_MIN_PSNR_RISE:
        fail("serve VAL: the mean PSNR did not rise enough above step 0's")
    if not (ev["count"] == SERVE_VAL_VIEWS
            and abs(ev["psnr"] - float(np.mean(png_psnr))) <= SERVE_PSNR_TOL
            and abs(ev["ssim"] - float(np.mean(png_ssim))) <= SERVE_PSNR_TOL
            and abs(mean_p - float(np.mean(val["psnr"]))) <= 5e-5):
        fail("serve: evaluate_dirs disagrees with the CPU, or metric.txt's mean with its lines")

    # --- one VAL view staged against windowed
    scene = renderer.load_scene(renderer.list_tile_dirs(logdir), device="cuda")
    ks, c2ws, H, W = dio.read_campara(os.path.join(logdir, "refined_camera.log"),
                                      return_shape=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    win = renderer.render_image(scene, ks[0], c2ws[0], H, W, device="cuda", **kw)
    t_win = time.perf_counter() - t0
    with Capture(*render_targets(sp, hw, fr)) as cap_staged:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stg = renderer.render_image(scene, ks[0], c2ws[0], H, W, device="cuda", backend="xla",
                                    **kw)
        torch.cuda.synchronize()
        t_stg = time.perf_counter() - t0
    print(f"serve staged VAL view 0 ({H}x{W}): {t_stg:.2f} s, windowed {t_win:.3f} s; max "
          f"|difference| on the exports' own grids {_max_diffs(win, stg)} (no limit: the "
          f"windowed backend gates samples by the union grid, the staged one by each tile's "
          f"grid, and the tiles' grids are not aligned)")
    full = dataclasses.replace(scene, occupied=torch.ones_like(scene.occupied),
                               union_occ=torch.ones_like(scene.union_occ))
    _check_close("serve staged against windowed, VAL view 0, all-occupied grids",
                 renderer.render_image(full, ks[0], c2ws[0], H, W, device="cuda", **kw),
                 renderer.render_image(full, ks[0], c2ws[0], H, W, device="cuda",
                                       backend="xla", **kw))

    # --- DEMO: a path between two city cameras, two 720x1280 frames
    a_cam, b_cam = 0, 4
    path = pose_paths.interpolate_poses(c2ws[a_cam], c2ws[b_cam], 4)
    Hd, Wd = cli.DEMO_H, cli.DEMO_W
    kd = ks[a_cam].copy()
    kd[:2, :2] *= Wd / W  # the city camera's field of view across the wider frame
    pose_paths.write_render_path(os.path.join(root, "renderPath.log"), kd, path, Hd, Wd)
    demo_dir = os.path.join(logdir, "demo")
    demo_ms = []
    for i in (1, 2):
        d = cli.main([cfg_path, logdir, "DEMO", str(i), str(i + 1)])
        demo_ms.append(d["times"][0] * 1e3)
        print(f"serve DEMO frame {i} ({Hd}x{Wd}): {demo_ms[-1]:.1f} ms, "
              f"{Hd * Wd / d['times'][0]:.0f} rays/s")
    one_png = png.read_png(os.path.join(demo_dir, "1.png"))
    os.environ["SCANERF_EARLY_TERM"] = "1"
    try:
        d = cli.main([cfg_path, logdir, "DEMO", "1", "2"])
    finally:
        os.environ.pop("SCANERF_EARLY_TERM")
    st = d["early_stats"]
    early_png = png.read_png(os.path.join(demo_dir, "1.png"))
    step = int(np.abs(early_png.astype(int) - one_png.astype(int)).max())
    print(f"serve DEMO frame 1 with SCANERF_EARLY_TERM=1: {d['times'][0] * 1e3:.1f} ms "
          f"({Hd * Wd / d['times'][0]:.0f} rays/s); fg rows {st['fg_rows']} / {st['full_fg_rows']} "
          f"= {st['fg_rows'] / st['full_fg_rows']:.4f}, bg rows {st['bg_rows']} / "
          f"{st['full_bg_rows']} = {st['bg_rows'] / st['full_bg_rows']:.4f}; the frame's "
          f"8-bit pixels within {step} of the one-shot frame's")
    print(f"serve DEMO frame 1 early termination: {len(st['slabs'])} slabs over "
          f"{-(-Hd * Wd // cli.CHUNK)} chunks, the first (alive, batch): {st['slabs'][:12]}")
    if not (d["early_term"] and step <= 1):
        fail("serve DEMO: the early-termination frame differs from the one-shot frame")
    pose1 = path[1]
    kd_c = kd.copy()
    kd_c[0, 2], kd_c[1, 2] = Wd / 2.0, Hd / 2.0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    one = renderer.render_image(scene, kd_c, pose1, Hd, Wd, device="cuda", **kw)
    t_one = time.perf_counter() - t0
    early = renderer.render_image(scene, kd_c, pose1, Hd, Wd, device="cuda", early_term=True,
                                  **kw)
    t_early = time.perf_counter() - t0 - t_one
    _check_close(f"serve early termination against one-shot, DEMO frame 1 (render_image: "
                 f"early {t_early:.3f} s, one-shot {t_one:.3f} s)", one, early)

    # --- early termination on the render phase's scene made opaque
    dec = dict(synth_scene.decoders)
    dec["sigma"] = {"w": dec["sigma"]["w"], "b": dec["sigma"]["b"] + SERVE_SIGMA_BIAS}
    opaque = dataclasses.replace(synth_scene, decoders=dec,
                                 dec_slabs=fr.pack_decoder_slabs(dec).contiguous())
    K_s, c2w_s = synth_view
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    one = renderer.render_image(opaque, K_s, c2w_s, IMG_H, IMG_W, chunk=CHUNK, device="cuda",
                                **kw)
    t_one = time.perf_counter() - t0
    st_o = {}  # the frame as one chunk: its slabs' alive counts in order
    early = renderer.render_image(opaque, K_s, c2w_s, IMG_H, IMG_W, chunk=IMG_H * IMG_W,
                                  device="cuda", early_term=True, early_kwargs={"stats": st_o},
                                  **kw)
    t_early = time.perf_counter() - t0 - t_one
    _check_close(f"serve early termination against one-shot, opaque scene ({IMG_W}x{IMG_H}; "
                 f"render_image: early {t_early:.3f} s in one chunk, one-shot {t_one:.3f} s in "
                 f"chunks of {CHUNK})", one, early)
    alive = [c for c, _ in st_o["slabs"]]
    print(f"serve opaque scene (sigma bias +{SERVE_SIGMA_BIAS}): fg rows {st_o['fg_rows']} / "
          f"{st_o['full_fg_rows']}, bg rows {st_o['bg_rows']} / {st_o['full_bg_rows']}, slabs "
          f"{st_o['slabs']}")
    if not (st_o["fg_rows"] < st_o["full_fg_rows"] and alive[-1] < alive[0]
            and st_o["bg_rows"] < st_o["full_bg_rows"]):
        fail("serve: early termination shed no work on the opaque scene")

    got = {k: c.launches for k, c in counters.items()}
    print(f"serve launches: {json.dumps(got)}")
    for k in ("B1", "B2", "B3", "B7"):
        if got[k] <= 0:
            fail(f"kernel {k} was not launched in the serve phase")

    # --- B7 at an early-termination slab's shape: the middle chunk of DEMO frame 1
    xy = rays_mod.pixel_grid(Hd, Wd, device="cuda")
    ro, rd = rays_mod.get_center_and_ray(
        xy, lie.invert(torch.as_tensor(pose1, device="cuda")),
        torch.as_tensor(kd_c, device="cuda"))
    mid = slice((Hd * Wd - 8192) // 2, (Hd * Wd + 8192) // 2)
    st_m = {}
    with Capture(*render_targets(sp, hw, fr)) as cap_early:
        early_term.render_rays_early(scene, ro[mid], rd[mid], device="cuda", stats=st_m, **kw)
    b7 = _b7_entry(*cap_early.args["B7"])
    b7.update(rays=8192, alive=st_m["slabs"][0][0], batch=st_m["slabs"][0][1],
              rows=st_m["slabs"][0][1] * 32 * min(4, scene.n_tiles))
    print(f"B7 early-termination slab (batch {b7['batch']} of {b7['alive']} alive rays x 32 "
          f"samples x {min(4, scene.n_tiles)} tiles = {b7['rows']} rows; {b7['chunks']} chunks, "
          f"{b7['live_chunks']} live, {b7['visited_blocks']} visited blocks): max err "
          f"{b7['max_abs_err']:.3g} (tol 1e-4), {b7['ms']:.4f} ms, plain {b7['plain_ms']:.3f} ms")
    if not (b7.pop("finite") and b7["max_abs_err"] <= 1e-4):
        fail("B7 differs from its plain version at the early-termination slab's shape")

    # --- B3 at the staged encode's shape: tile 0's fg points of view 0's first chunk
    b3 = _b3_entry(cap_staged.args["B3"][0])
    print(f"B3 staged encode (tile 0's fg samples of a {min(CHUNK, H * W)}-ray chunk x "
          f"{kw['num_sample']}: "
          f"{b3['chunks']} chunks, {b3['live_chunks']} live, {b3['visited_blocks']} visited "
          f"blocks, {b3['real_rows']} real rows): max err {b3['max_abs_err']:.3g}, largest entry "
          f"{b3['scale']:.3g} (tol 1e-5 of it), {b3['ms']:.4f} ms, plain {b3['plain_ms']:.3f} ms")
    if not (b3.pop("finite") and b3["max_abs_err"] <= 1e-5 * b3.pop("scale")):
        fail("B3 differs from its plain version at the staged encode's shape")

    # --- the staged render of a few hundred rays on the card against the CPU
    xy = rays_mod.pixel_grid(H, W, device="cuda")
    ro, rd = rays_mod.get_center_and_ray(xy, lie.invert(torch.as_tensor(c2ws[0], device="cuda")),
                                         torch.as_tensor(ks[0], device="cuda"))
    sel = torch.linspace(0, H * W - 1, N_STAGED_CHECK_RAYS, device="cuda").long()
    scene_cpu = renderer.load_scene(renderer.list_tile_dirs(logdir), device="cpu")
    card = renderer.render_rays(scene, ro[sel], rd[sel], device="cuda", backend="xla", **kw)
    plain = renderer.render_rays(scene_cpu, ro[sel].cpu(), rd[sel].cpu(), device="cpu",
                                 backend="xla", **kw)
    _check_close(f"serve staged render, {N_STAGED_CHECK_RAYS} rays of VAL view 0, card against "
                 f"CPU", {k: v.cpu() for k, v in card.items()}, plain)
    del scene_cpu

    # --- LPIPS (random weights) on two 128x128 frames, card against CPU
    params = _lpips_random_params()
    img0 = png.read_png(os.path.join(val_dir, "0.png"))[..., ::-1].astype(np.float32) / 255.0
    img1 = png.read_png(os.path.join(gt_dir, "0.png"))[..., ::-1].astype(np.float32) / 255.0
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True  # LPIPS must switch TF32 off itself
    try:
        on_card = lpips.LPIPSMetric(params=params, device="cuda")(img0, img1)
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    on_cpu = lpips.LPIPSMetric(params=params, device="cpu")(img0, img1)
    rel = abs(on_card - on_cpu) / abs(on_cpu)
    print(f"serve LPIPS (random weights) of VAL frame 0 against its ground truth: card "
          f"{on_card:.8f}, CPU {on_cpu:.8f}, relative {rel:.3g} (tol {SERVE_LPIPS_RTOL})")
    if not (np.isfinite(on_card) and rel <= SERVE_LPIPS_RTOL):
        fail("serve: LPIPS on the card differs from the CPU")
    print(f"phase serve: {time.perf_counter() - t_phase:.1f} s")
    return {"launches": got, "b7_early_slab": b7, "b3_staged": b3,
            "val_psnr": mean_p, "demo_ms": demo_ms}


# ---------------------------------------------------------------------------
# extras: normals, B4's dL/du-only and bf16 modes, the training knobs and
# build_tiles (slice 10)
# ---------------------------------------------------------------------------

EXTRAS_RAYS, EXTRAS_SAMPLES, EXTRAS_MARCH = 512, 128, 512
EXTRAS_KNOB_ARMS = {"dense": {}, "hash_bwd_bf16": dict(hash_bwd_bf16=True),
                    "sparse_adam": dict(sparse_adam=True)}
EXTRAS_WARM, EXTRAS_TIMED = 2, 3
EXTRAS_STOCH_LOG2_H, EXTRAS_STOCH_STEPS, EXTRAS_STOCH_POINTS = 12, 3, 65536
EXTRAS_ALLOCATION = {"TILE_SIZE": [2.0, 2.0, 2.0], "OVERLAP_RATIO": 0.2,
                     "OFFSET": [0.0, 0.0, 0.0], "EXPECT_NUM": 4, "MIN_NUM_IMAGE": 10,
                     "MAX_DIM_TILE": [4, 1, 4], "SCENE_TYPE": "outdoor"}
# Limits of the extras phase:
# - the normals of the card against the CPU's (both [0, 1]): the same
#   samples (B1 equals its plain version bit for bit) and points; the
#   features (B3) and dL/du (B4's dL/du mode against autograd through the
#   plain gather) sum in other orders, ~1e-6 relative each, and a normal
#   is its gradient normalised;
EXTRAS_NORMAL_TOL = 1e-4
# - B4's modes against their plain versions: dL/du within 1e-4 of its
#   largest entry (check_parts, as B4 is held); the bf16 mode's table
#   gradient, level by level, within 5e-6 of the level's largest entry.
#   Kernel and plain version round the same products w * g to bf16 and
#   differ only in the order of the f32 sums: the worst level read
#   2.37e-7 to 4.44e-7 of its largest entry in B4 and B6 on an H100
#   (exact B4's sums, unrounded, up to 1.74e-6), while exact B4, which
#   skips the rounding, sits 1.01e-4 to 1.08e-4 of the largest entry from
#   the bf16 result: the limit is 11 times the worst reading and a 20th
#   of what a kernel without the rounding gives. The same limit holds
#   B6's bf16 table gradient against the plain bf16 scatter of B6a's own
#   cotangent: against train_bwd_plain's cotangent, which differs by
#   ulps, a product near a bf16 rounding boundary rounds the other way,
#   off by one bf16 step (2^-8 of it; 8.8e-4 to 1.05e-3 of a level);
EXTRAS_BF16_TABLE_TOL = 5e-6
# - bf16 against exact B4 within 2% of the largest entry (the JAX
#   package's own bound for its bf16 backward, tests/test_pallas_hash.py:
#   120-150) and at least 1e-5 of it, above the noise of exact B4's
#   atomics (against its plain version at most 1.74e-6 of a level's
#   largest entry on an H100);
EXTRAS_BF16_VS_EXACT, EXTRAS_BF16_MIN_VS_EXACT = 0.02, 1e-5
# - one SparseAdam update on the card against the same update on the CPU:
#   counts equal, params and moments within 1e-6 of each array's largest
#   entry (the same elementwise f32 operations; pow and sqrt may round
#   apart by an ulp);
EXTRAS_SPARSE_RTOL = 1e-6
# - the stochastic-corner backward on the card against the CPU's on the
#   same points: the same corners (a hash of the points' bits), the table
#   gradient's index_add_ in another order on the card: within 1e-5 of each
#   gradient's largest entry.
EXTRAS_STOCH_RTOL = 1e-5


def _max_rel(a, b) -> float:
    """max |a - b| over b's largest entry (a, b on any devices)."""
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _normals_check(tile_ctx, counters):
    """``render_normals`` of the tile phase's trained tile on the card:
    counted, timed, its device-memory rise, and against the CPU."""
    from scanerf_tpu_torch.models import field
    from scanerf_tpu_torch.train import cameras
    from scanerf_tpu_torch.utils import rays as rays_mod

    state, cams, view = tile_ctx["state"], tile_ctx["cams"], tile_ctx["eval_view"]
    H, W = tile_ctx["H"], tile_ctx["W"]
    xy = rays_mod.pixel_grid(H, W, device="cuda")
    pose = cameras.get_rts(cams, state.params.se3_refine)[view]
    ro, rd = rays_mod.get_center_and_ray(xy, pose, cams.ks[view])
    sel = torch.linspace(0, H * W - 1, EXTRAS_RAYS, device="cuda").long()
    ro, rd = ro[sel].contiguous(), rd[sel].contiguous()
    step = torch.tensor(float(state.step), device="cuda")
    fs = state.field_state
    backend = field.effective_backend("windowed", tile_ctx["table_rows"])

    def call(params, fstate, o, d, s):
        return field.render_normals(params, fstate, o, d, EXTRAS_SAMPLES, s,
                                    num_march=EXTRAS_MARCH, backend=backend)

    call(state.params.field, fs, ro, rd, step)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    card = call(state.params.field, fs, ro, rd, step)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = {k: c.launches for k, c in counters.items()}
    rise = torch.cuda.max_memory_allocated() - base
    table_bytes = state.params.field.features.numel() * 4
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call(state.params.field, fs, ro, rd, step)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    cpu = call(to_device(state.params.field, "cpu"), to_device(fs, "cpu"), ro.cpu(), rd.cpu(),
               step.cpu())
    err = float((card.cpu() - cpu).abs().max())
    print(f"extras normals: {EXTRAS_RAYS} rays of view {view} at {EXTRAS_SAMPLES} samples "
          f"(M {EXTRAS_MARCH}), {backend} tables at H = 2^{int(np.log2(tile_ctx['table_rows']))}"
          f", step {state.step}: counted call {wall * 1e3:.1f} ms, then "
          + ", ".join(f"{w * 1e3:.1f}" for w in walls) + " ms; launches "
          + json.dumps(got))
    print(f"extras normals: device memory rise {rise / 2**20:.1f} MiB during the call (one "
          f"table's gradient would be {table_bytes / 2**20:.1f} MiB); card against CPU max "
          f"|diff| {err:.3g} (tol {EXTRAS_NORMAL_TOL}); range [{float(card.min()):.4f}, "
          f"{float(card.max()):.4f}], std {float(card.std()):.4f}")
    if card.shape != (EXTRAS_RAYS, 3) or not torch.isfinite(card).all():
        fail("extras: render_normals gave the wrong shape or non-finite values")
    if not (float(card.min()) >= 0.0 and float(card.max()) <= 1.0 and float(card.std()) > 0):
        fail("extras: the normals are not in [0, 1] or are constant")
    if not err <= EXTRAS_NORMAL_TOL:
        fail(f"extras: the card's normals differ from the CPU's by {err}")
    if not rise < table_bytes:
        fail(f"extras: render_normals raised device memory by {rise} bytes, not below one "
             f"table gradient's {table_bytes}: the tables' gradient was built")
    for k, n in got.items():
        if n <= 0:
            fail(f"kernel {k} was not launched by render_normals")
    return got, {"ms": 1e3 * sum(walls) / len(walls), "err": err, "rise": rise}


def _knob_arms(counters):
    """bench.py's full-recipe fused step with each knob (dense exact Adam,
    HASH_BWD_BF16, SPARSE_ADAM): 2 warm-up and 3 counted, timed steps; one
    SparseAdam update on the card held against the CPU; B6 with B4's bf16
    mode held against its plain version. Returns the launches, each arm's
    rays/s and the dense arm's state, data and tc."""
    from scanerf_tpu_torch.train import tile
    from scanerf_tpu_torch.train.sparse_adam import SparseAdam

    launches = dict.fromkeys(counters, 0)
    rates, keep = {}, None
    for arm, kw in EXTRAS_KNOB_ARMS.items():
        tc = tile.TrainConfig(**TRAIN_KW, **ARMS["full_recipe"], **kw)
        state, data = train_setup(tc)
        gen = torch.Generator().manual_seed(1)
        rays_per_step = (2**tc.batch_log2 // TRAIN_CAMS) // 4 * 4 * TRAIN_CAMS
        for _ in range(EXTRAS_WARM):
            state, aux = tile.train_step(state, data, tc, gen, device="cuda")
        for c in counters.values():
            c.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(EXTRAS_TIMED):
            state, aux = tile.train_step(state, data, tc, gen, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        for k, c in counters.items():
            launches[k] += c.launches
        rates[arm] = rays_per_step * EXTRAS_TIMED / wall
        if not all(bool(torch.isfinite(v).all()) for v in aux.values()):
            fail(f"extras: non-finite loss in the {arm} steps")
        print(f"extras train {arm}: {EXTRAS_TIMED} steps of {rays_per_step} rays, "
              f"{rates[arm]:.0f} training rays/s (dense exact arm "
              f"{rates.get('dense', rates[arm]):.0f}); total loss {float(aux['total_loss']):.5g}")
        if arm == "hash_bwd_bf16":
            _b6_bf16_check(state, data, tc, gen)
        if arm == "sparse_adam":
            (_, _), grads = tile.compute_grads(state, data, tc, gen)
            opt = state.hash_optimizer
            p = state.params.field.features
            g = grads["hash"][0]
            lr = tile._schedules(tc)["hash"](opt.param_groups[0]["count"])
            ref_p = p.detach().cpu().clone()
            ref = SparseAdam([ref_p], lr=lr, betas=opt.param_groups[0]["betas"],
                             eps=opt.param_groups[0]["eps"])
            ref.state[ref_p] = {k: v.cpu().clone() for k, v in opt.state[p].items()}
            ref_p.grad = g.cpu()
            ref.step()
            tile.apply_gradients(state, grads, tc)
            st, rst = opt.state[p], ref.state[ref_p]
            same = torch.equal(st["count"].cpu(), rst["count"])
            errs = {k: _max_rel(a, b) for k, a, b in (("params", p, ref_p),
                                                         ("mu", st["mu"], rst["mu"]),
                                                         ("nu", st["nu"], rst["nu"]))}
            active = float((g != 0).float().mean())
            print(f"extras sparse Adam: one update on the card against the CPU: counts equal "
                  f"{same} (entries stepped {active:.4f} of the table), worst relative "
                  + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
                  + f" (tol {EXTRAS_SPARSE_RTOL})")
            if not (same and max(errs.values()) <= EXTRAS_SPARSE_RTOL and 0 < active < 1):
                fail("extras: SparseAdam on the card differs from the CPU's update")
        if arm == "dense":
            keep = (state, data, tc, gen)
        else:
            del state, data
    torch.cuda.empty_cache()
    return launches, rates, keep


def _b4_modes(state, data, tc, gen, du_launches, bf16_launches):
    """B4's dL/du-only and bf16 modes on a full-recipe step's stream, with
    the feature cotangent B6a gives with every BARF level on: each against
    its plain version on the middle chunks, bf16 against exact B4, then
    both timed on the whole stream. Returns the two entries of B4's row."""
    from scanerf_tpu_torch.models import field
    from scanerf_tpu_torch.ops.kernels import fused_train as ft
    from scanerf_tpu_torch.ops.kernels import hash_encode as hw
    from scanerf_tpu_torch.train import tile

    with Capture((ft, "train_bwd", "B6")) as cap:
        tile.compute_grads(state, data, tc, gen)
    # detached: the stream's positions and the table are the step's tracked tensors
    pts, meta, table, res, _, feats, g, NW = (
        a.detach() if isinstance(a, torch.Tensor) else a for a in cap.args["B6"][0][:8])
    del cap
    pslab_all = ft.pack_train_slab(state.params.field.decoder,
                                   field.weight_feature(torch.tensor(20000.0, device="cuda")))
    gf = _chunk_cotangent(ft.decoder_bwd(pts, meta, pslab_all, feats, g)[0], meta)
    NC = pts.shape[0]
    c0 = max(0, NC // 2 - N_SUB_CHUNKS // 2)
    c1 = min(NC, c0 + N_SUB_CHUNKS)
    sub = (pts[c0:c1].contiguous(), meta[c0:c1].contiguous())
    gs = gf[c0 * hw.CHUNK:c1 * hw.CHUNK].contiguous()
    exact_k = hw.lookup_bwd(*sub, table, res, gs, NW)
    entries, errs = {}, {}
    for mode in ("du", "bf16"):
        dpts_k, dtab_k = hw.lookup_bwd(*sub, table, res, gs, NW, mode=mode)
        dpts_p, dtab_p = hw.lookup_bwd_plain(sub[0], table, res, gs, NW, mode=mode)
        if dpts_k[:, 3:].count_nonzero() or dpts_p[:, 3:].count_nonzero():
            fail(f"B4 ({mode}) dpts rows 3-7 are not zero")
        errs[mode] = max(check_parts(f"B4 ({mode})", [("dpts u", dpts_k[:, 0:3],
                                                       dpts_p[:, 0:3])], True))
        if mode == "du":
            if dtab_k is not None or dtab_p is not None:
                fail("B4 (du) returned a table gradient")
            same = torch.equal(dpts_k, exact_k[0])
            print(f"B4 (du) dL/du equals exact B4's bit for bit: {same}")
        else:
            errs[mode] = max(errs[mode], *check_parts(
                "B4 (bf16)", [(f"d_tables level {lv}", dtab_k[lv], dtab_p[lv])
                              for lv in range(LEVELS)], True, tol=EXTRAS_BF16_TABLE_TOL))
            e_exact = float((dtab_k - exact_k[1]).abs().max())
            scale = float(exact_k[1].abs().max())
            print(f"B4 (bf16) against exact B4: table gradient max |diff| {e_exact:.3g}, "
                  f"{e_exact / scale:.3g} of its largest entry {scale:.3g} (from "
                  f"{EXTRAS_BF16_MIN_VS_EXACT:g} to {EXTRAS_BF16_VS_EXACT:g} of it); dL/du "
                  f"equal bit for bit: {torch.equal(dpts_k, exact_k[0])}")
            if not (EXTRAS_BF16_MIN_VS_EXACT * scale <= e_exact <= EXTRAS_BF16_VS_EXACT * scale):
                fail("B4 (bf16) is not within 2% of exact B4, or too close to it to have "
                     "rounded")
        del dpts_k, dtab_k, dpts_p, dtab_p
    del exact_k
    torch.cuda.empty_cache()
    real_rows = int((pts[:, 3, :] < NW).sum())
    visited = int(torch.unique(meta[meta[:, :, 2].sum(dim=1) > 0, 0, 0]).numel())
    tab_bytes = visited * LEVELS * hw.WB * hw.W * 2 * 4
    # as B4's exact bound (lookup_kernels): pts rows 0-3, meta, the
    # cotangent and the visited table blocks read, dpts written; the bf16
    # mode also writes the dense table gradient, the dL/du mode none
    common = pts[:, 0:4].numel() * 4 + pts.numel() * 4 + meta.numel() * 4 + gf.numel() * 4 \
        + tab_bytes
    for mode, n, extra, ops in (("du", du_launches, 0, 9),
                                ("bf16", bf16_launches, table.numel() * 4, 16)):
        entries[mode] = dict(
            launches=n, max_abs_err=errs[mode],
            ms=timed(lambda: hw.lookup_bwd(pts, meta, table, res, gf, NW, mode=mode), 5),
            plain_ms=timed(lambda: hw.lookup_bwd_plain(pts, table, res, gf, NW, mode=mode), 1),
            bytes=common + extra, ops=real_rows * LEVELS * 8 * ops, library_ms=None,
            chunks=NC, real_rows=real_rows)
    exact_ms = timed(lambda: hw.lookup_bwd(pts, meta, table, res, gf, NW), 5)
    print(f"B4 modes on the whole stream ({NC} chunks, {real_rows} real rows, {visited} visited "
          f"blocks): exact {exact_ms:.4f} ms, du {entries['du']['ms']:.4f} ms (plain "
          f"{entries['du']['plain_ms']:.1f}), bf16 {entries['bf16']['ms']:.4f} ms (plain "
          f"{entries['bf16']['plain_ms']:.1f})")
    return {"du_only": entries["du"], "bf16": entries["bf16"]}


def _chunk_cotangent(d_feats, meta):
    """B6a's features' cotangent [NC, L*2, CHUNK] as B4's rows [Np, L*2],
    zero on dead chunks (B6a writes only live ones)."""
    live = (meta[:, :, 2].sum(dim=1) > 0)[:, None, None]
    return torch.where(live, d_feats, torch.zeros_like(d_feats)).permute(0, 2, 1) \
        .reshape(-1, d_feats.shape[1]).contiguous()


def _b6_bf16_check(state, data, tc, gen):
    """B6 as HASH_BWD_BF16 runs it (B6a, then B4's bf16 mode on the
    chunk-major cotangent, rows 3-7 left to B6a) on one step's stream,
    the middle chunks, every BARF level on: dL/du, dL/d dirs and the
    slab's gradient against ``train_bwd_plain(bwd_bf16=True)`` at B6's
    1e-4; the table gradient, level by level, against the plain bf16
    scatter of B6a's own cotangent at EXTRAS_BF16_TABLE_TOL."""
    from scanerf_tpu_torch.models import field
    from scanerf_tpu_torch.ops.kernels import fused_train as ft
    from scanerf_tpu_torch.ops.kernels import hash_encode as hw
    from scanerf_tpu_torch.train import tile

    with Capture((ft, "train_bwd", "B6")) as cap:
        tile.compute_grads(state, data, tc, gen)
    args, kw = cap.args["B6"]
    if not kw.get("bwd_bf16"):
        fail("extras: the HASH_BWD_BF16 step did not ask B6 for its bf16 mode")
    pts, meta, table, res, _, feats, g, NW = (
        a.detach() if isinstance(a, torch.Tensor) else a for a in args[:8])
    del cap, args
    slab = ft.pack_train_slab(state.params.field.decoder,
                              field.weight_feature(torch.tensor(20000.0, device="cuda")))
    NC = pts.shape[0]
    c0 = max(0, NC // 2 - N_SUB_CHUNKS // 2)
    c1 = min(NC, c0 + N_SUB_CHUNKS)
    sub = (pts[c0:c1].contiguous(), meta[c0:c1].contiguous())
    fs, gs = feats[c0:c1].contiguous(), g[c0 * hw.CHUNK:c1 * hw.CHUNK].contiguous()
    del pts, meta, feats, g
    dpts_k, dtab_k, dslab_k = ft.train_bwd(*sub, table, res, slab, fs, gs, NW, bwd_bf16=True)
    dpts_p, dtab_p, dslab_p = ft.train_bwd_plain(*sub, table, res, slab, fs, gs, NW,
                                                 bwd_bf16=True)
    if dpts_k[:, 3::4].count_nonzero() or dpts_p[:, 3::4].count_nonzero():
        fail("B6 (bf16) dpts rows 3 and 7 are not zero")
    check_parts("B6 (bf16)", [("dpts u", dpts_k[:, 0:3], dpts_p[:, 0:3]),
                              ("dpts dirs", dpts_k[:, 4:7], dpts_p[:, 4:7]),
                              ("d_slab", dslab_k, dslab_p)], True)
    gf = _chunk_cotangent(ft.decoder_bwd(*sub, slab, fs, gs)[0], sub[1])
    dtab_q = hw.lookup_bwd_plain(sub[0], table, res, gf, NW, mode="bf16")[1]
    check_parts("B6 (bf16) table gradient on B6a's cotangent",
                [(f"d_tables level {lv}", dtab_k[lv], dtab_q[lv]) for lv in range(LEVELS)],
                True, tol=EXTRAS_BF16_TABLE_TOL)
    flips = max(float((dtab_k[lv] - dtab_p[lv]).abs().max() / dtab_p[lv].abs().max())
                for lv in range(LEVELS))
    print(f"B6 (bf16) table gradient against train_bwd_plain's, whose cotangent differs by "
          f"ulps (not held: roundings flip): worst level {flips:.3g} of its largest entry")
    del dpts_k, dtab_k, dslab_k, dpts_p, dtab_p, dslab_p, gf, dtab_q
    torch.cuda.empty_cache()


def _stochastic_check():
    """A global-hash tile (H = 2^12, the xla backend) trained a few steps at
    bench.py's width with STOCHASTIC_HASH_GRAD; one backward of
    ``hash_encode_stoch`` on identical points, the card against the CPU."""
    from scanerf_tpu_torch.ops import hash_encode as he
    from scanerf_tpu_torch.train import tile

    tc = tile.TrainConfig(**TRAIN_KW, **ARMS["rgb_only"], hash_backend="xla",
                          stochastic_hash_grad=True)
    state, data = train_setup(tc, log2_h=EXTRAS_STOCH_LOG2_H)
    gen = torch.Generator().manual_seed(1)
    before = state.params.field.features.clone()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(EXTRAS_STOCH_STEPS):
        state, aux = tile.train_step(state, data, tc, gen, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rays = (2**tc.batch_log2 // TRAIN_CAMS) // 4 * 4 * TRAIN_CAMS * EXTRAS_STOCH_STEPS
    if not (all(bool(torch.isfinite(v).all()) for v in aux.values())
            and not torch.equal(before, state.params.field.features)):
        fail("extras: the stochastic-gradient steps are not finite or did not move the table")
    print(f"extras stochastic corners: {EXTRAS_STOCH_STEPS} rgb-only steps of a global-hash "
          f"tile at H = 2^{EXTRAS_STOCH_LOG2_H}: {rays / wall:.0f} training rays/s, total loss "
          f"{float(aux['total_loss']):.5g}")
    rng = np.random.default_rng(7)
    x = rng.uniform(-1.9, 1.9, (EXTRAS_STOCH_POINTS, 3)).astype(np.float32)
    cot = rng.standard_normal((EXTRAS_STOCH_POINTS, 2 * LEVELS)).astype(np.float32)
    grads = {}
    for dev in ("cuda", "cpu"):
        p = torch.tensor(x, device=dev, requires_grad=True)
        t = state.params.field.features.detach().to(dev).clone().requires_grad_()
        out = he.hash_encode_stoch(p, t, state.field_state.resolutions.to(dev))
        (out * torch.tensor(cot, device=dev)).sum().backward()
        grads[dev] = (out.detach(), p.grad, t.grad)
    errs = [_max_rel(a, b) for a, b in zip(grads["cuda"], grads["cpu"])]
    print(f"extras stochastic corners, {EXTRAS_STOCH_POINTS} points, card against CPU: "
          f"features {errs[0]:.3g}, dL/dpoints {errs[1]:.3g}, table gradient {errs[2]:.3g} of "
          f"each one's largest entry (tol {EXTRAS_STOCH_RTOL})")
    if not max(errs) <= EXTRAS_STOCH_RTOL:
        fail("extras: the stochastic-corner backward on the card differs from the CPU's")


def _build_tiles_check(scene_dir: str):
    """``build_tiles`` on two copies of the city's scene directory, once on
    the card and once on the CPU: the same three files."""
    from scanerf_tpu_torch.config import default_config
    from scanerf_tpu_torch.preprocess.build_tiles import build_tiles

    out, files = {}, {}
    for dev in ("cuda", "cpu"):
        root = f"{scene_dir}-{dev}"
        shutil.copytree(scene_dir, root)
        cfg = default_config().deep_update({"DATADIR": root, "ALLOCATION": EXTRAS_ALLOCATION})
        t0 = time.perf_counter()
        out[dev] = build_tiles(cfg, device=dev)
        secs = time.perf_counter() - t0
        files[dev] = {}
        for name in ("tile_info.txt", "training_views.txt", "tiles.obj"):
            with open(os.path.join(root, "tiles", name), "rb") as f:
                files[dev][name] = f.read()
        print(f"extras build_tiles ({dev}): {secs:.2f} s, {len(out[dev]['tiles'])} tiles, views "
              + json.dumps({k: len(v) for k, v in out[dev]["views"].items()}))
    if files["cuda"] != files["cpu"] or not out["cuda"]["tiles"]:
        fail("extras: build_tiles on the card wrote other files than on the CPU, or no tile")
    print("extras build_tiles: tile_info.txt, training_views.txt and tiles.obj identical on "
          "the card and on the CPU")


def extras_phase(tile_ctx: dict, scene_dir: str) -> dict:
    """Slice 10 on the card: ``render_normals`` of the tile phase's trained
    tile (B1, B2, B3 and B4's dL/du mode); bench.py's fused full-recipe
    step dense, with HASH_BWD_BF16 (B6 with B4's bf16 mode) and with
    SPARSE_ADAM; B4's two new modes against their plain versions and
    timed; the stochastic-corner gradient on a global-hash tile; and
    ``build_tiles`` on the city's scene directory on the card and on the
    CPU. Returns the phase's launches and B4's two new entries."""
    from scanerf_tpu_torch.ops.kernels import fused_train as ft
    from scanerf_tpu_torch.ops.kernels import hash_encode as hw
    from scanerf_tpu_torch.ops.kernels import sampler as sp

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    got, normals = _normals_check(tile_ctx, {"B1": sp.sample_fused, "B2": hw.pack,
                                             "B3": hw.lookup_fwd, "B4_du": B4Launches("du")})
    del tile_ctx["state"]
    # B4's exact mode runs inside B6 in the dense and SPARSE_ADAM steps
    step_counters = {"B1": sp.sample_fused, "B2": hw.pack, "B4": B4Launches("exact"),
                     "B5": ft.train_fwd, "B6": ft.train_bwd, "B4_bf16": B4Launches("bf16")}
    step_got, rates, (state, data, tc, gen) = _knob_arms(step_counters)
    for k, n in step_got.items():
        got[k] = got.get(k, 0) + n
    print("extras launches: " + json.dumps(got))
    for k in ("B1", "B2", "B3", "B4", "B4_du", "B5", "B6", "B4_bf16"):
        if got.get(k, 0) <= 0:
            fail(f"kernel {k} was not launched in the extras phase")
    b4 = _b4_modes(state, data, tc, gen, got["B4_du"], got["B4_bf16"])
    del state, data
    torch.cuda.empty_cache()
    _stochastic_check()
    torch.cuda.empty_cache()
    _build_tiles_check(scene_dir)
    print(f"phase extras: {time.perf_counter() - t_phase:.1f} s")
    return {"launches": got, "b4": b4, "normals": normals, "rates": rates}


# ---------------------------------------------------------------------------
# multi: the multi-device paths on ranks that share the card (slice 11)
# ---------------------------------------------------------------------------

# Two ranks, both on cuda:0, over gloo (NCCL refuses two ranks on one
# device; gloo takes CUDA tensors and stages them through the host). The
# phase proves that the sharded kernels and the collectives compute the
# right thing at full width; it measures no scaling across cards.
MULTI_WORLD = 2
MULTI_LOG2_H = 24  # config/paper_2p24_2chip.yaml's table, TABLE_SHARDS 2
MULTI_TIMED = 3  # timed table-sharded steps after one warm-up
MULTI_CITY_STEPS = 5  # steps of each tile in the tiles mesh's round
MULTI_TIMEOUT_S = 600
MULTI_KIND = dict(SERVE_KIND, B5="fused_train_fwd", B6="fused_train_bwd")
# Limits of the multi phase:
# - (a) the table-sharded step against the unsharded step on the same
#   batch and card: the train phase's fused-against-unfused limits
#   (FVU_LOSS_RTOL, FVU_GRAD_RTOL); both decode unfused, so only the
#   atomics' order and the two ranks' partial dL/du sums differ; each
#   rank's table-gradient shard against its slice of the whole gradient
#   at FVU_GRAD_RTOL["hash"] (relative L2);
# - B3 / B4 on the shard against their plain versions: B3 1e-5 of the
#   largest entry, B4 each part 1e-4 (the bf16 table gradient
#   EXTRAS_BF16_TABLE_TOL a level), as the train and extras phases hold
#   them; rows of other ranks' chunks exactly 0;
# - (b) the ray-DP step's averaged gradients against the mean of the two
#   replicas' gradients, each computed alone: FVU_GRAD_RTOL (B6's atomics
#   add in another order in each run), the aux within FVU_LOSS_RTOL; the
#   replicas' params after the step equal bit for bit;
# - (c) the round's consensus over ranks against one process's
#   consensus_update over the same four tiles: CITY_CONSENSUS_TOL;
# - (d) the sharded frame against the one-rank frame: RENDER_TOL.


def _multi_counters():
    from scanerf_tpu_torch.ops.kernels import fused_render as fr
    from scanerf_tpu_torch.ops.kernels import fused_train as ft
    from scanerf_tpu_torch.ops.kernels import hash_encode as hw
    from scanerf_tpu_torch.ops.kernels import sampler as sp

    class B4All:  # every launch of B4's kernel, whatever its mode
        @property
        def launches(self):
            return sum(hw.scatter_bwd.launches.values())

        @launches.setter
        def launches(self, n):
            for m in hw.scatter_bwd.launches:
                hw.scatter_bwd.launches[m] = n

    return {"B1": sp.sample_fused, "B2": hw.pack, "B3": hw.lookup_fwd, "B4": B4All(),
            "B5": ft.train_fwd, "B6": ft.train_bwd, "B7": fr.hash_decode_fused}


class _Counted:
    """Each kernel's launches while the block runs (the counts set to 0 on
    entry, read on exit), added into ``total``."""

    def __init__(self, counters, total):
        self.counters, self.total, self.got = counters, total, {}

    def __enter__(self):
        for c in self.counters.values():
            c.launches = 0
        return self

    def __exit__(self, *exc):
        self.got = {k: c.launches for k, c in self.counters.items()}
        for k, n in self.got.items():
            self.total[k] = self.total.get(k, 0) + n


def _multi_rank(rank, world, port, tmp, render_dirs, city_root):
    """One rank of the multi phase: (a)-(d), its results pickled to
    ``tmp``. Every failed check ends the rank (and so the phase)."""
    import pickle

    sys.path.insert(0, HERE)
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from scanerf_tpu_torch.parallel import mesh as mesh_lib

    mesh_lib.init_ranks("gloo", rank, world, f"tcp://127.0.0.1:{port}")
    counters, total = _multi_counters(), {}
    out = {"rank": rank}
    t = time.perf_counter()
    out["a"] = _multi_table(rank, world, counters, total)
    out["a_s"] = time.perf_counter() - t
    torch.cuda.empty_cache()
    t = time.perf_counter()
    out["b"] = _multi_dp(rank, world, counters, total)
    out["b_s"] = time.perf_counter() - t
    torch.cuda.empty_cache()
    t = time.perf_counter()
    out["c"] = _multi_tiles(rank, world, counters, total, city_root)
    out["c_s"] = time.perf_counter() - t
    torch.cuda.empty_cache()
    t = time.perf_counter()
    out["d"] = _multi_render(rank, world, counters, total, render_dirs)
    out["d_s"] = time.perf_counter() - t
    out["launches"] = total
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    with open(os.path.join(tmp, f"multi{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    torch.distributed.destroy_process_group()


def _collective_clock(mesh_lib):
    """Wrap ``mesh_lib.all_reduce`` so that it adds its seconds (the stream
    synchronised before and after, waits for the peer included) to the
    returned list's first entry."""
    spent = [0.0]
    orig = mesh_lib.all_reduce

    def clocked(t, axis, op="sum"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = orig(t, axis, op)
        torch.cuda.synchronize()
        spent[0] += time.perf_counter() - t0
        return r

    mesh_lib.all_reduce = clocked
    return spent, orig


def _multi_table(rank, world, counters, total):
    """(a) One tile's table sharded over the ranks at
    config/paper_2p24_2chip.yaml's operating point (bench.py's sphere scene,
    H = 2^24, 2^14 rays, 128 + 128 samples, M 512, the full recipe, the
    windowed backend; the sharded lookup decodes unfused): the first step
    against the unsharded step on the same batch, then one warm-up and
    MULTI_TIMED timed steps, then B3 and B4 on this rank's localized
    stream against their plain versions, and their times."""
    from scanerf_tpu_torch.parallel import mesh as mesh_lib
    from scanerf_tpu_torch.parallel import table_parallel
    from scanerf_tpu_torch.ops.kernels import hash_encode as hw
    from scanerf_tpu_torch.train import tile

    # every loss weighs in the comparison, as in the train phase's
    # fused_vs_unfused: alpha / gamma 0.02 / 1.0, mono normals that pass the
    # smooth loss's test, ADMM variables with overlapping cameras
    tc1 = tile.TrainConfig(**TRAIN_KW, **dict(ARMS["full_recipe"], alpha=0.02, gamma=1.0),
                           fused_decoder=False)
    tc2 = dataclasses.replace(tc1, table_shards=world)
    axis = mesh_lib.make_mesh({"table": world}).axis("table")
    state, data = train_setup(tc1, log2_h=MULTI_LOG2_H)
    rng = np.random.default_rng(13)

    def small(*shape):
        return torch.tensor(rng.standard_normal(shape) * 0.01, dtype=torch.float32,
                            device="cuda")

    normals = np.float32([0.1, 1.0, 0.2]) + rng.standard_normal(
        (TRAIN_CAMS, TRAIN_HW, TRAIN_HW, 3)).astype(np.float32) * 0.02
    data = dataclasses.replace(data, mono_normals=torch.tensor(normals, device="cuda"))
    state.admm = tile.AdmmState(
        shared_se3=small(TRAIN_CAMS, 6), delta_se3=small(TRAIN_CAMS, 6),
        overlap_flags=torch.arange(TRAIN_CAMS, device="cuda") % 4 != 1, rho=state.admm.rho)
    rays_per_step = (2**tc1.batch_log2 // TRAIN_CAMS) // 4 * 4 * TRAIN_CAMS
    ray_idx, locs = tile.sample_patches(torch.Generator().manual_seed(5), TRAIN_HW, TRAIN_HW,
                                        2**tc1.batch_log2 // TRAIN_CAMS // 4, device="cuda")
    pix = locs[None].expand(TRAIN_CAMS, *locs.shape)
    # the unsharded step's gradients, this rank's slice of the table's kept
    (_, a_ref), g_ref = tile.compute_grads(state, data, tc1, ray_idx=ray_idx, pixel_locs=pix)
    ref_hash = table_parallel.shard_features(g_ref["hash"][0], axis).clone()
    g_ref["hash"] = None
    torch.cuda.empty_cache()
    state = table_parallel.shard_state(state, axis)
    torch.cuda.empty_cache()
    with Capture((hw, "lookup_fwd", "B3"), (hw, "lookup_bwd", "B4")) as cap:
        (_, a_sh), g_sh = tile.compute_grads(state, data, tc2, ray_idx=ray_idx, pixel_locs=pix,
                                             table_axis=axis)
    res = {"losses": {}, "grads": {}}
    for k in ("total_loss", "rgb_loss", "depth_loss", "smooth_loss", "warp_loss", "admm_loss"):
        a, b = float(a_sh[k]), float(a_ref[k])
        tol = FVU_LOSS_RTOL.get(k, FVU_LOSS_RTOL["*"]) * abs(b)
        res["losses"][k] = (a, b)
        if not b > 1e-4:
            fail(f"multi (a): the check's {k} is {b:.3g}, not above 1e-4: it carries no weight")
        if not (np.isfinite(a) and abs(a - b) <= tol):
            fail(f"multi (a) rank {rank}: the table-sharded step's {k} {a} differs from the "
                 f"unsharded step's {b} (tol {tol:.3g})")
    pairs = {"hash": [(ref_hash, g_sh["hash"][0])],
             "decoder": list(zip(g_ref["decoder"], g_sh["decoder"])),
             "cam": list(zip(g_ref["cam"], g_sh["cam"]))}
    for name, ps in pairs.items():
        worst = max(rel_l2(r, g) for r, g in ps if r.abs().max() > 0)
        res["grads"][name] = worst
        if not worst <= FVU_GRAD_RTOL[name]:
            fail(f"multi (a) rank {rank}: the table-sharded step's {name} gradient differs "
                 f"from the unsharded step's: relative L2 {worst:.3g}")
    if not ref_hash.abs().max() > 0:
        fail(f"multi (a) rank {rank}: the unsharded table gradient's slice is zero")
    del g_ref, g_sh, ref_hash
    torch.cuda.empty_cache()

    # --- the counted main path: a warm-up and MULTI_TIMED timed steps
    gen = tile.batch_generator(1)
    tile.train_step(state, data, tc2, gen, device="cuda", table_axis=axis)
    spent, orig = _collective_clock(mesh_lib)
    try:
        with _Counted(counters, total) as counted:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(MULTI_TIMED):
                _, aux = tile.train_step(state, data, tc2, gen, device="cuda", table_axis=axis)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        mesh_lib.all_reduce = orig
    res.update(step_s=wall / MULTI_TIMED, collective_s=spent[0] / MULTI_TIMED,
               rays_per_s=rays_per_step * MULTI_TIMED / wall, launches=counted.got,
               loss=float(aux["total_loss"]))
    if not np.isfinite(res["loss"]):
        fail(f"multi (a) rank {rank}: non-finite loss in the timed steps")
    for k in ("B1", "B2", "B3", "B4"):
        if counted.got[k] <= 0:
            fail(f"multi (a) rank {rank}: kernel {k} was not launched in the sharded steps")

    # --- B3 and B4 on this rank's localized stream
    a3 = cap.args["B3"][0]
    pts, meta, table, rsl, NW = (x.detach() if isinstance(x, torch.Tensor) else x
                                 for x in a3[:5])
    g = cap.args["B4"][0][4].detach()
    del cap
    res.update(_sharded_lookup(rank, world, pts, meta, table, rsl, NW, g))
    # B4's bf16 mode as HASH_BWD_BF16 launches it in the sharded step
    with Capture((hw, "lookup_bwd", "B4")) as cap16:
        tile.compute_grads(state, data, dataclasses.replace(tc2, hash_bwd_bf16=True),
                           ray_idx=ray_idx, pixel_locs=pix, table_axis=axis)
    a4, kw4 = cap16.args["B4"]
    if kw4.get("mode") != "bf16":
        fail(f"multi (a) rank {rank}: HASH_BWD_BF16 did not take B4's bf16 mode")
    res["bf16"] = _sharded_b4(rank, world, *(x.detach() if isinstance(x, torch.Tensor) else x
                                             for x in a4[:6]), mode="bf16")
    return res


def _one_rank_at_a_time(rank, world, fn):
    """``fn()`` on each rank in turn, the others waiting at a barrier, so
    that a kernel's time is not shared with the other rank's on the card;
    -> this rank's result."""
    from scanerf_tpu_torch.parallel import mesh as mesh_lib

    out = None
    for r in range(world):
        mesh_lib.barrier()
        if r == rank:
            torch.cuda.synchronize()
            out = fn()
            torch.cuda.synchronize()
    mesh_lib.barrier()
    return out


def _owned_range(meta):
    """The middle N_SUB_CHUNKS of the chunks this rank's shard owns (span
    > 0 in the localized meta)."""
    live = torch.nonzero(meta[:, :, 2].sum(dim=1) > 0)[:, 0]
    mid = live[len(live) // 2].item()
    c0 = max(int(live[0]), mid - N_SUB_CHUNKS // 2)
    return c0, min(int(live[-1]) + 1, c0 + N_SUB_CHUNKS)


def _sharded_lookup(rank, world, pts, meta, table, res, NW, g):
    """B3 and exact B4 on a shard's localized stream: against their plain
    versions on the owned middle chunks, other ranks' chunks zero on the
    whole stream, then timed on it with their bounds over the owned
    chunks' bytes."""
    from scanerf_tpu_torch.ops.kernels import hash_encode as hw

    c0, c1 = _owned_range(meta)
    sub_p, sub_m = pts[c0:c1].contiguous(), meta[c0:c1].contiguous()
    wbase = int(meta[0, 0, 3])
    f_k = hw.lookup_fwd(sub_p, sub_m, table, res, NW, shards=world)
    f_p = hw.lookup_fwd_plain(sub_p, table, res, NW, wbase=sub_m[:, 0, 3])
    e3, scale = float((f_k - f_p).abs().max()), float(f_p.abs().max())
    print(f"multi (a) rank {rank} B3 on its shard (wbase {wbase}), chunks {c0}-{c1}: max err "
          f"{e3:.3g}, largest entry {scale:.3g} (tol 1e-5 of it)")
    if not (torch.isfinite(f_k).all() and scale > 0 and e3 <= 1e-5 * scale):
        fail(f"multi (a) rank {rank}: B3 on the shard differs from its plain version")
    owned = meta[:, :, 2].sum(dim=1) > 0
    feats = hw.lookup_fwd(pts, meta, table, res, NW, shards=world)
    dpts, _ = hw.lookup_bwd(pts, meta, table, res, g, NW, shards=world)
    other = ~owned.repeat_interleave(hw.CHUNK)
    if feats[other].count_nonzero() or dpts[~owned].count_nonzero():
        fail(f"multi (a) rank {rank}: chunks of the other shard have nonzero features or dL/du")
    del feats, dpts
    b4 = _sharded_b4(rank, world, pts, meta, table, res, g, NW, mode="exact")
    NC, L = pts.shape[0], table.shape[0]
    n_owned = int(owned.sum())
    real_owned = int(((pts[:, 3, :] < NW) & owned[:, None]).sum())
    visited = int(torch.unique(meta[owned, 0, 0]).numel())
    tab_bytes = visited * L * hw.WB * hw.W * 2 * 4
    # B3 reads the owned chunks' pts rows 0-3, the meta and the shard's
    # visited blocks, and writes every row's features (zeros on the other
    # shard's chunks)
    b3_bytes = n_owned * hw.CHUNK * 4 * 4 + meta.numel() * 4 + NC * hw.CHUNK * 2 * L * 4 \
        + tab_bytes
    b3_ms, b3_plain = _one_rank_at_a_time(rank, world, lambda: (
        timed(lambda: hw.lookup_fwd(pts, meta, table, res, NW, shards=world), 10),
        timed(lambda: hw.lookup_fwd_plain(pts, table, res, NW, wbase=meta[:, 0, 3]), 1)))
    b3 = dict(launches=0, max_abs_err=e3, wbase=wbase, chunks=NC, owned_chunks=n_owned,
              ms=b3_ms, plain_ms=b3_plain, bytes=b3_bytes, ops=real_owned * L * 8 * 6,
              library_ms=None)
    # B4 reads the owned chunks' pts rows 0-3 and cotangent rows, the meta
    # and the visited blocks, writes dpts (all rows) and the shard's dense
    # table gradient
    b4_bytes = n_owned * hw.CHUNK * (4 + 2 * L) * 4 + meta.numel() * 4 + pts.numel() * 4 \
        + tab_bytes + table.numel() * 4
    b4_ms, b4_plain = _one_rank_at_a_time(rank, world, lambda: (
        timed(lambda: hw.lookup_bwd(pts, meta, table, res, g, NW, shards=world), 5),
        timed(lambda: hw.lookup_bwd_plain(pts, table, res, g, NW, wbase=meta[:, 0, 3]), 1)))
    b4.update(launches=0, wbase=wbase, chunks=NC, owned_chunks=n_owned, ms=b4_ms,
              plain_ms=b4_plain, bytes=b4_bytes, ops=real_owned * L * 8 * 14, library_ms=None)
    print(f"multi (a) rank {rank}: B3 {b3['ms']:.4f} ms (plain {b3['plain_ms']:.1f}), B4 "
          f"{b4['ms']:.4f} ms (plain {b4['plain_ms']:.1f}) on the shard's stream: {NC} chunks, "
          f"{n_owned} owned, {real_owned} real rows owned, {visited} visited blocks")
    return {"b3": b3, "b4": b4}


def _sharded_b4(rank, world, pts, meta, table, res, g, NW, mode):
    """B4 (``mode``) on a shard's owned middle chunks against its plain
    version -> {"max_abs_err"}; the bf16 mode also times the whole stream."""
    from scanerf_tpu_torch.ops.kernels import hash_encode as hw

    c0, c1 = _owned_range(meta)
    sub_p, sub_m = pts[c0:c1].contiguous(), meta[c0:c1].contiguous()
    gs = g[c0 * hw.CHUNK:c1 * hw.CHUNK].contiguous()
    dpts_k, dtab_k = hw.lookup_bwd(sub_p, sub_m, table, res, gs, NW, mode=mode, shards=world)
    dpts_p, dtab_p = hw.lookup_bwd_plain(sub_p, table, res, gs, NW, mode, wbase=sub_m[:, 0, 3])
    if dpts_k[:, 3:].count_nonzero() or dpts_p[:, 3:].count_nonzero():
        fail(f"multi (a) rank {rank} B4 ({mode}) dpts rows 3-7 are not zero")
    tol = EXTRAS_BF16_TABLE_TOL if mode == "bf16" else 1e-4
    errs = check_parts(f"multi (a) rank {rank} B4 {mode} on its shard",
                       [("dpts u", dpts_k[:, 0:3], dpts_p[:, 0:3])], False)
    errs += check_parts(f"multi (a) rank {rank} B4 {mode} on its shard",
                        [(f"d_tables level {lv}", dtab_k[lv], dtab_p[lv])
                         for lv in range(LEVELS)], False, tol=tol)
    out = {"max_abs_err": max(errs)}
    if mode == "bf16":
        out["ms"] = _one_rank_at_a_time(rank, world, lambda: timed(
            lambda: hw.lookup_bwd(pts, meta, table, res, g, NW, mode="bf16", shards=world), 5))
    return out


def _multi_dp(rank, world, counters, total):
    """(b) Ray data parallelism at bench.py's width (H = 2^21, the full
    recipe, fused: B5 / B6): each rank's gradients alone on the batch its
    generator draws, exchanged; then one step of ``build_dp_step``, whose
    averaged gradients are held against their mean and whose replicas must
    end equal."""
    from scanerf_tpu_torch.parallel import mesh as mesh_lib
    from scanerf_tpu_torch.parallel import ray_parallel as rp
    from scanerf_tpu_torch.train import tile

    tc = tile.TrainConfig(**TRAIN_KW, **ARMS["full_recipe"])
    mesh = rp.make_ray_mesh()
    rays = mesh.axis("rays")
    state, data = train_setup(tc)
    state, data = rp.shard_dp(mesh, state, data)
    (_, a_own), g_own = tile.compute_grads(state, data, tc, tile.batch_generator(11, mesh))

    def mean_of_ranks(t):  # (rank 0's + rank 1's) / 2, exchanged exactly
        both = mesh_lib.gather_slices(t.detach()[None].contiguous(), rays, 0)
        return (both[0] + both[1]) / 2

    want = {k: [mean_of_ranks(x) for x in v] for k, v in g_own.items()}
    want_loss = float(mean_of_ranks(a_own["total_loss"]))
    del g_own
    step = rp.build_dp_step(mesh, dataclasses.replace(tc, ray_shards=world))
    with _Counted(counters, total) as counted, \
            Capture((tile, "apply_gradients", "update")) as cap:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, aux = step(state, data, tile.batch_generator(11, mesh))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    got = cap.args["update"][0][1]
    errs = {}
    for name in ("hash", "decoder", "cam"):
        errs[name] = max(rel_l2(w, g) for w, g in zip(want[name], got[name])
                         if w.abs().max() > 0)
        if not errs[name] <= FVU_GRAD_RTOL[name]:
            fail(f"multi (b) rank {rank}: the DP step's averaged {name} gradient differs from "
                 f"the mean of the replicas' (relative L2 {errs[name]:.3g})")
    loss = float(aux["total_loss"])
    if not abs(loss - want_loss) <= FVU_LOSS_RTOL["*"] * abs(want_loss):
        fail(f"multi (b) rank {rank}: the DP step's loss {loss} is not the replicas' mean "
             f"{want_loss}")
    from scanerf_tpu_torch.models.decoder import pack_params

    p = state.params
    for name, t in (("tables", p.field.features), ("decoder", pack_params(p.field.decoder)),
                    ("se3_refine", p.se3_refine)):
        d = mesh_lib.all_reduce(t.detach() * (1.0 if rank == 0 else -1.0), rays)
        if d.count_nonzero():
            fail(f"multi (b): the replicas' {name} differ after the step")
    print(f"multi (b) rank {rank}: DP step {wall * 1e3:.1f} ms for {world} x 2^14 rays; "
          f"averaged gradients against the mean (relative L2) {errs}; replicas equal")
    for k in ("B1", "B2", "B5", "B6"):
        if counted.got[k] <= 0:
            fail(f"multi (b) rank {rank}: kernel {k} was not launched in the DP step")
    return {"grads": errs, "loss": loss, "step_s": wall, "launches": counted.got}


def _multi_tiles(rank, world, counters, total, city_root):
    """(c) The tiles mesh: the city phase's 2 x 2 city by ``Trainer`` on two
    ranks of two tiles each, one round of MULTI_CITY_STEPS steps; its
    consensus over the ranks against one process's ``consensus_update``
    over the same four tiles' poses."""
    from scanerf_tpu_torch.config import default_config
    from scanerf_tpu_torch.parallel import consensus
    from scanerf_tpu_torch.parallel import mesh as mesh_lib
    from scanerf_tpu_torch.train.trainer import Trainer

    cfg = default_config().deep_update({
        "DATADIR": city_root, "TILES": list(range(CITY_NX * CITY_NZ)), "RHO": 100.0,
        "SYN_ITERS": MULTI_CITY_STEPS, "EVAL_STEP": 10**6, "UPDATE_MASK_STEP": 10**6,
        "CKPT_STEP": 0, "HASHGRID": {"LOG2_HASHMAP_SIZE": 21},
        "TRAINING": {"TOTAL_STEP": CITY_STEPS, "BS_LOG2DIM": 14, "NUM_SAMPLE": 128,
                     "NUM_BG_SAMPLE": 128, "NUM_MARCH": 512, "GRID_LOG2DIM": [6, 7],
                     "PRUNING_TH": [0.1], "ADJUST_STEP": 10**6, "CAMOPT": {"NOISE": 0.01}}})
    t0 = time.perf_counter()
    tr = Trainer(cfg, device="cuda", backend="gloo")
    build_s = time.perf_counter() - t0
    tiles = tr.mesh.axis("tiles")
    if tr.local_ids != [2 * rank, 2 * rank + 1]:
        fail(f"multi (c) rank {rank} holds tiles {tr.local_ids}")
    before = [(s.admm.shared_se3.clone(), s.admm.delta_se3.clone()) for s in tr.states]
    with _Counted(counters, total) as counted:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        aux = tr.train_round()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    def whole(ts):  # the four tiles' [4, ...] from each rank's two
        return mesh_lib.gather_slices(torch.stack(ts).float().contiguous(), tiles, 0)

    x = whole([s.params.se3_refine.detach() for s in tr.states])
    z, delta, ov, caux = consensus.consensus_update(
        x, whole(list(tr.confidence)), whole(list(tr.cam_map)).to(torch.int32),
        whole([b[0] for b in before]), whole([b[1] for b in before]), tr.states[0].admm.rho,
        tr.num_global_cams)
    mine = slice(2 * rank, 2 * rank + 2)
    errs = {}
    for name, ref, got in (("z", z[mine], [s.admm.shared_se3 for s in tr.states]),
                           ("delta", delta[mine], [s.admm.delta_se3 for s in tr.states])):
        errs[name] = float((torch.stack(got) - ref).abs().max() / ref.abs().max().clamp_min(1e-30))
    for k in ("primal_residual", "dual_residual"):
        errs[k] = abs(float(getattr(aux, k)) - float(getattr(caux, k)))
    same_ov = torch.equal(torch.stack([s.admm.overlap_flags for s in tr.states]), ov[mine])
    n_ovl = int(aux.num_overlap)
    rays_per_step = (2**14 // tr.datas[0].images.shape[0]) // 4 * 4 * tr.datas[0].images.shape[0]
    print(f"multi (c) rank {rank}: Trainer built in {build_s:.1f} s; round of 2 tiles x "
          f"{MULTI_CITY_STEPS} steps {wall:.2f} s ({2 * MULTI_CITY_STEPS * rays_per_step / wall:.0f}"
          f" training rays/s on this rank); consensus over the ranks against one process: "
          f"{errs} (tol {CITY_CONSENSUS_TOL}); overlap flags equal {same_ov}, {n_ovl} slots")
    if not (all(e <= CITY_CONSENSUS_TOL for e in errs.values()) and same_ov and n_ovl == int(
            caux.num_overlap) > 0):
        fail(f"multi (c) rank {rank}: the consensus over the ranks differs from one process's")
    for k in ("B1", "B2", "B5", "B6"):
        if counted.got[k] <= 0:
            fail(f"multi (c) rank {rank}: kernel {k} was not launched in the round")
    return {"errs": errs, "round_s": wall, "build_s": build_s, "launches": counted.got,
            "n_overlap": n_ovl, "primal": float(aux.primal_residual)}


def _multi_render(rank, world, counters, total, render_dirs):
    """(d) The render phase's overhead view at 256x128, ``sharded=True``
    over the ranks, fused and unfused, against the one-rank frame."""
    from scanerf_tpu_torch.parallel import mesh as mesh_lib
    from scanerf_tpu_torch.render import renderer

    scene = renderer.load_scene(render_dirs, device="cuda")
    K, views = cameras()
    mesh = mesh_lib.make_mesh({"rays": world})
    out = {}
    for fuse in (True, False):
        kw = dict(chunk=CHUNK, device="cuda", fuse_decoder=fuse, **RENDER_KW)
        with _Counted(counters, total) as counted:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            img = renderer.render_image(scene, K, views["overhead"], IMG_H, IMG_W, sharded=True,
                                        mesh=mesh, **kw)
            wall = time.perf_counter() - t0
        one = renderer.render_image(scene, K, views["overhead"], IMG_H, IMG_W, **kw)
        label = "fused" if fuse else "unfused"
        errs = {k: float(np.abs(img[k] - one[k]).max()) for k in ("rgb", "depth")}
        print(f"multi (d) rank {rank} sharded frame ({label}) {wall * 1e3:.1f} ms: max |sharded "
              f"- one rank| {errs} (tol {dict(RENDER_TOL)})")
        for k, tol in RENDER_TOL:
            if k in errs and not errs[k] <= tol:
                fail(f"multi (d) rank {rank}: the sharded frame ({label}) differs in {k}")
        need = ("B1", "B2", "B7") if fuse else ("B1", "B2", "B3")
        for k in need:
            if counted.got[k] <= 0:
                fail(f"multi (d) rank {rank}: kernel {k} was not launched ({label})")
        out[label] = {"errs": errs, "ms": wall * 1e3, "launches": counted.got}
    return out


def multi_phase() -> dict:
    """The multi-device paths on MULTI_WORLD ranks that share cuda:0 over
    gloo (``torch.multiprocessing``, spawn), after the kernels are built
    in this process: (a) a table-sharded 2^24 tile, (b) ray data
    parallelism, (c) the tiles mesh, (d) the sharded render. Returns each
    kernel's launches over the ranks' counted runs and B3's / B4's numbers
    on a shard (rank 1's: its ``wbase`` is not 0)."""
    import pickle
    import socket

    import torch.multiprocessing as mp

    from scanerf_tpu_torch.data import io as dio
    from scanerf_tpu_torch.data.city import write_city_scene_dir

    t_phase = time.perf_counter()
    print(f"multi: {MULTI_WORLD} ranks, all on cuda:0, collective backend gloo")
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        render_root = os.path.join(tmp, "render")
        os.makedirs(render_root)
        render_dirs = write_scene(render_root)
        city_root = os.path.join(tmp, "city")
        write_city_scene_dir(city_root, nx_tiles=CITY_NX, nz_tiles=CITY_NZ,
                             n_cameras=CITY_CAMS, H=CITY_HW, W=CITY_HW)
        path = os.path.join(city_root, "tiles", "tile_info.txt")
        infos = list(dio.read_tile_info(path).values())
        for info in infos:  # as the city phase's
            info.resolution = (32, 2048)
            info.corner = info.corner + np.array([0.0, 0.2, 0.0], np.float32)
        dio.write_tile_info(path, infos)
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        ctx = mp.start_processes(_multi_rank, args=(MULTI_WORLD, port, tmp, render_dirs,
                                                    city_root),
                                 nprocs=MULTI_WORLD, join=False, start_method="spawn")
        deadline = time.perf_counter() + MULTI_TIMEOUT_S
        try:
            while not ctx.join(timeout=5):
                if time.perf_counter() > deadline:
                    for p in ctx.processes:
                        p.kill()
                    fail(f"multi: the ranks did not end within {MULTI_TIMEOUT_S} s")
        except Exception as e:  # a rank failed: spawn ends the others
            fail(f"multi: a rank failed: {e}")
        outs = []
        for r in range(MULTI_WORLD):
            with open(os.path.join(tmp, f"multi{r}.pkl"), "rb") as f:
                outs.append(pickle.load(f))
    launches = {}
    for o in outs:
        for k, n in o["launches"].items():
            launches[k] = launches.get(k, 0) + n
    for o in outs:
        a = o["a"]
        print(f"multi (a) rank {o['rank']}: table-sharded 2^{MULTI_LOG2_H} step "
              f"{a['step_s'] * 1e3:.1f} ms, of it {a['collective_s'] * 1e3:.1f} ms in "
              f"collectives, {a['rays_per_s']:.0f} training rays/s (the tile's 2^14 rays a "
              f"step over both ranks); first step against the unsharded step: losses "
              + json.dumps({k: [round(x, 7) for x in v] for k, v in a["losses"].items()})
              + f", gradients (relative L2) {a['grads']}; peak device memory "
              f"{o['peak_gib']:.2f} GiB; parts (a)-(d) "
              + ", ".join(f"{o[p + '_s']:.1f}" for p in "abcd") + " s")
    print(f"multi launches (both ranks, counted runs of (a)-(d)): {launches}")
    a1 = outs[-1]["a"]
    b3 = dict(a1["b3"], launches=sum(o["a"]["launches"]["B3"] for o in outs),
              max_abs_err=max(o["a"]["b3"]["max_abs_err"] for o in outs))
    b4 = dict(a1["b4"], launches=sum(o["a"]["launches"]["B4"] for o in outs),
              max_abs_err=max(max(o["a"]["b4"]["max_abs_err"], o["a"]["bf16"]["max_abs_err"])
                              for o in outs),
              bf16_ms=a1["bf16"]["ms"])
    print(f"multi: phase {time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches, "b3": b3, "b4": b4}


def print_ptxas(lib: str, log: str) -> None:
    """One line per kernel of a library's ``-Xptxas -v`` log: registers,
    spills and shared memory."""
    import re

    kernel, spill = None, ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            names = re.findall(r"[a-z]+(?:_[a-z]+)*_kernel", line)
            kernel = (names[0] if names else "?") + ("<bf16>" if "bfloat16" in line else "")
        elif "spill stores" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line and kernel:
            print(f"  ptxas {lib} {kernel}: {line.split(':', 1)[1].strip()}; {spill}")
            kernel = None


def sass_report(build) -> None:
    """Where the toolkit has cuobjdump: the tensor-core (HMMA) and atomic
    instructions of the kernels of B5, B6a, B7 and B4, from the built
    libraries."""
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        print("sass: cuobjdump not found, tensor-core instructions not checked")
        return
    for lib, kernel in (("fused_train", "train_fwd_kernel"), ("fused_train", "decoder_bwd_kernel"),
                        ("fused_render", "fused_render_kernel"),
                        ("hash_encode", "lookup_bwd_kernel")):
        sass = subprocess.run([tool, "-sass", str(build.library_path(lib))], capture_output=True,
                              text=True, check=True).stdout
        for func in sass.split("Function : ")[1:]:
            if kernel not in func.splitlines()[0]:
                continue
            ops: dict[str, int] = {}
            for line in func.splitlines():
                words = line.split("*/")[1].split() if line.count("*/") >= 2 else []
                words = [w for w in words if not w.startswith("@")]
                if words and words[0].split(".")[0] in ("HMMA", "ATOMS", "ATOM", "ATOMG", "RED",
                                                        "REDG"):
                    op = words[0].rstrip(";")
                    ops[op] = ops.get(op, 0) + 1
            label = kernel + ("<bf16>" if "bfloat16" in func.splitlines()[0] else "")
            print(f"sass {label}: {ops or 'no HMMA or atomic instructions'}")


def occupancy_report(build) -> None:
    """The blocks an SM holds of B5, B6a and B7, whose grids are as many
    blocks as the card holds at once, and each block's dynamic shared
    memory."""
    import ctypes

    n = [ctypes.c_int() for _ in range(6)]
    build.check(build.load("fused_train").scanerf_train_occupancy(
        *(ctypes.byref(v) for v in n[:4])), "scanerf_train_occupancy")
    build.check(build.load("fused_render").scanerf_fused_render_occupancy(
        *(ctypes.byref(v) for v in n[4:])), "scanerf_fused_render_occupancy")
    fwd, bwd, fwd_smem, bwd_smem, render, render_smem = (v.value for v in n)
    print(f"blocks an SM holds (dynamic shared memory a block): B5 {fwd} of 512 threads "
          f"({fwd_smem} B), B6a {bwd} of 512 ({bwd_smem} B), B7 {render} of 512 "
          f"({render_smem} B)")


def b1_shape(label: str, a, kw, iters: int) -> dict:
    """B1 on one call's captured arguments: z and totals against the plain
    version (bit for bit: the kernel rounds every operation as the plain
    version does, and S and M are powers of two, so PyTorch's division by
    them through the reciprocal is exact), the wrapper's time, the kernel's
    alone (torch.profiler) and the plain version's, and what the function
    needs: its bytes, and its operations on this call's rays (the march
    and scan on rays with a non-empty span, a merge of the S quantiles into
    the M CDF values on rays that meet occupied cells)."""
    from scanerf_tpu_torch.ops.kernels import sampler as sp

    z_k, tot_k = sp.sample_fused(*a, **kw)
    z_p, tot_p = sp.sample_plain(*a, **kw)
    N, S, M = a[0].shape[0], a[4], a[8]
    valid = int((tot_p > 0).sum())
    n_z, n_t = int((z_k != z_p).sum()), int((tot_k != tot_p).sum())
    err = float((z_k - z_p).abs().max())
    print(f"B1 {label}: {N} rays S={S} M={M}: {valid} valid; entries that differ from the "
          f"plain version: z {n_z} of {z_p.numel()}, totals {n_t} of {N} (max |dz| {err:.3g}; "
          f"must be 0)")
    if n_z or n_t or not torch.isfinite(z_k).all():
        fail(f"B1 ({label}) differs from its plain version: it must be exact")
    if valid < N // 8:
        fail(f"B1 comparison ({label}) has only {valid} valid rays")
    n_span = int((a[3] > a[2]).sum())
    out = dict(err=err, ms=timed(lambda: sp.sample_fused(*a, **kw), iters),
               kernel_ms=kernel_ms(lambda: sp.sample_fused(*a, **kw), "sample_kernel", iters),
               plain_ms=timed(lambda: sp.sample_plain(*a, **kw), 3),
               bytes=N * 8 * 4 + a[5].numel() + 2 * 3 * 4 + N * (S + 1) * 4,
               ops=n_span * (M * 24 + M) + valid * (M + S))
    print(f"B1 {label}: wrapper {out['ms']:.4f} ms, kernel alone {fmt_ms(out['kernel_ms'])}, "
          f"plain {out['plain_ms']:.3f} ms")
    return out


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs an NVIDIA GPU")
    sys.path.insert(0, HERE)
    import scanerf_tpu_torch

    if not os.path.abspath(scanerf_tpu_torch.__file__).startswith(HERE + os.sep):
        fail(f"scanerf_tpu_torch imported from outside {HERE}")
    from scanerf_tpu_torch import _build
    from scanerf_tpu_torch.ops.kernels import fused_render as fr
    from scanerf_tpu_torch.ops.kernels import hash_encode as hw
    from scanerf_tpu_torch.ops.kernels import sampler as sp
    from scanerf_tpu_torch.render import renderer
    from scanerf_tpu_torch.utils import lie, rays as rays_mod

    # plain versions and the unfused decoder's products in full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("set torch.backends.cuda.matmul.allow_tf32 = False and "
          "torch.backends.cudnn.allow_tf32 = False: every f32 product in full f32")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    t_start = t0 = time.perf_counter()
    built = _build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s wall for {sorted(built)} "
          + " ".join(f"{k}={v[0]:.1f}s" for k, v in built.items()))
    for name, (_, log) in built.items():
        print_ptxas(name, log)
    sass_report(_build)
    occupancy_report(_build)

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        dirs = write_scene(tmp)
        print(f"scene written: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        scene = renderer.load_scene(dirs, device="cuda")
        torch.cuda.synchronize()
        print(f"load_scene f32: {time.perf_counter() - t0:.1f} s, union grid "
              f"{tuple(scene.union_occ.shape)}, occupied {float(scene.union_occ.float().mean()):.3f}")
        scene16 = renderer.load_scene(dirs, dtype=torch.bfloat16, device="cuda")
        scene_cpu = renderer.load_scene(dirs, device="cpu")
    K, views = cameras()
    n_rays = IMG_H * IMG_W
    n_chunks = -(-n_rays // CHUNK)

    def render(c2w, **kw):
        return renderer.render_image(scene, K, c2w, IMG_H, IMG_W, chunk=CHUNK,
                                     device="cuda", **kw, **RENDER_KW)

    # --- warm-up renders, then the counted main path: both views, in the
    # fused configuration (B7) and the unfused one (B3 + the decoder) ----
    counters = {True: {"B1": sp.sample_fused, "B2": hw.pack, "B7": fr.hash_decode_fused},
                False: {"B1": sp.sample_fused, "B2": hw.pack, "B3": hw.lookup_fwd}}
    stage_ms: dict[tuple, dict[str, float]] = {}
    launches: dict[bool, dict[str, int]] = {}
    for fuse in (True, False):
        label = "" if fuse else " unfused"
        for c2w in views.values():
            render(c2w, fuse_decoder=fuse)
        for c in counters[fuse].values():
            c.launches = 0
        for view, c2w in views.items():
            events = []

            def hook(name):
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                events.append((name, ev))

            start = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start.record()
            img = render(c2w, fuse_decoder=fuse, stage_hook=hook)
            wall = time.perf_counter() - t0
            print(f"render_image {view}{label} {IMG_W}x{IMG_H}: {wall * 1e3:.1f} ms, "
                  f"{n_rays / wall:.0f} rays/s, {n_chunks} chunks")
            if img["rgb"].shape != (IMG_H, IMG_W, 3) or not np.isfinite(img["rgb"]).all() \
                    or not np.isfinite(img["depth"]).all():
                fail(f"render_image ({view}{label}) output has the wrong shape or non-finite "
                     "values")
            print(f"image {view}{label}: rgb mean {img['rgb'].mean():.4f} std "
                  f"{img['rgb'].std():.4f}, depth mean {img['depth'].mean():.3f}")
            split: dict[str, float] = {}
            prev = start
            for name, ev in events:
                split[name] = split.get(name, 0.0) + prev.elapsed_time(ev)
                prev = ev
            stage_ms[view, fuse] = split
        launches[fuse] = {k: c.launches for k, c in counters[fuse].items()}
        print(f"launches in the counted renders{label} ({len(views)} views x {n_chunks} "
              f"chunks): {launches[fuse]}")
        for k, n in launches[fuse].items():
            if n <= 0:
                fail(f"kernel {k} was not launched on the render path{label}")

    # --- per view: share of rays that meet occupied cells, the unfused
    # render against the fused one, throughput without the stage hook,
    # device time by kernel (torch.profiler) ------------------------------
    frame_rays = {}
    for view, c2w in views.items():
        xy = rays_mod.pixel_grid(IMG_H, IMG_W, device="cuda")
        pose = lie.invert(torch.as_tensor(c2w, device="cuda"))
        ro, rd = rays_mod.get_center_and_ray(xy, pose, torch.as_tensor(K, device="cuda"))
        frame_rays[view] = ro, rd
        hits, worst = 0, dict.fromkeys(dict(RENDER_TOL), 0.0)
        for i in range(0, n_rays, CHUNK):
            out_f, out_u = (renderer.render_rays(scene, ro[i:i + CHUNK], rd[i:i + CHUNK],
                                                 device="cuda", fuse_decoder=fuse, **RENDER_KW)
                            for fuse in (True, False))
            hits += int(out_f["fore_valid"].sum())
            for k in worst:
                worst[k] = max(worst[k], float((out_f[k] - out_u[k]).abs().max()))
        for k, tol in RENDER_TOL:
            print(f"render {view}: max |unfused - fused| {k} {worst[k]:.3g} (tol {tol})")
            if not worst[k] <= tol:
                fail(f"the unfused render ({view}) differs from the fused one in {k}")
        print(f"view {view}: {hits} of {n_rays} rays meet occupied cells "
              f"(hit share {hits / n_rays:.4f})")
        for fuse in (True, False):
            label = f"{view}{'' if fuse else ' unfused'}"
            walls = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                render(c2w, fuse_decoder=fuse)
                walls.append(time.perf_counter() - t0)
            split = stage_ms[view, fuse]
            print(f"render_image {label} (no stage hook): "
                  + ", ".join(f"{n_rays / w:.0f}" for w in walls) + " rays/s")
            print(f"stages {label} (ms, whole frame): "
                  + json.dumps({k: round(v, 3) for k, v in split.items()}))
            print(f"rays/s {label} by device events: {n_rays / (sum(split.values()) / 1e3):.0f}")
        profiled_idle(lambda: render(c2w), f"frame {view}")

    # --- each kernel's inputs at the render's shapes: the middle chunk of
    # the overhead view, where every ray meets occupied cells -----------
    ro, rd = frame_rays["overhead"]
    mid = slice((n_rays - CHUNK) // 2, (n_rays + CHUNK) // 2)
    with Capture(*render_targets(sp, hw, fr)) as cap:
        out_mid = renderer.render_rays(scene, ro[mid], rd[mid], device="cuda", **RENDER_KW)
        renderer.render_rays(scene, ro[mid], rd[mid], device="cuda", fuse_decoder=False,
                             **RENDER_KW)
    print(f"capture chunk: {int(out_mid['fore_valid'].sum())} of {CHUNK} rays hit the tiles")
    torch.cuda.synchronize()
    rows = []

    # B1: the CDF sampler, exact against its plain version
    a, kw = cap.args["B1"]
    b1 = b1_shape("render chunk", a, kw, 20)
    rows.append(dict(
        name="cdf_sampler", route="cuda", source="scanerf_tpu_torch/csrc/sampler.cu",
        replaces="scanerf_tpu/ops/pallas/sampler.py:91",
        launches=launches[True]["B1"] + launches[False]["B1"], max_abs_err=b1["err"],
        ms=b1["ms"], kernel_ms=b1["kernel_ms"], plain_ms=b1["plain_ms"],
        bytes=b1["bytes"], ops=b1["ops"], library_ms=None))

    # B2: the stream pack
    a, kw = cap.args["B2"]
    src, pids, desc, NC, pad_wid = a
    pts_k, pidp_k = hw.pack(*a, **kw)
    pts_p, pidp_p = hw.pack_plain(*a, **kw)
    if not (torch.equal(pts_k, pts_p) and torch.equal(pidp_k, pidp_p)):
        fail("B2 differs from the plain version (must be exact)")
    Nsrc = src.shape[1]
    # yardstick: one index_select over the columns plus a pad column
    t = torch.arange(hw.CHUNK, device="cuda")
    real = t[None] < desc[:, 1:2]
    idx = torch.where(real, desc[:, 0:1] + t[None], torch.full_like(t, Nsrc)[None]).reshape(-1)
    pad = torch.tensor([0.5, 0.5, 0.5, float(pad_wid), 0, 0, 0], device="cuda")[:, None]
    src_ext = torch.cat([src, pad], 1)
    lib_ms = timed(lambda: torch.index_select(src_ext, 1, idx), 20)
    b2_bytes = Nsrc * 8 * 4 + NC * 8 + NC * hw.CHUNK * (8 + 1) * 4
    rows.append(dict(
        name="stream_pack", route="cuda", source="scanerf_tpu_torch/csrc/pack.cu",
        replaces="scanerf_tpu/ops/pallas/hash_encode.py:284",
        launches=launches[True]["B2"] + launches[False]["B2"], max_abs_err=0.0,
        ms=timed(lambda: hw.pack(*a, **kw), 20),
        plain_ms=timed(lambda: hw.pack_plain(*a, **kw), 5),
        bytes=b2_bytes, ops=0, library_ms=lib_ms))
    print(f"B2: {Nsrc} rows -> {NC} chunks: exact")

    # B7: fused hash + decoder, f32 and bf16 tables
    a, kw = cap.args["B7"]
    stream, ct, _, res, decs, NW = a
    b7 = _b7_entry(a, kw)
    live, visited = b7["live_chunks"], b7["visited_blocks"]
    out_k = fr.hash_decode_fused(stream, ct, scene16.features_flat, res, decs, NW, **kw)
    out_p = fr.hash_decode_fused_plain(stream, ct, scene16.features_flat, res, decs, NW)
    errs = {"f32": b7["max_abs_err"], "bf16": float((out_k - out_p).abs().max())}
    if not (b7["finite"] and torch.isfinite(out_k).all() and max(errs.values()) <= 1e-4):
        fail(f"B7 differs from the plain version: max err {errs} (tol 1e-4)")
    # as B5's: the large products in 3xTF32 beside the rest on the CUDA cores
    b7_tc, b7_cc, b7_f32 = decoder_bounds(live * hw.CHUNK, 1, LEVELS * 8 * 6)
    rows.append(dict(
        name="fused_hash_decode", route="cuda", source="scanerf_tpu_torch/csrc/fused_render.cu",
        replaces="scanerf_tpu/ops/pallas/fused_render.py:195",
        launches=launches[True]["B7"], max_abs_err=max(errs.values()), ms=b7["ms"],
        plain_ms=b7["plain_ms"], bytes=b7["bytes"], ops_ms=b7["ops_ms"], library_ms=None))
    bf16_ms = timed(lambda: fr.hash_decode_fused(stream, ct, scene16.features_flat, res, decs,
                                                 NW, **kw), 5)
    print(f"B7: {stream.pts.shape[0]} chunks, {live} live, {visited} visited blocks: "
          f"max err f32 {errs['f32']:.3g} bf16 {errs['bf16']:.3g} (tol 1e-4); "
          f"bf16 tables {bf16_ms:.3f} ms; operation bound {max(b7_tc, b7_cc):.3f} ms with the "
          f"tensor cores (3xTF32 {b7_tc:.3f}, CUDA cores {b7_cc:.3f}), {b7_f32:.3f} ms all in f32 "
          f"on the CUDA cores")

    # B3 on the same chunk (the unfused render's stream), f32 and bf16 tables
    a, kw = cap.args["B3"]
    pts, meta, feats, res, NW = a
    render_b3 = {"launches": launches[False]["B3"], "err": 0.0}
    for label, table in (("f32", feats), ("bf16", scene16.features_flat)):
        f_k = hw.lookup_fwd(pts, meta, table, res, NW)
        f_p = hw.lookup_fwd_plain(pts, table, res, NW)
        e, scale = float((f_k - f_p).abs().max()), float(f_p.abs().max())
        render_b3["err"] = max(render_b3["err"], e)
        ms = timed(lambda: hw.lookup_fwd(pts, meta, table, res, NW), 10)
        print(f"B3 render chunk ({label} tables): {pts.shape[0]} chunks, max err {e:.3g}, "
              f"largest entry {scale:.3g} (tol 1e-5 of it); {ms:.3f} ms")
        if not (torch.isfinite(f_k).all() and e <= 1e-5 * scale):
            fail(f"B3 ({label} tables) differs from its plain version on the render stream")
    # and on a stream whose chunks span up to a whole block of windows, so
    # that every pass of B3's staging runs (real streams rarely go past one)
    w_pts, w_meta, w_spans = wide_span_stream(NW)
    for label, table in (("f32", feats), ("bf16", scene16.features_flat)):
        f_k = hw.lookup_fwd(w_pts, w_meta, table, res, NW)
        f_p = hw.lookup_fwd_plain(w_pts, table, res, NW)
        e, scale = float((f_k - f_p).abs().max()), float(f_p.abs().max())
        render_b3["err"] = max(render_b3["err"], e)
        zero = bool((f_k[-2 * hw.CHUNK + 700:] == 0).all())
        print(f"B3 wide-span stream ({label} tables; chunks spanning {w_spans} windows): max "
              f"err {e:.3g}, largest entry {scale:.3g} (tol 1e-5 of it); sentinel rows zero: "
              f"{zero}")
        if not (torch.isfinite(f_k).all() and e <= 1e-5 * scale and zero):
            fail(f"B3 ({label} tables) differs from its plain version on the wide-span stream")

    # --- the card's render against the plain render on the CPU, per view
    sel = torch.linspace(0, n_rays - 1, N_PARITY_RAYS, device="cuda").long()
    for (view, (ro, rd)), fuse in itertools.product(frame_rays.items(), (True, False)):
        label = f"{view}{'' if fuse else ' unfused'}"
        ro_s, rd_s = ro[sel], rd[sel]
        card = renderer.render_rays(scene, ro_s, rd_s, device="cuda", fuse_decoder=fuse,
                                    **RENDER_KW)
        plain = renderer.render_rays(scene_cpu, ro_s.cpu(), rd_s.cpu(), device="cpu",
                                     fuse_decoder=fuse, **RENDER_KW)
        for k, tol in RENDER_TOL:
            e = float((card[k].cpu() - plain[k]).abs().max())
            print(f"render parity {label} {k}: max |card - cpu| {e:.3g} (tol {tol})")
            if not e <= tol:
                fail(f"card render ({label}) differs from the CPU plain render in {k}: "
                     f"{e} > {tol}")
        if not torch.equal(card["fore_valid"].cpu(), plain["fore_valid"]):
            fail(f"card and CPU renders ({label}) disagree on which rays hit the scene")

    print(f"phase render: {time.perf_counter() - t_start:.1f} s")
    t1 = time.perf_counter()
    train_rows, b1_train, b1_train_launches = train_phase(render_b3)
    rows += train_rows
    print(f"phase train: {time.perf_counter() - t1:.1f} s; total {time.perf_counter() - t_start:.1f} s")
    tiled = tile_phase()
    with tempfile.TemporaryDirectory() as xroot:
        city_copy = os.path.join(xroot, "city")

        def after_city(root, tr, evals):
            served = serve_phase(root, tr, evals, scene, (K, views["overhead"]))
            # the city's scene directory without the trainer's logs, for build_tiles
            shutil.copytree(root, city_copy, ignore=shutil.ignore_patterns("logs"))
            return served

        city = city_phase(serve=after_city)
        print(f"total {time.perf_counter() - t_start:.1f} s")
        extras = extras_phase(tiled["ctx"], city_copy)
    print(f"total {time.perf_counter() - t_start:.1f} s")
    del tiled
    multi = multi_phase()
    print(f"total {time.perf_counter() - t_start:.1f} s")

    def bound(r):
        t_bytes = r.pop("bytes") / HBM_BYTES_PER_S * 1e3
        t_ops = r.pop("ops_ms") if "ops_ms" in r else r.pop("ops") / F32_OPS_PER_S * 1e3
        r["bound_ms"] = max(t_bytes, t_ops)
        r["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        return r

    for r in rows:
        bound(r)
    # each kernel's launches in the city phase beside the counted runs
    # and B3 at the pruning query's shape
    by_name = {r["name"]: r for r in rows}
    for k, n in city["launches"].items():
        by_name[CITY_KIND[k]]["city_launches"] = n
    by_name["hash_lookup_fwd"]["pruning_query"] = bound(dict(city["b3"]))
    # each kernel's launches in the serve phase, B7 at an early-termination
    # slab's shape and B3 at the staged encode's
    serve = city["serve"]
    for k, n in serve["launches"].items():
        by_name[SERVE_KIND[k]]["serve_launches"] = n
    by_name["fused_hash_decode"]["early_slab"] = bound(dict(serve["b7_early_slab"]))
    by_name["hash_lookup_fwd"]["staged"] = bound(dict(serve["b3_staged"]))
    # each kernel's launches in the extras phase, and B4's dL/du-only and
    # bf16 modes on a training step's stream
    for r in rows:
        r["extras_launches"] = 0
    for k, n in extras["launches"].items():
        if k in SERVE_KIND:  # B4's mode counts go on its du_only and bf16 entries
            by_name[SERVE_KIND[k]]["extras_launches"] = n
    for mode, entry in extras["b4"].items():
        by_name["hash_lookup_bwd"][mode] = bound(dict(entry))
    # each kernel's launches over the multi phase's ranks, and B3's and
    # B4's numbers on a table shard
    for r in rows:
        r["multi_launches"] = 0
    for k, n in multi["launches"].items():
        by_name[MULTI_KIND[k]]["multi_launches"] = n
    by_name["hash_lookup_fwd"]["sharded"] = bound(dict(multi["b3"]))
    by_name["hash_lookup_bwd"]["sharded"] = bound(dict(multi["b4"]))
    # B1's row: the render chunk's numbers, all its launches, and each
    # training shape's launches and times beside them
    b1 = rows[0]
    b1["training"] = [dict(rays=n, S=S, M=M, **bound(dict(
        launches=v["launches"], max_abs_err=v["err"], ms=v["ms"], kernel_ms=v["kernel_ms"],
        plain_ms=v["plain_ms"], bytes=v["bytes"], ops=v["ops"])))
        for (n, S, M), v in b1_train.items()]
    loss = b1["launches"] * (b1["ms"] - b1["bound_ms"]) + sum(
        t["launches"] * (t["ms"] - t["bound_ms"]) for t in b1["training"])
    b1["launches"] += b1_train_launches
    print(f"B1 over all its {b1['launches']} launches: launches x (time - bound) {loss:.3f} ms "
          f"(render chunk {b1['ms']:.4f} ms, bound {b1['bound_ms']:.5f}; "
          + "; ".join(f"{t['rays']} rays {t['launches']} launches {t['ms']:.4f} ms, bound "
                      f"{t['bound_ms']:.5f}" for t in b1["training"]) + ")")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
