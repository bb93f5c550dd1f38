#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (scanerf_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from csrc/, writes a 4-tile scene in the
reference export layout (16 levels x 2 features, H = 2^21 entries per
tile, 64^3 occupancy shells, random decoders at the real widths; all
from a fixed seed), loads it with ``load_scene(device="cuda")`` and
renders a 256x128 frame (4 chunks of 8192 rays, 128 fg + 128 bg
samples, a 512-step march, up to 4 blended tiles) with ``render_image``
from two views: one from outside the tile grid, where few rays meet
occupied cells, and one from inside it looking down, where all do.
Then it holds every kernel of that path against its plain PyTorch
version on the card at the render's shapes, holds the card's render of a
few hundred rays of each view against the plain render on the CPU, times
the kernels and the render's stages with CUDA events, and prints:

- the card's name and power limit (nvidia-smi);
- per view, the share of rays that meet occupied cells, rays/s and the
  per-stage split;
- one JSON line ``{"kernels": [...]}`` with, per kernel, its launches in
  the counted render, max error against the plain version, times, and
  the bound (least time the card could take for the same work);
- last, ``{"ok": true, "device": {...}}``.

Any failed build, launch or comparison ends the script with a non-zero
exit code before the last line. Without CUDA it exits 1 and prints no
result.
"""

from __future__ import annotations

import json
import os
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

T_TILES, LEVELS, TABLE = 4, 16, 2**21
GRID = 64
IMG_H, IMG_W = 128, 256
CHUNK = 8192
RENDER_KW = dict(num_sample=128, num_bg_sample=128, num_march=512, max_blend_tiles=4)
N_PARITY_RAYS = 256


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
    """Swap the three kernel wrappers for recorders that keep the first
    call's arguments and call through; restore them on exit. A wrapper
    counts its launches on the name it is bound to in its module, so the
    recorder carries its own count and these launches stay out of the
    wrapper's."""

    def __init__(self, modules):
        self.sampler, self.hw, self.fr = modules
        self.args = {}

    def _wrap(self, mod, name, key):
        orig = getattr(mod, name)

        def rec(*a, **kw):
            self.args.setdefault(key, (a, kw))
            return orig(*a, **kw)

        rec.launches = 0
        setattr(mod, name, rec)
        return mod, name, orig

    def __enter__(self):
        self.saved = [self._wrap(self.sampler, "sample_fused", "B1"),
                      self._wrap(self.hw, "pack", "B2"),
                      self._wrap(self.fr, "hash_decode_fused", "B7")]
        return self

    def __exit__(self, *exc):
        for mod, name, orig in self.saved:
            setattr(mod, name, orig)


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

    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full f32
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    built = _build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s wall for {sorted(built)} "
          + " ".join(f"{k}={v[0]:.1f}s" for k, v in built.items()))
    for name, (_, log) in built.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")

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

    # --- warm-up renders, then the counted main path: both views -------
    for c2w in views.values():
        render(c2w)
    counters = {"B1": sp.sample_fused, "B2": hw.pack, "B7": fr.hash_decode_fused}
    stage_ms: dict[str, dict[str, float]] = {}
    for c in counters.values():
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
        img = render(c2w, stage_hook=hook)
        wall = time.perf_counter() - t0
        print(f"render_image {view} {IMG_W}x{IMG_H}: {wall * 1e3:.1f} ms, "
              f"{n_rays / wall:.0f} rays/s, {n_chunks} chunks")
        if img["rgb"].shape != (IMG_H, IMG_W, 3) or not np.isfinite(img["rgb"]).all() \
                or not np.isfinite(img["depth"]).all():
            fail(f"render_image ({view}) output has the wrong shape or non-finite values")
        print(f"image {view}: rgb mean {img['rgb'].mean():.4f} std {img['rgb'].std():.4f}, "
              f"depth mean {img['depth'].mean():.3f}")
        split: dict[str, float] = {}
        prev = start
        for name, ev in events:
            split[name] = split.get(name, 0.0) + prev.elapsed_time(ev)
            prev = ev
        stage_ms[view] = split
    launches = {k: c.launches for k, c in counters.items()}
    print(f"launches in the counted renders ({len(views)} views x {n_chunks} chunks): "
          f"{launches}")
    for k, n in launches.items():
        if n <= 0:
            fail(f"kernel {k} was not launched on the render path")

    # --- per view: share of rays that meet occupied cells, throughput
    # without the stage hook, device time by kernel (torch.profiler) ----
    from torch.profiler import ProfilerActivity, profile

    frame_rays = {}
    for view, c2w in views.items():
        xy = rays_mod.pixel_grid(IMG_H, IMG_W, device="cuda")
        pose = lie.invert(torch.as_tensor(c2w, device="cuda"))
        ro, rd = rays_mod.get_center_and_ray(xy, pose, torch.as_tensor(K, device="cuda"))
        frame_rays[view] = ro, rd
        hits = sum(int(renderer.render_rays(scene, ro[i:i + CHUNK], rd[i:i + CHUNK],
                                            device="cuda", **RENDER_KW)["fore_valid"].sum())
                   for i in range(0, n_rays, CHUNK))
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            render(c2w)
            walls.append(time.perf_counter() - t0)
        print(f"view {view}: {hits} of {n_rays} rays meet occupied cells "
              f"(hit share {hits / n_rays:.4f}); render_image (no stage hook): "
              + ", ".join(f"{n_rays / w:.0f}" for w in walls) + " rays/s")
        print(f"stages {view} (ms, whole frame): " + json.dumps(
            {k: round(v, 3) for k, v in stage_ms[view].items()}))
        print(f"rays/s {view} by device events: "
              f"{n_rays / (sum(stage_ms[view].values()) / 1e3):.0f}")
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            render(c2w)
            prof_wall = (time.perf_counter() - t0) * 1e3
        dev_us = {}
        for ev in prof.events():
            t_us = ev.time_range.elapsed_us() if ev.device_type.name == "CUDA" else 0
            if t_us > 0:
                dev_us[ev.name] = dev_us.get(ev.name, 0.0) + t_us
        busy = sum(dev_us.values()) / 1e3
        if busy > 0:
            print(f"profiled frame {view}: {prof_wall:.1f} ms wall, {busy:.1f} ms device "
                  f"busy ({100 * busy / prof_wall:.1f}%), idle {100 * (1 - busy / prof_wall):.1f}%")
            for name, t_us in sorted(dev_us.items(), key=lambda kv: -kv[1])[:12]:
                print(f"  {t_us / 1e3:8.3f} ms  {name[:100]}")
        else:
            print(f"profiled frame {view}: the profiler recorded no device time (not measured)")

    # --- each kernel's inputs at the render's shapes: the middle chunk of
    # the overhead view, where every ray meets occupied cells -----------
    ro, rd = frame_rays["overhead"]
    mid = slice((n_rays - CHUNK) // 2, (n_rays + CHUNK) // 2)
    with Capture((sp, hw, fr)) as cap:
        out_mid = renderer.render_rays(scene, ro[mid], rd[mid], device="cuda", **RENDER_KW)
    print(f"capture chunk: {int(out_mid['fore_valid'].sum())} of {CHUNK} rays hit the tiles")
    torch.cuda.synchronize()
    rows = []

    # B1: the CDF sampler
    a, kw = cap.args["B1"]
    z_k, tot_k = sp.sample_fused(*a, **kw)
    z_p, tot_p = sp.sample_plain(*a, **kw)
    v_k, v_p = tot_k > 0, tot_p > 0
    if not torch.equal(v_k, v_p):
        fail("B1 valid masks differ from the plain version")
    if not torch.allclose(tot_k, tot_p, rtol=1e-5, atol=1e-7):
        fail("B1 totals differ from the plain version beyond 1e-5 relative")
    if int(v_p.sum()) < a[0].shape[0] // 8:
        fail(f"B1 comparison chunk has only {int(v_p.sum())} valid rays")
    err_b1 = float((z_k - z_p)[v_p].abs().max())
    if err_b1 > 1e-4:
        fail(f"B1 z differs from the plain version by {err_b1} > 1e-4")
    N, S, M = a[0].shape[0], a[4], a[8]
    b1_bytes = N * 8 * 4 + a[5].numel() + (M + 1) * 4 + N * (S + 1) * 4
    # what this run's rays need: the march and the scan on rays with a
    # non-empty span, and on rays that met occupied cells the inversion as
    # a merge of the S sorted quantiles into the M sorted CDF values
    n_span = int((a[3] > a[2]).sum())
    b1_ops = n_span * (M * 24 + M) + int(v_p.sum()) * (M + S)
    rows.append(dict(
        name="cdf_sampler", route="cuda", source="scanerf_tpu_torch/csrc/sampler.cu",
        replaces="scanerf_tpu/ops/pallas/sampler.py:91",
        launches=launches["B1"], max_abs_err=err_b1,
        ms=timed(lambda: sp.sample_fused(*a, **kw), 20),
        plain_ms=timed(lambda: sp.sample_plain(*a, **kw), 3),
        bytes=b1_bytes, ops=b1_ops, library_ms=None))
    print(f"B1: {N} rays S={S} M={M}: valid {int(v_p.sum())}, max |dz| {err_b1:.3g} (tol 1e-4)")

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
        launches=launches["B2"], max_abs_err=0.0,
        ms=timed(lambda: hw.pack(*a, **kw), 20),
        plain_ms=timed(lambda: hw.pack_plain(*a, **kw), 5),
        bytes=b2_bytes, ops=0, library_ms=lib_ms))
    print(f"B2: {Nsrc} rows -> {NC} chunks: exact")

    # B7: fused hash + decoder, f32 and bf16 tables
    a, kw = cap.args["B7"]
    stream, ct, feats, res, decs, NW = a
    live = int((stream.meta[:, :, 2].sum(1) > 0).sum())
    visited = int(stream.visited.sum())
    errs = {}
    for label, table in (("f32", feats), ("bf16", scene16.features_flat)):
        out_k = fr.hash_decode_fused(stream, ct, table, res, decs, NW, **kw)
        out_p = fr.hash_decode_fused_plain(stream, ct, table, res, decs, NW)
        errs[label] = float((out_k - out_p).abs().max())
        if not torch.isfinite(out_k).all() or errs[label] > 1e-4:
            fail(f"B7 ({label} tables) differs from the plain version by {errs[label]} > 1e-4")
    macs = 32 * 64 + 64 * 64 + 7 * 32 + 48 * 64 + 64 * 64 + 3 * 64
    b7_ops = live * hw.CHUNK * (2 * macs + LEVELS * 8 * 6)
    b7_bytes = (stream.pts.numel() * 4 + stream.meta.numel() * 4 + NC * 4
                + stream.pts.shape[0] * hw.CHUNK * 16
                + visited * LEVELS * hw.WB * hw.W * 2 * feats.element_size()
                + kw["slabs"].numel() * 4)
    rows.append(dict(
        name="fused_hash_decode", route="cuda", source="scanerf_tpu_torch/csrc/fused_render.cu",
        replaces="scanerf_tpu/ops/pallas/fused_render.py:195",
        launches=launches["B7"], max_abs_err=max(errs.values()),
        ms=timed(lambda: fr.hash_decode_fused(*a, **kw), 5),
        plain_ms=timed(lambda: fr.hash_decode_fused_plain(*a[:6]), 1),
        bytes=b7_bytes, ops=b7_ops, library_ms=None))
    bf16_ms = timed(lambda: fr.hash_decode_fused(stream, ct, scene16.features_flat, res, decs,
                                                 NW, **kw), 5)
    print(f"B7: {stream.pts.shape[0]} chunks, {live} live, {visited} visited blocks: "
          f"max err f32 {errs['f32']:.3g} bf16 {errs['bf16']:.3g} (tol 1e-4); "
          f"bf16 tables {bf16_ms:.3f} ms")

    # --- the card's render against the plain render on the CPU, per view
    sel = torch.linspace(0, n_rays - 1, N_PARITY_RAYS, device="cuda").long()
    for view, (ro, rd) in frame_rays.items():
        ro_s, rd_s = ro[sel], rd[sel]
        card = renderer.render_rays(scene, ro_s, rd_s, device="cuda", **RENDER_KW)
        plain = renderer.render_rays(scene_cpu, ro_s.cpu(), rd_s.cpu(), device="cpu",
                                     **RENDER_KW)
        for k, tol in (("rgb", 1e-4), ("depth", 1e-3), ("T_left", 1e-4)):
            e = float((card[k].cpu() - plain[k]).abs().max())
            print(f"render parity {view} {k}: max |card - cpu| {e:.3g} (tol {tol})")
            if not e <= tol:
                fail(f"card render ({view}) differs from the CPU plain render in {k}: "
                     f"{e} > {tol}")
        if not torch.equal(card["fore_valid"].cpu(), plain["fore_valid"]):
            fail(f"card and CPU renders ({view}) disagree on which rays hit the scene")

    for r in rows:
        t_bytes = r.pop("bytes") / HBM_BYTES_PER_S * 1e3
        t_ops = r.pop("ops") / F32_OPS_PER_S * 1e3
        r["bound_ms"] = max(t_bytes, t_ops)
        r["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
