"""Render cells: ``render_image`` of a city's tiles, one frame after another
(closed loop), each from the next pose of the mix's path.

Set-up builds the kernels, makes the city (boxes, occupancy shells,
tables and decoders from the seed, the tables drawn on the device) and
renders one frame, which warms every shape the window uses (every frame
has the same size, so the same chunks). The window renders frames until
``seconds`` have passed; ``render_rays_per_s`` is every pixel of its
frames over its seconds. Afterwards the scene is freed, and the
reference renders a sample of each frame's pixels, drawn from the seed,
from the same weights.
"""

from __future__ import annotations

import dataclasses
import gc
import sys
import time

import numpy as np
import torch

from benchmark import generator, harness, inputs
from benchmark.counts import render as counts
from benchmark.reference import field as F
from benchmark.reference import render as ref

CHECKS = ("rgb", "depth")  # the numbers compared, each with its limit


def build_scene(job, city):
    """The program's scene: boxes, grids and decoders through
    ``scene_from_arrays``; its tables are the benchmark's, made on the
    device (``scene_from_arrays`` takes host arrays only, so it is given
    placeholder tables of the least windowed size, which are replaced)."""
    from scanerf_tpu_torch.render import renderer

    cfg, dev = job.config, job.device
    T, L = city["corners"].shape[0], cfg["levels"]
    tables, decs = inputs.city_weights(job.seed, cfg, dev)
    small = np.zeros((T, L, cfg["placeholder_entries"], 2), np.float32)
    scene = renderer.scene_from_arrays(small, decs.cpu().numpy(), city["resolutions"],
                                       city["corners"], city["sizes"],
                                       ref.union_grids(city["corners"], city["sizes"],
                                                       city["grids"]).cpu().numpy(),
                                       device=dev)
    return dataclasses.replace(scene, features_flat=tables.contiguous(),
                               table_size=2 ** cfg["log2_table"])


def frame(scene, mix, K, c2w, dev, hook=None):
    from scanerf_tpu_torch.render import renderer

    kw = {"stage_hook": hook} if hook else {}
    return renderer.render_image(scene, K, c2w, mix["height"], mix["width"], chunk=mix["chunk"],
                                 num_sample=mix["num_sample"], num_bg_sample=mix["num_bg_sample"],
                                 num_march=mix["num_march"], device=dev, **kw)


def frame_rows(job, counter, mix, K, c2w, seen=None) -> tuple[int, int]:
    """(rows, rays that meet occupied cells) of a frame (see
    ``counts/render.py``), counted from the benchmark's own samples on
    ``counter``, a weightless reference city; with ``seen`` [T, L, H] the
    table entries the rows touch are marked too."""
    ro, rd = pixel_rays(mix, K, c2w, np.arange(mix["height"] * mix["width"]), job.device)
    rows = hits = 0
    for i in range(0, ro.shape[0], mix["chunk"]):
        r, h = ref.needed_rows(counter, ro[i:i + mix["chunk"]], rd[i:i + mix["chunk"]],
                               mix["num_sample"], mix["num_bg_sample"], mix["num_march"],
                               seen=seen)
        rows, hits = rows + r, hits + h
    return rows, hits


def pixel_rays(mix, K, c2w, pix, dev):
    """Rays [n, 3] of pixel indices ``pix`` into the frame."""
    W = mix["width"]
    pix = torch.as_tensor(pix, device=dev)
    xy = torch.stack([(pix % W).float() + 0.5,
                      torch.div(pix, W, rounding_mode="floor").float() + 0.5], -1)
    w2c = F.pose_invert(torch.as_tensor(c2w, device=dev))
    return F.rays_from(xy, w2c, torch.as_tensor(K, device=dev))


def city_ref(job, city, weights=True) -> ref.City:
    """The reference's city: its own union grid, and the seed's weights
    (or none, to count rows)."""
    tables, decs = inputs.city_weights(job.seed, job.config, job.device) if weights \
        else (None, None)
    return ref.City(city["corners"], city["sizes"], city["grids"], city["resolutions"], tables,
                    decs, job.device)


def run(job) -> harness.Outcome:
    dev, mix = job.device, job.traffic
    if dev.startswith("cuda"):
        from scanerf_tpu_torch import _build

        _build.build()
    t_kernels = time.perf_counter()
    torch.zeros(1, device=dev)  # the CUDA context, timed apart
    harness.sync(dev)
    t_context = time.perf_counter()
    city = inputs.city_scene(job.config, dev)
    scene = build_scene(job, city)
    harness.sync(dev)
    t_scene = time.perf_counter()
    K = generator.intrinsics(mix)
    poses = generator.path_poses(mix)
    order = generator.frame_order(mix, job.seed)
    frame(scene, mix, K, poses[order[-1]], dev)  # warm-up: every chunk shape of a frame
    harness.sync(dev)
    setup_s = time.perf_counter() - job.t_start
    print(f"[render] set-up: to the kernels built {t_kernels - job.t_start:.3f} s, context "
          f"{t_context - t_kernels:.3f} s, scene "
          f"{t_scene - t_context:.3f} s, warm-up frame {job.t_start + setup_s - t_scene:.3f} s",
          file=sys.stderr)

    clock = harness.StageClock(dev) if job.trace else None
    hook = None
    if clock:
        def hook(name):
            clock.mark(name)
            if name == "blend":  # a chunk's last stage: the next chunk's span starts here
                clock.groups[-1].append(("start", clock.groups[-1][-1][1]))
    shown, outs = [], []
    t0 = time.perf_counter()
    while True:
        c2w = poses[order[len(shown) % len(order)]]
        if clock:
            clock.start()
        outs.append(frame(scene, mix, K, c2w, dev, hook))
        shown.append(c2w)
        if time.perf_counter() - t0 >= job.seconds:
            break
    window_s = time.perf_counter() - t0
    n_pix = mix["height"] * mix["width"]
    failed = sum(int(not (np.isfinite(o["rgb"]).all() and np.isfinite(o["depth"]).all()))
                 for o in outs)
    out = harness.Outcome(attempted=len(outs), failed=failed,
                          end_to_end={"render_rays_per_s": len(outs) * n_pix / window_s,
                                      "setup_s": setup_s},
                          checks=[], memory_peak=0, context={})
    print(f"[render] setup {setup_s:.3f} s, {len(outs)} frames in {window_s:.3f} s, "
          f"{out.end_to_end['render_rays_per_s']:.1f} rays/s", file=sys.stderr)

    if job.trace:
        spans = clock.spans()
        ctx = {"frames": len(outs), "window_s": window_s,
               "stage_ms": {k: v for k, v in spans.items() if k != "start"}}
        if dev.startswith("cuda"):
            def frames_of(n):
                def fn(mark):
                    for i in range(n):
                        mark("start")
                        frame(scene, mix, K, shown[i % len(shown)], dev, mark)
                return fn

            prof, wall = harness.profile(frames_of(1), False)
            busy, breakdown = harness.busy_and_breakdown(list(prof.events()))
            out.busy_s, out.window_s, out.breakdown = busy, wall, breakdown
            del prof
            prof, _ = harness.profile(frames_of(1), True)
            ctx["stage_kernel_s"] = harness.stage_kernel_s(prof)
            del prof
            print("[render] kernel ms a frame by stage: "
                  f"{ {k: round(1e3 * v, 3) for k, v in ctx['stage_kernel_s'].items()} }",
                  file=sys.stderr)
            ctx["trace_busy_s"], ctx["trace_window_s"] = busy, wall
        out.context = ctx

    out.memory_peak = torch.cuda.max_memory_allocated() if dev.startswith("cuda") else 0
    del scene
    gc.collect()
    if dev.startswith("cuda"):
        torch.cuda.empty_cache()

    if job.trace:
        t1 = time.perf_counter()
        counter = city_ref(job, city, weights=False)
        rows = [frame_rows(job, counter, mix, K, c2w) for c2w in shown]
        out.context["frame_flops"] = [r * counts.row_flops(job.config["levels"])
                                      for r, _ in rows]
        if dev.startswith("cuda"):  # the profiled frames were the first shown
            T = city["corners"].shape[0]
            seen = torch.zeros((T, job.config["levels"], 2 ** job.config["log2_table"]),
                               dtype=torch.bool, device=dev)
            frame_rows(job, counter, mix, K, shown[0], seen)
            out.context["decode"] = counts.decode_work(rows[0][0], int(seen.sum()),
                                                       job.config["levels"])
            del seen
        hit = sum(h for _, h in rows) / (len(rows) * n_pix)
        print(f"[render] rows counted in {time.perf_counter() - t1:.1f} s: "
              f"{[r for r, _ in rows]}; rays meeting occupied cells {100 * hit:.2f}%",
              file=sys.stderr)

    t1 = time.perf_counter()
    gaps = compare(job, city, mix, K, shown, outs)
    print(f"[render] reference: {time.perf_counter() - t1:.1f} s", file=sys.stderr)
    lim = job.cell["limits"]
    out.checks = [harness.Check(k, gaps[k], lim[k]) for k in CHECKS]
    return out


def sample_pixels(job, mix, n_frames):
    """The pixels of each frame the reference checks, drawn from the seed."""
    rng = np.random.default_rng((int(job.seed) * 31 + 7) % 2**63)
    n = mix["height"] * mix["width"]
    return [rng.choice(n, size=min(job.config["reference"]["pixels_per_frame"], n),
                       replace=False) for _ in range(n_frames)]


def compare(job, city, mix, K, shown, outs, tf32: bool = False) -> dict:
    """The widest gaps between the frames' sampled pixels and the
    reference's: rgb (absolute) and depth (relative to the reference's,
    floored at 1e-3). ``tf32`` computes the reference with TF32 products
    and holds it against the f32 reference instead (the control; ``outs``
    is then unused)."""
    dev = job.device
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    c = city_ref(job, city)
    gaps = {"rgb": 0.0, "depth": 0.0}
    try:
        for c2w, pix, o in zip(shown, sample_pixels(job, mix, len(shown)), outs):
            ro, rd = pixel_rays(mix, K, c2w, pix, dev)
            res = []
            for allow in ((tf32, False) if tf32 else (False,)):
                torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = allow
                parts = [ref.render_rays(c, ro[i:i + mix["chunk"]], rd[i:i + mix["chunk"]],
                                         mix["num_sample"], mix["num_bg_sample"],
                                         mix["num_march"])
                         for i in range(0, ro.shape[0], mix["chunk"])]
                res.append({k: torch.cat([p[k] for p in parts]).cpu().numpy() for k in parts[0]})
            if tf32:
                got = res[0]
                want = res[1]
            else:
                got = {"rgb": o["rgb"].reshape(-1, 3)[pix], "depth": o["depth"].reshape(-1)[pix]}
                want = res[0]
            gaps["rgb"] = max(gaps["rgb"], float(np.abs(got["rgb"] - want["rgb"]).max()))
            rel = np.abs(got["depth"] - want["depth"]) / np.maximum(np.abs(want["depth"]), 1e-3)
            gaps["depth"] = max(gaps["depth"], float(rel.max()))
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
    return gaps
