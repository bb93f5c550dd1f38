"""Training cells: ``train_step`` of one tile in a closed loop.

Set-up builds the kernels, draws the tile's weights from the seed, builds
the program's field, state and data, and starts the state at the
configuration's ``start_step``. It then drives that same state through the
first three steps, through the window's own call and batches: they warm
up every shape the window uses and give the readings the reference is
held to (each step's loss, the first step's gradient as Adam took it,
and the change of every parameter after the third). The window steps on
from there until ``seconds`` have passed and the device is done;
``train_rays_per_s`` is every ray of its steps over its seconds.

After the window (and, in a traced run, the stage spans and two profiled
stretches of steps), the program's state is freed and the reference
follows the same three steps from the same weights and batches.
"""

from __future__ import annotations

import gc
import statistics
import sys
import time

import torch

from benchmark import generator, harness, inputs
from benchmark.counts import train as counts
from benchmark.reference import field as F
from benchmark.reference import train as ref

N_CHECKED = 3  # steps the reference follows
CHECKS = ("loss", "grad", "change")  # the numbers compared, each with its limit
B1_ADAM = 0.9  # Adam's first-moment decay in every group


def program_config(job):
    """The port's config tree and ``TrainConfig`` for the cell."""
    from scanerf_tpu_torch import config as pcfg
    from scanerf_tpu_torch.train.tile import TrainConfig

    cfg = pcfg.default_config()
    cfg.deep_update(job.config["config"])
    cfg.TRAINING.BS_LOG2DIM = job.traffic["batch_log2"]
    return cfg, TrainConfig.from_cfg(cfg)


def program_leaves(state) -> dict:
    """{leaf name: tensor} of the program's trainables, named as the
    reference names its own."""
    from scanerf_tpu_torch.train import tile

    g = tile.group_leaves(state.params)
    names = [f"{n}.{k}" for n in F.DECODER_SHAPES for k in ("w", "b")]
    return {"hash": g["hash"][0], **dict(zip(names, g["decoder"])), "cam": g["cam"][0]}


def initial_leaves(job, n_cam: int) -> dict:
    """The weights every run starts from, drawn again from the seed."""
    table, dec = inputs.train_weights(job.seed, job.config, job.device)
    d = F.unpack_decoder(dec)
    out = {"hash": table}
    for n in F.DECODER_SHAPES:
        for k in ("w", "b"):
            out[f"{n}.{k}"] = d[n][k]
    out["cam"] = torch.zeros((n_cam, 6), device=job.device)
    return out


def norm64(t: torch.Tensor) -> float:
    """The L2 norm of ``t`` in f64, a row at a time."""
    rows = t.reshape(t.shape[0], -1) if t.dim() > 1 else t.reshape(1, -1)
    return float(torch.sqrt(sum((r.double() ** 2).sum() for r in rows)))


def leaf_gaps(prog: dict, refv: dict, leaves) -> dict:
    """Each leaf's |norm - reference norm| over the larger of the leaf's
    reference norm and the median leaf's."""
    med = statistics.median(refv[k] for k in leaves)
    return {k: abs(prog[k] - refv[k]) / max(refv[k], med, 1e-30) for k in leaves}


def gaps(got, want) -> dict:
    """The numbers a training cell compares, from (losses, first gradient
    norms, change norms) of the program (or a stand-in) and of the
    reference: the worst step's relative loss gap and the worst leaf's
    norm gap (``leaf_gaps``); leaves whose reference gradient is under a
    thousandth of the median leaf's move by round-off alone and are left
    out of the change. Under "worst" the leaf each leaf gap came from."""
    (lp, gp, cp), (lr, gr, cr) = got, want
    med = statistics.median(gr.values())
    moved = [k for k in gr if gr[k] >= 1e-3 * med]
    g, c = leaf_gaps(gp, gr, list(gr)), leaf_gaps(cp, cr, moved)
    return {"loss": max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(lp, lr)),
            "grad": max(g.values()), "change": max(c.values()),
            "worst": {"grad": max(g, key=g.get), "change": max(c, key=c.get)}}


def build_program(job, scene, cfg, tc):
    from scanerf_tpu_torch.models import field
    from scanerf_tpu_torch.train import cameras, tile

    dev = job.device
    t = [time.perf_counter()]
    fp, fs = field.create_field(
        torch.Generator(device=dev).manual_seed(0), scene["bbox_corner"],
        scene["bbox_size_inner"], log2_hashmap_size=cfg.HASHGRID.LOG2_HASHMAP_SIZE,
        grid_resolution=tuple(job.config["resolutions"]),
        sampler_log2dim=job.config["scene"]["grid_log2dim"], occupied_grid=scene["occupied"],
        device=dev)
    n_cam = scene["images"].shape[0]
    harness.sync(dev)
    t.append(time.perf_counter())
    with torch.no_grad():  # the benchmark's weights, in the program's own tensors
        init = initial_leaves(job, n_cam)
        fp.features.copy_(init["hash"])
        for n in F.DECODER_SHAPES:
            for k in ("w", "b"):
                fp.decoder[n][k].copy_(init[f"{n}.{k}"])
        del init
    harness.sync(dev)
    t.append(time.perf_counter())
    state = tile.create_train_state(fp, fs, n_cam, tc, device=dev)
    state.step = job.config["start_step"]
    for opt in state.optimizers():
        for group in opt.param_groups:
            group["count"] = job.config["start_step"]

    harness.sync(dev)
    t.append(time.perf_counter())

    def dev_t(a, dtype=torch.float32):
        return torch.as_tensor(a, dtype=dtype, device=dev)

    data = tile.TileData(
        images=dev_t(scene["images"]),
        occlusions=torch.ones(scene["images"].shape[:3], dtype=torch.bool, device=dev),
        cameras=cameras.make_cameras(dev_t(scene["ks"]), dev_t(scene["c2ws"])),
        mono_depths=dev_t(scene["depths"]), mono_normals=dev_t(scene["normals"]))
    harness.sync(dev)
    t.append(time.perf_counter())
    print("[train] state: create_field {:.3f} s, the seed's weights {:.3f} s, "
          "create_train_state {:.3f} s, data {:.3f} s".format(
              *[b - a for a, b in zip(t[:-1], t[1:])]), file=sys.stderr)
    return state, data


def step_call(state, data, tc, batch, n_cam, dev, hook=None):
    from scanerf_tpu_torch.train import tile

    ray_idx, locs = batch
    return tile.train_step(state, data, tc, ray_idx=ray_idx,
                           pixel_locs=locs[None].expand(n_cam, *locs.shape), device=dev,
                           stage_hook=hook)


def backward_rows(job, scene, batch, cfg) -> tuple[int, int]:
    """(live rows, table entries they touch) of one batch's main stream,
    from the benchmark's own rays (the base poses) and samples."""
    dev = job.device
    tile_ref = ref.Tile(scene, dev)
    T = cfg["TRAINING"]
    H = 2 ** cfg["HASHGRID"]["LOG2_HASHMAP_SIZE"]
    seen = torch.zeros((job.config["levels"], H), dtype=torch.bool, device=dev)
    rows = 0
    W = scene["images"].shape[2]
    ray_idx = batch[0]
    xy = torch.stack([(ray_idx % W).float() + 0.5,
                      torch.div(ray_idx, W, rounding_mode="floor").float() + 0.5], -1)
    ro, rd = F.rays_from(xy, tile_ref.rts, tile_ref.ks)
    ro, rd = ro.reshape(-1, 3), rd.reshape(-1, 3)
    blk = job.config["reference"]["block_rays"]
    with torch.no_grad():
        for i in range(0, ro.shape[0], blk):
            o, d = ro[i:i + blk], rd[i:i + blk]
            zf, _, vf = F.fg_samples(o, d, T["NUM_SAMPLE"], tile_ref.grid,
                                     tile_ref.min_bbox + tile_ref.size / 4, tile_ref.size / 2,
                                     T["NUM_MARCH"])
            zb, _, vb = F.bg_samples(o, d, T["NUM_BG_SAMPLE"],
                                     tile_ref.min_bbox + tile_ref.size / 2, tile_ref.size)
            xf = tile_ref.contract_fg(o[vf][:, None, :] + zf[vf][..., None] * d[vf][:, None, :])
            xb = tile_ref.contract_bg(o[vb][:, None, :] + zb[vb][..., None] * d[vb][:, None, :])
            x = torch.cat([xf.reshape(-1, 3), xb.reshape(-1, 3)])
            rows += x.shape[0]
            F.mark_touched(x, tile_ref.res, seen)
    return rows, int(seen.sum())


def run(job) -> harness.Outcome:
    dev = job.device
    if dev.startswith("cuda"):
        from scanerf_tpu_torch import _build

        _build.build()
    t_kernels = time.perf_counter()
    torch.zeros(1, device=dev)  # the CUDA context, timed apart
    harness.sync(dev)
    t_context = time.perf_counter()
    cfg, tc = program_config(job)
    scene = inputs.tile_scene(job.config, dev)
    t_scene = time.perf_counter()
    n_cam, Hh, Ww = scene["images"].shape[:3]
    state, data = build_program(job, scene, cfg, tc)
    harness.sync(dev)
    t_state = time.perf_counter()
    batches = generator.TrainBatches(job.traffic, job.seed, n_cam, Hh, Ww, dev)
    rays_per_step = batches.rays_per_step(n_cam)

    # the first steps: warm-up, and the readings the reference is held to
    first, losses = [], []
    for k in range(N_CHECKED):
        batch = batches.next()
        first.append(batch)
        state, aux = step_call(state, data, tc, batch, n_cam, dev)
        losses.append(aux["total_loss"])
        if k == 0:
            opt_state = {o: s for opt in state.optimizers() for o, s in opt.state.items()}
            grad_p = {}
            for name, p in program_leaves(state).items():
                m = opt_state.get(p, {}).get("exp_avg")
                grad_p[name] = 0.0 if m is None else norm64(m) / (1 - B1_ADAM)
    with torch.no_grad():
        init = initial_leaves(job, n_cam)
        change_p = {k: norm64(p - init[k]) for k, p in program_leaves(state).items()}
        del init
    losses_p = [float(x) for x in losses]
    harness.sync(dev)
    setup_s = time.perf_counter() - job.t_start
    print(f"[train] set-up: to the kernels built {t_kernels - job.t_start:.3f} s, context "
          f"{t_context - t_kernels:.3f} s, scene "
          f"{t_scene - t_context:.3f} s, state {t_state - t_scene:.3f} s, first steps "
          f"{job.t_start + setup_s - t_state:.3f} s", file=sys.stderr)

    # the window
    clock = harness.StageClock(dev) if job.trace else None
    steps, window_losses = 0, []
    t0 = time.perf_counter()
    while True:
        batch = batches.next()
        if clock:
            clock.start()
        state, aux = step_call(state, data, tc, batch, n_cam, dev, clock.mark if clock else None)
        window_losses.append(aux["total_loss"])
        steps += 1
        if time.perf_counter() - t0 >= job.seconds:
            harness.sync(dev)
            break
    window_s = time.perf_counter() - t0
    failed = int((~torch.isfinite(torch.stack(window_losses))).sum())
    out = harness.Outcome(attempted=steps, failed=failed,
                          end_to_end={"train_rays_per_s": steps * rays_per_step / window_s,
                                      "setup_s": setup_s},
                          checks=[], memory_peak=0, context={})
    print(f"[train] setup {setup_s:.3f} s, {steps} steps in {window_s:.3f} s, "
          f"{out.end_to_end['train_rays_per_s']:.1f} rays/s", file=sys.stderr)

    if job.trace:
        ctx = {"step_s": window_s / steps, "stage_ms": clock.spans(), "steps": steps}
        T = cfg.TRAINING
        ctx["step_flops"] = counts.step_flops(
            rays_per_step, T.NUM_SAMPLE, T.NUM_BG_SAMPLE, job.config["levels"],
            cfg.HASHGRID.LOG2_HASHMAP_SIZE, tc.warp_top_k,
            (tc.warp_vis_sample, tc.warp_vis_bg_sample))["total"]
        if dev.startswith("cuda"):
            def steps_of(n):
                def fn(mark):
                    nonlocal state
                    for _ in range(n):
                        b = batches.next()
                        mark("start")
                        state, _ = step_call(state, data, tc, b, n_cam, dev, mark)
                return fn

            prof, wall = harness.profile(steps_of(job.config["trace"]["idle_steps"]), False)
            busy, breakdown = harness.busy_and_breakdown(list(prof.events()))
            out.busy_s, out.window_s, out.breakdown = busy, wall, breakdown
            del prof
            n_stage = job.config["trace"]["stage_steps"]
            prof, _ = harness.profile(steps_of(n_stage), True)
            ctx["stage_kernel_s"] = {k: v / n_stage
                                     for k, v in harness.stage_kernel_s(prof).items()}
            del prof
            print("[train] kernel ms a step by stage: "
                  f"{ {k: round(1e3 * v, 3) for k, v in ctx['stage_kernel_s'].items()} }",
                  file=sys.stderr)
            rows, touched = backward_rows(job, scene, first[0], cfg)
            ctx["backward"] = counts.backward_work(rows, touched)
            ctx["trace_busy_s"], ctx["trace_window_s"] = busy, wall
        out.context = ctx

    out.memory_peak = torch.cuda.max_memory_allocated() if dev.startswith("cuda") else 0
    del state, data, aux, window_losses
    gc.collect()
    if dev.startswith("cuda"):
        torch.cuda.empty_cache()

    t1 = time.perf_counter()
    losses_r, grad_r, change_r = follow(job, scene, cfg, first, n_cam)
    print(f"[train] reference: {time.perf_counter() - t1:.1f} s; losses of the first steps "
          f"{losses_p} (reference {losses_r})", file=sys.stderr)
    lim = job.cell["limits"]
    g = gaps((losses_p, grad_p, change_p), (losses_r, grad_r, change_r))
    out.checks = [harness.Check(k, g[k], lim[k]) for k in CHECKS]
    print(f"[train] worst leaves: {g['worst']}", file=sys.stderr)
    return out


def follow(job, scene, cfg, batches, n_cam, tf32: bool = False, half: bool = False):
    """The reference over ``batches`` from the seed's weights -> (losses,
    first gradient norms by leaf, change norms by leaf after the last).
    ``tf32`` computes it with TF32 products (the lower-precision
    control); ``half`` leaves out the second half of every batch's patches
    (a fault)."""
    dev = job.device
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        recipe = ref.Recipe.from_config(cfg)
        table, dec = inputs.train_weights(job.seed, job.config, dev)
        R = ref.Reference(ref.Tile(scene, dev), recipe, table, dec, job.config["start_step"],
                          block=job.config["reference"]["block_rays"])
        losses, grad_norms = [], None
        for k, (idx, locs) in enumerate(batches):
            if half:
                keep = idx.shape[0] // 8 * 4
                idx, locs = idx[:keep], locs[:keep]
            loss, g = R.grads(idx, locs)
            taken = R.apply(g)
            losses.append(float(loss))
            if k == 0:
                grad_norms = ref.leaf_norms(taken)
        del g, taken
        init = initial_leaves(job, n_cam)
        now = {k: v for k, v in R.leaves().items()}
        with torch.no_grad():
            change = {"hash": [torch.cat([t.reshape(-1) for t in now["hash"]])
                               - init["hash"].reshape(-1)]}
            for k in now:
                if k != "hash":
                    change[k] = [now[k][0] - init[k]]
        return losses, grad_norms, ref.leaf_norms(change)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
