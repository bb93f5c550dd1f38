#!/usr/bin/env python3
"""Readings of a cell's lower-precision control and faults, at the cell's
own size, for setting the limits of its checks.

    python3 benchmark/control.py --workload <cell> --seeds <n> [<n> ...]

The control is the reference put in the program's place and computed with
TF32 products, the next precision below the f32 the configurations state
(the reference itself runs with TF32 off). For a training cell it also
reads the fault "half of the batch left out" (the reference on each
batch's first half of patches, the mean over those), and prints what a
state left unchanged reads (1 on the change, by construction). For a
render cell it reads the control on the first ``FRAMES`` frames of the
seed's order, about what a 10-second window shows. One JSON line a seed;
nothing of the program runs, so it runs beside no program state.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAMES = 6


def readings(job, frames: int) -> dict:
    from benchmark import generator, inputs
    from benchmark.drivers import render as rdrv
    from benchmark.drivers import train as tdrv

    if job.config["driver"] == "train":
        cfg, _ = tdrv.program_config(job)
        scene = inputs.tile_scene(job.config, job.device)
        n_cam, H, W = scene["images"].shape[:3]
        gen = generator.TrainBatches(job.traffic, job.seed, n_cam, H, W, job.device)
        batches = [gen.next() for _ in range(tdrv.N_CHECKED)]
        base = tdrv.follow(job, scene, cfg, batches, n_cam)
        out = {}
        for name, kw in (("tf32", {"tf32": True}), ("half_batch", {"half": True})):
            got = tdrv.follow(job, scene, cfg, batches, n_cam, **kw)
            out[name] = tdrv.gaps(got, base)
        out["unchanged"] = {"change": 1.0}
        return out
    mix = job.traffic
    city = inputs.city_scene(job.config, job.device)
    poses = generator.path_poses(mix)
    order = generator.frame_order(mix, job.seed)
    shown = [poses[order[i % len(order)]] for i in range(frames)]
    return {"tf32": rdrv.compare(job, city, mix, generator.intrinsics(mix), shown,
                                 [None] * len(shown), tf32=True)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    a = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    from benchmark import generator, harness

    entry = {w["name"]: w for w in harness.manifest()["workloads"]}[a.workload]
    for seed in a.seeds:
        t0 = time.perf_counter()
        job = harness.Job(cell=harness.load_json("workloads", a.workload),
                          config=harness.load_json("configs", entry["config"]),
                          traffic=generator.load(entry["traffic"]), seed=seed, seconds=0.0,
                          trace=False, device="cuda", t_start=t0)
        print(json.dumps({"workload": a.workload, "seed": seed,
                          "readings": readings(job, FRAMES),
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
