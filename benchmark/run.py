#!/usr/bin/env python3
"""Run one cell of the benchmark of ``scanerf_tpu_torch`` on this machine.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell (``BENCHMARK.json``'s ``workloads``)
names its configuration (``benchmark/configs/<name>.json``, whose
``driver`` names ``benchmark/drivers/<driver>.py``) and its traffic mix
(``benchmark/traffic/<name>.json``); ``benchmark/workloads/<cell>.json``
holds the limits its outputs are held to. With ``--trace 0`` the result
line carries the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics, each read by ``benchmark/metrics/<name>.py``.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` (with ``busy_s`` and
``window_s`` when traced), ``breakdown`` when traced, and last ``checks``,
every number compared with its limit (also the last lines of standard
error). Without as many CUDA devices as the cell asks for, or with JAX or
the JAX package loaded once the window has closed, the run prints no
result and exits with a non-zero code.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "scanerf_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def cell_metrics(man: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics a cell reports: its end-to-end ones untraced, its
    per-layer ones traced."""
    e2e = [m for m in man["end_to_end"] if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}

    def reported(m):
        return cell in m["workloads"] if "workloads" in m else m["moves"] in names

    return [m for m in man["per_layer"] if reported(m)]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--device", default="cuda", help=argparse.SUPPRESS)  # tests: "cpu"
    a = p.parse_args(argv)
    sys.path.insert(0, ROOT)

    import torch

    from benchmark import generator, harness

    man = harness.manifest()
    cells = {w["name"]: w for w in man["workloads"]}
    if a.workload not in cells:
        print(f"unknown workload {a.workload!r}; the cells are {sorted(cells)}", file=sys.stderr)
        return 2
    entry = cells[a.workload]
    if a.device == "cuda" and (not torch.cuda.is_available()
                               or torch.cuda.device_count() < entry["chips"]):
        print(f"{a.workload} needs {entry['chips']} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    cell = harness.load_json("workloads", a.workload)
    config = harness.load_json("configs", entry["config"])
    job = harness.Job(cell=cell, config=config, traffic=generator.load(entry["traffic"]),
                      seed=a.seed, seconds=a.seconds, trace=bool(a.trace), device=a.device,
                      t_start=T_START)
    outcome = harness.load_module("drivers", config["driver"]).run(job)

    bad = forbidden_modules()
    if bad:
        print(f"loaded in this process: {', '.join(bad)} (JAX or the JAX package)",
              file=sys.stderr)
        return 4

    metrics = {}
    for m in cell_metrics(man, a.workload, bool(a.trace)):
        value = outcome.end_to_end.get(m["name"]) if not a.trace else \
            harness.load_module("metrics", m["name"]).read(outcome.context)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = harness.device_info(entry["chips"], outcome.memory_peak)
    if a.trace and outcome.busy_s is not None:
        device.update(busy_s=outcome.busy_s, window_s=outcome.window_s)
    line = {"correct": all(c.ok() for c in outcome.checks) and bool(outcome.checks),
            "attempted": outcome.attempted, "failed": outcome.failed, "metrics": metrics,
            "device": device}
    if a.trace and outcome.breakdown is not None:
        line["breakdown"] = outcome.breakdown
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in outcome.checks}
    for c in outcome.checks:
        print(f"check {c.name}: {c.value!r} (limit {c.limit!r})", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
