"""What every cell's run shares: the manifest and the files it names, the
stage clock, the profiler's reduction to busy time, idle gaps and per-stage
kernel time, and the device's description.

A per-layer metric's reader, ``metrics/<name>.py``, defines
``read(ctx) -> float | None`` over the context dict its cell's driver
filled (None where it finds nothing to read); a cell's driver,
``drivers/<name>.py``, defines ``run(job) -> Outcome`` and ``CHECKS``, the
names of the numbers it compares. Both are found by name.
"""

from __future__ import annotations

import bisect
import dataclasses
import importlib.util
import json
import math
import os
import subprocess
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
MARK = "bench:"  # prefix of the stage markers in a profile


def manifest() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def load_json(kind: str, name: str) -> dict:
    with open(os.path.join(HERE, kind, f"{name}.json")) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``benchmark/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = os.path.join(HERE, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"benchmark_{kind}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Job:
    """One run: the cell, its configuration file and traffic mix, the seed,
    the window's length, whether it is traced, and the device."""

    cell: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: str
    t_start: float  # perf_counter at the process's start


@dataclasses.dataclass
class Check:
    """One number compared with its limit; a value that is not finite is
    kept as 1e300 (the result line stays JSON) and fails."""

    name: str
    value: float
    limit: float

    def __post_init__(self):
        self.value = float(self.value)
        if not math.isfinite(self.value):
            self.value = 1e300

    def ok(self) -> bool:
        return self.value <= self.limit


@dataclasses.dataclass
class Outcome:
    attempted: int
    failed: int
    end_to_end: dict  # name -> value
    checks: list
    memory_peak: int
    context: dict  # what the per-layer readers read (traced runs)
    busy_s: float | None = None
    window_s: float | None = None
    breakdown: dict | None = None


# ---------------------------------------------------------------------------
# stage spans by device events
# ---------------------------------------------------------------------------

class StageClock:
    """Records a device event (a host time on the CPU) at each stage mark;
    ``spans()`` gives each stage's time since the previous mark, in ms,
    summed per stage over a group (a step or a frame) and averaged over the
    groups."""

    def __init__(self, device: str):
        self.cuda = device.startswith("cuda")
        self.groups: list[list] = []

    def start(self):
        self.groups.append([("start", self._stamp())])

    def mark(self, name: str):
        self.groups[-1].append((name, self._stamp()))

    def _stamp(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def spans(self) -> dict:
        if self.cuda:
            torch.cuda.synchronize()
        total: dict = {}
        for g in self.groups:
            for (_, a), (name, b) in zip(g[:-1], g[1:]):
                ms = a.elapsed_time(b) if self.cuda else (b - a) * 1e3
                total[name] = total.get(name, 0.0) + ms
        n = max(len(self.groups), 1)
        return {k: v / n for k, v in total.items()}


# ---------------------------------------------------------------------------
# the profiler
# ---------------------------------------------------------------------------

def profile(fn, stage_sync: bool):
    """Run ``fn(mark)`` under torch.profiler, where ``mark(name)`` drops a
    marker into the trace (after a device synchronise when ``stage_sync``)
    -> (the profiler, wall seconds)."""
    from torch.profiler import ProfilerActivity, record_function
    from torch.profiler import profile as tprofile

    def mark(name):
        if stage_sync:
            torch.cuda.synchronize()
        with record_function(MARK + name):
            pass

    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn(mark)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return prof, wall


def _is_kernel(ev) -> bool:
    return ev.device_type.name == "CUDA" and not getattr(ev, "is_user_annotation", False) \
        and ev.time_range.elapsed_us() > 0


def kernels(events) -> list:
    """(start us, end us, name) of every device activity, by start."""
    return sorted((e.time_range.start, e.time_range.end, e.name) for e in events if _is_kernel(e))


def markers(events) -> list:
    """(time us, stage) of the stage markers, by time."""
    return sorted((e.time_range.start, e.name[len(MARK):]) for e in events
                  if e.device_type.name == "CPU" and e.name.startswith(MARK))


def busy_intervals(ks) -> list:
    """The union of the device activities' intervals."""
    out = []
    for s, e, _ in ks:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def stage_kernel_s(prof) -> dict:
    """Device seconds of the kernels launched in each stage of a profile
    taken with a synchronise before each marker: a kernel belongs to the
    stage whose marker is the first after the CUDA runtime call that
    launched it (same correlation id); a kernel whose launch the trace
    lacks, to the stage whose marker is the first after its start."""
    launch, ks, ms = {}, [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type().name == "CUDA":
            ks.append((e.correlation_id(), e.start_ns(), e.duration_ns() * 1e-9))
        elif name.startswith(MARK):
            ms.append((e.start_ns(), name[len(MARK):]))
        elif name.startswith("cu"):
            launch[e.correlation_id()] = e.start_ns()
    ms.sort()
    times = [t for t, _ in ms]
    out: dict = {}
    for corr, start, dur in ks:
        j = bisect.bisect_left(times, launch.get(corr, start))
        if j < len(ms):
            out[ms[j][1]] = out.get(ms[j][1], 0.0) + dur
    return out


def busy_and_breakdown(events) -> tuple[float, dict]:
    """(device busy seconds, breakdown): the ten device operations that
    took most time, and the ten longest idle gaps, each named by the stage
    the host was in and the innermost host operation running at its
    middle."""
    ks = kernels(events)
    busy = busy_intervals(ks)
    busy_s = sum(e - s for s, e in busy) * 1e-6
    by_name: dict = {}
    for s, e, n in ks:
        by_name[n] = by_name.get(n, 0.0) + (e - s) * 1e-6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(((b[0] - a[1], a[1], b[0]) for a, b in zip(busy[:-1], busy[1:])),
                  reverse=True)[:10]
    host = [(e.time_range.start, e.time_range.end, e.name) for e in events
            if e.device_type.name == "CPU" and not e.name.startswith(MARK)
            and not e.name.startswith("cu") and not e.name.startswith("Activity Buffer")]
    ms = markers(events)
    named = []
    for dur, a, b in gaps:
        mid = (a + b) / 2
        stage = "start"
        for t, n in ms:
            if t <= mid:
                stage = n
        inner = [(e - s, n) for s, e, n in host if s <= mid <= e]
        op = min(inner)[1] if inner else "host"
        named.append([f"after {stage}: {op}", dur * 1e-6])
    return busy_s, {"device_ops": [[n, s] for n, s in ops], "idle_gaps": named}


# ---------------------------------------------------------------------------
# the device
# ---------------------------------------------------------------------------

def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"not read ({type(e).__name__})"
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() \
        else "not read"


def device_info(count: int, memory_peak: int) -> dict:
    if not torch.cuda.is_available():
        return {"platform": "cpu", "kind": "cpu", "count": count,
                "memory_peak_bytes": memory_peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count,
            "memory_peak_bytes": memory_peak, "power_limit": power_limit()}


def sync(device: str):
    if device.startswith("cuda"):
        torch.cuda.synchronize()
