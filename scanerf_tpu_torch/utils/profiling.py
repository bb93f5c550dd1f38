"""Profiling and tracing harness (counterpart of
``scanerf_tpu/utils/profiling.py``).

- :func:`force_sync` waits for the work queued on the devices of the
  given tensors (``torch.cuda.synchronize``); on the GPU no host fetch
  is needed to know that the work is done, so a span's host clock
  covers it;
- :func:`timed`, a context manager: the wall-clock span of a block,
  synchronised on the given tensors before the clock stops;
- :func:`trace`: a ``torch.profiler`` trace of the block (CPU and, when
  present, CUDA activity), written as a Chrome trace (``trace.json``
  under ``logdir``; open it in chrome://tracing or Perfetto).
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


def _tensors(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _tensors(v)


def force_sync(*arrays) -> None:
    """Wait for the queued work of every CUDA device that holds one of
    ``arrays`` (tensors, or dicts / lists of them); CPU tensors need no
    wait."""
    devices = {t.device for a in arrays for t in _tensors(a) if t.is_cuda}
    for dev in devices:
        torch.cuda.synchronize(dev)


class Span:
    def __init__(self, name: str):
        self.name = name
        self.elapsed = 0.0


@contextlib.contextmanager
def timed(name: str, *sync_arrays, log: bool = True):
    """``with timed("render", out) as span: ...`` -> ``span.elapsed``
    seconds, ``sync_arrays`` synchronised before the clock stops (pass
    the block's outputs; they may be filled in inside the block)."""
    span = Span(name)
    t0 = time.perf_counter()
    try:
        yield span
    finally:
        force_sync(*sync_arrays)
        span.elapsed = time.perf_counter() - t0
        if log:
            print(f"[{name}] {span.elapsed * 1e3:.2f} ms")


@contextlib.contextmanager
def trace(logdir: str):
    """``torch.profiler`` trace of the block, written to
    ``logdir/trace.json`` (Chrome trace format); yields the profiler
    (``key_averages()`` gives the per-kernel table)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
