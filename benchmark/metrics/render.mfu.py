"""render.mfu: the model operations of the window's frames (the rows their
rays need, ``counts/render.py``) over the window's seconds, as a share of
the H100's TF32 peak."""

from benchmark.counts import peaks


def read(ctx):
    if not ctx.get("frame_flops") or not ctx.get("window_s"):
        return None
    return 100.0 * sum(ctx["frame_flops"]) / ctx["window_s"] / peaks.TF32_FLOPS
