"""train.mfu: the step's model operations (``counts/train.py``) over the
window's mean step time, as a share of the H100's TF32 peak."""

from benchmark.counts import peaks


def read(ctx):
    if "step_flops" not in ctx or not ctx.get("step_s"):
        return None
    return 100.0 * ctx["step_flops"] / ctx["step_s"] / peaks.TF32_FLOPS
