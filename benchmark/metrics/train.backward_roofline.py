"""train.backward_roofline: the least time of the backward decode's work
(``counts/train.py::backward_work``) over the device time of the kernels
launched in the step's "backward" stage (profiled, stage by stage)."""


def read(ctx):
    busy = ctx.get("stage_kernel_s", {}).get("backward")
    if "backward" not in ctx or not busy:
        return None
    return 100.0 * ctx["backward"]["min_s"] / busy
