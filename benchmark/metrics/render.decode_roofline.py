"""render.decode_roofline: the least time of a frame's decode
(``counts/render.py::decode_work``) over the device time of the kernels
launched in its "decode" stages (one profiled frame, stage by stage)."""


def read(ctx):
    busy = ctx.get("stage_kernel_s", {}).get("decode")
    if "decode" not in ctx or not busy:
        return None
    return 100.0 * ctx["decode"]["min_s"] / busy
