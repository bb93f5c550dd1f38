"""train.warp_ms: the mean span, over the window's steps, from the step's
"losses" mark to its "warp" mark (device events at the marks)."""


def read(ctx):
    return ctx.get("stage_ms", {}).get("warp")
