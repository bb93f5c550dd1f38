"""render.sample_ms: per frame, the "sample" stages (device events at the
renderer's marks), averaged over the window's frames."""


def read(ctx):
    return ctx.get("stage_ms", {}).get("sample")
