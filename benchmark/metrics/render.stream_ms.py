"""render.stream_ms: per frame, the "slots", "sort_pack" and "unsort"
stages (device events at the renderer's marks), averaged over the
window's frames."""


def read(ctx):
    ms = ctx.get("stage_ms", {})
    parts = [ms.get(k) for k in ("slots", "sort_pack", "unsort")]
    return None if any(p is None for p in parts) else sum(parts)
