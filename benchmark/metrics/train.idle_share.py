"""train.idle_share: the share of a profiled stretch of steps in which no
device operation ran."""


def read(ctx):
    if not ctx.get("trace_window_s") or ctx.get("trace_busy_s") is None:
        return None
    return 100.0 * (1.0 - ctx["trace_busy_s"] / ctx["trace_window_s"])
