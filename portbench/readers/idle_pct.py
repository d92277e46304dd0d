def read(ctx, table):
    """Share of the profiled window in which no device activity runs: 1 -
    the union of kernels, copies and sets over the window's length, both
    from the trace (the result line's busy_s and window_s). The profiler's own
    host cost is inside the window."""
    if ctx.trace is None or not ctx.trace.device:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_ns() / ctx.trace.window_ns)
