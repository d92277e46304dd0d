from portbench import spans


def read(ctx, table):
    """Wall ms a call (a step) that the union of the program's host spans
    in table["spans"] covers, on the trace's clock. None without a trace or
    where none of them is in it (a program without these spans)."""
    if ctx.trace is None:
        return None
    ns = spans.covered_ns(ctx.trace, table["spans"])
    return None if ns is None else ns / 1e6 / ctx.trace.calls
