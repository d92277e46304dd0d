from portbench import spans


def read(ctx, table):
    """Device-idle ms a call (a step) in the gaps between the device's busy
    intervals whose middle lies in one of the program's host spans in
    table["spans"], that span being the innermost of the program's spans
    open there. None without a trace or where none of them is in it."""
    if ctx.trace is None:
        return None
    ns = spans.idle_ns(ctx.trace, table["spans"])
    return None if ns is None else ns / 1e6 / ctx.trace.calls
