def read(ctx, table):
    """Device ms a call of host-device copies (Memcpy HtoD and DtoH)."""
    if ctx.trace is None or not ctx.trace.device:
        return None
    return sum(a.ns for a in ctx.trace.host_copies) / 1e6 / ctx.trace.calls
