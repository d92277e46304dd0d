from portbench import trace


def read(ctx, table):
    """Device ms a call (a step) of kernels outside the port's dinov2::
    namespace: PyTorch's and cuBLAS's. Copies and sets are not kernels."""
    if ctx.trace is None or not ctx.trace.device:
        return None
    ns = sum(a.ns for a in ctx.trace.kernels if not trace.is_port_kernel(a.name))
    return ns / 1e6 / ctx.trace.calls
