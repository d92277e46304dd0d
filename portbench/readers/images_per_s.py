def read(ctx, table):
    """Images whose outputs reached the host (training: images of every
    step) over the window's wall time, closed by the last call's result on
    the host (training: a synchronize)."""
    return ctx.window.images / ctx.window.wall_s
