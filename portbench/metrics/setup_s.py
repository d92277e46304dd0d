def read(ctx):
    """Seconds from the process's start to the end of set-up."""
    return ctx.setup_s
