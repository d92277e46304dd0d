from portbench import work


def read(ctx, table):
    """Model operations of the window's images over its wall time, against
    the published dense peak of the cell's compute type (bf16: 989 TFLOP/s;
    float32: TF32's 495). An image counts table["forwards"] forwards'
    operations (training: 3, forward and backward, the remat recompute not
    counted); the head counts unless the cell extracts features."""
    if ctx.trace is None:
        return None
    head = ctx.traffic["entry"] != "extract_features"
    flops = table["forwards"] * work.forward_flops(ctx.config, ctx.tokens, head)
    rate = ctx.window.images * flops / ctx.window.wall_s
    return 100.0 * rate / work.PEAK_FLOPS[ctx.traffic["dtype"]]
