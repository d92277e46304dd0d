from portbench import work


def read(ctx, table):
    """Model operations of the window's images over its wall time, against
    the published dense peak of the cell's compute type (bf16: 989 TFLOP/s;
    float32: TF32's 495). An image counts table["forwards"] forwards'
    operations (training: 3, forward and backward, the remat recompute not
    counted); the head counts unless the cell extracts features. A
    traffic's int8 scheme runs the linears it names W8A8: their operations
    are held against the int8 peak (1979 TOP/s), so that the share is that
    of the least time the chip could take, and is never counted high."""
    if ctx.trace is None:
        return None
    head = ctx.traffic["entry"] != "extract_features"
    flops = table["forwards"] * work.forward_flops(ctx.config, ctx.tokens, head)
    peak = work.PEAK_FLOPS[ctx.traffic["dtype"]]
    if "int8" not in ctx.traffic:
        rate = ctx.window.images * flops / ctx.window.wall_s
        return 100.0 * rate / peak
    coded = table["forwards"] * work.int8_flops(ctx.config, ctx.tokens, head,
                                                ctx.traffic["int8"]["activations"])
    least_s = (flops - coded) / peak + coded / work.PEAK_FLOPS["int8"]
    return 100.0 * ctx.window.images * least_s / ctx.window.wall_s
