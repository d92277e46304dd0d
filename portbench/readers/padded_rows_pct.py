import sys


def read(ctx, table):
    """Share of the rows the engine uploaded that are bucket padding:
    100 x DinoEngine.padded_rows / DinoEngine.uploaded_rows, the program's
    counters over the process (set-up's warm-up, the window and the traced
    calls). None where nothing was uploaded, or the engine keeps no such
    counters."""
    module = sys.modules.get("dinov2_tpu_torch.runtime.engine")
    engine = getattr(module, "DinoEngine", None)
    uploaded = getattr(engine, "uploaded_rows", 0)
    if not uploaded:
        return None
    return 100.0 * engine.padded_rows / uploaded
