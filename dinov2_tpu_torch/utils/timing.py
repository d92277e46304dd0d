"""Wall-clock timing closed by a device synchronize (port of
dinov2_tpu/utils/timing.py): PyTorch returns before a CUDA device finishes,
so the clock is read only after torch.cuda.synchronize().

`span(name)` marks a host range on torch's profiler and does nothing else:
it shows in a trace exactly when a profiler runs (torch.profiler,
`cli.inference --profile DIR`). It is an ordinary host operation there, on the
calling thread and the profiler's clock beside the device's activities;
`torch.profiler.record_function` would be a user annotation instead, which
trace readers that drop their own annotations drop too.
"""

from __future__ import annotations

import time

import torch

try:
    from torch._C._profiler import _RecordFunctionFast
except ImportError as e:  # no silent fall back to record_function: see above
    raise ImportError(
        "dinov2_tpu_torch.utils.timing needs torch._C._profiler._RecordFunctionFast "
        f"(torch 2.2 or later; this is torch {torch.__version__})"
    ) from e


def span(name: str) -> _RecordFunctionFast:
    """A context manager: the block as the host range `name` on torch's
    profiler (about 1 µs with no profiler running)."""
    return _RecordFunctionFast(name)


def _wait_for(device) -> None:
    """Synchronize a CUDA device; None or the CPU has nothing to wait for."""
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def time_blocked(fn, *args, device=None, **kwargs):
    """Run fn, wait for `device` (a CUDA device: synchronize; None or the
    CPU: nothing to wait for), return (outputs, elapsed_ms)."""
    start = time.perf_counter()
    out = fn(*args, **kwargs)
    _wait_for(device)
    return out, (time.perf_counter() - start) * 1e3
