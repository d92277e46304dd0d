"""Wall-clock timing closed by a device synchronize (port of
dinov2_tpu/utils/timing.py): PyTorch returns before a CUDA device finishes,
so the clock is read only after torch.cuda.synchronize()."""

from __future__ import annotations

import time

import torch


def time_blocked(fn, *args, device=None, **kwargs):
    """Run fn, wait for `device` (a CUDA device: synchronize; None or the
    CPU: nothing to wait for), return (outputs, elapsed_ms)."""
    start = time.perf_counter()
    out = fn(*args, **kwargs)
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    return out, (time.perf_counter() - start) * 1e3
