"""Wall-clock timing closed by a device synchronize (port of
dinov2_tpu/utils/timing.py): PyTorch returns before a CUDA device finishes,
so the clock is read only after torch.cuda.synchronize()."""

from __future__ import annotations

import contextlib
import time

import torch


def _wait_for(device) -> None:
    """Synchronize a CUDA device; None or the CPU has nothing to wait for."""
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Timer:
    def __init__(self):
        self.elapsed_ms = 0.0

    @contextlib.contextmanager
    def measure(self, device=None):
        """Time the block; the bracket closes after `device` has finished."""
        start = time.perf_counter()
        try:
            yield self
        finally:
            _wait_for(device)
            self.elapsed_ms = (time.perf_counter() - start) * 1e3


def time_blocked(fn, *args, device=None, **kwargs):
    """Run fn, wait for `device` (a CUDA device: synchronize; None or the
    CPU: nothing to wait for), return (outputs, elapsed_ms)."""
    start = time.perf_counter()
    out = fn(*args, **kwargs)
    _wait_for(device)
    return out, (time.perf_counter() - start) * 1e3
