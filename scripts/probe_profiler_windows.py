"""How often a torch.profiler window of short GPU work loses kernel records,
with and without host-side margins around the launches of its active step.

    python3 scripts/probe_profiler_windows.py

Profiles 30 windows each of 10 and of 100 launches of the int8 quantize
(K9's first launch, on a (16448, 3072) bf16 input, ~0.08 ms a launch), with
no margin and with 0.02 s and 0.1 s of host sleep after the profiler's step
into the active phase and after the last launch's synchronize, and prints
how many windows held fewer than all but one of their launches. This is
what chip_smoke.py::profile_window's PROFILE_MARGIN_S rests on. Needs a
CUDA device and nvcc.
"""

import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, schedule

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from dinov2_tpu_torch.ops.int8_matmul_kernel import quantize_rows_int8_kernel  # noqa: E402

WINDOWS = 30


def window(run, calls: int, margin_s: float) -> int:
    """The kernel records one profiler window keeps of `calls` launches."""
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        run()
        torch.cuda.synchronize()
        prof.step()
        time.sleep(margin_s)
        for _ in range(calls):
            run()
        torch.cuda.synchronize()
        time.sleep(margin_s)
    return sum(e.device_type == torch.autograd.DeviceType.CUDA and "int8" in e.name
               for e in prof.events())


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_profiler_windows: no CUDA device available", file=sys.stderr)
        return 1
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((16448, 3072)))
    x = x.to("cuda", torch.bfloat16)

    def run():
        quantize_rows_int8_kernel(x)

    run()
    torch.cuda.synchronize()
    print(torch.cuda.get_device_name(0))
    for margin in (0.0, 0.02, 0.0, 0.02, 0.1):
        for calls in (10, 100):
            counts = sorted(window(run, calls, margin) for _ in range(WINDOWS))
            short = sum(c < calls - 1 for c in counts)
            print(f"margin {margin} s, {calls} launches: {short} of {WINDOWS} windows short; "
                  f"fewest records {counts[:3]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
