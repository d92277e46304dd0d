"""The benchmark of dinov2_tpu_torch: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the CUDA cards the cell
asks for. The last line of standard output is the result as one JSON
object: `correct`, `attempted`, `failed`, `metrics` (the cell's end-to-end
metrics, or with --trace 1 its per-layer ones), `device`, with --trace 1
`breakdown`, and last `checks`, each number compared with its limit. The
same numbers are the last lines of standard error. Without the cards, or
if jax, jaxlib, flax or dinov2_tpu is loaded once the window has closed, it
prints no result and exits with 1.

The run keeps glibc's freed heap memory for reuse (`steady_heap`), and
hands the program its GGUF as a file in memory, never on disk. Set-up's
phases (wall and CPU seconds, page faults, preemptions) go to standard
error, before the checks.

Every build and kernel cache stays in the checkout: the program's kernel
libraries in build/kernels/, Python's bytecode in build/pycache/
(`bytecode_cache`), and TORCH_EXTENSIONS_DIR and TRITON_CACHE_DIR under
build/.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def bytecode_cache() -> None:
    """Write and read the compiled bytecode of every module the run imports
    (torch's, numpy's, the program's, the benchmark's) under build/pycache/
    of the checkout, whatever PYTHONDONTWRITEBYTECODE says. On the H100
    machines that variable is set and torch ships its 2141 modules without
    bytecode, so every process compiled them afresh: 8.4-11.6 s of CPU
    before the card was reached, most of set-up and of its spread. Only a
    checkout's first run compiles them now, as it builds the kernels."""
    sys.pycache_prefix = str(ROOT / "build" / "pycache")
    sys.dont_write_bytecode = False


def steady_heap() -> None:
    """Keep the heap's freed memory for reuse (glibc: buffers under 1 GiB
    from the heap, and the heap never trimmed), so that the program's
    per-call host buffers are not unmapped and faulted in afresh each
    call. On a sandboxed H100 host, first touches of fresh memory ran at
    0.9-2.4 GB/s, threefold apart from process to process, and spread the
    inference cells' runs by 9-19%; the program's work is unchanged."""
    try:
        libc = ctypes.CDLL("libc.so.6")
    except OSError:
        return
    for option, value in ((-3, 1 << 30), (-1, 1 << 31), (-2, 256 << 20)):
        libc.mallopt(option, value)  # M_MMAP_THRESHOLD, M_TRIM_THRESHOLD, M_TOP_PAD


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="portbench/run.py")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    bytecode_cache()
    steady_heap()
    sys.path.insert(0, str(ROOT))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    from portbench import harness, spec

    clock = harness.SetupClock(harness.process_start())
    clock.mark("python and torch")
    import torch

    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: the cell needs {cell.chips} CUDA card(s); "
              f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 1
    import dinov2_tpu_torch  # noqa: F401  (fails here, before any work, without the program)

    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                              clock=clock)
    print(result.pop("setup_phases"), file=sys.stderr)
    forbidden = result.pop("forbidden")
    errors = result.pop("errors")
    for e in errors:
        print(f"portbench: a call failed: {e}", file=sys.stderr)
    if forbidden:
        print(f"portbench: modules that must not load were loaded: {forbidden}", file=sys.stderr)
        return 1
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
