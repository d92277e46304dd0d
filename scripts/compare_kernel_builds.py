"""Compare two builds of the port's CUDA kernels on one GPU, in one process.

    python3 scripts/compare_kernel_builds.py --other-csrc DIR

DIR holds another version of dinov2_tpu_torch/csrc/ (e.g. the parent
commit's: `git archive <commit> dinov2_tpu_torch/csrc | tar -x -C <dir>`).
For K1, K2, K3, K4 (without lse) and K8, at the shapes chip_smoke.py checks
them at, it builds both versions, runs both wrappers on the same seeded
inputs, says whether the outputs are equal bit for bit, and times them in
turns (other, this, this, other; median CUDA-event ms). Exits non-zero if
any output differs. Needs a CUDA device and nvcc.
"""

import argparse
import contextlib
import ctypes
import functools
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from dinov2_tpu_torch.models.params import quantize_linear  # noqa: E402
from dinov2_tpu_torch.ops import _kernels  # noqa: E402
from dinov2_tpu_torch.ops.flash_attention import flash_attention_slab  # noqa: E402
from dinov2_tpu_torch.ops.fused_attention import (  # noqa: E402
    slab_attention,
    slab_attention_block,
    slab_layer_block,
)
from dinov2_tpu_torch.ops.fused_quant_attention import slab_layer_block_quant  # noqa: E402

LIBS = ("slab_layer_lib", "slab_attention_lib", "flash_attention_lib", "quant_layer_lib")


@contextlib.contextmanager
def csrc(directory: Path):
    """Build and load the kernels from `directory` inside the block."""
    saved = _kernels.CSRC_DIR, _kernels.flash_attention_lib
    _kernels.CSRC_DIR = directory
    for lib in LIBS:
        getattr(_kernels, lib).cache_clear()
    if "dinov2_flash_attention_lse_bf16" not in (directory / "flash_attention.cu").read_text():
        _kernels.flash_attention_lib = _flash_attention_lib_without_lse
    try:
        yield
    finally:
        _kernels.CSRC_DIR, _kernels.flash_attention_lib = saved
        _flash_attention_lib_without_lse.cache_clear()
        for lib in LIBS:
            getattr(_kernels, lib).cache_clear()


@functools.cache
def _flash_attention_lib_without_lse():
    """The K4 library of a version from before the `with_lse` entry."""
    lib = _kernels._load("flash_attention")
    ptr, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.dinov2_flash_attention_bf16.argtypes = [ptr] * 4 + [i32] * 3 + [i64] * 3 + [f32, ptr]
    lib.dinov2_flash_attention_bf16.restype = i32
    return lib


def median_ms(fn, reps: int = 20) -> float:
    for _ in range(3):
        fn()
    events = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def half_layer_args(rng, b, t, d):
    arrays = [
        (rng.standard_normal((b, t, d)), torch.bfloat16),
        (rng.uniform(0.5, 1.5, d), torch.float32),
        (rng.standard_normal(d) * 0.1, torch.float32),
        (rng.standard_normal((d, 3 * d)) * 0.05, torch.bfloat16),
        (rng.standard_normal(3 * d) * 0.1, torch.float32),
        (rng.standard_normal((d, d)) * 0.05, torch.bfloat16),
        (rng.standard_normal(d) * 0.1, torch.float32),
        (rng.uniform(0.1, 1.0, d), torch.float32),
    ]
    return [torch.from_numpy(a).to("cuda", dt) for a, dt in arrays]


def cases():
    """name -> a call of the wrapper on seeded inputs on the card."""
    rng = np.random.default_rng(0)
    b, t, d, heads = 64, 257, 768, 12
    args = half_layer_args(rng, b, t, d)
    x, lns, lnb, _, bq, wp, bp, ls = args
    qkv = torch.from_numpy(rng.standard_normal((b, t, 3 * d))).to("cuda", torch.bfloat16)
    wq4 = quantize_linear(rng.standard_normal((3 * d, d)) * 0.05, "q4_0", device="cuda")
    wp4 = quantize_linear(rng.standard_normal((d, d)) * 0.05, "q4_0", device="cuda")
    long_qkv = torch.from_numpy(rng.standard_normal((8, 1370, 3 * 1024)) * 1.5)
    long_qkv = long_qkv.to("cuda", torch.bfloat16)
    return {
        "K1 slab_layer_block B=64 T=257 D=768":
            lambda: slab_layer_block(*args, heads, 0.125, 1e-6),
        "K2 slab_attention_block B=64 T=257 D=768":
            lambda: slab_attention_block(x, qkv, wp, bp, ls, heads, 0.125),
        "K3 slab_attention B=64 T=257 H=12":
            lambda: slab_attention(qkv, heads, 0.125),
        "K4 flash_attention_slab B=8 T=1370 H=16":
            lambda: flash_attention_slab(long_qkv, 16, 0.125),
        "K8 slab_layer_block_quant q4_0 B=64 T=257 D=768":
            lambda: slab_layer_block_quant(x, lns, lnb, wq4, bq, wp4, bp, ls, heads, 0.125, 1e-6),
    }


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--other-csrc", required=True, type=Path)
    opts = parser.parse_args()
    other = opts.other_csrc.resolve()
    if not torch.cuda.is_available():
        print("compare_kernel_builds: no CUDA device available", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(card)
    same = True
    with torch.inference_mode():
        for name, call in cases().items():
            with csrc(other):
                theirs = call()
                ms_other = [median_ms(call)]
            ours = call()
            ms_this = [median_ms(call), median_ms(call)]
            with csrc(other):
                ms_other.append(median_ms(call))
            torch.cuda.synchronize()
            equal = torch.equal(ours, theirs)
            same &= equal
            print(
                f"{name}: bit for bit equal: {equal}; other build {ms_other[0]:.4f} and "
                f"{ms_other[1]:.4f} ms, this build {ms_this[0]:.4f} and {ms_this[1]:.4f} ms "
                f"(order other, this, this, other; {card})"
            )
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
