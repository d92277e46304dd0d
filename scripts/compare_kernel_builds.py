"""Compare two builds of the port's CUDA kernels on one GPU, in one process.

    python3 scripts/compare_kernel_builds.py --other-csrc DIR

DIR holds another version of dinov2_tpu_torch/csrc/ (e.g. the parent
commit's: `git archive <commit> dinov2_tpu_torch/csrc | tar -x -C <dir>`).
For K1, K2, K3, K4 (with and without lse), K6 (dq, dk, dv) and K8, at the
shapes chip_smoke.py checks them at, it builds both versions, runs both
wrappers on the same seeded inputs, and times them in turns (other, this,
this, other; median CUDA-event ms, and the host's microseconds to issue one
call with the card never waited for). K1, K2, K3 and K8 must be equal bit for
bit. K4 and K6, whose tile loops differ between versions (other tile sizes,
a base-2 exponent, another order of the f32 sums), must be equal within
TOLERANCE of the output's scale (bf16 outputs: an ulp of the largest values
is 0.4% of them) and, for the f32 lse, within LSE_TOLERANCE; so must K3's
backward on its flash route, which is K4 with lse and K6 behind autograd
(four launches: where the event time is the host time, the host binds it).
Exits non-zero otherwise. Needs a CUDA device and nvcc.
"""

import argparse
import contextlib
import statistics
import subprocess
import sys
import time
from functools import partial
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from dinov2_tpu_torch.models.params import quantize_linear  # noqa: E402
from dinov2_tpu_torch.ops import _kernels  # noqa: E402
from dinov2_tpu_torch.ops.attention import split_heads  # noqa: E402
from dinov2_tpu_torch.ops.flash_attention import (  # noqa: E402
    flash_attention,
    flash_attention_slab,
    flash_backward,
    flash_forward_lse,
)
from dinov2_tpu_torch.ops.fused_attention import (  # noqa: E402
    slab_attention,
    slab_attention_backward,
    slab_attention_block,
    slab_layer_block,
)
from dinov2_tpu_torch.ops.fused_quant_attention import slab_layer_block_quant  # noqa: E402

LIBS = ("slab_layer_lib", "slab_attention_lib", "flash_attention_lib", "flash_backward_lib",
        "quant_layer_lib")
REDESIGNED = ("K4", "K6")  # held within tolerance; every other kernel bit for bit
TOLERANCE = 1e-2  # of max|other|, plus 1e-5
LSE_TOLERANCE = 1e-3


@contextlib.contextmanager
def csrc(directory: Path):
    """Build and load the kernels from `directory` inside the block."""
    saved = _kernels.CSRC_DIR
    _kernels.CSRC_DIR = directory
    for lib in LIBS:
        getattr(_kernels, lib).cache_clear()
    try:
        yield
    finally:
        _kernels.CSRC_DIR = saved
        for lib in LIBS:
            getattr(_kernels, lib).cache_clear()


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


def host_us(fn, reps: int = 50) -> float:
    """Microseconds of host time to issue one call; the card is waited for
    only after the last."""
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(reps):
        fn()
    spent = time.perf_counter() - start
    torch.cuda.synchronize()
    return spent / reps * 1e6


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
    calls = {
        "K1 slab_layer_block B=64 T=257 D=768":
            lambda: slab_layer_block(*args, heads, 0.125, 1e-6),
        "K2 slab_attention_block B=64 T=257 D=768":
            lambda: slab_attention_block(x, qkv, wp, bp, ls, heads, 0.125),
        "K3 slab_attention B=64 T=257 H=12":
            lambda: slab_attention(qkv, heads, 0.125),
        "K8 slab_layer_block_quant q4_0 B=64 T=257 D=768":
            lambda: slab_layer_block_quant(x, lns, lnb, wq4, bq, wp4, bp, ls, heads, 0.125, 1e-6),
    }
    for bb, tt, hh in ((8, 1370, 16), (1, 4226, 16), (32, 257, 12)):
        slab = torch.from_numpy(rng.standard_normal((bb, tt, 3 * 64 * hh)) * 1.5)
        slab = slab.to("cuda", torch.bfloat16)
        g = torch.from_numpy(rng.standard_normal((bb, tt, hh, 64))).to("cuda", torch.bfloat16)
        q, k, v = split_heads(slab, hh)
        shape = f"B={bb} T={tt} H={hh}"
        if tt == 4226:  # contiguous heads, as chip_smoke.py checks this shape
            q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
            calls[f"K4 flash_attention {shape}"] = partial(flash_attention, q, k, v, 0.125)
            continue
        if tt == 1370:
            calls[f"K4 flash_attention_slab {shape}"] = partial(flash_attention_slab, slab, hh, 0.125)
        calls[f"K4 with lse flash_forward_lse {shape}"] = partial(flash_forward_lse, q, k, v, 0.125)
        out, lse = flash_forward_lse(q, k, v, 0.125)
        calls[f"K6 flash_backward {shape}"] = partial(flash_backward, q, k, v, out, lse, g, 0.125)
        if tt == 257:
            calls[f"K6 and K4 with lse as K3's backward, slab_attention_backward flash {shape}"] = (
                partial(slab_attention_backward, slab, g.reshape(bb, tt, 64 * hh), hh, 0.125,
                        "flash"))
    return calls


def compare(name: str, ours, theirs) -> tuple[bool, str]:
    """Whether this build's output(s) meet the other's, and how to say it."""
    ours = ours if isinstance(ours, tuple) else (ours,)
    theirs = theirs if isinstance(theirs, tuple) else (theirs,)
    if not name.startswith(REDESIGNED):
        equal = all(torch.equal(a, b) for a, b in zip(ours, theirs))
        return equal, f"bit for bit equal: {equal}"
    ok, parts = True, []
    for a, b in zip(ours, theirs):
        diff = (a.float() - b.float()).abs().max().item()
        bound = (LSE_TOLERANCE if a.dtype == torch.float32
                 else TOLERANCE * b.float().abs().max().item() + 1e-5)
        ok &= bool(torch.isfinite(a).all()) and diff <= bound
        parts.append(f"max|this-other| {diff:.4g} (bound {bound:.4g})")
    return ok, f"equal within tolerance: {ok}; " + ", ".join(parts)


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
    with torch.no_grad():  # K3's backward turns grad on again inside
        for name, call in cases().items():
            with csrc(other):
                theirs = call()
                ms_other, us_other = [median_ms(call)], [host_us(call)]
            ours = call()
            ms_this = [median_ms(call), median_ms(call)]
            us_this = [host_us(call), host_us(call)]
            with csrc(other):
                ms_other.append(median_ms(call))
                us_other.append(host_us(call))
            torch.cuda.synchronize()
            equal, verdict = compare(name, ours, theirs)
            same &= equal
            print(
                f"{name}: {verdict}; other build {ms_other[0]:.4f} and "
                f"{ms_other[1]:.4f} ms, this build {ms_this[0]:.4f} and {ms_this[1]:.4f} ms; "
                f"host us to issue a call: other {us_other[0]:.1f} and {us_other[1]:.1f}, this "
                f"{us_this[0]:.1f} and {us_this[1]:.1f} (order other, this, this, other; {card})"
            )
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
