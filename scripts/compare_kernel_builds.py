"""Compare two builds of the port's CUDA kernels on one GPU, in one process.

    python3 scripts/compare_kernel_builds.py --other-csrc DIR

DIR holds another version of dinov2_tpu_torch/csrc/ (e.g. the parent
commit's: `git archive <commit> dinov2_tpu_torch/csrc | tar -x -C <dir>`).
For K1, K2, K3, K4 (with and without lse), K5, K6 (dq, dk, dv), K7 (bf16
fc1 and fc2, f32 fc1, fc2 and head), K8, K6 f32 at the two training
shapes and K9 (the whole call, its quantize and its
GEMM alone, at chip_smoke.py's INT8_SHAPES: fc1, fc2, the head and qkv at
T=1370), at the shapes chip_smoke.py checks them at,
it builds both versions, runs both wrappers on the same seeded inputs, and
times them in turns (other, this, this, other; median CUDA-event ms, and the
host's microseconds to issue one call with the card never waited for). K4
(with and without lse) and K6 must be equal bit for bit, and so must K9
(integer sums, the JAX package's roundings); so must
K3's backward on its flash route, which is K4 with lse and K6
behind autograd (four launches: where the event time is the host time, the
host binds it). The kernels that REDESIGNED names, whose f32 sums may run in
another order in the two versions, must be equal within TOLERANCE of the
output's scale (bf16 outputs: an ulp of the largest values is 0.4% of
them): against the parent of the 3xTF32 redesign of K7's f32 route and K6
f32, those two; against an older tree, add the kernels redesigned since
(K8 against a tree before its wgmma kernel; K1, K2, K3 against one before
theirs; K5 and K7's bf16 path against one before theirs). Exits non-zero
otherwise. The f32 cases also print each build's distance from their plain
f32 version on the same inputs. Needs a CUDA device and nvcc.

The wrappers pass K5's hidden buffer, K7's and K8's weight scratch and
K9's GELU table as the last argument of their C entries, so an entry from
before those buffers, which takes one argument fewer, runs with the same
wrapper and never reads it. --only PREFIX keeps the cases whose names start
with it (e.g. --only K9).

    python3 scripts/compare_kernel_builds.py --host-tree DIR

times the host instead, with the whole Python package of another tree
(e.g. the parent commit's `git archive <commit> | tar -x -C <dir>`) against
this one's: each in its own process, in turns (other, this, this, other,
twice), the host's microseconds to issue one K1 call (slab_layer_block at B=64,
T=257, D=768) and one eager ViT-B/14 classify forward (batch 64, 224 px,
bf16, random weights), the card waited for after each forward. In this
tree it also times K1's launch without the operator's dispatch
(slab_layer_buffers) and through a `torch.library.custom_op` registration
of the same launch, the registration ops/_library.py did not take.
"""

import argparse
import contextlib
import json
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

from dinov2_tpu_torch.models.params import Int8Linear, quantize_linear  # noqa: E402
from dinov2_tpu_torch.ops import _kernels  # noqa: E402
from dinov2_tpu_torch.ops.attention import split_heads  # noqa: E402
from dinov2_tpu_torch.ops.flash_attention import (  # noqa: E402
    flash_attention,
    flash_attention_slab,
    flash_backward,
    flash_backward_reference,
    flash_forward_lse,
)
from dinov2_tpu_torch.ops.fused_attention import (  # noqa: E402
    slab_attention,
    slab_attention_backward,
    slab_attention_block,
    slab_layer_block,
    slab_mlp_block,
)
from dinov2_tpu_torch.ops.fused_quant_attention import slab_layer_block_quant  # noqa: E402
from dinov2_tpu_torch.ops.int8_matmul_kernel import (  # noqa: E402
    int8_gelu_table,
    int8_gemm_kernel,
    int8_matmul_kernel,
    quantize_rows_int8_kernel,
)
from dinov2_tpu_torch.ops.qmatmul import quantize_rows_int8  # noqa: E402
from dinov2_tpu_torch.ops.qmatmul_kernel import (  # noqa: E402
    quant_matmul_kernel,
    quant_matmul_reference,
)

LIBS = ("slab_layer_lib", "slab_attention_lib", "slab_mlp_lib", "flash_attention_lib",
        "flash_backward_lib", "quant_matmul_lib", "quant_layer_lib", "int8_matmul_lib",
        "int8_gelu_table_entry", "int8_probe_entries")
# chip_smoke.py's INT8_SHAPES: name -> (M, K, N, activation, x dtype)
INT8_SHAPES = {
    "fc1": (64 * 257, 768, 3072, "gelu_tanh_f16", torch.bfloat16),
    "fc2": (64 * 257, 3072, 768, None, torch.bfloat16),
    "head": (64, 1536, 1000, None, torch.float32),
    "qkv_t1370": (8 * 1370, 768, 2304, None, torch.bfloat16),
}
# held within tolerance; every other kernel bit for bit
REDESIGNED = ("K7 f32", "K6 f32")
TOLERANCE = 1e-2  # of max|other|, plus 1e-5


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


def mlp_args(rng, b, t, d):
    arrays = [
        (rng.standard_normal((b, t, d)), torch.bfloat16),
        (rng.uniform(0.5, 1.5, d), torch.float32),
        (rng.standard_normal(d) * 0.1, torch.float32),
        (rng.standard_normal((d, 4 * d)) * 0.05, torch.bfloat16),
        (rng.standard_normal(4 * d) * 0.1, torch.float32),
        (rng.standard_normal((4 * d, d)) * 0.05, torch.bfloat16),
        (rng.standard_normal(d) * 0.1, torch.float32),
        (rng.uniform(0.1, 1.0, d), torch.float32),
    ]
    return [torch.from_numpy(a).to("cuda", dt) for a, dt in arrays]


# f32 cases -> their plain f32 version on the same inputs (filled by cases())
PLAIN = {}


def cases():
    """name -> a call of the wrapper on seeded inputs on the card; the f32
    cases' plain versions go to PLAIN."""
    rng = np.random.default_rng(0)
    b, t, d, heads = 64, 257, 768, 12
    args = half_layer_args(rng, b, t, d)
    x, lns, lnb, _, bq, wp, bp, ls = args
    qkv = torch.from_numpy(rng.standard_normal((b, t, 3 * d))).to("cuda", torch.bfloat16)
    wq4 = quantize_linear(rng.standard_normal((3 * d, d)) * 0.05, "q4_0", device="cuda")
    wp4 = quantize_linear(rng.standard_normal((d, d)) * 0.05, "q4_0", device="cuda")
    wq8 = quantize_linear(rng.standard_normal((3 * d, d)) * 0.05, "q8_0", device="cuda")
    wp8 = quantize_linear(rng.standard_normal((d, d)) * 0.05, "q8_0", device="cuda")
    calls = {
        "K1 slab_layer_block B=64 T=257 D=768":
            lambda: slab_layer_block(*args, heads, 0.125, 1e-6),
        "K2 slab_attention_block B=64 T=257 D=768":
            lambda: slab_attention_block(x, qkv, wp, bp, ls, heads, 0.125),
        "K3 slab_attention B=64 T=257 H=12":
            lambda: slab_attention(qkv, heads, 0.125),
        "K8 slab_layer_block_quant q4_0 packed B=64 T=257 D=768":
            lambda: slab_layer_block_quant(x, lns, lnb, wq4, bq, wp4, bp, ls, heads, 0.125, 1e-6),
        "K8 slab_layer_block_quant q8_0 int8 SoA B=64 T=257 D=768":
            lambda: slab_layer_block_quant(x, lns, lnb, wq8, bq, wp8, bp, ls, heads, 0.125, 1e-6),
    }
    for bb, tt, dd in ((64, 257, 768), (8, 1370, 1024)):
        mlp = mlp_args(rng, bb, tt, dd)
        calls[f"K5 slab_mlp_block B={bb} T={tt} D={dd} gelu_tanh_f16"] = partial(
            slab_mlp_block, *mlp, "gelu_tanh_f16", 1e-6)
    quant_shapes = {  # (x dtype, layer) -> (M, K, N, activation), chip_smoke.py's
        ("bf16", "fc1"): (b * t, d, 4 * d, "gelu_tanh_f16"),
        ("bf16", "fc2"): (b * t, 4 * d, d, None),
        ("f32", "fc1"): (b * t, d, 4 * d, "gelu_tanh_f16"),
        ("f32", "fc2"): (b * t, 4 * d, d, None),
        ("f32", "head"): (b, 2 * d, 1000, None),
    }
    for (kind, layer), (m, k, n, act) in quant_shapes.items():
        name = f"K7 {kind} quant_matmul_kernel q4_0 {layer}"
        dtype = torch.bfloat16 if kind == "bf16" else torch.float32
        ql = quantize_linear(rng.standard_normal((n, k)) * 0.05, "q4_0", device="cuda")
        xq = torch.from_numpy(rng.standard_normal((m, k))).to("cuda", dtype)
        bias = torch.from_numpy(rng.standard_normal(n) * 0.1).to("cuda", torch.float32)
        calls[f"{name} M={m} K={k} N={n} {act}"] = partial(
            quant_matmul_kernel, xq, ql, bias, act)
        if kind == "f32":
            PLAIN[f"{name} M={m} K={k} N={n} {act}"] = partial(
                quant_matmul_reference, xq, ql, bias, act)
    int8_gelu_table(torch.device("cuda"))  # made by this tree's library, read by both builds
    for name, (m, k, n, act, dtype) in INT8_SHAPES.items():
        w = rng.standard_normal((n, k)).astype(np.float32) * 0.05
        s = np.maximum(np.abs(w).max(axis=1) / 127.0, 1e-12)
        il = Int8Linear(
            codes=torch.from_numpy(np.clip(np.rint(w / s[:, None]), -127, 127).astype(np.int8))
            .cuda(), s=torch.from_numpy(s.astype(np.float32)).cuda(), shape=(n, k))
        x9 = torch.from_numpy(rng.standard_normal((m, k))).to("cuda", dtype)
        bias = torch.from_numpy(rng.standard_normal(n) * 0.1).to("cuda", torch.float32)
        x8, sx = quantize_rows_int8(x9)
        shape = f"{name} M={m} K={k} N={n} {act}"
        calls[f"K9 int8_matmul_kernel {shape}"] = partial(int8_matmul_kernel, x9, il, bias, act)
        calls[f"K9 quantize_rows_int8_kernel {shape}"] = partial(quantize_rows_int8_kernel, x9)
        calls[f"K9 int8_gemm_kernel {shape}"] = partial(
            int8_gemm_kernel, x8, sx, il, bias, act, dtype)
    slab_g = torch.from_numpy(rng.standard_normal((16, 257, 3 * 1536))).to("cuda", torch.bfloat16)
    calls["K3 slab_attention B=16 T=257 H=24"] = lambda: slab_attention(slab_g, 24, 0.125)
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
        if tt in (257, 1370):  # K6 f32 at the f32 training slices' shapes
            q32, k32, v32 = split_heads(slab.float(), hh)
            g32 = g.float()
            out32, lse32 = flash_forward_lse(q32, k32, v32, 0.125)
            calls[f"K6 f32 flash_backward {shape}"] = partial(
                flash_backward, q32, k32, v32, out32, lse32, g32, 0.125)
            PLAIN[f"K6 f32 flash_backward {shape}"] = partial(
                flash_backward_reference, q32, k32, v32, out32, lse32, g32, 0.125)
        if tt == 257:
            calls[f"K6 and K4 with lse as K3's backward, slab_attention_backward flash {shape}"] = (
                partial(slab_attention_backward, slab, g.reshape(bb, tt, 64 * hh), hh, 0.125,
                        "flash"))
    return calls


def distance(got, plain) -> str:
    """Each output's max|got - plain| / max(1, max|plain|)."""
    got = got if isinstance(got, tuple) else (got,)
    plain = plain if isinstance(plain, tuple) else (plain,)
    return ", ".join(f"{(a - p).abs().max().item() / max(1.0, p.abs().max().item()):.3g}"
                     for a, p in zip(got, plain))


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
        bound = TOLERANCE * b.float().abs().max().item() + 1e-5
        ok &= bool(torch.isfinite(a).all()) and diff <= bound
        parts.append(f"max|this-other| {diff:.4g} (bound {bound:.4g})")
    return ok, f"equal within tolerance: {ok}; " + ", ".join(parts)


# One tree's host times, run with that tree's package first on sys.path
# (--host-tree): prints one JSON object.
HOST_PROBE = """
import json, statistics, sys, time
sys.path.insert(0, sys.argv[1])
import numpy as np, torch
from dinov2_tpu_torch.models.config import PRESETS, DinoConfig
from dinov2_tpu_torch.models.params import init_params
from dinov2_tpu_torch.models.vit import ModelOptions, forward
from dinov2_tpu_torch.ops import fused_attention
from dinov2_tpu_torch.ops.qmatmul import set_cuda_matmul_precision

set_cuda_matmul_precision()
rng = np.random.default_rng(0)
arrays = [((64, 257, 768), torch.bfloat16, 1.0), ((768,), torch.float32, 1.0),
          ((768,), torch.float32, 0.1), ((768, 2304), torch.bfloat16, 0.05),
          ((2304,), torch.float32, 0.1), ((768, 768), torch.bfloat16, 0.05),
          ((768,), torch.float32, 0.1), ((768,), torch.float32, 1.0)]
args = [torch.from_numpy(rng.standard_normal(s) * c).to("cuda", t) for s, t, c in arrays]

def host_us(fn, reps=50, blocks=7):
    # the median over the blocks of the mean host us to issue one of `reps`
    # calls, the card waited for after each block
    for _ in range(3):
        fn()
    means = []
    for _ in range(blocks):
        torch.cuda.synchronize()
        start = time.perf_counter()
        for _ in range(reps):
            fn()
        means.append((time.perf_counter() - start) / reps * 1e6)
        torch.cuda.synchronize()
    return statistics.median(means)

out = {"k1_us": host_us(lambda: fused_attention.slab_layer_block(*args, 12, 0.125, 1e-6))}
if hasattr(fused_attention, "_SLAB_LAYER_OP"):
    out["k1_launch_alone_us"] = host_us(
        lambda: fused_attention.slab_layer_buffers(*args, 12, 0.125, 1e-6))

    @torch.library.custom_op("dinov2_host_probe::slab_layer_block", mutates_args=())
    def probe(x: torch.Tensor, ln_scale: torch.Tensor, ln_bias: torch.Tensor,
              w_qkv: torch.Tensor, b_qkv: torch.Tensor, w_proj: torch.Tensor,
              b_proj: torch.Tensor, ls1: torch.Tensor, num_heads: int, scale: float,
              eps: float) -> torch.Tensor:
        return fused_attention._slab_layer_cuda(x, ln_scale, ln_bias, w_qkv, b_qkv, w_proj,
                                                b_proj, ls1, num_heads, scale, eps)

    probe.register_fake(fused_attention._slab_layer_fake)
    out["k1_custom_op_us"] = host_us(lambda: probe(*args, 12, 0.125, 1e-6))
config = DinoConfig(**{**PRESETS["base"].__dict__, "num_classes": 1000, "img_size": 518})
params = init_params(config, seed=0, dtype=torch.bfloat16, device="cuda")
x = torch.from_numpy(rng.standard_normal((64, 224, 224, 3)).astype(np.float32)).cuda()
opts = ModelOptions(compute_dtype=torch.bfloat16)
times = []
with torch.inference_mode():
    for i in range(43):
        torch.cuda.synchronize()
        start = time.perf_counter()
        forward(params, x, config, opts, classify=True)
        spent = time.perf_counter() - start
        torch.cuda.synchronize()
        if i >= 3:
            times.append(spent * 1e6)
out["forward_us"] = statistics.median(times)
print(json.dumps(out))
"""


def compare_hosts(other: Path, card: str) -> int:
    """--host-tree: the HOST_PROBE in the other tree and in this one, in
    turns, each in a fresh process."""
    readings = []
    for name, tree in (("other", other), ("this", ROOT), ("this", ROOT), ("other", other)) * 2:
        proc = subprocess.run([sys.executable, "-c", HOST_PROBE, str(tree)], cwd=tree,
                              capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            print(f"host probe in {tree} failed:\n{proc.stderr[-3000:]}", file=sys.stderr)
            return 1
        readings.append((name, json.loads(proc.stdout.strip().splitlines()[-1])))
    for key in ("k1_us", "k1_launch_alone_us", "k1_custom_op_us", "forward_us"):
        values = ", ".join(f"{name} {r[key]:.1f}" for name, r in readings if key in r)
        print(f"host us, {key}: {values} (order other, this, this, other, twice; {card})")
    return 0


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    which = parser.add_mutually_exclusive_group(required=True)
    which.add_argument("--other-csrc", type=Path)
    which.add_argument("--host-tree", type=Path)
    parser.add_argument("--only", default="", help="keep the cases whose names start with this")
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        print("compare_kernel_builds: no CUDA device available", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(card)
    if opts.host_tree:
        return compare_hosts(opts.host_tree.resolve(), card)
    other = opts.other_csrc.resolve()
    same = True
    with torch.no_grad():  # K3's backward turns grad on again inside
        for name, call in cases().items():
            if not name.startswith(opts.only):
                continue
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
            if name in PLAIN:
                plain = PLAIN[name]()
                verdict += (f"; from the plain f32 version, of max(1, max|plain|): this "
                            f"{distance(ours, plain)}, other {distance(theirs, plain)}")
            print(
                f"{name}: {verdict}; other build {ms_other[0]:.4f} and "
                f"{ms_other[1]:.4f} ms, this build {ms_this[0]:.4f} and {ms_this[1]:.4f} ms; "
                f"host us to issue a call: other {us_other[0]:.1f} and {us_other[1]:.1f}, this "
                f"{us_this[0]:.1f} and {us_this[1]:.1f} (order other, this, this, other; {card})"
            )
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
