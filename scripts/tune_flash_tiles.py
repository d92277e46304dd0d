"""Check and time each tile-size variant of the flash-attention kernels
(K4, csrc/flash_attention.cu; K6, csrc/flash_backward.cu) on one GPU. K4's
tile loop (csrc/flash_forward.cuh) is K3's kernel too: the forward shapes
are timed on the head views of a qkv slab, K3's two shapes among them.

    python3 scripts/tune_flash_tiles.py [--ptxas] [--quick]

The C entry points pick a block's rows (64 or 128) by shape (K4) or take one
pair (K6) and have no argument for it. This script builds the other variants
from the same sources into build/kernels/ with -DDINOV2_FORWARD_QUERY_ROWS=,
-DDINOV2_BACKWARD_KEY_ROWS= and -DDINOV2_BACKWARD_QUERY_ROWS=, times each in
turns at the shapes the paths use, beside one scaled_dot_product_attention
call (forward, and its backward), and holds each variant against the plain
PyTorch version over ragged sequence lengths. With --profile it ends with
torch.profiler's device time of each kernel of one K4 (with lse) and one K6
call at the backward shapes. K1's GEMM core (csrc/wgmma_gemm.cuh) has its
block shape and ring depth as macros too (-DDINOV2_GEMM_COLUMNS=,
-DDINOV2_GEMM_STAGES=), and K5 (csrc/slab_mlp.cu), K7
(csrc/quant_matmul.cu) and K8 (csrc/quant_layer.cu) run on it: each variant
is held against K1's, K5's, K7's and K8's plain versions at the same ragged
lengths, and K1, K5, K7's fc1 and fc2 and K8 are timed on each at their
shapes. With --ptxas it first prints what `nvcc -Xptxas -v` says of the
eight kernel sources: both flash sources, csrc/slab_layer.cu (K1: the wgmma
GEMM kernels of csrc/wgmma_gemm.cuh and the attention kernel as the slab
kernels instantiate it), csrc/slab_attention.cu (K3, K2), csrc/slab_mlp.cu
(K5: the layer norm and the GEMM with the activation and with the residual
epilogue), csrc/quant_matmul.cu (K7: the dequantize kernels, the GEMM on a
k-major weight, the f32 route's persistent 3xTF32 GEMM), csrc/quant_layer.cu
(K8: the dequantize kernel and K1's launches with the k-major weight) and
csrc/int8_matmul.cu (K9: the quantize and the persistent s8 GEMM with each
epilogue): registers, spills, shared memory, the count of HGMMA and IGMMA (wgmma,
float and integer), HMMA (mma.sync), LDGSTS (cp.async) and UTMALDG (TMA
load) instructions in their SASS, the registers each warpgroup role holds
after setmaxnreg, ptxas's C751x notes, and K9's GEMM build (variant, tile,
ring depth, dynamic shared memory). --quick skips the timing. Exits
non-zero if a variant disagrees with the plain version. Needs a CUDA device
and nvcc.
"""

import argparse
import contextlib
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from dinov2_tpu_torch.models.params import quantize_linear  # noqa: E402
from dinov2_tpu_torch.ops import _kernels  # noqa: E402
from dinov2_tpu_torch.ops.attention import split_heads  # noqa: E402
from dinov2_tpu_torch.ops.flash_attention import (  # noqa: E402
    flash_backward_reference,
    flash_forward_reference,
)
from dinov2_tpu_torch.ops.fused_attention import (  # noqa: E402
    slab_layer_buffers,
    slab_layer_reference,
    slab_mlp_block,
    slab_mlp_reference,
)
from dinov2_tpu_torch.ops.fused_quant_attention import (  # noqa: E402
    quant_layer_reference,
    slab_layer_block_quant,
)
from dinov2_tpu_torch.ops.qmatmul_kernel import (  # noqa: E402
    quant_matmul_kernel,
    quant_matmul_reference,
)

RAGGED_T = (1, 63, 64, 65, 127, 128, 129, 257, 300)
FORWARD_SHAPES = (
    (8, 1370, 16), (8, 1370, 12), (1, 4226, 16), (8, 257, 12), (16, 257, 12), (32, 257, 12),
    (64, 257, 12), (16, 257, 24))
BACKWARD_SHAPES = ((8, 1370, 16), (32, 257, 12))
SCALE = 0.125
# a variant: the -D macros its build takes; () is the build the port loads
BY_SHAPE = ()
FORWARD_VARIANTS = {
    64: ("DINOV2_FORWARD_QUERY_ROWS=64",), 128: ("DINOV2_FORWARD_QUERY_ROWS=128",)}
BACKWARD_VARIANTS = {  # (the dK/dV kernel's keys, the dQ kernel's queries)
    (keys, queries): (f"DINOV2_BACKWARD_KEY_ROWS={keys}", f"DINOV2_BACKWARD_QUERY_ROWS={queries}")
    for keys in (64, 128) for queries in (64, 128)}
# K1's GEMM core (csrc/wgmma_gemm.cuh): (a block's columns, ring stages)
GEMM_VARIANTS = {
    (columns, stages): (f"DINOV2_GEMM_COLUMNS={columns}", f"DINOV2_GEMM_STAGES={stages}")
    for columns, stages in ((128, 3), (256, 3), (256, 4))}
GEMM_SHAPES = ((64, 257, 12), (32, 257, 12), (16, 257, 24))  # K1 at (B, T, heads), D = 64 heads
# built on the GEMM core's variants
GEMM_LIBS = ("slab_layer", "slab_mlp", "quant_matmul", "quant_layer")
MLP_SHAPES = ((64, 257, 768), (8, 1370, 1024))  # K5 at (B, T, D)
QUANT_SHAPES = {"fc1": (64 * 257, 768, 3072, "gelu_tanh_f16"), "fc2": (64 * 257, 3072, 768, None)}
_BUILD_ONE = (
    "import sys; from dinov2_tpu_torch.ops import _kernels; "
    "_kernels.NVCC_FLAGS += tuple(sys.argv[2:]); _kernels.build(sys.argv[1])")


def flags(defines) -> tuple:
    return tuple(f"-D{define}" for define in defines)


def build_all() -> None:
    """Every variant's library, one nvcc each, all at once (a process each:
    ops/_kernels.py reads its flags from the module)."""
    jobs = [("flash_attention", d) for d in (BY_SHAPE, *FORWARD_VARIANTS.values())]
    jobs += [("flash_backward", d) for d in (BY_SHAPE, *BACKWARD_VARIANTS.values())]
    jobs += [(lib, d) for lib in GEMM_LIBS for d in (BY_SHAPE, *GEMM_VARIANTS.values())]
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_ONE, name, *flags(defines)], cwd=ROOT)
             for name, defines in jobs]
    if any(proc.wait() for proc in procs):
        raise RuntimeError("a variant did not build")


@contextlib.contextmanager
def variant(defines):
    """Inside the block the flash libraries and the GEMM core's (K1, K5,
    K7, K8) are the ones built with these macros (built by build_all;
    ops/_kernels.py names a library by its flags)."""
    libs = (_kernels.flash_attention_lib, _kernels.flash_backward_lib, _kernels.slab_layer_lib,
            _kernels.slab_mlp_lib, _kernels.quant_matmul_lib, _kernels.dequant_weight_entry,
            _kernels.quant_layer_lib)
    saved = _kernels.NVCC_FLAGS
    _kernels.NVCC_FLAGS = saved + flags(defines)
    for lib in libs:
        lib.cache_clear()
    try:
        yield
    finally:
        _kernels.NVCC_FLAGS = saved
        for lib in libs:
            lib.cache_clear()


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
    return float(np.median([s.elapsed_time(e) for s, e in events]))


def ptxas_report(name: str) -> str:
    """Registers, spills and shared memory of csrc/<name>.cu's kernels, its
    SASS's tensor-core and async-copy instruction counts, the registers a
    warpgroup holds after each setmaxnreg (a warp-specialised kernel's
    roles: DEALLOC gives back, TRY_ALLOC takes), and ptxas's C751x notes
    (a wgmma it serialised), said to be none when there are none."""
    cubin = _kernels.BUILD_DIR / f"{name}.cubin"
    _kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _kernels.find_nvcc()
    proc = subprocess.run(
        [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-cubin",
         "-Xptxas", "-v", "-o", str(cubin), str(_kernels.CSRC_DIR / f"{name}.cu")],
        capture_output=True, text=True,
    )
    lines = [f"== {name}.cu (nvcc exit {proc.returncode})"]
    entry = ""
    notes = [line for line in (proc.stdout + proc.stderr).splitlines() if re.search(r"C751\d", line)]
    for line in (proc.stdout + proc.stderr).splitlines():
        if "Compiling entry function" in line:
            entry = re.sub(r".*entry function '(\w+)'.*", r"\1", line)
            entry = subprocess.run(["c++filt", entry], capture_output=True, text=True).stdout.strip()
        elif "Used" in line or "spill" in line:
            lines.append(f"{entry[:90]}: {line.strip()}")
        elif any(word in line.lower() for word in ("warning", "error", "performance")):
            lines.append(line.strip()[:220])  # C7515 and the like: wgmma serialized
    sass = subprocess.run(
        [str(Path(nvcc).with_name("cuobjdump")), "-sass", str(cubin)],
        capture_output=True, text=True,
    ).stdout
    for word in ("HGMMA", "IGMMA", "HMMA", "LDGSTS", "UTMALDG", "WARPGROUP", "MUFU.EX2", "STL",
                 "LDL"):
        lines.append(f"SASS lines with {word}: {sum(word in row for row in sass.splitlines())}")
    roles = sorted({(m.group(1), int(m.group(2), 16)) for m in re.finditer(
        r"USETMAXREG\.(\w+)\.CTAPOOL[^,;]*?,?\s*(0x[0-9a-f]+)", sass)})
    if roles:
        lines.append("setmaxnreg, registers a thread after it: " + ", ".join(
            f"{'a producer gives back to' if kind == 'DEALLOC' else 'a consumer takes'} {regs}"
            for kind, regs in roles))
    lines.append(f"ptxas C751x notes (a wgmma serialised): {len(notes) or 'none'}")
    return "\n".join(lines + [note.strip()[:220] for note in notes])


def inputs(b, t, heads, seed):
    rng = np.random.default_rng(seed)
    qkv = torch.from_numpy(rng.standard_normal((b, t, 3 * 64 * heads)) * 1.5)
    qkv = qkv.to("cuda", torch.bfloat16)
    g = torch.from_numpy(rng.standard_normal((b, t, heads, 64))).to("cuda", torch.bfloat16)
    return split_heads(qkv, heads), g


def strides(x):
    return tuple(s if n > 1 else 0 for s, n in zip(x.stride(), x.shape))[:3]


def forward(q, k, v, with_lse=True):
    b, t, heads, _ = q.shape
    lib = _kernels.flash_attention_lib()
    out = torch.empty((b, t, heads, 64), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, heads, t), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream().cuda_stream
    if with_lse:
        code = lib.dinov2_flash_attention_lse_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            b, t, heads, *strides(q), SCALE, stream)
    else:
        code = lib.dinov2_flash_attention_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, t, heads, *strides(q), SCALE, stream)
    _kernels.check_status(lib, code, "flash_attention")
    return out, lse


def backward(q, k, v, out, lse, g):
    b, t, heads, _ = q.shape
    lib = _kernels.flash_backward_lib()
    grads = [torch.empty_like(out) for _ in range(3)]
    delta = torch.empty((b, heads, t), dtype=torch.float32, device=q.device)
    code = lib.dinov2_flash_backward_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), g.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), *(d.data_ptr() for d in grads), b, t, heads, *strides(q),
        *strides(grads[0]), SCALE, torch.cuda.current_stream().cuda_stream)
    _kernels.check_status(lib, code, "flash_backward")
    return grads


def held(name, got, plain, want) -> bool:
    """chip_smoke.py's rule: the kernel may be twice as far from f32 as the
    plain version in bf16, plus 1e-3 of the output's scale; and 1e-5 for a
    gradient that is exactly 0 (T=1), where only f32 summation order shows."""
    err = (got.float() - want).abs().max().item()
    err_plain = (plain.float() - want).abs().max().item()
    bound = 2 * err_plain + 1e-3 * want.abs().max().item() + 1e-5
    ok = bool(torch.isfinite(got).all()) and err <= bound
    if not ok:
        print(f"  DISAGREES: {name}: max|kernel-f32| {err:.6g}, max|plain-f32| {err_plain:.6g}, "
              f"bound {bound:.6g}")
    return ok


def check_variants(b, t, heads) -> bool:
    (q, k, v), g = inputs(b, t, heads, seed=t + heads)
    out_plain, _ = flash_forward_reference(q, k, v, SCALE)
    out32, lse32 = flash_forward_reference(q.float(), k.float(), v.float(), SCALE)
    ok = True
    outs = {}
    for rows, defines in FORWARD_VARIANTS.items():
        with variant(defines):
            out, lse = forward(q, k, v)
            without, _ = forward(q, k, v, with_lse=False)
        torch.cuda.synchronize()
        ok &= held(f"forward rows={rows} B={b} T={t} H={heads}", out, out_plain, out32)
        lse_err = (lse - lse32).abs().max().item()
        if not (lse_err <= 1e-3 and torch.equal(out, without)):
            print(f"  DISAGREES: forward rows={rows} T={t}: max|lse-lse f32| {lse_err:.3g}, out "
                  f"equal without lse: {torch.equal(out, without)}")
            ok = False
        outs[rows] = (out, lse)
    out, lse = outs[64]
    plain = flash_backward_reference(q, k, v, out, lse, g, SCALE)
    want = flash_backward_reference(q.float(), k.float(), v.float(), out32, lse32, g.float(), SCALE)
    for rows in ((64, 64), (128, 128), BY_SHAPE):
        with variant(BACKWARD_VARIANTS.get(rows, BY_SHAPE)):
            got = backward(q, k, v, out, lse, g)
            again = backward(q, k, v, out, lse, g)
        torch.cuda.synchronize()
        for name, a, a2, p, w in zip(("dq", "dk", "dv"), got, again, plain, want):
            ok &= held(f"backward rows={rows} B={b} T={t} H={heads} {name}", a, p, w)
            if not torch.equal(a, a2):
                print(f"  DISAGREES: backward rows={rows} T={t} {name}: two runs differ")
                ok = False
    return ok


def half_layer_args(b, t, d, seed):
    rng = np.random.default_rng(seed)
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


def mlp_args(b, t, d, seed):
    rng = np.random.default_rng(seed)
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


def quant_args(m, k, n, seed, fmt="q4_0"):
    """x (M, K) bf16, an (N, K) QuantLinear, bias (N,) f32 on the card."""
    rng = np.random.default_rng(seed)
    ql = quantize_linear(rng.standard_normal((n, k)) * 0.05, fmt, device="cuda")
    x = torch.from_numpy(rng.standard_normal((m, k))).to("cuda", torch.bfloat16)
    return x, ql, torch.from_numpy(rng.standard_normal(n) * 0.1).to("cuda", torch.float32)


def quant_layer_args(b, t, heads, seed, fmt="q4_0", packed=True):
    """K8's inputs on the card: x, LN rows, the qkv and proj QuantLinear
    (the load path's layout, or int8 SoA), biases and LayerScale."""
    d = 64 * heads
    rng = np.random.default_rng(seed)
    x, lns, lnb, _, bq, _, bp, ls = half_layer_args(b, t, d, seed)
    wq = quantize_linear(rng.standard_normal((3 * d, d)) * 0.05, fmt, packed, device="cuda")
    wp = quantize_linear(rng.standard_normal((d, d)) * 0.05, fmt, packed, device="cuda")
    return x, lns, lnb, wq, bq, wp, bp, ls


def check_gemm_variants(b, t, heads) -> bool:
    """K1 (D = 64 heads), K5 (D = 384), K7 (q5_1, N = 70, M = B T) and K8
    (q5_1 int8 SoA, D = 64 heads) on each variant of their GEMM core against
    the plain versions."""
    args = half_layer_args(b, t, 64 * heads, seed=t + heads)
    mlp = mlp_args(b, t, 384, seed=t)
    x, ql, bias = quant_args(b * t, 256, 70, seed=t, fmt="q5_1")
    quant_layer = quant_layer_args(b, t, heads, seed=t, fmt="q5_1", packed=False)
    cases = {
        "K1": (lambda: slab_layer_buffers(*args, heads, SCALE, 1e-6)[0],
               slab_layer_reference(*args, heads, SCALE, 1e-6),
               slab_layer_reference(*[a.float() for a in args], heads, SCALE, 1e-6)),
        "K5": (lambda: slab_mlp_block(*mlp, "gelu_erf", 1e-6),
               slab_mlp_reference(*mlp, "gelu_erf", 1e-6),
               slab_mlp_reference(*[a.float() for a in mlp], "gelu_erf", 1e-6)),
        "K7": (lambda: quant_matmul_kernel(x, ql, bias, "gelu_tanh"),
               quant_matmul_reference(x, ql, bias, "gelu_tanh"),
               quant_matmul_reference(x.float(), ql, bias, "gelu_tanh")),
        "K8": (lambda: slab_layer_block_quant(*quant_layer, heads, SCALE, 1e-6),
               quant_layer_reference(*quant_layer, heads, SCALE, 1e-6),
               quant_layer_reference(quant_layer[0].float(), *quant_layer[1:], heads, SCALE,
                                     1e-6)),
    }
    ok = True
    for pair, defines in GEMM_VARIANTS.items():
        for name, (kernel, plain, want) in cases.items():
            with variant(defines):
                got = kernel()
            torch.cuda.synchronize()
            ok &= held(f"{name} (columns, stages)={pair} B={b} T={t} H={heads}", got, plain, want)
    return ok


def sdpa_pair(q, k, v, g):
    leaves = [x.detach().transpose(1, 2).requires_grad_() for x in (q, k, v)]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = sdpa(*leaves, scale=SCALE)
    grad = g.transpose(1, 2)
    with torch.no_grad():
        fwd_ms = median_ms(lambda: sdpa(*leaves, scale=SCALE))
    return fwd_ms, median_ms(lambda: torch.autograd.grad(out, leaves, grad, retain_graph=True))


def profile_kernels(card: str) -> None:
    """Device time of each kernel the entries launch, by torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    for b, t, heads in BACKWARD_SHAPES:
        (q, k, v), g = inputs(b, t, heads, seed=t)
        out, lse = forward(q, k, v)
        backward(q, k, v, out, lse, g)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                out, lse = forward(q, k, v)
                backward(q, k, v, out, lse, g)
            torch.cuda.synchronize()
        for event in prof.key_averages():
            if "flash" in event.key or "delta" in event.key:
                name = re.search(r"(flash_\w+|delta_kernel)(<[^>]*>)?", event.key).group(0)
                print(f"profile B={b} T={t} H={heads}: {name}: "
                      f"{event.device_time_total / event.count / 1e3:.4f} ms a launch, "
                      f"{event.count} launches ({card})")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--ptxas", action="store_true")
    parser.add_argument("--quick", action="store_true")
    parser.add_argument("--profile", action="store_true")
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        print("tune_flash_tiles: no CUDA device available", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(card)
    names = ("flash_attention", "flash_backward", "slab_layer", "slab_attention", "slab_mlp",
             "quant_matmul", "quant_layer", "int8_matmul")
    with ThreadPoolExecutor(len(names)) as pool:
        reports = pool.map(ptxas_report, names) if opts.ptxas else ()
        build_all()
        for report in reports:
            print(report)
    if opts.ptxas:
        from dinov2_tpu_torch.ops.int8_matmul_kernel import int8_gemm_variant

        v = int8_gemm_variant()
        print(f"K9's GEMM: {v['variant']}, {v['tile'][0]} x {v['tile'][1]} tiles, a "
              f"{v['stages']}-stage ring, {v['shared_bytes']} bytes of dynamic shared memory, "
              f"{v['producer_registers']} / {v['consumer_registers']} registers a producer / "
              f"consumer thread after setmaxnreg")

    ok = True
    for t in RAGGED_T + (1370,):
        for b, heads in ((2, 3), (1, 1)):
            good = check_variants(b, t, heads) & check_gemm_variants(b, t, heads)
            ok &= good
            print(f"check B={b} T={t} H={heads}: both variants of K4, K4-lse and K6, and K1, K5, "
                  f"K7 and K8 on every variant of their GEMM core, "
                  f"{'agree with' if good else 'DISAGREE with'} the plain versions")
    if opts.quick:
        return 0 if ok else 1

    for b, t, heads in FORWARD_SHAPES:
        (q, k, v), g = inputs(b, t, heads, seed=t)
        ms = {}
        for rows in (64, 128, 128, 64):
            with variant(FORWARD_VARIANTS[rows]):
                for with_lse in (False, True):
                    ms.setdefault((rows, with_lse), []).append(
                        median_ms(lambda: forward(q, k, v, with_lse)))
        picked = _kernels.flash_attention_lib().dinov2_flash_attention_query_rows(b, t, heads)
        sdpa_ms = sdpa_pair(q, k, v, g)[0]
        shown = "; ".join(f"rows {r}{' lse' if w else ''} {min(x):.4f}" for (r, w), x in ms.items())
        print(f"K4 B={b} T={t} H={heads}: ms (best of two medians) {shown}; one SDPA call "
              f"{sdpa_ms:.4f}; the entry picks {picked} ({card})")
    for b, t, heads in BACKWARD_SHAPES:
        (q, k, v), g = inputs(b, t, heads, seed=t)
        out, lse = forward(q, k, v)
        ms = {}
        for pair in ((64, 64), (128, 128), (128, 64), (64, 128), (64, 128), (128, 64),
                     (128, 128), (64, 64)):
            with variant(BACKWARD_VARIANTS[pair]):
                ms.setdefault(pair, []).append(median_ms(lambda: backward(q, k, v, out, lse, g)))
        picked = divmod(_kernels.flash_backward_lib().dinov2_flash_backward_rows(), 1000)
        sdpa_ms = sdpa_pair(q, k, v, g)[1]
        shown = "; ".join(f"keys {kr} queries {qr} {min(x):.4f}" for (kr, qr), x in ms.items())
        print(f"K6 B={b} T={t} H={heads}: ms (best of two medians) {shown}; SDPA's backward "
              f"{sdpa_ms:.4f}; the entry takes keys, queries {picked} ({card})")
    for b, t, heads in GEMM_SHAPES:
        args = half_layer_args(b, t, 64 * heads, seed=t)
        ms = {}
        order = list(GEMM_VARIANTS)
        for pair in order + order[::-1]:
            with variant(GEMM_VARIANTS[pair]):
                ms.setdefault(pair, []).append(
                    median_ms(lambda: slab_layer_buffers(*args, heads, SCALE, 1e-6)))
        shown = "; ".join(f"{w}-column blocks, {st} stages {min(x):.4f}" for (w, st), x in ms.items())
        print(f"K1 B={b} T={t} D={64 * heads}: ms of the four launches (best of two medians) "
              f"{shown} ({card})")
    timed = {f"K5 B={b} T={t} D={d} gelu_tanh_f16, its three launches":
             (slab_mlp_block, (*mlp_args(b, t, d, seed=t), "gelu_tanh_f16", 1e-6))
             for b, t, d in MLP_SHAPES}
    for name, (m, k, n, act) in QUANT_SHAPES.items():
        timed[f"K7 q4_0 {name} M={m} K={k} N={n} {act}, its two launches"] = (
            quant_matmul_kernel, (*quant_args(m, k, n, seed=k), act))
    timed["K8 q4_0 B=64 T=257 D=768, its six launches"] = (
        slab_layer_block_quant, (*quant_layer_args(64, 257, 12, seed=0), 12, SCALE, 1e-6))
    for label, (fn, args) in timed.items():
        ms = {}
        order = list(GEMM_VARIANTS)
        for pair in order + order[::-1]:
            with variant(GEMM_VARIANTS[pair]):
                ms.setdefault(pair, []).append(median_ms(lambda: fn(*args)))
        shown = "; ".join(f"{w}-column blocks, {st} stages {min(x):.4f}" for (w, st), x in ms.items())
        print(f"{label}: ms (best of two medians) {shown} ({card})")
    if opts.profile:
        profile_kernels(card)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
