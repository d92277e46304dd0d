"""Bring-up check of the PyTorch/CUDA port (dinov2_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's three user paths once each through the Python API a user
calls, with random f16 weights from a seed, bf16, parity="reference":
  - classify: DinoEngine.classify on 64 RGB images of 256x256 with a
    full-width ViT-B/14 (1000 classes); the attention half-layer is K1;
  - quantized classify: the same ViT-B/14 quantized to q4_0 with
    quantize_gguf, through DinoEngine(quant_mode="fused").classify on the
    same images; K8 is the attention half-layer, K7 runs fc1, fc2 and the
    head from the packed blocks;
  - features and PCA: DinoEngine.extract_features and pca_visualizations on
    8 RGB images of 512x512 (518 px in, a 37x37 grid, T=1370) with a
    full-width ViT-L/14; its attention core is K4.
On the way it builds every hand-written kernel of those paths from the
sources in this checkout (one nvcc per source, all at once) and holds each
against its plain PyTorch version on the card. Each path runs with the
launch counts set to 0 just before it and read just after.

Phases, one line each (or one per format): device, build, kernel checks
(K1, K4, K7, K8), classify slice and its cross-check, quantized classify
slice, its cross-check and its findings (other routes, weight memory),
feature slice, PCA, feature cross-check. Any failure exits non-zero. The
line before the last is a JSON object with one entry per kernel; the last
line is {"ok": true, "device": {...}}. With no CUDA device, or run from a
directory that holds only this file, it exits non-zero and prints no
result.
"""

import os

# dinov2_tpu/__init__.py imports jax when JAX_PLATFORMS is set; the port
# re-exports that package's jax-free host modules and must run without jax.
os.environ.pop("JAX_PLATFORMS", None)

import json  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import time  # noqa: E402
from concurrent.futures import ThreadPoolExecutor  # noqa: E402
from functools import partial  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

ROOT = Path(__file__).resolve().parent
SEED = 0
BATCH = 64
IMAGE_PX = 256
TIMED_CALLS = 10
CROSS_CHECK_IMAGES = 4
# bf16 vs f32 on the same f16 weights: docs/PARITY.md measured <= 8.4e-2 on
# O(1) final tokens (max |token| ~5, so ~2% of the max) and <= 1.2e-4 on
# probs for ViT-S/B/L; the bounds leave 2.5x of room.
TOKEN_REL_BOUND = 5e-2
PROB_ABS_BOUND = 3e-4
# the feature slice: ViT-L/14 at 518 px, the JAX package's marquee feature shape
FEATURE_BATCH = 8
FEATURE_PX = 512  # quirk Q4: 512 px -> 518 px -> a 37x37 grid, T = 1370
FEATURE_TIMED_CALLS = 10
# PCA images from the same tokens on the card and on the CPU: at most one u8
# level apart (an f32 rounding across a .5 boundary) on >= 99% of pixels
PCA_AGREE = 0.99
KERNELS = ("slab_layer", "flash_attention", "quant_matmul", "quant_layer")
QUANT_FORMATS = ("q4_0", "q4_1", "q5_0", "q5_1", "q8_0")
QUANT_SLICE_FORMAT = "q4_0"


def require(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def cuda_median_ms(fn, warmup: int = 3, reps: int = 20) -> float:
    """Median CUDA-event time of one call of fn."""
    for _ in range(warmup):
        fn()
    events = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def phase_device() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(
        f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}"
    )
    return smi


def phase_build() -> None:
    """Every kernel library, one nvcc each, started together."""
    from dinov2_tpu_torch.ops import _kernels

    start = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        libs = list(pool.map(_kernels.build, KERNELS))
    for name in KERNELS:
        getattr(_kernels, f"{name}_lib")()
    names = ", ".join(str(lib.relative_to(ROOT)) for lib in libs)
    print(f"build: {names} in {time.perf_counter() - start:.2f} s")


def phase_kernel_check(card: str) -> dict:
    """K1 at the main path's shape against its plain version in bf16 and f32."""
    from dinov2_tpu_torch.ops.fused_attention import (
        slab_layer_block,
        slab_layer_reference,
    )

    b, t, d, heads = BATCH, 257, 768, 12
    scale, eps = 1.0 / (d // heads) ** 0.5, 1e-6
    rng = np.random.default_rng(SEED)
    arrays = [
        (rng.standard_normal((b, t, d)), torch.bfloat16),  # x
        (rng.uniform(0.5, 1.5, d), torch.float32),  # ln scale
        (rng.standard_normal(d) * 0.1, torch.float32),  # ln bias
        (rng.standard_normal((d, 3 * d)) * 0.05, torch.bfloat16),  # w_qkv
        (rng.standard_normal(3 * d) * 0.1, torch.float32),  # b_qkv
        (rng.standard_normal((d, d)) * 0.05, torch.bfloat16),  # w_proj
        (rng.standard_normal(d) * 0.1, torch.float32),  # b_proj
        (rng.uniform(0.1, 1.0, d), torch.float32),  # ls1
    ]
    args = [torch.from_numpy(a).to("cuda", dt) for a, dt in arrays]
    args32 = [a.float() for a in args]  # the same bf16-rounded values in f32

    got = slab_layer_block(*args, heads, scale, eps)
    plain = slab_layer_reference(*args, heads, scale, eps)
    want = slab_layer_reference(*args32, heads, scale, eps)
    torch.cuda.synchronize()
    err_kernel = (got.float() - want).abs().max().item()
    err_plain = (plain.float() - want).abs().max().item()
    ref_max = want.abs().max().item()
    # The kernel and the plain bf16 version round to bf16 at the same points
    # but sum in other orders, and the kernel rounds the unnormalized
    # probabilities where the plain version rounds normalized ones. Both
    # distances from f32 are bf16 rounding noise of one size, so the kernel
    # may be twice as far as the plain version, plus 1e-3 of the output's
    # scale for the differently rounded probabilities.
    bound = 2 * err_plain + 1e-3 * ref_max
    ms_kernel = cuda_median_ms(lambda: slab_layer_block(*args, heads, scale, eps))
    ms_plain = cuda_median_ms(lambda: slab_layer_reference(*args, heads, scale, eps))
    print(
        f"kernel check: slab_layer_block B={b} T={t} D={d} H={heads}: "
        f"max|K1-f32| {err_kernel:.6g}, max|plain_bf16-f32| {err_plain:.6g}, "
        f"max|f32| {ref_max:.6g}, bound {bound:.6g}; median K1 {ms_kernel:.4f} ms, "
        f"plain bf16 {ms_plain:.4f} ms ({card})"
    )
    require(bool(torch.isfinite(got).all()), "K1 output is not finite")
    require(err_kernel <= bound, f"K1 error {err_kernel} exceeds {bound}")
    return {"max_abs_err": err_kernel, "ms": ms_kernel, "plain_ms": ms_plain}


def phase_flash_check(card: str) -> dict:
    """K4 against its plain version in bf16 and f32 at the feature slice's
    shape through flash_attention_slab, and at an 896 px image's sequence
    (T=4226, which the TPU runs as multi-KV online softmax) through
    flash_attention."""
    from dinov2_tpu_torch.ops.attention import split_heads, vanilla_attention
    from dinov2_tpu_torch.ops.flash_attention import flash_attention, flash_attention_slab

    heads, scale = 16, 0.125
    measured = {}
    for b, t, slab in ((FEATURE_BATCH, 1370, True), (1, 4226, False)):
        rng = np.random.default_rng(SEED + t)
        qkv = torch.from_numpy(rng.standard_normal((b, t, 3 * 64 * heads)) * 1.5)
        qkv = qkv.to("cuda", torch.bfloat16)
        q, k, v = split_heads(qkv, heads)
        if slab:
            entry, kernel = "flash_attention_slab", partial(flash_attention_slab, qkv, heads, scale)
        else:
            q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
            entry, kernel = "flash_attention", partial(flash_attention, q, k, v, scale)
        got = kernel().reshape(b, t, heads, 64)
        plain = vanilla_attention(q, k, v, scale)
        want = vanilla_attention(q.float(), k.float(), v.float(), scale)
        torch.cuda.synchronize()
        err_kernel = (got.float() - want).abs().max().item()
        err_plain = (plain.float() - want).abs().max().item()
        ref_max = want.abs().max().item()
        bound = 2 * err_plain + 1e-3 * ref_max  # K1's bound, for the same reasons
        ms_kernel = cuda_median_ms(kernel)
        ms_plain = cuda_median_ms(lambda: vanilla_attention(q, k, v, scale))
        print(
            f"kernel check: {entry} B={b} T={t} H={heads} hd=64: "
            f"max|K4-f32| {err_kernel:.6g}, max|plain_bf16-f32| {err_plain:.6g}, "
            f"max|f32| {ref_max:.6g}, bound {bound:.6g}; median K4 {ms_kernel:.4f} ms, "
            f"plain bf16 {ms_plain:.4f} ms ({card})"
        )
        require(bool(torch.isfinite(got).all()), f"K4 output at T={t} is not finite")
        require(err_kernel <= bound, f"K4 error {err_kernel} at T={t} exceeds {bound}")
        measured[t] = {"max_abs_err": err_kernel, "ms": ms_kernel, "plain_ms": ms_plain}
    return {
        # the JSON line's numbers are the slice shape's; the error is the worse
        "max_abs_err": max(m["max_abs_err"] for m in measured.values()),
        "ms": measured[1370]["ms"],
        "plain_ms": measured[1370]["plain_ms"],
        "ms_t4226": measured[4226]["ms"],
        "plain_ms_t4226": measured[4226]["plain_ms"],
    }


def _vit_b14_config():
    from dinov2_tpu_torch.models.config import PRESETS, DinoConfig

    return DinoConfig(**{**PRESETS["base"].__dict__, "num_classes": 1000, "img_size": 518})


def _classify_images() -> np.ndarray:
    return np.random.default_rng(SEED + 1).integers(
        0, 256, (BATCH, IMAGE_PX, IMAGE_PX, 3), dtype=np.uint8
    )


def _timed_classify(engine, images) -> tuple[float, float]:
    """img/s over TIMED_CALLS classify_probs calls, and their median ms."""
    seconds = []
    for _ in range(TIMED_CALLS):
        start = time.perf_counter()
        engine.classify_probs(images)
        seconds.append(time.perf_counter() - start)
    return BATCH * TIMED_CALLS / sum(seconds), 1e3 * statistics.median(seconds)


def _cpu_cross_check(engine, cpu_params, images, config) -> tuple[float, float]:
    """The first images through the engine's forward on the card and through
    the port's plain f32 forward on the CPU: max|dtokens|/max|tokens| and
    max|dprobs|."""
    from dinov2_tpu_torch.image.preprocess import classify_preprocess
    from dinov2_tpu_torch.models.vit import ModelOptions, forward_features, forward_head

    sub = images[:CROSS_CHECK_IMAGES]
    with torch.inference_mode():
        pre = classify_preprocess(torch.from_numpy(sub).cuda())
        tok = forward_features(engine.model.params, pre, config, engine.opts)
        prob = forward_head(engine.model.params, tok, config, engine.opts)
        opts32 = ModelOptions(parity="reference", compute_dtype=torch.float32)
        pre32 = classify_preprocess(torch.from_numpy(sub))
        tok32 = forward_features(cpu_params, pre32, config, opts32)
        prob32 = forward_head(cpu_params, tok32, config, opts32)
    tok_rel = ((tok.cpu() - tok32).abs().max() / tok32.abs().max()).item()
    return tok_rel, (prob.cpu() - prob32).abs().max().item()


def _check_probs(top5, probs, config) -> float:
    """Shapes, finiteness and row sums of a classify run; returns the
    largest |row sum - 1|."""
    require(len(top5) == BATCH and all(len(r) == 5 for r in top5), "classify top-5 shape")
    require(probs.shape == (BATCH, config.num_classes), f"probs shape {probs.shape}")
    require(bool(np.isfinite(probs).all()), "probs are not finite")
    row_err = float(np.abs(probs.sum(axis=-1) - 1.0).max())
    require(row_err <= 1e-3, f"probs rows sum to 1 within {row_err}")
    return row_err


def phase_quant_matmul_check(card: str) -> dict:
    """K7 in every format at the quantized slice's shapes against its plain
    version in x's dtype and in f32: fc1 with the GELU epilogue, fc2 with its
    bias, and the head on f32 features (N=1000, the masked edge)."""
    from dinov2_tpu_torch.models.params import quantize_linear
    from dinov2_tpu_torch.ops.qmatmul_kernel import quant_matmul_kernel, quant_matmul_reference

    shapes = {  # name -> (M, K, N, activation, x dtype)
        "fc1": (BATCH * 257, 768, 3072, "gelu_tanh_f16", torch.bfloat16),
        "fc2": (BATCH * 257, 3072, 768, None, torch.bfloat16),
        "head": (BATCH, 1536, 1000, None, torch.float32),
    }
    measured: dict = {}
    for fmt in QUANT_FORMATS:
        for name, (m, k, n, act, dtype) in shapes.items():
            rng = np.random.default_rng(SEED + k)
            ql = quantize_linear(rng.standard_normal((n, k)) * 0.05, fmt, device="cuda")
            x = torch.from_numpy(rng.standard_normal((m, k))).to("cuda", dtype)
            bias = torch.from_numpy(rng.standard_normal(n) * 0.1).to("cuda", torch.float32)
            kernel = partial(quant_matmul_kernel, x, ql, bias, act)
            plain = partial(quant_matmul_reference, x, ql, bias, act)
            got, ref = kernel(), plain()
            want = quant_matmul_reference(x.float(), ql, bias, act)
            torch.cuda.synchronize()
            err_kernel = (got.float() - want).abs().max().item()
            err_plain = (ref.float() - want).abs().max().item()
            ref_max = want.abs().max().item()
            bound = 2 * err_plain + 1e-3 * ref_max  # K1's bound, for the same reasons
            ms_kernel, ms_plain = cuda_median_ms(kernel), cuda_median_ms(plain)
            print(
                f"kernel check: quant_matmul_kernel {fmt} {name} M={m} K={k} N={n} "
                f"{str(dtype).removeprefix('torch.')} {act}: max|K7-f32| {err_kernel:.6g}, "
                f"max|plain-f32| {err_plain:.6g}, max|f32| {ref_max:.6g}, bound {bound:.6g}; "
                f"median K7 {ms_kernel:.4f} ms, plain {ms_plain:.4f} ms ({card})"
            )
            require(bool(torch.isfinite(got).all()), f"K7 {fmt} {name} output is not finite")
            require(err_kernel <= bound, f"K7 {fmt} {name} error {err_kernel} exceeds {bound}")
            measured[fmt, name] = {"max_abs_err": err_kernel, "ms": ms_kernel, "plain_ms": ms_plain}
    q = {name: measured[QUANT_SLICE_FORMAT, name] for name in shapes}
    return {
        # q4_0's times at fc1 (and the other shapes beside); the worst error
        "max_abs_err": max(v["max_abs_err"] for v in measured.values()),
        "ms": q["fc1"]["ms"],
        "plain_ms": q["fc1"]["plain_ms"],
        **{f"{key}_{name}": q[name][key] for name in ("fc2", "head") for key in ("ms", "plain_ms")},
    }


def phase_quant_layer_check(card: str) -> dict:
    """K8 at the main path's shape against its plain version in bf16 and
    f32, for q4_0 and q5_1 (packed planes, q5_1 with m and 5th bits) and
    q8_0 (int8 SoA)."""
    from dinov2_tpu_torch.models.params import quantize_linear
    from dinov2_tpu_torch.ops.fused_quant_attention import (
        quant_layer_reference,
        slab_layer_block_quant,
    )

    b, t, d, heads = BATCH, 257, 768, 12
    scale, eps = 1.0 / (d // heads) ** 0.5, 1e-6
    measured = {}
    for fmt in ("q4_0", "q5_1", "q8_0"):
        rng = np.random.default_rng(SEED)
        arrays = [
            (rng.standard_normal((b, t, d)), torch.bfloat16),  # x
            (rng.uniform(0.5, 1.5, d), torch.float32),  # ln scale
            (rng.standard_normal(d) * 0.1, torch.float32),  # ln bias
            (rng.standard_normal(3 * d) * 0.1, torch.float32),  # b_qkv
            (rng.standard_normal(d) * 0.1, torch.float32),  # b_proj
            (rng.uniform(0.1, 1.0, d), torch.float32),  # ls1
        ]
        x, lns, lnb, bq, bp, ls = [torch.from_numpy(a).to("cuda", dt) for a, dt in arrays]
        wq = quantize_linear(rng.standard_normal((3 * d, d)) * 0.05, fmt, device="cuda")
        wp = quantize_linear(rng.standard_normal((d, d)) * 0.05, fmt, device="cuda")
        rest = (lns, lnb, wq, bq, wp, bp, ls, heads, scale, eps)
        got = slab_layer_block_quant(x, *rest)
        plain = quant_layer_reference(x, *rest)
        want = quant_layer_reference(x.float(), *rest)
        torch.cuda.synchronize()
        err_kernel = (got.float() - want).abs().max().item()
        err_plain = (plain.float() - want).abs().max().item()
        ref_max = want.abs().max().item()
        bound = 2 * err_plain + 1e-3 * ref_max  # K1's bound, for the same reasons
        ms_kernel = cuda_median_ms(lambda: slab_layer_block_quant(x, *rest))
        ms_plain = cuda_median_ms(lambda: quant_layer_reference(x, *rest))
        print(
            f"kernel check: slab_layer_block_quant {fmt} ({'packed' if wq.packed else 'int8 SoA'}) "
            f"B={b} T={t} D={d} H={heads}: max|K8-f32| {err_kernel:.6g}, "
            f"max|plain_bf16-f32| {err_plain:.6g}, max|f32| {ref_max:.6g}, bound {bound:.6g}; "
            f"median K8 {ms_kernel:.4f} ms, plain bf16 {ms_plain:.4f} ms ({card})"
        )
        require(bool(torch.isfinite(got).all()), f"K8 {fmt} output is not finite")
        require(err_kernel <= bound, f"K8 {fmt} error {err_kernel} exceeds {bound}")
        measured[fmt] = {"max_abs_err": err_kernel, "ms": ms_kernel, "plain_ms": ms_plain}
    return {
        "max_abs_err": max(v["max_abs_err"] for v in measured.values()),
        "ms": measured[QUANT_SLICE_FORMAT]["ms"],
        "plain_ms": measured[QUANT_SLICE_FORMAT]["plain_ms"],
    }


def _load_engine(path, **quant):
    """A DinoEngine on the card and the device memory its load allocated:
    (engine, peak MB during the load, MB held after it)."""
    from dinov2_tpu_torch.runtime.engine import DinoEngine

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    engine = DinoEngine(path, dtype=torch.bfloat16, parity="reference", device="cuda", **quant)
    torch.cuda.synchronize()
    return (engine, (torch.cuda.max_memory_allocated() - base) / 1e6,
            (torch.cuda.memory_allocated() - base) / 1e6)


def phase_quant_slice(card: str, dense_rate: float) -> tuple[int, int]:
    """The ViT-B/14 of the classify slice quantized to q4_0 through
    DinoEngine(quant_mode="fused").classify on the card; returns the K7 and
    K8 launches of that run (K1 and K4 must launch no time). Then, as
    findings and no checks, the other quantized routes' rates and the
    weights' device memory in fused and dequant mode."""
    from dinov2_tpu_torch.io.synthetic import write_synthetic_gguf
    from dinov2_tpu_torch.models.params import load_params
    from dinov2_tpu_torch.ops.flash_attention import flash_attention
    from dinov2_tpu_torch.ops.fused_attention import slab_layer_block
    from dinov2_tpu_torch.ops.fused_quant_attention import slab_layer_block_quant
    from dinov2_tpu_torch.ops.qmatmul_kernel import quant_matmul_kernel
    from dinov2_tpu_torch.quant import quantize_gguf

    config = _vit_b14_config()
    images = _classify_images()
    with tempfile.TemporaryDirectory() as tmp:
        dense = write_synthetic_gguf(Path(tmp) / "vit_b14.gguf", config, seed=SEED)
        start = time.perf_counter()
        path = quantize_gguf(dense, Path(tmp) / f"vit_b14.{QUANT_SLICE_FORMAT}.gguf",
                             QUANT_SLICE_FORMAT)
        quantize_s = time.perf_counter() - start
        engine, fused_peak_mb, fused_mb = _load_engine(path, quant_mode="fused")
        routes = {
            'quant_slab="dequant" (K1 on per-layer dequantized weights, K7)':
                _load_engine(path, quant_mode="fused", quant_slab="dequant")[0],
            'quant_backend="dequant" (K8, plain dequant + cuBLAS matmuls)':
                _load_engine(path, quant_mode="fused", quant_backend="dequant")[0],
        }
        dequant_engine, dequant_peak_mb, dequant_mb = _load_engine(path, quant_mode="dequant")
        del dequant_engine
        cpu_model = load_params(path, dtype=torch.float32, device="cpu", quant_mode="dequant")
    require(engine.loaded.quantized, "the q4_0 file did not load as QuantLinear weights")

    engine.warmup((IMAGE_PX, IMAGE_PX), batch=BATCH)
    counters = (slab_layer_block_quant, quant_matmul_kernel, slab_layer_block, flash_attention)
    for counter in counters:
        counter.launches = 0
    top5 = engine.classify(images, topk=5)
    probs = engine.classify_probs(images)
    rate, median_ms = _timed_classify(engine, images)
    k8, k7, k1, k4 = (counter.launches for counter in counters)
    forwards = 2 + TIMED_CALLS
    layers = config.num_hidden_layers

    row_err = _check_probs(top5, probs, config)
    require(k8 == layers * forwards, f"K8 launched {k8} times in {forwards} forwards")
    require(k7 == (2 * layers + 1) * forwards, f"K7 launched {k7} times in {forwards} forwards")
    require(k1 == 0 and k4 == 0, f"K1 launched {k1} and K4 {k4} times in the quantized path")
    print(
        f"quant slice: ViT-B/14 {QUANT_SLICE_FORMAT} (quant_mode=\"fused\") classify "
        f"{BATCH}x{IMAGE_PX}px bf16 on {card}: probs finite, max|row sum - 1| {row_err:.3g}, "
        f"K8 launches {k8} = {layers} x {forwards} forwards, K7 launches {k7} = "
        f"{2 * layers + 1} x {forwards}, K1 and K4 0; {rate:.1f} img/s over {TIMED_CALLS} "
        f"timed classify_probs calls (median {median_ms:.2f} ms/call); "
        f"quantize_gguf took {quantize_s:.1f} s"
    )

    tok_rel, prob_err = _cpu_cross_check(engine, cpu_model.params, images, config)
    print(
        f"quant cross-check: {CROSS_CHECK_IMAGES} images, GPU bf16 fused vs CPU f32 plain on "
        f"the same {QUANT_SLICE_FORMAT} file decoded at load: max|dtokens|/max|tokens| "
        f"{tok_rel:.4g} (bound {TOKEN_REL_BOUND}), max|dprobs| {prob_err:.4g} "
        f"(bound {PROB_ABS_BOUND})"
    )
    require(tok_rel <= TOKEN_REL_BOUND, "quantized tokens differ from the CPU f32 forward")
    require(prob_err <= PROB_ABS_BOUND, "quantized probs differ from the CPU f32 forward")

    for label, other in routes.items():
        other.warmup((IMAGE_PX, IMAGE_PX), batch=BATCH)
        other_rate, other_ms = _timed_classify(other, images)
        print(
            f"quant finding, not a check: {label}: {other_rate:.1f} img/s (median "
            f"{other_ms:.2f} ms/call) against {rate:.1f} img/s on the default kernel routes "
            f"and {dense_rate:.1f} img/s for the dense bf16 model ({card})"
        )
    weight_mb = sum(t.numel() * t.element_size() for t in engine.model.buffers()) / 1e6
    print(
        f"quant finding, not a check: device memory of the load, {QUANT_SLICE_FORMAT} ViT-B/14: "
        f"fused {fused_mb:.1f} MB held ({weight_mb:.1f} MB of model buffers, peak "
        f"{fused_peak_mb:.1f} MB), dequant {dequant_mb:.1f} MB held (peak "
        f"{dequant_peak_mb:.1f} MB) (torch.cuda memory stats, {card})"
    )
    return k7, k8


def phase_slice(card: str) -> tuple[int, float]:
    """DinoEngine.classify on the card; returns K1 launches of that run (K4
    must launch no time: T=257 takes the slab route) and its img/s."""
    from dinov2_tpu_torch.io.synthetic import write_synthetic_gguf
    from dinov2_tpu_torch.models.params import load_params
    from dinov2_tpu_torch.ops.flash_attention import flash_attention
    from dinov2_tpu_torch.ops.fused_attention import slab_layer_block
    from dinov2_tpu_torch.runtime.engine import DinoEngine

    config = _vit_b14_config()
    images = _classify_images()
    with tempfile.TemporaryDirectory() as tmp:
        path = write_synthetic_gguf(Path(tmp) / "vit_b14.gguf", config, seed=SEED)
        engine = DinoEngine(path, dtype=torch.bfloat16, parity="reference", device="cuda")
        cpu_model = load_params(path, dtype=torch.float32, device="cpu")

    engine.warmup((IMAGE_PX, IMAGE_PX), batch=BATCH)
    slab_layer_block.launches = flash_attention.launches = 0
    top5 = engine.classify(images, topk=5)
    probs = engine.classify_probs(images)
    rate, median_ms = _timed_classify(engine, images)
    launches, k4_launches = slab_layer_block.launches, flash_attention.launches
    forwards = 2 + TIMED_CALLS

    row_err = _check_probs(top5, probs, config)
    require(
        launches == config.num_hidden_layers * forwards,
        f"K1 launched {launches} times in {forwards} forwards",
    )
    require(k4_launches == 0, f"K4 launched {k4_launches} times in the classify path")
    print(
        f"slice: ViT-B/14 classify {BATCH}x{IMAGE_PX}px bf16 on {card}: probs finite, "
        f"max|row sum - 1| {row_err:.3g}, K1 launches {launches} = "
        f"{config.num_hidden_layers} x {forwards} forwards; "
        f"{rate:.1f} img/s over {TIMED_CALLS} timed "
        f"classify_probs calls (median {median_ms:.2f} ms/call)"
    )

    # the same images through the port's plain f32 forward on the CPU
    tok_rel, prob_err = _cpu_cross_check(engine, cpu_model.params, images, config)
    print(
        f"cross-check: {CROSS_CHECK_IMAGES} images, GPU bf16 vs CPU f32 plain: "
        f"max|dtokens|/max|tokens| {tok_rel:.4g} (bound {TOKEN_REL_BOUND}), "
        f"max|dprobs| {prob_err:.4g} (bound {PROB_ABS_BOUND})"
    )
    require(tok_rel <= TOKEN_REL_BOUND, "tokens differ from the CPU f32 forward")
    require(prob_err <= PROB_ABS_BOUND, "probs differ from the CPU f32 forward")
    return launches, rate


def _agree_u8(a: np.ndarray, b: np.ndarray) -> float:
    """Share of values at most one u8 level apart."""
    return float((np.abs(a.astype(np.int32) - b.astype(np.int32)) <= 1).mean())


def phase_features(card: str) -> int:
    """DinoEngine.extract_features and pca_visualizations with a full-width
    ViT-L/14 on 8 images of 512 px; returns K4 launches of that run (K1 must
    launch no time: T=1370 takes the flash route). Then, as a routing
    finding and no check, the same batch on the slab route (K1 at T=1370)."""
    from dinov2_tpu_torch.image.pca import pca_visualization_batch, resize_nearest_host
    from dinov2_tpu_torch.image.preprocess import feature_preprocess
    from dinov2_tpu_torch.io.synthetic import write_synthetic_gguf
    from dinov2_tpu_torch.models.config import PRESETS
    from dinov2_tpu_torch.models.params import load_params
    from dinov2_tpu_torch.models.vit import ModelOptions, forward
    from dinov2_tpu_torch.ops.flash_attention import flash_attention
    from dinov2_tpu_torch.ops.fused_attention import slab_layer_block
    from dinov2_tpu_torch.runtime.engine import DinoEngine

    config = PRESETS["large"]
    hw = (FEATURE_PX, FEATURE_PX)
    images = np.random.default_rng(SEED + 2).integers(
        0, 256, (FEATURE_BATCH, *hw, 3), dtype=np.uint8
    )
    with tempfile.TemporaryDirectory() as tmp:
        path = write_synthetic_gguf(Path(tmp) / "vit_l14.gguf", config, seed=SEED)
        engines = {
            route: DinoEngine(path, dtype=torch.bfloat16, parity="reference",
                              flash_attention=route, device="cuda")
            for route in ("auto", "slab")
        }
        cpu_model = load_params(path, dtype=torch.float32, device="cpu")
    engine = engines["auto"]

    def timed(eng) -> tuple[list[float], float]:
        """Host seconds of each call, and the median ms of its synchronized
        forward alone (the engine's last_compute_ms: preprocess and model,
        without the upload and the copy of the tokens to the host)."""
        seconds, forward_ms = [], []
        for _ in range(FEATURE_TIMED_CALLS):
            start = time.perf_counter()
            eng.extract_features(images)
            seconds.append(time.perf_counter() - start)
            forward_ms.append(eng.last_compute_ms)
        return seconds, statistics.median(forward_ms)

    engine.warmup(hw, batch=FEATURE_BATCH, classify=False)
    slab_layer_block.launches = flash_attention.launches = 0
    feats = engine.extract_features(images)
    seconds, forward_ms = timed(engine)
    start = time.perf_counter()
    vis = engine.pca_visualizations(list(images))
    pca_seconds = time.perf_counter() - start
    launches, k1_launches = flash_attention.launches, slab_layer_block.launches
    forwards = 2 + FEATURE_TIMED_CALLS

    tokens, grid = feats["patch_tokens"], feats["grid"]
    n_tokens = grid[0] * grid[1]
    require(grid == (37, 37), f"feature grid {grid}")
    require(tokens.shape == (FEATURE_BATCH, n_tokens, config.hidden_size),
            f"patch_tokens shape {tokens.shape}")
    require(feats["cls_token"].shape == (FEATURE_BATCH, config.hidden_size),
            f"cls_token shape {feats['cls_token'].shape}")
    require(bool(np.isfinite(tokens).all() and np.isfinite(feats["cls_token"]).all()),
            "features are not finite")
    require(
        launches == config.num_hidden_layers * forwards,
        f"K4 launched {launches} times in {forwards} forwards",
    )
    require(k1_launches == 0, f"K1 launched {k1_launches} times in the feature path")
    rate = FEATURE_BATCH * FEATURE_TIMED_CALLS / sum(seconds)
    print(
        f"features: ViT-L/14 extract_features {FEATURE_BATCH}x{FEATURE_PX}px -> grid {grid}, "
        f"T={n_tokens + 1}, bf16 on {card}: tokens finite, K4 launches {launches} = "
        f"{config.num_hidden_layers} x {forwards} forwards, K1 launches 0; "
        f"{rate:.1f} img/s over {FEATURE_TIMED_CALLS} timed calls "
        f"(median {1e3 * statistics.median(seconds):.2f} ms/call, of which the forward "
        f"{forward_ms:.2f} ms)"
    )

    slab = engines["slab"]
    slab.warmup(hw, batch=FEATURE_BATCH, classify=False)
    slab_seconds, slab_forward_ms = timed(slab)
    print(
        f"features, slab route (K1 at T={n_tokens + 1}, a routing finding, not a check): "
        f"{FEATURE_BATCH * FEATURE_TIMED_CALLS / sum(slab_seconds):.1f} img/s "
        f"(median {1e3 * statistics.median(slab_seconds):.2f} ms/call, forward "
        f"{slab_forward_ms:.2f} ms) against {rate:.1f} img/s (median "
        f"{1e3 * statistics.median(seconds):.2f} ms/call, forward {forward_ms:.2f} ms) "
        f"on the auto route (K4)"
    )

    # PCA: the card's against the plain CPU version on the card's tokens
    with torch.inference_mode():
        card_grid = pca_visualization_batch(torch.from_numpy(tokens).cuda(), grid).cpu().numpy()
        cpu_grid = pca_visualization_batch(torch.from_numpy(tokens), grid).numpy()
    cpu_vis = resize_nearest_host(cpu_grid, *hw)
    agree_grid = _agree_u8(card_grid, cpu_grid)
    agree_vis = _agree_u8(np.stack(vis), cpu_vis)
    require(
        all(v.shape == (*hw, 3) and v.dtype == np.uint8 for v in vis) and len(vis) == FEATURE_BATCH,
        "PCA: pca_visualizations output shape",
    )
    print(
        f"pca: {FEATURE_BATCH} images of {FEATURE_PX}x{FEATURE_PX}x3 u8 in "
        f"{1e3 * pca_seconds:.1f} ms (one pca_visualizations call: forward, eigh, host "
        f"resize); within one level of "
        f"the CPU PCA of the card's tokens: {agree_grid:.2%} of the grid values (card PCA "
        f"of the same tokens), {agree_vis:.2%} of the pixels (pca_visualizations); "
        f"bound {PCA_AGREE:.0%}"
    )
    require(agree_grid >= PCA_AGREE, "PCA: the card's PCA differs from the CPU PCA")
    require(agree_vis >= PCA_AGREE, "PCA: pca_visualizations differs from the CPU PCA")

    # the forward: one image through the port's plain f32 forward on the CPU
    with torch.inference_mode():
        opts32 = ModelOptions(parity="reference", flash_attention="vanilla",
                              compute_dtype=torch.float32)
        pre32 = feature_preprocess(torch.from_numpy(images[:1]), config.patch_size)
        out32 = forward(cpu_model.params, pre32, config, opts32)
    tok32 = torch.cat([out32["cls_token"][:, None], out32["patch_tokens"]], dim=1)
    tok = torch.from_numpy(
        np.concatenate([feats["cls_token"][:1, None], tokens[:1]], axis=1)
    )
    tok_rel = ((tok - tok32).abs().max() / tok32.abs().max()).item()
    print(
        f"feature cross-check: 1 image, GPU bf16 (K4) vs CPU f32 plain (vanilla route): "
        f"max|dtokens|/max|tokens| {tok_rel:.4g} (bound {TOKEN_REL_BOUND})"
    )
    require(tok_rel <= TOKEN_REL_BOUND, "forward: feature tokens differ from the CPU f32 forward")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    smi = phase_device()
    card = smi.replace(",", "")
    phase_build()
    k1_measured = phase_kernel_check(card)
    k4_measured = phase_flash_check(card)
    k7_measured = phase_quant_matmul_check(card)
    k8_measured = phase_quant_layer_check(card)
    k1_launches, dense_rate = phase_slice(card)
    k7_launches, k8_launches = phase_quant_slice(card, dense_rate)
    k4_launches = phase_features(card)
    kernels = [
        {
            "name": "slab_layer_block",
            "route": "cuda",
            "source": "dinov2_tpu_torch/csrc/slab_layer.cu",
            "replaces": "dinov2_tpu/ops/fused_attention.py:593",
            "launches": k1_launches,
            **k1_measured,
        },
        {
            "name": "flash_attention",
            "route": "cuda",
            "source": "dinov2_tpu_torch/csrc/flash_attention.cu",
            "replaces": "dinov2_tpu/ops/flash_attention.py:95",
            "also_replaces": "dinov2_tpu/ops/flash_attention.py:34",
            "launches": k4_launches,
            **k4_measured,
        },
        {
            "name": "quant_matmul_kernel",
            "route": "cuda",
            "source": "dinov2_tpu_torch/csrc/quant_matmul.cu",
            "replaces": "dinov2_tpu/ops/pallas_qmatmul.py:215",
            "also_replaces": "dinov2_tpu/ops/pallas_qmatmul.py:81, dinov2_tpu/ops/pallas_qmatmul.py:104",
            "launches": k7_launches,
            **k7_measured,
        },
        {
            "name": "slab_layer_block_quant",
            "route": "cuda",
            "source": "dinov2_tpu_torch/csrc/quant_layer.cu",
            "replaces": "dinov2_tpu/ops/fused_quant_attention.py:183",
            "launches": k8_launches,
            **k8_measured,
        },
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
