"""Bring-up check of the PyTorch/CUDA port (dinov2_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's user paths once each through the Python API a user calls,
with random f16 weights from a seed, bf16, parity="reference":
  - classify: DinoEngine.classify on 64 RGB images of 256x256 with a
    full-width ViT-B/14 (1000 classes); the attention half-layer is K1. Then
    the same weights with fuse_mlp=True: K1 and, for the MLP half-layer, K5;
  - quantized classify: the same ViT-B/14 quantized to q4_0 with
    quantize_gguf, through DinoEngine(quant_mode="fused").classify on the
    same images; K8 is the attention half-layer, K7 runs fc1, fc2 and the
    head from the packed blocks;
  - features and PCA: DinoEngine.extract_features and pca_visualizations on
    8 RGB images of 512x512 (518 px in, a 37x37 grid, T=1370) with a
    full-width ViT-L/14; its attention core is K4;
  - ViT-g/14 classify: DinoEngine.classify on 16 images of 256x256 with
    ViT-g/14 at full width (D=1536, 24 heads, SwiGLU hidden 4096, 1000
    classes) from a synthetic f16 GGUF, depth cut to 12 of its 40 layers, at
    each level of the slab route: slab_fusion="core" (K3, the JAX package's
    route for this model), "proj" (K2) and "layer" (K1) on the same device
    weights;
  - training: make_trainer(...).place and five Trainer.step calls on one
    batch of 32 uint8 images of 256x256 with a full-width ViT-B/14 (12
    layers, 1000 classes, init_params seed 0), parity="hf", bf16 compute
    over f32 masters, remat, AdamW: with flash_attention=True (the K4
    with_lse forward and K6, the flash backward) and with "auto" (K1
    forward, recompute backward); the model exported with export_gguf after
    step 5 classifies through DinoEngine; then two steps at batch 8 on
    518 px preprocessed input (T=1370, "auto" takes the flash route).
On the way it builds every hand-written kernel of those paths from the
sources in this checkout (one nvcc per source, all at once) and holds each
against its plain PyTorch version on the card, with its time beside its
roofline bound (H100 SXM peaks) and, for K3 and K4, beside
scaled_dot_product_attention on the same inputs (a yardstick the port never
calls). Each path runs with the launch counts set to 0 just before it and
read just after.

Phases, one line each (or one per format or shape), each with its seconds:
device, build, kernel checks (K1, K3 and K2, K5, K4, K4 with lse and K6, the
autograd Functions of K1, K2, K3 and K5, K7, K8), classify slice,
its cross-check and the fuse_mlp slice with its own, quantized classify
slice, its cross-check and its findings (other routes, weight memory),
feature slice, PCA, feature cross-check, ViT-g/14 slice at its three levels
and its cross-check, training slice on both routes with its cross-check and
export, long-sequence training; then a check that no "auto" attention route
of these bf16 paths fell to plain PyTorch on the card. Any failure exits
non-zero. The line before the last is a JSON object with one entry per kernel; the last line is
{"ok": true, "device": {...}}. With no CUDA device, or run from a directory
that holds only this file, it exits non-zero and prints no result.
"""

import copy
import dataclasses
import json
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from functools import partial
from pathlib import Path
from typing import Any

import numpy as np
import torch

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
KERNELS = ("slab_layer", "slab_attention", "slab_mlp", "flash_attention", "flash_backward",
           "quant_matmul", "quant_layer")
QUANT_FORMATS = ("q4_0", "q4_1", "q5_0", "q5_1", "q8_0")
QUANT_SLICE_FORMAT = "q4_0"
# the ViT-g/14 slice: full width, 12 of the 40 layers (the file to write and
# load twice is 0.7 GB instead of 2.3 GB: writing and loading it, not the
# forwards, is most of the phase's time)
GIANT_LAYERS = 12
GIANT_BATCH = 16
GIANT_CROSS_CHECK_IMAGES = 2
# bf16 error grows with depth: docs/PARITY.md measured 2.5e-1 on the 40-layer
# giant's bf16 tokens against 8.4e-2 for ViT-S/B (3x), and no bf16 probs for
# it. The token bound is relative to max|token| and stays; the probs bound
# scales with the tokens' envelope, 3 x 3e-4 ~ 1e-3 (this slice reads 3.2e-4).
GIANT_PROB_ABS_BOUND = 1e-3
# the training slice: the train CLI's default batch of 256 px images (224 px
# in the model, T=257), five steps on one batch; then T=1370 at batch 8
TRAIN_BATCH = 32
TRAIN_STEPS = 5
TRAIN_CROSS_CHECK_IMAGES = 4
# the loss of a batch in bf16 on the card against f32 on the CPU: logits of a
# random-weight model are O(1) and carry the bf16 token envelope above
TRAIN_LOSS_ABS_BOUND = 2e-2
TRAIN_LONG_BATCH = 8
TRAIN_LONG_STEPS = 2
LSE_ABS_BOUND = 1e-3  # the kernel's f32 row logsumexp against the plain f32 one
# H100 SXM peaks (NVIDIA's data sheet, dense): a kernel's bound is the larger
# of its operations over the first and its bytes over the second
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12  # outside the tensor cores: K7's f32 head
PEAK_BYTES_PER_S = 3.35e12


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


def nbytes(*tensors) -> int:
    """Bytes of the given tensors; a QuantLinear counts its tensor fields."""
    total = 0
    for t in tensors:
        parts = t.tensors().values() if hasattr(t, "tensors") else [t]
        total += sum(p.numel() * p.element_size() for p in parts)
    return total


def roofline(flops: float, moved_bytes: int, peak_flops: float = PEAK_BF16_FLOPS) -> dict:
    """The least time the card could take: each input byte read once, each
    output byte written once, the operations at the peak rate of their type
    (the bf16 tensor rate unless the caller says otherwise)."""
    ops_ms = 1e3 * flops / peak_flops
    bytes_ms = 1e3 * moved_bytes / PEAK_BYTES_PER_S
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def check_kernel(label, tag, kernel, plain, plain_f32, card, flops, moved_bytes,
                 library=None, peak_flops=PEAK_BF16_FLOPS) -> dict:
    """One kernel call against its plain version in the same dtype and in
    f32 on the same inputs. The kernel and the plain bf16 version round to
    bf16 at the same points but sum in other orders, and the attention
    kernels round the unnormalized probabilities where the plain version
    rounds normalized ones. Both distances from f32 are bf16 rounding noise
    of one size, so the kernel may be twice as far as the plain version,
    plus 1e-3 of the output's scale. Then CUDA-event medians of the kernel,
    the plain version and, where given, the library call."""
    got, ref, want = kernel(), plain(), plain_f32()
    torch.cuda.synchronize()
    got = got.reshape(want.shape)
    err_kernel = (got.float() - want).abs().max().item()
    err_plain = (ref.reshape(want.shape).float() - want).abs().max().item()
    ref_max = want.abs().max().item()
    bound = 2 * err_plain + 1e-3 * ref_max
    measured = {
        "max_abs_err": err_kernel,
        "ms": cuda_median_ms(kernel),
        "plain_ms": cuda_median_ms(plain),
        **roofline(flops, moved_bytes, peak_flops),
        "library_ms": cuda_median_ms(library) if library else None,
    }
    line = (
        f"kernel check: {label}: max|{tag}-f32| {err_kernel:.6g}, max|plain-f32| "
        f"{err_plain:.6g}, max|f32| {ref_max:.6g}, bound {bound:.6g}; median {tag} "
        f"{measured['ms']:.4f} ms, plain {measured['plain_ms']:.4f} ms, roofline "
        f"{measured['bound_ms']:.4f} ms ({measured['bound_by']})"
    )
    if library:
        line += f", scaled_dot_product_attention {measured['library_ms']:.4f} ms"
    print(f"{line} ({card})")
    require(bool(torch.isfinite(got).all()), f"{label}: output is not finite")
    require(err_kernel <= bound, f"{label}: error {err_kernel} exceeds {bound}")
    return measured


def sdpa(q, k, v, scale):
    """The library yardstick for K3 and K4: one
    scaled_dot_product_attention call on the (B, T, H, 64) head views."""
    return torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), scale=scale
    )


def _half_layer_args(rng, b, t, d) -> list:
    """x, LN scale and bias, w_qkv, b_qkv, w_proj, b_proj, ls1 on the card."""
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
    return [torch.from_numpy(a).to("cuda", dt) for a, dt in arrays]


def half_layer_flops(b, t, d, heads) -> float:
    """QKV and proj GEMMs and the attention products of one half-layer."""
    return 2.0 * b * t * d * 4 * d + attention_flops(b, t, heads)


def attention_flops(b, t, heads) -> float:
    return 4.0 * b * heads * t * t * 64


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
    from dinov2_tpu_torch.ops.fused_attention import slab_layer_block, slab_layer_reference

    b, t, d, heads = BATCH, 257, 768, 12
    scale, eps = 1.0 / (d // heads) ** 0.5, 1e-6
    args = _half_layer_args(np.random.default_rng(SEED), b, t, d)
    args32 = [a.float() for a in args]  # the same bf16-rounded values in f32
    return check_kernel(
        f"slab_layer_block B={b} T={t} D={d} H={heads}", "K1",
        lambda: slab_layer_block(*args, heads, scale, eps),
        lambda: slab_layer_reference(*args, heads, scale, eps),
        lambda: slab_layer_reference(*args32, heads, scale, eps),
        card, half_layer_flops(b, t, d, heads), nbytes(*args, args[0]),
    )


def phase_slab_attention_check(card: str) -> tuple[dict, dict]:
    """K3 and K2 against their plain versions at ViT-g/14's classify shape
    and at ViT-B/14's, each on the slab K1 makes from random inputs; there
    K3 must equal K1's attention output and K2 K1's output bit for bit.
    Beside K3, scaled_dot_product_attention on the same head views."""
    from dinov2_tpu_torch.ops.attention import split_heads
    from dinov2_tpu_torch.ops.fused_attention import (
        _slab_block_reference,
        _slab_reference,
        slab_attention,
        slab_attention_block,
        slab_layer_buffers,
    )

    measured = {}
    for b, t, heads in ((GIANT_BATCH, 257, 24), (BATCH, 257, 12)):
        d, scale = 64 * heads, 0.125
        args = _half_layer_args(np.random.default_rng(SEED + heads), b, t, d)
        x, _, _, _, _, wp, bp, ls = args
        k1_out, qkv, k1_attn = slab_layer_buffers(*args, heads, scale, 1e-6)
        shape = f"B={b} T={t} D={d} H={heads}"
        k3 = check_kernel(
            f"slab_attention {shape}", "K3",
            lambda: slab_attention(qkv, heads, scale),
            lambda: _slab_reference(qkv, heads, scale),
            lambda: _slab_reference(qkv.float(), heads, scale),
            card, attention_flops(b, t, heads), nbytes(qkv, k1_attn),
            library=partial(sdpa, *split_heads(qkv, heads), scale),
        )
        block = (x, qkv, wp, bp, ls)
        k2 = check_kernel(
            f"slab_attention_block {shape}", "K2",
            lambda: slab_attention_block(*block, heads, scale),
            lambda: _slab_block_reference(*block, heads, scale),
            lambda: _slab_block_reference(*[a.float() for a in block], heads, scale),
            card, attention_flops(b, t, heads) + 2.0 * b * t * d * d, nbytes(*block, x),
        )
        same_k3 = torch.equal(slab_attention(qkv, heads, scale), k1_attn)
        same_k2 = torch.equal(slab_attention_block(*block, heads, scale), k1_out)
        print(f"kernel check: on K1's own slab, {shape}: K3 equals K1's attention output bit "
              f"for bit: {same_k3}; K2 equals K1's output bit for bit: {same_k2}")
        require(same_k3, f"K3 differs from K1's attention output at {shape}")
        require(same_k2, f"K2 differs from K1's output at {shape}")
        measured[heads] = k3, k2
    (k3, k2), (k3_b, k2_b) = measured[24], measured[12]
    for main, other in ((k3, k3_b), (k2, k2_b)):  # the JSON line's numbers are ViT-g's shape's
        main["max_abs_err"] = max(main["max_abs_err"], other["max_abs_err"])
        main["ms_vit_b"], main["plain_ms_vit_b"] = other["ms"], other["plain_ms"]
    k3["library_ms_vit_b"] = k3_b["library_ms"]
    return k3, k2


def phase_slab_mlp_check(card: str) -> dict:
    """K5 against its plain version at the fuse_mlp slice's shape for both
    parity modes' activations, and at ViT-L/14's 518 px shape."""
    from dinov2_tpu_torch.ops.fused_attention import slab_mlp_block, slab_mlp_reference

    measured = {}
    for b, t, d, act in ((BATCH, 257, 768, "gelu_tanh_f16"), (BATCH, 257, 768, "gelu_erf"),
                         (FEATURE_BATCH, 1370, 1024, "gelu_tanh_f16")):
        rng = np.random.default_rng(SEED + d)
        arrays = [
            (rng.standard_normal((b, t, d)), torch.bfloat16),  # x
            (rng.uniform(0.5, 1.5, d), torch.float32),  # ln scale
            (rng.standard_normal(d) * 0.1, torch.float32),  # ln bias
            (rng.standard_normal((d, 4 * d)) * 0.05, torch.bfloat16),  # w1
            (rng.standard_normal(4 * d) * 0.1, torch.float32),  # b1
            (rng.standard_normal((4 * d, d)) * 0.05, torch.bfloat16),  # w2
            (rng.standard_normal(d) * 0.1, torch.float32),  # b2
            (rng.uniform(0.1, 1.0, d), torch.float32),  # ls2
        ]
        args = [torch.from_numpy(a).to("cuda", dt) for a, dt in arrays]
        args32 = [a.float() for a in args]
        measured[d, act] = check_kernel(
            f"slab_mlp_block B={b} T={t} D={d} DH={4 * d} {act}", "K5",
            lambda: slab_mlp_block(*args, act, 1e-6),
            lambda: slab_mlp_reference(*args, act, 1e-6),
            lambda: slab_mlp_reference(*args32, act, 1e-6),
            card, 4.0 * b * t * d * 4 * d, nbytes(*args, args[0]),
        )
    main = measured[768, "gelu_tanh_f16"]
    main["max_abs_err"] = max(m["max_abs_err"] for m in measured.values())
    for key in ("ms", "plain_ms"):
        main[f"{key}_gelu_erf"] = measured[768, "gelu_erf"][key]
        main[f"{key}_vit_l_518"] = measured[1024, "gelu_tanh_f16"][key]
    return main


def phase_flash_check(card: str) -> dict:
    """K4 against its plain version in bf16 and f32 at the feature slice's
    shape through flash_attention_slab, and at an 896 px image's sequence
    (T=4226, which the TPU runs as multi-KV online softmax) through
    flash_attention; scaled_dot_product_attention beside both."""
    from dinov2_tpu_torch.ops.attention import split_heads, vanilla_attention
    from dinov2_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_slab,
        kernel_tile_rows,
    )

    heads, scale = 16, 0.125
    measured = {}
    for b, t, slab in ((FEATURE_BATCH, 1370, True), (1, 4226, False)):
        print(f"kernel check: K4 at B={b} T={t} H={heads} takes "
              f"{kernel_tile_rows(b, t, heads)['forward']}-query blocks")
        rng = np.random.default_rng(SEED + t)
        qkv = torch.from_numpy(rng.standard_normal((b, t, 3 * 64 * heads)) * 1.5)
        qkv = qkv.to("cuda", torch.bfloat16)
        q, k, v = split_heads(qkv, heads)
        if slab:
            entry, kernel = "flash_attention_slab", partial(flash_attention_slab, qkv, heads, scale)
        else:
            q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
            entry, kernel = "flash_attention", partial(flash_attention, q, k, v, scale)
        measured[t] = check_kernel(
            f"{entry} B={b} T={t} H={heads} hd=64", "K4", kernel,
            partial(vanilla_attention, q, k, v, scale),
            partial(vanilla_attention, q.float(), k.float(), v.float(), scale),
            card, attention_flops(b, t, heads), nbytes(q, k, v, q),
            library=partial(sdpa, q, k, v, scale),
        )
    main = measured[1370]  # the JSON line's numbers are the slice shape's; the error is the worse
    main["max_abs_err"] = max(m["max_abs_err"] for m in measured.values())
    for key in ("ms", "plain_ms", "library_ms"):
        main[f"{key}_t4226"] = measured[4226][key]
    return main


def sdpa_backward(q, k, v, g, scale):
    """The library yardstick for K6: the backward of one
    scaled_dot_product_attention call on the (B, T, H, 64) head views (its
    forward is run once, outside the timed call)."""
    leaves = [x.detach().transpose(1, 2).requires_grad_() for x in (q, k, v)]
    out = torch.nn.functional.scaled_dot_product_attention(*leaves, scale=scale)
    grad = g.transpose(1, 2)
    return lambda: torch.autograd.grad(out, leaves, grad, retain_graph=True)


def phase_flash_backward_check(card: str) -> tuple[dict, dict]:
    """K4's with_lse forward and K6 at the training slice's shape (B=32,
    T=257, H=12) and at the long-sequence one (B=8, T=1370, H=16). The lse variant's out must equal K4's without lse bit
    for bit and its lse the plain f32 one within LSE_ABS_BOUND; dq, dk and dv
    are held to check_kernel's rule, each against the plain version in bf16
    and in f32 on the same inputs. Beside K6, the backward of one
    scaled_dot_product_attention call. Returns K6's numbers and the lse
    variant's (for K4's entry)."""
    from dinov2_tpu_torch.ops.attention import split_heads
    from dinov2_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_backward,
        flash_backward_reference,
        flash_forward_lse,
        flash_forward_reference,
        kernel_tile_rows,
    )

    scale = 0.125
    k6, lse_variant = {"max_abs_err": 0.0}, {}
    for b, t, heads in ((TRAIN_BATCH, 257, 12), (TRAIN_LONG_BATCH, 1370, 16)):
        rows = kernel_tile_rows(b, t, heads)
        print(f"kernel check: at B={b} T={t} H={heads} K4 with lse takes {rows['forward']}-query "
              f"blocks, K6 {rows['backward_keys']}-key blocks (dK/dV) and "
              f"{rows['backward_queries']}-query blocks (dQ)")
        rng = np.random.default_rng(SEED + t + heads)
        qkv = torch.from_numpy(rng.standard_normal((b, t, 3 * 64 * heads)) * 1.5)
        qkv = qkv.to("cuda", torch.bfloat16)
        g = torch.from_numpy(rng.standard_normal((b, t, heads, 64))).to("cuda", torch.bfloat16)
        q, k, v = split_heads(qkv, heads)
        shape = f"B={b} T={t} H={heads} hd=64"

        without = partial(flash_attention, q, k, v, scale)
        with_lse = partial(flash_forward_lse, q, k, v, scale)
        out, lse = with_lse()
        out32, lse32 = flash_forward_reference(q.float(), k.float(), v.float(), scale)
        same_out = torch.equal(out, without())
        lse_err = (lse - lse32).abs().max().item()
        ms = [cuda_median_ms(fn) for fn in (without, with_lse, with_lse, without)]
        lse_variant[t] = {"lse_max_abs_err": lse_err, "lse_ms": min(ms[1:3]),
                          "ms_beside_lse": min(ms[0], ms[3])}
        print(
            f"kernel check: flash_forward_lse {shape}: out equals K4's without lse bit for bit: "
            f"{same_out}; max|lse-lse f32| {lse_err:.3g} (bound {LSE_ABS_BOUND}); median ms without "
            f"lse {ms[0]:.4f} and {ms[3]:.4f}, with lse {ms[1]:.4f} and {ms[2]:.4f} (in that "
            f"order: without, with, with, without) ({card})"
        )
        require(same_out, f"the with_lse forward's out differs from K4's at {shape}")
        require(lse_err <= LSE_ABS_BOUND, f"lse error {lse_err} at {shape}")

        kernel = partial(flash_backward, q, k, v, out, lse, g, scale)
        plain = partial(flash_backward_reference, q, k, v, out, lse, g, scale)
        got, ref = kernel(), plain()
        want = flash_backward_reference(q.float(), k.float(), v.float(), out32, lse32, g.float(),
                                        scale)
        torch.cuda.synchronize()
        errors = []
        for name, a, r, w in zip(("dq", "dk", "dv"), got, ref, want):
            err_kernel = (a.float() - w).abs().max().item()
            err_plain = (r.float() - w).abs().max().item()
            bound = 2 * err_plain + 1e-3 * w.abs().max().item()
            errors.append(f"{name} max|K6-f32| {err_kernel:.6g}, max|plain-f32| {err_plain:.6g}, "
                          f"bound {bound:.6g}")
            require(bool(torch.isfinite(a).all()), f"flash_backward {shape}: {name} is not finite")
            require(err_kernel <= bound,
                    f"flash_backward {shape}: {name} error {err_kernel} exceeds {bound}")
            k6["max_abs_err"] = max(k6["max_abs_err"], err_kernel)
        del ref, want
        measured = {
            "ms": cuda_median_ms(kernel),
            "plain_ms": cuda_median_ms(plain, reps=10),
            **roofline(10.0 * b * heads * t * t * 64, nbytes(q, k, v, out, g, lse, *got)),
            "library_ms": cuda_median_ms(sdpa_backward(q, k, v, g, scale)),
        }
        print(
            f"kernel check: flash_backward {shape}: {'; '.join(errors)}; median K6 "
            f"{measured['ms']:.4f} ms, plain {measured['plain_ms']:.4f} ms, roofline "
            f"{measured['bound_ms']:.4f} ms ({measured['bound_by']}), "
            f"scaled_dot_product_attention backward {measured['library_ms']:.4f} ms ({card})"
        )
        if t == 257:  # the JSON line's numbers are the training slice's shape's
            k6.update(measured)
        else:
            k6.update({f"{key}_t1370": value for key, value in measured.items()})
    lse = {**lse_variant[257],
           **{f"{key}_t1370": value for key, value in lse_variant[1370].items()}}
    return k6, lse


def phase_function_checks(card: str) -> dict:
    """The autograd Functions of K1, K2, K3 and K5 on the card, at the
    training slice's shape, bf16 activations over f32 master weights: the
    output has a grad_fn, every input gets a finite gradient of its own
    dtype, and the gradients agree with autograd through the plain version
    on the same CUDA tensors (K1, K2, K5 and K3's plain route recompute
    through that very version: within 1e-3 of the gradient's scale; K3's
    flash route, K4 with lse and K6, by check_kernel's rule against f32).
    Then K3's two backward routes timed at T=257 and T=1370, the reading
    behind ops/fused_attention.py::SLAB_BWD_FLASH_MIN_T."""
    from dinov2_tpu_torch.ops.fused_attention import (
        _slab_block_reference,
        _slab_reference,
        slab_attention,
        slab_attention_backward,
        slab_attention_block,
        slab_layer_block,
        slab_layer_reference,
        slab_mlp_block,
        slab_mlp_reference,
    )

    b, t, d, heads = TRAIN_BATCH, 257, 768, 12
    scale, eps = 0.125, 1e-6
    rng = np.random.default_rng(SEED + 5)
    x, lns, lnb, wq, bq, wp, bp, ls = _half_layer_args(rng, b, t, d)
    wq, wp = wq.float(), wp.float()  # f32 masters: the Functions cast on the way in
    w1 = torch.from_numpy(rng.standard_normal((d, 4 * d)) * 0.05).to("cuda", torch.float32)
    b1 = torch.from_numpy(rng.standard_normal(4 * d) * 0.1).to("cuda", torch.float32)
    w2 = torch.from_numpy(rng.standard_normal((4 * d, d)) * 0.05).to("cuda", torch.float32)
    qkv = torch.from_numpy(rng.standard_normal((b, t, 3 * d))).to("cuda", torch.bfloat16)
    g = torch.from_numpy(rng.standard_normal((b, t, d))).to("cuda", torch.bfloat16)

    def gradients(fn, tensors):
        leaves = [a.detach().clone().requires_grad_() for a in tensors]
        out = fn(*leaves)
        require(out.grad_fn is not None, "a Function's output is cut from the graph")
        return torch.autograd.grad(out, leaves, g)

    cases = {
        "K1 slab_layer_block": (
            lambda *a: slab_layer_block(*a, heads, scale, eps),
            lambda *a: slab_layer_reference(*a, heads, scale, eps),
            (x, lns, lnb, wq, bq, wp, bp, ls)),
        "K2 slab_attention_block": (
            lambda *a: slab_attention_block(*a, heads, scale),
            lambda *a: _slab_block_reference(*a, heads, scale),
            (x, qkv, wp, bp, ls)),
        "K5 slab_mlp_block": (
            lambda *a: slab_mlp_block(*a, "gelu_erf", eps),
            lambda *a: slab_mlp_reference(*a, "gelu_erf", eps),
            (x, lns, lnb, w1, b1, w2, bp, ls)),
    }
    for label, (kernel, plain, tensors) in cases.items():
        got, want = gradients(kernel, tensors), gradients(plain, tensors)
        torch.cuda.synchronize()
        worst = 0.0
        for i, (a, w, inp) in enumerate(zip(got, want, tensors)):
            require(a is not None and a.dtype == inp.dtype and bool(torch.isfinite(a).all()),
                    f"{label}: gradient of input {i} is missing, of another dtype or not finite")
            rel = ((a.float() - w.float()).abs().max() / w.float().abs().max()).item()
            worst = max(worst, rel)
        print(f"function check: {label} B={b} T={t} D={d}: {len(got)} input gradients finite, "
              f"each of its input's dtype; max|d-d plain|/max|d plain| {worst:.3g} (bound 1e-3)")
        require(worst <= 1e-3, f"{label}: gradients differ from autograd through the plain version")

    leaf = qkv.detach().clone().requires_grad_()
    out = slab_attention(leaf, heads, scale)
    require(out.grad_fn is not None, "K3: the output is cut from the graph")
    (through_function,) = torch.autograd.grad(out, leaf, g)
    timings = {}
    for bb, tt, hh in ((b, t, heads), (TRAIN_LONG_BATCH, 1370, 16)):
        rng = np.random.default_rng(SEED + tt)
        slab = torch.from_numpy(rng.standard_normal((bb, tt, 3 * 64 * hh))).to("cuda", torch.bfloat16)
        gg = torch.from_numpy(rng.standard_normal((bb, tt, 64 * hh))).to("cuda", torch.bfloat16)
        routes = {route: partial(slab_attention_backward, slab, gg, hh, scale, route)
                  for route in ("plain", "flash")}
        want = slab_attention_backward(slab.float(), gg.float(), hh, scale, "plain")
        err = {route: (fn().float() - want).abs().max().item() for route, fn in routes.items()}
        bound = 2 * err["plain"] + 1e-3 * want.abs().max().item()
        del want
        ms = {route: cuda_median_ms(fn, reps=10) for route, fn in routes.items()}
        timings[tt] = ms
        print(
            f"function check: K3 slab_attention backward B={bb} T={tt} H={hh}: flash route (K4 "
            f"with lse + K6) max|d-f32| {err['flash']:.6g}, plain route {err['plain']:.6g}, bound "
            f"{bound:.6g}; median ms of one backward (recompute and gradient): plain "
            f"{ms['plain']:.4f}, flash {ms['flash']:.4f} ({card})"
        )
        require(err["flash"] <= bound, f"K3's flash backward route differs at T={tt}")
    auto = slab_attention_backward(qkv, g, heads, scale)
    require(torch.equal(through_function, auto), "K3's Function does not take the auto route")
    return {"backward_plain_ms": timings[257]["plain"], "backward_flash_ms": timings[257]["flash"],
            "backward_plain_ms_t1370": timings[1370]["plain"],
            "backward_flash_ms_t1370": timings[1370]["flash"]}


# sha256 of each inference kernel's output bytes on phase_output_digests'
# seeded inputs, recorded on an NVIDIA H100 80GB HBM3 with CUDA 12.8: K1, K2,
# K3 and K8 from a build of the sources as they were before the with_lse
# variant entered the shared attention core (csrc/attention_core.cuh), K4
# from its wgmma kernel (csrc/flash_attention.cu; the mma.sync kernel before
# it gave fedb833cf86a345f)
RECORDED_DIGESTS = {"K1": "867f80bd9af52824", "K2": "7de1ddce09564e6c", "K3": "7e73001d935cec19",
                    "K4": "db6c0a22b377b664", "K8": "d4a00e2c9c944476"}


def phase_output_digests() -> dict:
    """K1 (its three launches' buffers), K2, K3, K4 without lse and K8 on
    small seeded inputs at real widths: the outputs' sha256 against the
    recorded digests, so that a change to the shared attention core
    (csrc/attention_core.cuh, which K1, K2, K3 and K8 run) or to K4's own
    kernel that alters an inference kernel's output shows. K4's digest is
    its wgmma kernel's: that kernel sums and rounds in another order than
    the mma.sync one before it, so its recorded digest changed with it. A
    finding, not a check: another compiler version may order sums
    otherwise."""
    import hashlib

    from dinov2_tpu_torch.models.params import quantize_linear
    from dinov2_tpu_torch.ops.flash_attention import flash_attention_slab
    from dinov2_tpu_torch.ops.fused_attention import (
        slab_attention,
        slab_attention_block,
        slab_layer_buffers,
    )
    from dinov2_tpu_torch.ops.fused_quant_attention import slab_layer_block_quant

    b, t, d, heads = 4, 257, 768, 12
    rng = np.random.default_rng(SEED + 6)
    args = _half_layer_args(rng, b, t, d)
    x, lns, lnb, _, bq, wp, bp, ls = args
    qkv = torch.from_numpy(rng.standard_normal((b, t, 3 * d))).to("cuda", torch.bfloat16)
    wq4 = quantize_linear(rng.standard_normal((3 * d, d)) * 0.05, "q4_0", device="cuda")
    wp4 = quantize_linear(rng.standard_normal((d, d)) * 0.05, "q4_0", device="cuda")
    long_qkv = torch.from_numpy(rng.standard_normal((1, 1370, 3 * 1024)) * 1.5)
    long_qkv = long_qkv.to("cuda", torch.bfloat16)
    with torch.inference_mode():
        outputs = {
            "K1": torch.cat([a.flatten() for a in slab_layer_buffers(*args, heads, 0.125, 1e-6)]),
            "K2": slab_attention_block(x, qkv, wp, bp, ls, heads, 0.125),
            "K3": slab_attention(qkv, heads, 0.125),
            "K4": flash_attention_slab(long_qkv, 16, 0.125),
            "K8": slab_layer_block_quant(x, lns, lnb, wq4, bq, wp4, bp, ls, heads, 0.125, 1e-6),
        }
    digests = {
        name: hashlib.sha256(out.view(torch.int16).cpu().numpy().tobytes()).hexdigest()[:16]
        for name, out in outputs.items()
    }
    same = {name: RECORDED_DIGESTS.get(name) == digest for name, digest in digests.items()}
    print(f"output digests (a finding, not a check): {digests}; equal to the recorded "
          f"digests: {same}")
    return digests


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
    return len(images) * TIMED_CALLS / sum(seconds), 1e3 * statistics.median(seconds)


def _same_weights(engine, **options):
    """A second engine on the same device tensors, with other ModelOptions."""
    from dinov2_tpu_torch.models.vit import DinoViT

    other = copy.copy(engine)
    other.opts = dataclasses.replace(engine.opts, **options)
    other.model = DinoViT(engine.loaded.params, engine.config, other.opts)
    return other


def _cpu_cross_check(engine, cpu_params, images, config,
                     n: int = CROSS_CHECK_IMAGES) -> tuple[float, float]:
    """The first images through the engine's forward on the card and through
    the port's plain f32 forward on the CPU: max|dtokens|/max|tokens| and
    max|dprobs|."""
    from dinov2_tpu_torch.image.preprocess import classify_preprocess
    from dinov2_tpu_torch.models.vit import ModelOptions, forward_features, forward_head

    sub = images[:n]
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
    batch = len(probs)
    require(len(top5) == batch and all(len(r) == 5 for r in top5), "classify top-5 shape")
    require(probs.shape == (batch, config.num_classes), f"probs shape {probs.shape}")
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
            measured[fmt, name] = check_kernel(
                f"quant_matmul_kernel {fmt} {name} M={m} K={k} N={n} "
                f"{str(dtype).removeprefix('torch.')} {act}", "K7",
                partial(quant_matmul_kernel, x, ql, bias, act),
                partial(quant_matmul_reference, x, ql, bias, act),
                partial(quant_matmul_reference, x.float(), ql, bias, act),
                card, 2.0 * m * k * n, nbytes(x, ql, bias) + m * n * x.element_size(),
                peak_flops=PEAK_F32_FLOPS if dtype == torch.float32 else PEAK_BF16_FLOPS,
            )
    q = {name: measured[QUANT_SLICE_FORMAT, name] for name in shapes}
    return {
        # q4_0's numbers at fc1 (and the other shapes' times beside); the worst error
        **q["fc1"],
        "max_abs_err": max(v["max_abs_err"] for v in measured.values()),
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
        x, lns, lnb, _, bq, _, bp, ls = _half_layer_args(rng, b, t, d)
        wq = quantize_linear(rng.standard_normal((3 * d, d)) * 0.05, fmt, device="cuda")
        wp = quantize_linear(rng.standard_normal((d, d)) * 0.05, fmt, device="cuda")
        rest = (lns, lnb, wq, bq, wp, bp, ls, heads, scale, eps)
        measured[fmt] = check_kernel(
            f"slab_layer_block_quant {fmt} ({'packed' if wq.packed else 'int8 SoA'}) "
            f"B={b} T={t} D={d} H={heads}", "K8",
            lambda: slab_layer_block_quant(x, *rest),
            lambda: quant_layer_reference(x, *rest),
            lambda: quant_layer_reference(x.float(), *rest),
            card, half_layer_flops(b, t, d, heads), nbytes(x, lns, lnb, wq, bq, wp, bp, ls, x),
        )
    return {
        **measured[QUANT_SLICE_FORMAT],
        "max_abs_err": max(v["max_abs_err"] for v in measured.values()),
        **{f"ms_{fmt}": measured[fmt]["ms"] for fmt in ("q5_1", "q8_0")},
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


def phase_slice(card: str) -> tuple[int, float, int]:
    """DinoEngine.classify on the card; returns K1 launches of that run (no
    other kernel of the port may launch: T=257 takes the slab route and
    fuse_mlp is off by default), its img/s, and the K5 launches of the
    second run, the same weights with fuse_mlp=True (K1 and K5 in every
    layer, no plain-torch op on the residual stream between them)."""
    from dinov2_tpu_torch.io.synthetic import write_synthetic_gguf
    from dinov2_tpu_torch.models.params import load_params
    from dinov2_tpu_torch.ops.flash_attention import flash_attention
    from dinov2_tpu_torch.ops.fused_attention import (
        slab_attention,
        slab_attention_block,
        slab_layer_block,
        slab_mlp_block,
    )
    from dinov2_tpu_torch.runtime.engine import DinoEngine

    config = _vit_b14_config()
    images = _classify_images()
    with tempfile.TemporaryDirectory() as tmp:
        path = write_synthetic_gguf(Path(tmp) / "vit_b14.gguf", config, seed=SEED)
        engine = DinoEngine(path, dtype=torch.bfloat16, parity="reference", device="cuda")
        cpu_model = load_params(path, dtype=torch.float32, device="cpu")
    layers, forwards = config.num_hidden_layers, 2 + TIMED_CALLS
    counters = (slab_layer_block, slab_mlp_block, slab_attention, slab_attention_block,
                flash_attention)

    def run(eng):
        """The path with the counts at 0 just before and read just after."""
        eng.warmup((IMAGE_PX, IMAGE_PX), batch=BATCH)
        for counter in counters:
            counter.launches = 0
        top5 = eng.classify(images, topk=5)
        probs = eng.classify_probs(images)
        rate, median_ms = _timed_classify(eng, images)
        return [c.launches for c in counters], _check_probs(top5, probs, config), rate, median_ms

    (launches, k5_off, *others), row_err, rate, median_ms = run(engine)
    require(launches == layers * forwards, f"K1 launched {launches} times in {forwards} forwards")
    require(k5_off == 0 and not any(others),
            f"K5 launched {k5_off} and K3, K2, K4 {others} times in the default classify path")
    print(
        f"slice: ViT-B/14 classify {BATCH}x{IMAGE_PX}px bf16 on {card}: probs finite, "
        f"max|row sum - 1| {row_err:.3g}, K1 launches {launches} = "
        f"{layers} x {forwards} forwards, K5, K3, K2 and K4 0; "
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

    fused = _same_weights(engine, fuse_mlp=True)
    (k1, k5, *others), row_err, fused_rate, fused_ms = run(fused)
    require(k1 == layers * forwards and k5 == layers * forwards,
            f"fuse_mlp: K1 launched {k1} and K5 {k5} times in {forwards} forwards")
    require(not any(others), f"fuse_mlp: K3, K2, K4 launched {others} times")
    tok_rel, prob_err = _cpu_cross_check(fused, cpu_model.params, images, config)
    print(
        f"fuse_mlp slice: ViT-B/14 classify, fuse_mlp=True, {BATCH}x{IMAGE_PX}px bf16 on {card}: "
        f"probs finite, max|row sum - 1| {row_err:.3g}, K1 launches {k1} and K5 launches {k5} "
        f"= {layers} x {forwards} forwards each; {fused_rate:.1f} img/s (median "
        f"{fused_ms:.2f} ms/call) against {rate:.1f} img/s (median {median_ms:.2f} ms/call) "
        f"with fuse_mlp=False in this run; cross-check vs CPU f32 plain: "
        f"max|dtokens|/max|tokens| {tok_rel:.4g} (bound {TOKEN_REL_BOUND}), max|dprobs| "
        f"{prob_err:.4g} (bound {PROB_ABS_BOUND})"
    )
    require(tok_rel <= TOKEN_REL_BOUND, "fuse_mlp: tokens differ from the CPU f32 forward")
    require(prob_err <= PROB_ABS_BOUND, "fuse_mlp: probs differ from the CPU f32 forward")
    return launches, rate, k5


def phase_giant(card: str) -> tuple[int, int]:
    """ViT-g/14 at full width (SwiGLU; GIANT_LAYERS of its 40 layers) through
    DinoEngine.classify from a synthetic f16 GGUF, slab_fusion="core": returns the K3 launches of that
    run and, from the same device weights at "proj", the K2 launches; then
    "layer" (K1), each level timed as a finding; and the "core" forward held
    against the port's plain f32 forward on the CPU."""
    from dinov2_tpu_torch.io.synthetic import write_synthetic_gguf
    from dinov2_tpu_torch.models.config import PRESETS
    from dinov2_tpu_torch.models.params import load_params
    from dinov2_tpu_torch.ops.fused_attention import (
        slab_attention,
        slab_attention_block,
        slab_layer_block,
        slab_mlp_block,
    )

    config = dataclasses.replace(PRESETS["giant"], num_hidden_layers=GIANT_LAYERS)
    images = np.random.default_rng(SEED + 3).integers(
        0, 256, (GIANT_BATCH, IMAGE_PX, IMAGE_PX, 3), dtype=np.uint8
    )
    with tempfile.TemporaryDirectory() as tmp:
        start = time.perf_counter()
        path = write_synthetic_gguf(Path(tmp) / "vit_g14.gguf", config, seed=SEED)
        write_s, size_gb = time.perf_counter() - start, path.stat().st_size / 1e9
        start = time.perf_counter()
        engine, _, held_mb = _load_engine(path, slab_fusion="core")
        load_s = time.perf_counter() - start
        start = time.perf_counter()
        cpu_model = load_params(path, dtype=torch.float32, device="cpu")
        cpu_load_s = time.perf_counter() - start
    require(engine.config.swiglu and engine.config.swiglu_hidden == 4096,
            "the ViT-g/14 file did not load as SwiGLU with hidden 4096")
    print(
        f"giant load: ViT-g/14 f16 GGUF of {size_gb:.2f} GB written in {write_s:.1f} s, loaded "
        f"onto the card in {load_s:.1f} s ({held_mb:.0f} MB held) and onto the CPU in f32 in "
        f"{cpu_load_s:.1f} s"
    )

    layers, forwards = config.num_hidden_layers, 2 + TIMED_CALLS
    counters = {"core": slab_attention, "proj": slab_attention_block, "layer": slab_layer_block}
    rates = {}
    for level in ("core", "proj", "layer"):
        eng = engine if level == "core" else _same_weights(engine, slab_fusion=level)
        eng.warmup((IMAGE_PX, IMAGE_PX), batch=GIANT_BATCH)
        for counter in (*counters.values(), slab_mlp_block):
            counter.launches = 0
        top5 = eng.classify(images, topk=5)
        probs = eng.classify_probs(images)
        rate, median_ms = _timed_classify(eng, images)
        launches = {name: counter.launches for name, counter in counters.items()}
        row_err = _check_probs(top5, probs, config)
        require(launches == {name: layers * forwards * (name == level) for name in counters},
                f'slab_fusion="{level}": launches {launches} in {forwards} forwards')
        require(slab_mlp_block.launches == 0, "K5 launched on the SwiGLU path")
        rates[level] = rate, median_ms, launches[level]
        kernel = {"core": "K3", "proj": "K2", "layer": "K1"}[level]
        print(
            f'giant slice: ViT-g/14 classify, slab_fusion="{level}", {GIANT_BATCH}x{IMAGE_PX}px '
            f"bf16 on {card}: probs finite, max|row sum - 1| {row_err:.3g}, {kernel} launches "
            f"{launches[level]} = {layers} x {forwards} forwards, the other two levels' kernels "
            f"0; {rate:.1f} img/s over {TIMED_CALLS} timed classify_probs calls (median "
            f"{median_ms:.2f} ms/call)"
            + ("" if level == "core" else ", a finding, not a check")
        )

    start = time.perf_counter()
    tok_rel, prob_err = _cpu_cross_check(engine, cpu_model.params, images, config,
                                         n=GIANT_CROSS_CHECK_IMAGES)
    print(
        f"giant cross-check: {GIANT_CROSS_CHECK_IMAGES} images, GPU bf16 (K3) vs CPU f32 plain, "
        f"all {layers} layers: max|dtokens|/max|tokens| {tok_rel:.4g} (bound {TOKEN_REL_BOUND}), "
        f"max|dprobs| {prob_err:.4g} (bound {GIANT_PROB_ABS_BOUND}) in "
        f"{time.perf_counter() - start:.1f} s"
    )
    require(tok_rel <= TOKEN_REL_BOUND, "ViT-g/14 tokens differ from the CPU f32 forward")
    require(prob_err <= GIANT_PROB_ABS_BOUND, "ViT-g/14 probs differ from the CPU f32 forward")
    return rates["core"][2], rates["proj"][2]


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


def _train_counters():
    from dinov2_tpu_torch.ops.flash_attention import flash_attention, flash_backward
    from dinov2_tpu_torch.ops.fused_attention import (
        slab_attention,
        slab_attention_block,
        slab_layer_block,
        slab_mlp_block,
    )

    return {"K4": flash_attention, "K6": flash_backward, "K1": slab_layer_block,
            "K2": slab_attention_block, "K3": slab_attention, "K5": slab_mlp_block}


def _timed_steps(trainer, params, opt_state, images, labels, steps):
    """`steps` Trainer.step calls with the launch counts at 0 just before and
    read just after: (params, opt_state, losses, seconds per step, launches,
    peak device bytes)."""
    counters = _train_counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for counter in counters.values():
        counter.launches = 0
    losses, seconds = [], []
    for _ in range(steps):
        start = time.perf_counter()
        params, opt_state, metrics = trainer.step(params, opt_state, images, labels)
        losses.append(float(metrics["loss"]))  # waits for the device
        seconds.append(time.perf_counter() - start)
    launches = {name: counter.launches for name, counter in counters.items()}
    return params, opt_state, losses, seconds, launches, torch.cuda.max_memory_allocated()


def phase_train(card: str) -> tuple[dict, Any]:
    """The training slice: make_trainer -> place -> five Trainer.step calls
    on one batch, full-width ViT-B/14, bf16 compute over f32 masters, remat,
    on the flash route (K4 with lse, K6) and on "auto" (K1 forward, recompute
    backward). Returns the flash route's launches and the f32 source
    parameters (for the long-sequence phase)."""
    from dinov2_tpu_torch.io.export import export_gguf
    from dinov2_tpu_torch.models.params import init_params, tree_leaves
    from dinov2_tpu_torch.models.vit import ModelOptions
    from dinov2_tpu_torch.parallel.train import make_trainer
    from dinov2_tpu_torch.runtime.engine import DinoEngine

    config = _vit_b14_config()
    layers = config.num_hidden_layers
    rng = np.random.default_rng(SEED)
    images = rng.integers(0, 256, (TRAIN_BATCH, IMAGE_PX, IMAGE_PX, 3), dtype=np.uint8)
    labels = rng.integers(0, config.num_classes, TRAIN_BATCH)
    start = time.perf_counter()
    source = init_params(config, seed=SEED, dtype=torch.float32)
    init_s = time.perf_counter() - start

    def options(route, compute_dtype=torch.bfloat16, remat=True):
        return ModelOptions(parity="hf", flash_attention=route, compute_dtype=compute_dtype,
                            remat=remat)

    # the reference: one f32 step of the same model on the CPU, on 4 of the images
    n = TRAIN_CROSS_CHECK_IMAGES
    start = time.perf_counter()
    cpu_trainer = make_trainer(config, opts=options("auto", torch.float32), device="cpu")
    cpu_state = cpu_trainer.place(source)
    cpu_loss = float(cpu_trainer.step(*cpu_state, images[:n], labels[:n])[2]["loss"])
    del cpu_state
    print(f"train cross-check reference: one f32 Trainer.step on the CPU on {n} images, loss "
          f"{cpu_loss:.6f}, in {time.perf_counter() - start:.1f} s (init_params {init_s:.1f} s)")

    expected = {
        True: {"K4": 2 * layers * TRAIN_STEPS, "K6": layers * TRAIN_STEPS},
        "auto": {"K1": 2 * layers * TRAIN_STEPS},
    }
    flash_launches = {}
    for route in (True, "auto"):
        name = "flash_attention=True (K4 with lse + K6)" if route is True else \
            'flash_attention="auto" (K1, recompute backward)'
        trainer = make_trainer(config, learning_rate=1e-4, weight_decay=0.05, opts=options(route))
        require(trainer.device.type == "cuda", "the Trainer does not default to the card")
        params, opt_state = trainer.place(source)
        dev_images, dev_labels = trainer.shard_batch(images, labels)

        # step 1's gradients, leaf by leaf, and the loss of the 4 cross-check images
        leaves = tree_leaves(params)
        loss, _ = trainer.loss_fn(params, dev_images, dev_labels)
        grads = torch.autograd.grad(loss, leaves)
        finite = all(bool(torch.isfinite(g).all()) for g in grads)
        require(len(grads) == len(leaves) and finite,
                f"train {name}: a leaf's gradient is missing or not finite at step 1")
        reached = sum(bool(g.abs().max() > 0) for g in grads)
        with torch.no_grad():
            loss_n = float(trainer.loss_fn(params, dev_images[:n], dev_labels[:n])[0])
        del grads, loss
        require(abs(loss_n - cpu_loss) <= TRAIN_LOSS_ABS_BOUND,
                f"train {name}: step-1 loss {loss_n} against {cpu_loss} on the CPU in f32")

        params, opt_state, losses, seconds, launches, peak = _timed_steps(
            trainer, params, opt_state, images, labels, TRAIN_STEPS)
        want = {key: expected[route].get(key, 0) for key in launches}
        require(launches == want, f"train {name}: launches {launches}, expected {want}")
        require(all(np.isfinite(losses)) and all(b < a for a, b in zip(losses, losses[1:])),
                f"train {name}: losses {losses} are not finite and falling")
        step_ms = 1e3 * statistics.median(seconds[1:])
        print(
            f"train slice: ViT-B/14 {name}, {TRAIN_BATCH}x{IMAGE_PX}px uint8, bf16 over f32 "
            f"masters, remat, AdamW lr 1e-4 wd 0.05 on {card}: losses "
            f"{', '.join(f'{v:.4f}' for v in losses)} (falling); step-1 loss on {n} images "
            f"{loss_n:.6f} against {cpu_loss:.6f} on the CPU in f32 (bound {TRAIN_LOSS_ABS_BOUND}); "
            f"{len(leaves)} leaves with a finite gradient at step 1 ({reached} nonzero); launches "
            f"in {TRAIN_STEPS} steps {launches}; median step {step_ms:.2f} ms "
            f"({TRAIN_BATCH / step_ms * 1e3:.1f} img/s, steps 2-{TRAIN_STEPS}; first step "
            f"{1e3 * seconds[0]:.1f} ms), peak memory {peak / 1e6:.0f} MB"
        )

        plain = make_trainer(config, opts=options(route, remat=False))
        params, opt_state, _, seconds, _, peak_plain = _timed_steps(
            plain, params, opt_state, images, labels, 4)
        plain_ms = 1e3 * statistics.median(seconds[1:])
        print(
            f"train finding, not a check: {name} with remat=False: median step {plain_ms:.2f} ms "
            f"({TRAIN_BATCH / plain_ms * 1e3:.1f} img/s), peak memory {peak_plain / 1e6:.0f} MB, "
            f"against {step_ms:.2f} ms and {peak / 1e6:.0f} MB with remat ({card})"
        )
        if route is True:
            flash_launches = launches
            with tempfile.TemporaryDirectory() as tmp:
                path = export_gguf(Path(tmp) / "tuned.gguf", params, config)
                engine = DinoEngine(path, dtype=torch.bfloat16, parity="hf", device="cuda")
            top5 = engine.classify(images[:8], topk=5)
            probs = engine.classify_probs(images[:8])
            row_err = _check_probs(top5, probs, config)
            with torch.no_grad():
                x = torch.from_numpy(images[:8]).cuda()
                from dinov2_tpu_torch.image.preprocess import classify_preprocess
                from dinov2_tpu_torch.models.vit import forward_features, head_logits

                tokens = forward_features(params, classify_preprocess(x), config, trainer.opts)
                own = torch.softmax(head_logits(params, tokens, config, trainer.opts), dim=-1)
            drift = float(np.abs(own.cpu().numpy() - probs).max())
            print(
                f"train export: the model after step {opt_state['count']} through export_gguf "
                f"-> DinoEngine(device=\"cuda\", parity=\"hf\").classify on 8 images: probs "
                f"finite, max|row sum - 1| {row_err:.3g}; max|dprobs| against the trainer's own "
                f"f32 masters {drift:.3g} (the file holds f16 weights; a finding, not a check)"
            )
            del engine
        del params, opt_state
    return flash_launches, source


def phase_train_long(card: str, source) -> None:
    """Long sequences, the case the flash backward is for: two steps of the
    same ViT-B/14 at batch 8 on 518 px preprocessed input (T=1370), where
    "auto" takes the flash route; preprocess_in_step=False."""
    from dinov2_tpu_torch.image.preprocess import feature_preprocess
    from dinov2_tpu_torch.models.vit import ModelOptions
    from dinov2_tpu_torch.parallel.train import make_trainer

    config = _vit_b14_config()
    layers = config.num_hidden_layers
    rng = np.random.default_rng(SEED + 4)
    images = rng.integers(0, 256, (TRAIN_LONG_BATCH, FEATURE_PX, FEATURE_PX, 3), dtype=np.uint8)
    labels = rng.integers(0, config.num_classes, TRAIN_LONG_BATCH)
    x = feature_preprocess(torch.from_numpy(images).cuda(), config.patch_size)
    trainer = make_trainer(
        config, preprocess_in_step=False,
        opts=ModelOptions(parity="hf", flash_attention="auto", compute_dtype=torch.bfloat16,
                          remat=True),
    )
    params, opt_state = trainer.place(source)
    params, opt_state, losses, seconds, launches, peak = _timed_steps(
        trainer, params, opt_state, x, labels, TRAIN_LONG_STEPS)
    want = {key: 0 for key in launches}
    want.update({"K4": 2 * layers * TRAIN_LONG_STEPS, "K6": layers * TRAIN_LONG_STEPS})
    require(launches == want, f"long-sequence training: launches {launches}, expected {want}")
    require(all(np.isfinite(losses)) and losses[-1] < losses[0],
            f"long-sequence training: losses {losses} are not finite and falling")
    tokens = (x.shape[1] // config.patch_size) * (x.shape[2] // config.patch_size) + 1
    print(
        f"train long T: ViT-B/14, {TRAIN_LONG_BATCH} preprocessed images of "
        f"{x.shape[1]}x{x.shape[2]} (T={tokens}), flash_attention=\"auto\" -> flash, bf16 over "
        f"f32 masters, remat on {card}: losses {', '.join(f'{v:.4f}' for v in losses)}; "
        f"launches in {TRAIN_LONG_STEPS} steps {launches}; steps "
        f"{', '.join(f'{1e3 * v:.1f}' for v in seconds)} ms "
        f"({TRAIN_LONG_BATCH / seconds[-1]:.1f} img/s in the last), peak memory {peak / 1e6:.0f} MB"
    )


def timed_phase(name: str, phase, *args):
    """Run one phase and print the seconds it took."""
    start = time.perf_counter()
    result = phase(*args)
    torch.cuda.synchronize()
    print(f"phase time: {name} {time.perf_counter() - start:.1f} s")
    return result


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    start = time.perf_counter()
    smi = phase_device()
    card = smi.replace(",", "")
    timed_phase("build", phase_build)
    k1_measured = timed_phase("K1 check", phase_kernel_check, card)
    k3_measured, k2_measured = timed_phase("K3 and K2 checks", phase_slab_attention_check, card)
    k5_measured = timed_phase("K5 check", phase_slab_mlp_check, card)
    k4_measured = timed_phase("K4 check", phase_flash_check, card)
    k6_measured, lse_measured = timed_phase(
        "K4 with lse and K6 checks", phase_flash_backward_check, card)
    k3_backward = timed_phase("autograd Function checks", phase_function_checks, card)
    k7_measured = timed_phase("K7 check", phase_quant_matmul_check, card)
    k8_measured = timed_phase("K8 check", phase_quant_layer_check, card)
    timed_phase("output digests", phase_output_digests)
    k1_launches, dense_rate, k5_launches = timed_phase("classify slices", phase_slice, card)
    k7_launches, k8_launches = timed_phase("quantized slice", phase_quant_slice, card, dense_rate)
    k4_launches = timed_phase("feature slice", phase_features, card)
    k3_launches, k2_launches = timed_phase("ViT-g/14 slice", phase_giant, card)
    train_launches, source = timed_phase("training slice", phase_train, card)
    timed_phase("long-sequence training", phase_train_long, card, source)
    from dinov2_tpu_torch.ops.attention import vanilla_route_warnings

    require(vanilla_route_warnings() == 0,
            'an "auto" attention route took plain PyTorch on the card (see the warning above)')
    print('attention routes: no "auto" route on the card fell to plain PyTorch in this run')
    print(f"phase time: all {time.perf_counter() - start:.1f} s")
    fused = "dinov2_tpu/ops/fused_attention.py"
    kernels = [
        {
            "name": "slab_layer_block",
            "route": "cuda",
            "source": "dinov2_tpu_torch/csrc/slab_layer.cu",
            "replaces": f"{fused}:593",
            "launches": k1_launches,
            **k1_measured,
        },
        {
            "name": "slab_attention_block",
            "route": "cuda",
            "source": "dinov2_tpu_torch/csrc/slab_attention.cu",
            "replaces": f"{fused}:478",
            "launches": k2_launches,
            **k2_measured,
        },
        {
            "name": "slab_attention",
            "route": "cuda",
            "source": "dinov2_tpu_torch/csrc/slab_attention.cu",
            "replaces": f"{fused}:331",
            "launches": k3_launches,
            **k3_measured,
            **k3_backward,
        },
        {
            "name": "flash_attention",
            "route": "cuda",
            "source": "dinov2_tpu_torch/csrc/flash_attention.cu",
            "replaces": "dinov2_tpu/ops/flash_attention.py:95",
            "also_replaces": "dinov2_tpu/ops/flash_attention.py:34",
            "launches": k4_launches,
            **k4_measured,
            "lse_launches": train_launches["K4"],
            **lse_measured,
        },
        {
            "name": "flash_backward",
            "route": "cuda",
            "source": "dinov2_tpu_torch/csrc/flash_backward.cu",
            "replaces": "dinov2_tpu/ops/flash_attention.py:468",
            "also_replaces": "dinov2_tpu/ops/flash_attention.py:499",
            "launches": train_launches["K6"],
            **k6_measured,
        },
        {
            "name": "slab_mlp_block",
            "route": "cuda",
            "source": "dinov2_tpu_torch/csrc/slab_mlp.cu",
            "replaces": f"{fused}:811",
            "also_replaces": f"{fused}:859",
            "launches": k5_launches,
            **k5_measured,
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
