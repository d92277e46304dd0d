"""Bring-up check of the PyTorch/CUDA port (dinov2_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's user paths once each through the Python API a user calls,
with random f16 weights from a seed, bf16, parity="reference":
  - classify: DinoEngine.classify on 64 RGB images of 256x256 with a
    full-width ViT-B/14 (1000 classes); the attention half-layer is K1. Then
    the same weights with fuse_mlp=True: K1 and, for the MLP half-layer, K5;
  - serving: a BatchingServer in this process on the same ViT-B/14 file,
    with clients posting over localhost: 256 JPEG images of 256 px to
    /classify (K1), 64 in flight from client processes that share no GIL
    with the server, then 16 PNG images of 512 px to /features
    and 8 to /pca (T=1370, K4), then /healthz; each reply held against the
    engine called directly, with the requests/s, latencies and mean batch
    beside the direct classify rate;
  - the CLIs: subprocesses of `python3 -m dinov2_tpu_torch.cli.<name>` on
    the card, each with a time limit: inference -c and its PCA mode, eval
    over a directory, realtime --synthetic (854x480, T=2171, K4, its last
    frame held against engine.pca_visualization of the same frame), benchmark
    and serve (polled until it answers, one /classify, then SIGTERM), each
    output held against the engine in this process;
  - AOT artifacts: the same ViT-B/14 file through runtime/aot.py:
    export_forward (batch 64, 224 px classify for cuda and cpu; 518 px
    features, T=1370; the q4_0 file in quant_mode="fused"), save_artifact,
    load_artifact, and calls of the CUDA program against the eager forward
    on the same weights and input (top-5, max|d|, launches a call, the
    graph's operator nodes, img/s of both); then `python3 -m
    dinov2_tpu_torch.cli.aot` export, info and run as subprocesses, run's
    top-5 lines against cli.inference's, and both cold starts;
  - quantized classify: the same ViT-B/14 quantized to q4_0 with
    quantize_gguf, through DinoEngine(quant_mode="fused").classify on the
    same images; K8 is the attention half-layer, K7 runs fc1, fc2 and the
    head from the packed blocks;
  - int8 classify: the same ViT-B/14 file through
    DinoEngine(quant_mode="int8").classify on the same images: K9 (its
    quantize and its s8 GEMM) runs fc1, fc2 and the head, K1 the attention
    half-layer on the dequantized qkv/proj; then quant_slab="off" (K9 for
    every linear, K3 between); 518 px features of the same file (K9 around
    K4); `inference -c` and `benchmark` with --quant-mode int8 as
    subprocesses; and the ViT-g/14 file below in int8 (SwiGLU's win and
    wout on K9);
  - features and PCA: DinoEngine.extract_features and pca_visualizations on
    8 RGB images of 512x512 (518 px in, a 37x37 grid, T=1370) with a
    full-width ViT-L/14; its attention core is K4;
  - ViT-g/14 classify: DinoEngine.classify on 16 images of 256x256 with
    ViT-g/14 at full width (D=1536, 24 heads, SwiGLU hidden 4096, 1000
    classes) from a synthetic f16 GGUF, depth cut to 12 of its 40 layers, at
    each level of the slab route: slab_fusion="core" (K3, the JAX package's
    route for this model), "proj" (K2) and "layer" (K1) on the same device
    weights;
  - multi-device inference (the mesh slice), single-controller as in the
    JAX package, every mesh's shards on this one card (make_mesh(axes,
    devices=[card] * n): the launches n cards would run, one after the
    other): the ViT-g/14 file in q4_0 through tp_prepare_params and
    make_tp_forward at {"model": 2}, {"model": 4} and {"data": 2,
    "model": 2} (K3 on each shard's heads, K7 on its weight shards); the
    ViT-B/14 file data-parallel at {"data": 4} (K1 in each replica; in q4_0
    K8 and K7), bit for bit the single-device forward, dense TP at
    {"data": 2, "model": 2} (K3) and 518 px features at {"model": 2} (K4
    on 6 heads); pipeline_forward over 4 stages of 4 microbatches (K1);
    then DinoEngine(mesh_axes={"data": n, "model": 1}) for the dense and
    the q4_0 file and `cli.inference -c --mesh n,1` at the machine's card
    count n. Each sharded forward beside the single-device one on the same
    weights: bit for bit, or both held to the CPU f32 forward with the
    slice's bounds; its ms and one call's peak device memory beside the
    single-device call's;
  - training: make_trainer(...).place and five Trainer.step calls on one
    batch of 32 uint8 images of 256x256 with a full-width ViT-B/14 (12
    layers, 1000 classes, init_params seed 0), parity="hf", bf16 compute
    over f32 masters, remat, AdamW: with flash_attention=True (the K4
    with_lse forward and K6, the flash backward) and with "auto" (K1
    forward, recompute backward); the model exported with export_gguf after
    step 5 classifies through DinoEngine; then two steps at batch 8 on
    518 px preprocessed input (T=1370, "auto" takes the flash route);
  - training on a mesh (the mesh training slice), every mesh's shards on
    this card: the same ViT-B/14 and batch through Trainer(mesh=...) at
    {"data": 4} on "auto" (K1 in each replica), {"data": 2, "model": 2}
    Megatron TP on the flash route (K4 with lse and K6 on 6 heads a
    shard) and on "auto" (K3, its backward K4 with lse and K6), TP with
    sequence parallelism on the flash route, and make_pipeline_train_step
    over 4 stages of 4 microbatches of 8 (K1). Each case's f32 step held
    to the single-device f32 step at the JAX package's CPU bounds, its
    bf16 step's loss and raw gradients (SGD with learning rate 1) within
    twice the single-device bf16 step's distance from f32, its exact
    launches a step, ms a step and peak memory beside the single-device
    step's; then `cli.train --mesh 2,2 --device cuda:0 --flash-attn` with
    --export and --checkpoint-dir, and `cli.inference -c` on the export;
  - several processes (the multi-process slice): two rank processes of
    this script (`chip_smoke.py --rank ...`) call
    parallel/mesh.py::init_distributed with backend="gloo", both on this
    card, and run the same ViT-B/14 (a synthetic GGUF) and batch through
    Trainer(mesh=...) across them for three AdamW steps: DP {"data": 2}
    "auto" (K1), TP {"data": 1, "model": 2} on the flash route (K4 with
    lse, K6) and on "auto" (K3), TP + SP, and {"data": 2, "model": 2}
    (two positions a rank); each rank's losses and parameters bit for bit
    the one-process mesh's on this card, its exact launches, ms a step and
    peak memory; the ranks' checkpoint restored in this process bit for
    bit; the pipeline across the ranks ({"stage": 4}, 4 microbatches, two
    stages a rank): pipeline_forward classify on 64 images (K1) and three
    AdamW steps of make_pipeline_train_step on "auto" (K1, with the stages
    in rank blocks and interleaved 0, 1, 0, 1) and on the flash route (K4
    with lse, K6), each rank's outputs or losses and positions bit for bit
    the one-process pipeline's on this card, with its exact launches;
    DinoEngine(mesh_axes={"model": 2}) classify across the ranks bit
    for bit the one-process engine (K3); and NCCL asked for this one card
    by two ranks must fail in both. With 2 or more cards the cases also
    run over NCCL, rank k on card k.
  - f32, the trainer's default dtype and every --dtype f32 run, on the f32
    kernels of K1 to K6 and K8 (their own C entries and counts,
    `.f32_launches`) and K7's f32 kernel: DinoEngine(dtype=torch.float32)
    .classify on the classify slice's file and images (K1 f32), at
    slab_fusion "proj" (K2 f32) and "core" (K3 f32), and with fuse_mlp=True
    (K1 and K5 f32); the same file in q4_0 through quant_mode="fused" (K8
    f32 and K7), with fuse_mlp=True (K8 f32, K5 f32 on the dequantized
    fc1/fc2, K7 for the head), and `inference -c --dtype f32 --quant-mode
    fused` on it; a ViT-B/14 with 4 register tokens (T=261, a masked tail)
    in bf16 and f32 (K1); the ViT-L/14 feature slice in f32 (K4 f32);
    make_trainer(config) as shipped (f32 over f32 masters, parity "hf",
    remat, "auto": K1 f32), on the flash route (K4 with lse and K6 f32),
    with fuse_mlp=True (K1 and K5 f32) and at T=1370. Each against the CPU
    f32 run of the same weights and
    preprocessed input: tokens within 2e-5 of max(1, max|token|) and probs
    within 1e-5 with the same top-5 (in parity "hf"), step 1's loss within
    1e-5 and its raw gradients with at most 1e-4 of a leaf beyond 1e-5; the
    launches exact.
On the way it builds every hand-written kernel of those paths from the
sources in this checkout (one nvcc per source, all at once) and holds each
against its plain PyTorch version on the card, with its time beside its
roofline bound (H100 SXM peaks) and, for K3 and K4, beside
scaled_dot_product_attention on the same inputs (a yardstick the port never
calls). Each path runs with the launch counts set to 0 just before it and
read just after.

Phases, one line each (or one per format or shape), each with its seconds:
device, which image decoders import (a finding), build, kernel checks (K1,
then K1 launch by launch beside torch.nn.functional.linear on the two GEMMs'
operands, K3 and K2, K5 and its three launches likewise, K4 at the feature,
realtime and 896 px shapes, K4 with lse and
K6, the autograd Functions of K1, K2, K3 and K5, K7 with its dequantize and
GEMM launches at fc1 and fc2 beside one linear call on the decoded weight,
K8 at ViT-B's and ViT-g's widths, then its six launches in order and one by
one beside one linear call on each GEMM's operands, K9 bit for bit at fc1,
fc2, the head and qkv at T=1370, each launch beside torch._int_mm and one
linear call, its table GELU on every bf16 input, fc1's GEMM with and
without its activation, its build and x8's tensor-map encode time),
classify slice,
its cross-check and the fuse_mlp slice with its own, serving slice, CLI
slice, AOT slice (classify, features, q4_0, the CLI, cold starts), quantized
classify slice, its cross-check and its findings (other
routes, weight memory, the peak device memory of one call), int8 slice on
both routes with its cross-checks and img/s beside dense and q4_0, int8
feature slice, int8 CLI slice,
feature slice, PCA, feature cross-check, ViT-g/14 slice at its three levels
and its cross-check, ViT-g/14 int8 slice, mesh slice (one line a case),
training slice on both routes with its cross-check and
export, long-sequence training, mesh training slice (K4 with lse and K6 at
a shard's shape, one line a case, the CLI), multi-process slice (each
rank's kernel checks, one line a case, the pipeline cases, the checkpoint
and the engine, the NCCL refusal), and the f32 phases (f32 kernel checks after
K9's, each f32 kernel within 1e-5 (gradients 2e-5; K5 and K7 with
gelu_tanh_f16 5e-4, one f16 step of the GELU) of max(1, max|y|) of its
plain f32 version beside its bound at 67 TFLOP/s and SDPA or one f32 linear
call, K8 f32 bit for bit K1 f32 on the dequantized weights; the f32
classify slice; the f32 run of the feature slice; the f32
training slice); then a check that no "auto" attention route of these paths
fell to plain PyTorch on the card. Any failure exits
non-zero. The line before the last is a JSON object with one entry per kernel; the last line is
{"ok": true, "device": {...}}. With no CUDA device, or run from a directory
that holds only this file, it exits non-zero and prints no result.
"""

import copy
import dataclasses
import gc
import json
import shutil
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
PRINTED_PROB_BOUND = 0.005 + PROB_ABS_BOUND  # a prob printed to two decimals
# the feature slice: ViT-L/14 at 518 px, the JAX package's marquee feature shape
FEATURE_BATCH = 8
FEATURE_PX = 512  # quirk Q4: 512 px -> 518 px -> a 37x37 grid, T = 1370
FEATURE_TIMED_CALLS = 10
# PCA images from the same tokens on the card and on the CPU: at most one u8
# level apart (an f32 rounding across a .5 boundary) on >= 99% of pixels
PCA_AGREE = 0.99
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
# the serving slice: a server in this process on the classify slice's
# ViT-B/14, its batch cap the direct path's batch
SERVE_MAX_BATCH = BATCH
SERVE_CLASSIFY_REQUESTS = 256
SERVE_IN_FLIGHT = 64
SERVE_FEW_IN_FLIGHT = 8
SERVE_FEATURE_REQUESTS = 16  # 512 px: T=1370, K4
SERVE_PCA_REQUESTS = 8
# the CLI slice: subprocesses on the card, each with this limit
CLI_TIMEOUT_S = 300
CLI_EVAL_IMAGES = 16
CLI_REALTIME_FRAMES = 20
# H100 SXM peaks (NVIDIA's data sheet, dense): a kernel's bound is the larger
# of its operations over the first and its bytes over the second
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12  # f32 FFMA outside the tensor cores
# f32-accurate products on the tensor cores: 3xTF32 (csrc/tf32x3.cuh), three
# TF32 passes at 494.7 TFLOP/s dense; every f32 kernel's bound
PEAK_TF32X3_FLOPS = 494.7e12 / 3
PEAK_INT8_OPS = 1979e12  # K9's s8 x s8 -> s32 products
PEAK_BYTES_PER_S = 3.35e12
# the int8 slices (quant_mode="int8" on the classify slice's ViT-B/14 file,
# and on the ViT-g/14 file): bf16 on the card against f32 on the CPU, both
# int8. They differ by (a) the bf16 roundings, which the dense bounds
# (TOKEN_REL_BOUND, PROB_ABS_BOUND) cover, and (b) codes: a bf16 activation
# is 2^-9 of itself from its f32 value, which moves x / sx by up to 127 *
# 2^-9 ~ 1/4 of a step near the row's absmax, so many codes differ by one.
# Each such input moves by one quantization step, the size of what int8
# quantization itself does to the dense values. So each cross-check's bound
# is the dense bound plus the int8 mode's own envelope, measured in the same
# run on the CPU: f32 int8 against f32 dense on the same images
# (_int8_cross_check).
INT8_DENSE_PROB_GAP = 0.15  # int8 against dense bf16: tests/test_int8_mode.py's 8-bit envelope
INT8_GIANT_CROSS_CHECK_IMAGES = 1


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
                 library=None, peak_flops=PEAK_BF16_FLOPS,
                 library_name="scaled_dot_product_attention") -> dict:
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
        line += f", {library_name} {measured['library_ms']:.4f} ms"
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


def phase_image_decoders() -> None:
    """Which image decoders import on this machine: the port's CLIs decode
    with cv2 and have no other way in yet. A finding, never a failure."""
    import importlib

    found = {}
    for name in ("cv2", "PIL", "torchvision.io"):
        try:
            found[name] = getattr(importlib.import_module(name), "__version__", "imports")
        except ImportError:
            found[name] = "no"
    print(f"image decoders on this machine (a finding, not a check): {found}")


def phase_build() -> None:
    """Every kernel library, one nvcc each, started together."""
    from dinov2_tpu_torch.ops import _kernels

    start = time.perf_counter()
    libs = _kernels.build_all()
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


PROFILE_WINDOWS = 3
PROFILE_MARGIN_S = 0.02  # host time around a window's launches (profile_window)


def _card_kernels(prof) -> list:
    """The kernel records of a profile (copies and fills left out), in the
    order they started on the card."""
    return sorted((e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                   and "Memcpy" not in e.name and "Memset" not in e.name),
                  key=lambda e: e.time_range.start)


def profile_window(run, calls: int, complete):
    """A torch.profiler window of the card's kernels over `calls` calls of
    run, after one call in a warmup step of the profiler. On an H100 a window
    has lost records at its start (9, once 8, of K7's 10 dequantize launches;
    one of K8's two dequantize launches; two fill kernels put first), and
    sometimes every record of a short window, as if the profiler dropped
    the device records it places outside the active step's host span. With
    PROFILE_MARGIN_S of host time on both sides of the launches inside that
    span, scripts/probe_profiler_windows.py found no short window in 120 on
    an NVIDIA H100 80GB HBM3 at 700 W, against 8 of 120 without. A window
    that complete(prof) refuses is still taken again, up to PROFILE_WINDOWS
    in all; the last one is returned whatever it holds, for the caller's
    check to refuse."""
    from torch.profiler import ProfilerActivity, profile, schedule

    run()
    torch.cuda.synchronize()
    for window in range(1, PROFILE_WINDOWS + 1):
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            run()
            torch.cuda.synchronize()
            prof.step()
            time.sleep(PROFILE_MARGIN_S)
            for _ in range(calls):
                run()
            torch.cuda.synchronize()
            time.sleep(PROFILE_MARGIN_S)
        if complete(prof) or window == PROFILE_WINDOWS:
            return prof
        print(f"torch.profiler window {window} of {PROFILE_WINDOWS} lost records "
              f"({len(_card_kernels(prof))} kernel records); taking another")


def device_ms_by_launch(run, kernels: dict, what: str, calls: int = 10,
                        per_call: dict | None = None) -> dict:
    """torch.profiler's device ms of one launch of each kernel of `kernels`
    (a word of its name -> a label) over `calls` calls of run, each kernel
    launched once a call, or per_call[label] times (its ms is then that of
    its launches of one call together). A kernel's ms is the mean over the
    records it has, and it needs all but one call's worth of them (see
    profile_window for the records a window loses)."""
    per_call = per_call or {}

    def totals_of(prof) -> dict:
        totals = {name: [0, 0.0] for name in kernels.values()}  # records, device us
        for event in prof.key_averages():
            for word, name in kernels.items():
                if word in event.key:
                    totals[name][0] += event.count
                    totals[name][1] += event.device_time_total
        return totals

    def enough(totals: dict) -> bool:
        return all((calls - 1) * per_call.get(name, 1) <= count <= calls * per_call.get(name, 1)
                   for name, (count, _) in totals.items())

    totals = totals_of(profile_window(run, calls, lambda prof: enough(totals_of(prof))))
    for name, (count, _) in totals.items():
        n = per_call.get(name, 1)
        require((calls - 1) * n <= count <= calls * n,
                f"{what}'s {name} kernel: {count} records of {calls * n}")
    return {name: us / count * per_call.get(name, 1) / 1e3
            for name, (count, us) in totals.items()}


def device_ms_per_call(run, calls: int = 10) -> float:
    """torch.profiler's device ms of all the kernels of one call of run
    (copies and fills left out), over `calls` calls, for a call whose
    kernels are not known by name."""
    def device_us(prof) -> float:
        return sum(e.time_range.elapsed_us() for e in _card_kernels(prof))

    us = device_us(profile_window(run, calls, lambda prof: device_us(prof) > 0))
    require(us > 0, "the profiler recorded no kernel")
    return us / calls / 1e3


def launch_order(run, count: int, calls: int = 3) -> list:
    """The names of the last `count` kernels of `calls` calls of run, the
    kernels of its last call when one call launches `count`, in the order
    they started on the card (torch.profiler). A window loses records at its
    start, so only the last call is read, from a window that holds at least
    `count` kernel records (profile_window)."""
    prof = profile_window(run, calls, lambda prof: len(_card_kernels(prof)) >= count)
    return [e.name for e in _card_kernels(prof)[-count:]]


def require_kernels_in_window(run, words: dict, what: str, card: str) -> dict:
    """A torch.profiler window (profile_window) over one call of run holds a
    kernel record whose name has each word of `words` (a word -> what it
    is); returns the records of each."""
    def found(prof) -> dict:
        names = [e.name for e in _card_kernels(prof)]
        return {word: sum(word in name for name in names) for word in words}

    counts = found(profile_window(run, 1, lambda prof: all(found(prof).values())))
    print(f"{what}: torch.profiler records in one call: "
          f"{', '.join(f'{label} ({word}) {counts[word]}' for word, label in words.items())} "
          f"({card})")
    require(all(counts.values()), f"{what}: no record of {[w for w, n in counts.items() if not n]}")
    return counts


def phase_half_layer_split(card: str) -> dict:
    """K1's launches one by one, at the main path's shape and at the training
    slice's batch: torch.profiler's device time of each of its kernels over
    ten calls (layer norm, QKV, attention, proj). Beside the
    two GEMM launches, one torch.nn.functional.linear call each on the same
    operands (the normalized rows, the attention output), a yardstick the
    port never calls."""
    from dinov2_tpu_torch.ops.fused_attention import slab_layer_buffers

    d, heads, calls = 768, 12, 10
    kernels = {"layer_norm_rows_kernel": "layer_norm", "BiasEpilogue": "qkv",
               "flash_forward_kernel": "attention", "ResidualEpilogue": "proj"}
    measured = {}
    for b in (BATCH, TRAIN_BATCH):
        args = _half_layer_args(np.random.default_rng(SEED), b, 257, d)
        x, lns, lnb, wq, bq, wp, bp, _ = args
        run = partial(slab_layer_buffers, *args, heads, 0.125, 1e-6)
        _, _, attn = run()
        ms = device_ms_by_launch(run, kernels, "K1", calls)
        h = torch.nn.functional.layer_norm(x.float(), (d,), lns, lnb, 1e-6).to(x.dtype)
        wq_t, wp_t = wq.T.contiguous(), wp.T.contiguous()  # linear takes (out, in)
        linear = torch.nn.functional.linear
        library = {"qkv": cuda_median_ms(partial(linear, h, wq_t, bq.to(x.dtype))),
                   "proj": cuda_median_ms(partial(linear, attn, wp_t, bp.to(x.dtype)))}
        tflops = {name: 2e-9 * b * 257 * d * n / ms[name]
                  for name, n in (("qkv", 3 * d), ("proj", d))}
        print(
            f"K1 launch by launch, B={b} T=257 D={d}: device ms of a launch (torch.profiler, "
            f"{calls} calls): layer norm {ms['layer_norm']:.4f}, QKV {ms['qkv']:.4f} "
            f"({tflops['qkv']:.0f} TFLOP/s), attention {ms['attention']:.4f}, proj "
            f"{ms['proj']:.4f} ({tflops['proj']:.0f} TFLOP/s), sum {sum(ms.values()):.4f}; one "
            f"torch.nn.functional.linear call on the same operands: qkv {library['qkv']:.4f}, "
            f"proj {library['proj']:.4f} ({card})"
        )
        suffix = "" if b == BATCH else f"_b{b}"
        measured.update({f"ms_{name}{suffix}": value for name, value in ms.items()})
        measured.update({f"library_ms_{name}{suffix}": value for name, value in library.items()})
    return measured


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


def _mlp_args(b, t, d) -> list:
    """x, LN scale and bias, w1, b1, w2, b2, ls2 on the card."""
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
    return [torch.from_numpy(a).to("cuda", dt) for a, dt in arrays]


def phase_slab_mlp_check(card: str) -> dict:
    """K5 against its plain version at the fuse_mlp slice's shape for both
    parity modes' activations, and at ViT-L/14's 518 px shape."""
    from dinov2_tpu_torch.ops.fused_attention import slab_mlp_block, slab_mlp_reference

    measured = {}
    for b, t, d, act in ((BATCH, 257, 768, "gelu_tanh_f16"), (BATCH, 257, 768, "gelu_erf"),
                         (FEATURE_BATCH, 1370, 1024, "gelu_tanh_f16")):
        args = _mlp_args(b, t, d)
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


def phase_mlp_split(card: str) -> dict:
    """K5's three launches one by one at the fuse_mlp slice's shape (layer
    norm, fc1 with the GELU, fc2 with the residual), by torch.profiler over
    ten calls; beside each GEMM one torch.nn.functional.linear call on the
    same operands (the normalized rows; the hidden activation), a yardstick
    the port never calls."""
    from dinov2_tpu_torch.ops.fused_attention import slab_mlp_block
    from dinov2_tpu_torch.ops.qmatmul import apply_activation

    b, t, d, act = BATCH, 257, 768, "gelu_tanh_f16"
    args = _mlp_args(b, t, d)
    x, lns, lnb, w1, b1, w2, b2, _ = args
    ms = device_ms_by_launch(
        partial(slab_mlp_block, *args, act, 1e-6),
        {"layer_norm_rows_kernel": "layer_norm", "ActEpilogue": "fc1",
         "ResidualEpilogue": "fc2"}, "K5")
    linear = torch.nn.functional.linear
    h = torch.nn.functional.layer_norm(x.float(), (d,), lns, lnb, 1e-6).to(x.dtype)
    w1_t, w2_t = w1.T.contiguous(), w2.T.contiguous()  # linear takes (out, in)
    hidden = apply_activation(linear(h, w1_t, b1.to(x.dtype)), act)
    library = {"fc1": cuda_median_ms(partial(linear, h, w1_t, b1.to(x.dtype))),
               "fc2": cuda_median_ms(partial(linear, hidden, w2_t, b2.to(x.dtype)))}
    tflops = {name: 2e-9 * b * t * d * 4 * d / ms[name] for name in ("fc1", "fc2")}
    print(
        f"K5 launch by launch, B={b} T={t} D={d} {act}: device ms of a launch (torch.profiler, "
        f"10 calls): layer norm {ms['layer_norm']:.4f}, fc1 {ms['fc1']:.4f} "
        f"({tflops['fc1']:.0f} TFLOP/s), fc2 {ms['fc2']:.4f} ({tflops['fc2']:.0f} TFLOP/s), sum "
        f"{sum(ms.values()):.4f}; one torch.nn.functional.linear call on the same operands: fc1 "
        f"{library['fc1']:.4f}, fc2 {library['fc2']:.4f} ({card})"
    )
    return {**{f"ms_{name}": value for name, value in ms.items()},
            **{f"library_ms_{name}": value for name, value in library.items()}}


def phase_flash_check(card: str) -> dict:
    """K4 against its plain version in bf16 and f32 at the feature slice's
    shape through flash_attention_slab, at the realtime CLI's shape (one
    854x480 frame of ViT-B, T=2171, H=12: few enough blocks that K4 takes
    its 64-query variant) through flash_attention_slab as the model calls
    it, and at an 896 px image's sequence (T=4226, which the TPU runs as
    multi-KV online softmax) through flash_attention;
    scaled_dot_product_attention beside each."""
    from dinov2_tpu_torch.ops.attention import split_heads, vanilla_attention
    from dinov2_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_slab,
        kernel_tile_rows,
    )

    scale = 0.125
    measured = {}
    for b, t, heads, slab in ((FEATURE_BATCH, 1370, 16, True), (1, 2171, 12, True),
                              (1, 4226, 16, False)):
        rows = kernel_tile_rows(b, t, heads)["forward"]
        print(f"kernel check: K4 at B={b} T={t} H={heads} takes {rows}-query blocks")
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
        measured[t]["query_rows"] = rows
        if t == 2171:  # under 0.1 ms a call the host's time shows: the device's alone
            kernel_device = device_ms_by_launch(kernel, {"flash_forward": "K4"}, "K4")["K4"]
            sdpa_device = device_ms_per_call(partial(sdpa, q, k, v, scale))
            measured[t].update(device_ms=kernel_device, library_device_ms=sdpa_device)
            print(f"kernel check, a finding: K4 at B={b} T={t} H={heads}, device ms of a call "
                  f"(torch.profiler, 10 calls): K4 {kernel_device:.4f}, "
                  f"scaled_dot_product_attention {sdpa_device:.4f} ({card})")
    main = measured[1370]  # the JSON line's numbers are the slice shape's; the error is the worst
    main["max_abs_err"] = max(m["max_abs_err"] for m in measured.values())
    for t in (2171, 4226):
        for key, value in measured[t].items():
            if key not in ("max_abs_err", "bound_by"):
                main[f"{key}_t{t}"] = value
    return main


def sdpa_backward(q, k, v, g, scale):
    """The library yardstick for K6: the backward of one
    scaled_dot_product_attention call on the (B, T, H, 64) head views (its
    forward is run once, outside the timed call)."""
    leaves = [x.detach().transpose(1, 2).requires_grad_() for x in (q, k, v)]
    out = torch.nn.functional.scaled_dot_product_attention(*leaves, scale=scale)
    grad = g.transpose(1, 2)
    return lambda: torch.autograd.grad(out, leaves, grad, retain_graph=True)


def _flash_training_shape(card: str, b: int, t: int, heads: int,
                          forward_check: bool = False) -> tuple[dict, dict, dict | None]:
    """K4's with_lse forward and K6 at one shape. The lse variant's out must
    equal K4's without lse bit for bit and its lse the plain f32 one within
    LSE_ABS_BOUND; dq, dk and dv are held to check_kernel's rule, each
    against the plain version in bf16 and in f32 on the same inputs. Beside
    K6, the backward of one scaled_dot_product_attention call. With
    `forward_check`, the lse variant's out by check_kernel too, beside one
    scaled_dot_product_attention call. Returns (K6's numbers with its max
    error, the lse variant's, the forward check's or None)."""
    from dinov2_tpu_torch.ops.attention import split_heads, vanilla_attention
    from dinov2_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_backward,
        flash_backward_reference,
        flash_forward_lse,
        flash_forward_reference,
        kernel_tile_rows,
    )

    scale = 0.125
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
    lse_variant = {"lse_max_abs_err": lse_err, "lse_ms": min(ms[1:3]),
                   "ms_beside_lse": min(ms[0], ms[3])}
    print(
        f"kernel check: flash_forward_lse {shape}: out equals K4's without lse bit for bit: "
        f"{same_out}; max|lse-lse f32| {lse_err:.3g} (bound {LSE_ABS_BOUND}); median ms without "
        f"lse {ms[0]:.4f} and {ms[3]:.4f}, with lse {ms[1]:.4f} and {ms[2]:.4f} (in that "
        f"order: without, with, with, without) ({card})"
    )
    require(same_out, f"the with_lse forward's out differs from K4's at {shape}")
    require(lse_err <= LSE_ABS_BOUND, f"lse error {lse_err} at {shape}")
    forward = None
    if forward_check:
        forward = check_kernel(
            f"flash_forward_lse {shape}, out", "K4 with lse", lambda: with_lse()[0],
            partial(vanilla_attention, q, k, v, scale),
            partial(vanilla_attention, q.float(), k.float(), v.float(), scale),
            card, attention_flops(b, t, heads), nbytes(q, k, v, out, lse),
            library=partial(sdpa, q, k, v, scale))

    kernel = partial(flash_backward, q, k, v, out, lse, g, scale)
    plain = partial(flash_backward_reference, q, k, v, out, lse, g, scale)
    got, ref = kernel(), plain()
    want = flash_backward_reference(q.float(), k.float(), v.float(), out32, lse32, g.float(),
                                    scale)
    torch.cuda.synchronize()
    errors, worst = [], 0.0
    for name, a, r, w in zip(("dq", "dk", "dv"), got, ref, want):
        err_kernel = (a.float() - w).abs().max().item()
        err_plain = (r.float() - w).abs().max().item()
        bound = 2 * err_plain + 1e-3 * w.abs().max().item()
        errors.append(f"{name} max|K6-f32| {err_kernel:.6g}, max|plain-f32| {err_plain:.6g}, "
                      f"bound {bound:.6g}")
        require(bool(torch.isfinite(a).all()), f"flash_backward {shape}: {name} is not finite")
        require(err_kernel <= bound,
                f"flash_backward {shape}: {name} error {err_kernel} exceeds {bound}")
        worst = max(worst, err_kernel)
    del ref, want
    measured = {
        "max_abs_err": worst,
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
    return measured, lse_variant, forward


def phase_flash_backward_check(card: str) -> tuple[dict, dict]:
    """K4's with_lse forward and K6 (_flash_training_shape) at the training
    slice's shape (B=32, T=257, H=12) and at the long-sequence one (B=8,
    T=1370, H=16). Returns K6's numbers and the lse variant's (for K4's
    entry)."""
    k6, lse_variant = {"max_abs_err": 0.0}, {}
    for b, t, heads in ((TRAIN_BATCH, 257, 12), (TRAIN_LONG_BATCH, 1370, 16)):
        measured, lse_variant[t], _ = _flash_training_shape(card, b, t, heads)
        worst = max(k6["max_abs_err"], measured.pop("max_abs_err"))
        if t == 257:  # the JSON line's numbers are the training slice's shape's
            k6.update(measured)
        else:
            k6.update({f"{key}_t1370": value for key, value in measured.items()})
        k6["max_abs_err"] = worst
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
# K3 and K8 from the wgmma kernels (csrc/wgmma_gemm.cuh's GEMMs, K8's on its
# dequantized weights, and csrc/flash_forward.cuh's tile loop on the slab's
# head views), K4 from its wgmma kernel (the same tile loop; the mma.sync
# kernel before it gave fedb833cf86a345f). K8's mma.sync GEMMs around that
# tile loop gave the same c2b29f319d066d94. Before K1, K2 and K3 took their
# wgmma kernels and K8 the wgmma tile loop, they gave 867f80bd9af52824,
# 7de1ddce09564e6c, 7e73001d935cec19, d4a00e2c9c944476.
RECORDED_DIGESTS = {"K1": "cf2cbe3a19ddb848", "K2": "d179e4ab67c501f0", "K3": "a9ec9a1f534f1636",
                    "K4": "db6c0a22b377b664", "K8": "c2b29f319d066d94", "K9": "ccf976236cc23e31"}


def phase_output_digests() -> dict:
    """K1 (its three launches' buffers), K2, K3, K4 without lse, K8 and K9
    (fc1's shape at B=4, with its GELU) on small seeded inputs at real
    widths: the outputs' sha256 against the recorded digests, so that a
    change to the shared attention tile loop (csrc/flash_forward.cuh, which
    K1, K2, K3, K4 and K8 run) or to a GEMM core that alters an inference
    kernel's output shows. A finding, not a check: another compiler version
    may order sums otherwise (K9's integer sums have one order's bits, but
    its GELU's tanh may round otherwise)."""
    import hashlib

    from dinov2_tpu_torch.models.params import quantize_linear
    from dinov2_tpu_torch.ops.flash_attention import flash_attention_slab
    from dinov2_tpu_torch.ops.fused_attention import (
        slab_attention,
        slab_attention_block,
        slab_layer_buffers,
    )
    from dinov2_tpu_torch.ops.fused_quant_attention import slab_layer_block_quant
    from dinov2_tpu_torch.ops.int8_matmul_kernel import int8_matmul_kernel

    b, t, d, heads = 4, 257, 768, 12
    rng = np.random.default_rng(SEED + 6)
    args = _half_layer_args(rng, b, t, d)
    x, lns, lnb, _, bq, wp, bp, ls = args
    qkv = torch.from_numpy(rng.standard_normal((b, t, 3 * d))).to("cuda", torch.bfloat16)
    wq4 = quantize_linear(rng.standard_normal((3 * d, d)) * 0.05, "q4_0", device="cuda")
    wp4 = quantize_linear(rng.standard_normal((d, d)) * 0.05, "q4_0", device="cuda")
    long_qkv = torch.from_numpy(rng.standard_normal((1, 1370, 3 * 1024)) * 1.5)
    long_qkv = long_qkv.to("cuda", torch.bfloat16)
    x9, il9, bias9 = _int8_operands(b * t, d, 4 * d, torch.bfloat16, seed=SEED + 9)
    with torch.inference_mode():
        outputs = {
            "K1": torch.cat([a.flatten() for a in slab_layer_buffers(*args, heads, 0.125, 1e-6)]),
            "K2": slab_attention_block(x, qkv, wp, bp, ls, heads, 0.125),
            "K3": slab_attention(qkv, heads, 0.125),
            "K4": flash_attention_slab(long_qkv, 16, 0.125),
            "K8": slab_layer_block_quant(x, lns, lnb, wq4, bq, wp4, bp, ls, heads, 0.125, 1e-6),
            "K9": int8_matmul_kernel(x9, il9, bias9, "gelu_tanh_f16"),
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
    bias, and the head on f32 features (N=1000, the masked edge), the head
    beside one f32 torch.nn.functional.linear call on the decoded weight (the
    same function in one library call; a yardstick the port never calls)."""
    from dinov2_tpu_torch.models.params import quantize_linear
    from dinov2_tpu_torch.ops.qmatmul import dequant_weight
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
            library = None
            if name == "head":
                library = partial(torch.nn.functional.linear, x, dequant_weight(ql, dtype), bias)
            measured[fmt, name] = check_kernel(
                f"quant_matmul_kernel {fmt} {name} M={m} K={k} N={n} "
                f"{str(dtype).removeprefix('torch.')} {act}", "K7",
                partial(quant_matmul_kernel, x, ql, bias, act),
                partial(quant_matmul_reference, x, ql, bias, act),
                partial(quant_matmul_reference, x.float(), ql, bias, act),
                card, 2.0 * m * k * n, nbytes(x, ql, bias) + m * n * x.element_size(),
                peak_flops=PEAK_TF32X3_FLOPS if dtype == torch.float32 else PEAK_BF16_FLOPS,
                library=library, library_name="f32 linear on the decoded weight",
            )
    q = {name: measured[QUANT_SLICE_FORMAT, name] for name in shapes}
    return {
        # the dequantize and GEMM launches of fc1 and fc2 one by one
        **phase_quant_matmul_split(card, {name: shapes[name] for name in ("fc1", "fc2")}),
        # q4_0's numbers at fc1 (and the other shapes' times beside); the worst error
        **q["fc1"],
        "max_abs_err": max(v["max_abs_err"] for v in measured.values()),
        **{f"{key}_{name}": q[name][key] for name in ("fc2", "head") for key in ("ms", "plain_ms")},
        **{f"{key}_head": q["head"][key] for key in ("bound_ms", "library_ms")},
    }


def phase_quant_matmul_split(card: str, shapes: dict) -> dict:
    """K7's two bf16 launches one by one for the quantized slice's format
    (dequantize, then the GEMM on the k-major weight), by torch.profiler over
    ten calls; beside the GEMM one torch.nn.functional.linear call on x and
    the decoded weight, a yardstick the port never calls."""
    from dinov2_tpu_torch.models.params import quantize_linear
    from dinov2_tpu_torch.ops.qmatmul import dequant_weight
    from dinov2_tpu_torch.ops.qmatmul_kernel import quant_matmul_kernel

    measured = {}
    for name, (m, k, n, act, dtype) in shapes.items():
        rng = np.random.default_rng(SEED + k)
        ql = quantize_linear(rng.standard_normal((n, k)) * 0.05, QUANT_SLICE_FORMAT, device="cuda")
        x = torch.from_numpy(rng.standard_normal((m, k))).to("cuda", dtype)
        bias = torch.from_numpy(rng.standard_normal(n) * 0.1).to("cuda", torch.float32)
        ms = device_ms_by_launch(
            partial(quant_matmul_kernel, x, ql, bias, act),
            {"dequant_weight_kernel": "dequantize", "ActEpilogue": "gemm"}, "K7")
        library = cuda_median_ms(partial(torch.nn.functional.linear, x,
                                         dequant_weight(ql, dtype), bias.to(dtype)))
        print(
            f"K7 launch by launch, {QUANT_SLICE_FORMAT} {name} M={m} K={k} N={n} {act}: device ms "
            f"of a launch (torch.profiler, 10 calls): dequantize {ms['dequantize']:.4f}, GEMM "
            f"{ms['gemm']:.4f} ({2e-9 * m * k * n / ms['gemm']:.0f} TFLOP/s), sum "
            f"{sum(ms.values()):.4f}; one torch.nn.functional.linear call on x and the decoded "
            f"weight {library:.4f} ({card})"
        )
        measured.update({f"ms_{key}_{name}": value for key, value in ms.items()})
        measured[f"library_ms_{name}"] = library
    return measured


def phase_quant_layer_check(card: str) -> dict:
    """K8 at the main path's shape against its plain version in bf16 and
    f32, for q4_0 and q5_1 (packed planes, q5_1 with m and 5th bits) and
    q8_0 (int8 SoA); and q4_0 at ViT-g/14's width (B=16, D=1536, H=24)."""
    from dinov2_tpu_torch.models.params import quantize_linear
    from dinov2_tpu_torch.ops.fused_quant_attention import (
        quant_layer_reference,
        slab_layer_block_quant,
    )

    t, eps = 257, 1e-6
    measured = {}
    for fmt, b, heads in (("q4_0", BATCH, 12), ("q5_1", BATCH, 12), ("q8_0", BATCH, 12),
                          ("q4_0", GIANT_BATCH, 24)):
        d = 64 * heads
        scale = 1.0 / 64**0.5
        rng = np.random.default_rng(SEED)
        x, lns, lnb, _, bq, _, bp, ls = _half_layer_args(rng, b, t, d)
        wq = quantize_linear(rng.standard_normal((3 * d, d)) * 0.05, fmt, device="cuda")
        wp = quantize_linear(rng.standard_normal((d, d)) * 0.05, fmt, device="cuda")
        rest = (lns, lnb, wq, bq, wp, bp, ls, heads, scale, eps)
        measured[fmt, d] = check_kernel(
            f"slab_layer_block_quant {fmt} ({'packed' if wq.packed else 'int8 SoA'}) "
            f"B={b} T={t} D={d} H={heads}", "K8",
            lambda: slab_layer_block_quant(x, *rest),
            lambda: quant_layer_reference(x, *rest),
            lambda: quant_layer_reference(x.float(), *rest),
            card, half_layer_flops(b, t, d, heads), nbytes(x, lns, lnb, wq, bq, wp, bp, ls, x),
        )
    giant = measured["q4_0", 1536]
    return {
        **measured[QUANT_SLICE_FORMAT, 768],
        "max_abs_err": max(v["max_abs_err"] for v in measured.values()),
        **{f"ms_{fmt}": measured[fmt, 768]["ms"] for fmt in ("q5_1", "q8_0")},
        **{f"{key}_vit_g": giant[key] for key in ("ms", "plain_ms", "bound_ms")},
    }


def phase_quant_layer_split(card: str) -> dict:
    """K8's six launches one by one at the main path's shape for the
    quantized slice's format, by torch.profiler over ten calls (the two
    dequantize launches together, layer norm, QKV, attention, proj), after a
    check that one call launches them in that order. Beside each GEMM, one
    torch.nn.functional.linear call on the same operands and the decoded
    weight, a yardstick the port never calls."""
    from dinov2_tpu_torch.models.params import quantize_linear
    from dinov2_tpu_torch.ops.fused_attention import slab_layer_buffers
    from dinov2_tpu_torch.ops.fused_quant_attention import slab_layer_block_quant
    from dinov2_tpu_torch.ops.qmatmul import dequant_weight

    b, t, d, heads, eps = BATCH, 257, 768, 12, 1e-6
    scale = 1.0 / 64**0.5
    rng = np.random.default_rng(SEED)
    x, lns, lnb, _, bq, _, bp, ls = _half_layer_args(rng, b, t, d)
    wq = quantize_linear(rng.standard_normal((3 * d, d)) * 0.05, QUANT_SLICE_FORMAT, device="cuda")
    wp = quantize_linear(rng.standard_normal((d, d)) * 0.05, QUANT_SLICE_FORMAT, device="cuda")
    run = partial(slab_layer_block_quant, x, lns, lnb, wq, bq, wp, bp, ls, heads, scale, eps)
    words = ("dequant_weight_kernel", "dequant_weight_kernel", "layer_norm_rows_kernel",
             "BiasEpilogue", "flash_forward_kernel", "ResidualEpilogue")
    order = launch_order(run, len(words))
    require(len(order) == len(words) and all(w in n for w, n in zip(words, order)),
            f"K8's launches: {order}")
    ms = device_ms_by_launch(
        run, {"dequant_weight_kernel": "dequantize", "layer_norm_rows_kernel": "layer_norm",
              "BiasEpilogue": "qkv", "flash_forward_kernel": "attention",
              "ResidualEpilogue": "proj"}, "K8", per_call={"dequantize": 2})
    dense = [dequant_weight(w, torch.bfloat16) for w in (wq, wp)]  # (out, in), as linear takes
    _, _, attn = slab_layer_buffers(x, lns, lnb, dense[0].T.contiguous(), bq,
                                    dense[1].T.contiguous(), bp, ls, heads, scale, eps)
    h = torch.nn.functional.layer_norm(x.float(), (d,), lns, lnb, eps).to(x.dtype)
    linear = torch.nn.functional.linear
    library = {"qkv": cuda_median_ms(partial(linear, h, dense[0], bq.to(x.dtype))),
               "proj": cuda_median_ms(partial(linear, attn, dense[1], bp.to(x.dtype)))}
    tflops = {name: 2e-9 * b * t * d * n / ms[name] for name, n in (("qkv", 3 * d), ("proj", d))}
    print(
        f"K8 launch by launch, {QUANT_SLICE_FORMAT} B={b} T={t} D={d}: launches in order "
        f"{', '.join(w.removesuffix('_kernel') for w in words)}; device ms (torch.profiler, "
        f"10 calls): dequantize (both weights) {ms['dequantize']:.4f}, layer norm "
        f"{ms['layer_norm']:.4f}, QKV {ms['qkv']:.4f} ({tflops['qkv']:.0f} TFLOP/s), attention "
        f"{ms['attention']:.4f}, proj {ms['proj']:.4f} ({tflops['proj']:.0f} TFLOP/s), sum "
        f"{sum(ms.values()):.4f}; one torch.nn.functional.linear call on the same operands and "
        f"the decoded weight: qkv {library['qkv']:.4f}, proj {library['proj']:.4f} ({card})"
    )
    return {**{f"ms_{name}": value for name, value in ms.items()},
            **{f"library_ms_{name}": value for name, value in library.items()}}


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


def phase_quant_slice(card: str, dense: Path, dense_rate: float) -> tuple[int, int]:
    """The ViT-B/14 of the classify slice (the file `dense`) quantized to q4_0 through
    DinoEngine(quant_mode="fused").classify on the card; returns the K7 and
    K8 launches of that run (K1 and K4 must launch no time). Then, as
    findings and no checks, the other quantized routes' rates and the
    weights' device memory in fused and dequant mode."""
    from dinov2_tpu_torch.models.params import load_params
    from dinov2_tpu_torch.ops.flash_attention import flash_attention
    from dinov2_tpu_torch.ops.fused_attention import slab_layer_block
    from dinov2_tpu_torch.ops.fused_quant_attention import slab_layer_block_quant
    from dinov2_tpu_torch.ops.qmatmul_kernel import quant_matmul_kernel
    from dinov2_tpu_torch.quant import quantize_gguf

    config = _vit_b14_config()
    images = _classify_images()
    with tempfile.TemporaryDirectory() as tmp:
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

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    engine.classify_probs(images)
    torch.cuda.synchronize()
    call_peak_mb = (torch.cuda.max_memory_allocated() - base) / 1e6

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
        f"{dequant_peak_mb:.1f} MB); one fused classify_probs call of {BATCH} images peaks "
        f"{call_peak_mb:.1f} MB above what it starts from (activations and K7's and K8's "
        f"transient bf16 weight scratch, one launch's weights at a time) (torch.cuda memory "
        f"stats, {card})"
    )
    return k7, k8


INT8_SHAPES = {  # name -> (M, K, N, activation, x dtype): ViT-B/14's K9 launches
    "fc1": (BATCH * 257, 768, 3072, "gelu_tanh_f16", torch.bfloat16),
    "fc2": (BATCH * 257, 3072, 768, None, torch.bfloat16),
    "head": (BATCH, 1536, 1000, None, torch.float32),
    "qkv_t1370": (FEATURE_BATCH * 1370, 768, 2304, None, torch.bfloat16),
}


def _int8_operands(m, k, n, dtype, seed):
    """x (M, K), an (N, K) Int8Linear made as the loader makes one, and an
    f32 bias, on the card."""
    from dinov2_tpu_torch.models.params import Int8Linear

    rng = np.random.default_rng(seed)
    w = rng.standard_normal((n, k)).astype(np.float32) * 0.05
    s = np.maximum(np.abs(w).max(axis=1) / 127.0, 1e-12)
    codes = np.clip(np.rint(w / s[:, None]), -127, 127).astype(np.int8)
    il = Int8Linear(codes=torch.from_numpy(codes).cuda(),
                    s=torch.from_numpy(s.astype(np.float32)).cuda(), shape=(n, k))
    x = torch.from_numpy(rng.standard_normal((m, k))).to("cuda", dtype)
    bias = torch.from_numpy(rng.standard_normal(n) * 0.1).to("cuda", torch.float32)
    return x, il, bias


def _int_mm_or_none(x8, codes):
    """torch._int_mm's s32 product (a yardstick the port never calls), or
    None where this PyTorch refuses the shape."""
    try:
        return torch._int_mm(x8, codes.t())
    except RuntimeError as e:
        print(f"K9 finding: torch._int_mm refuses {tuple(x8.shape)} x {tuple(codes.shape)}: "
              f"{str(e).splitlines()[0][:160]}")
        return None


def phase_int8_check(card: str) -> dict:
    """K9 at the int8 slice's shapes (ViT-B/14 classify's fc1, fc2 and head,
    qkv at T=1370): the quantize's codes and scales and the GEMM's output bit
    for bit against the plain quantize and the plain epilogue over the exact
    s32 product (f64 sums; torch._int_mm's s32 product must equal them); then
    the whole call by CUDA events beside its plain version, each launch's
    device ms by torch.profiler, and beside the GEMM one bf16 (head: f32)
    torch.nn.functional.linear call on the dequantized weight and
    torch._int_mm alone and with the plain epilogue, yardsticks the port
    never calls. Then the bf16 gelu_tanh_f16 epilogue's table lookup on all
    65,536 bf16 inputs against the plain gelu_tanh_f16 on the card, bit for
    bit (NaN where it gives NaN); fc1's GEMM by torch.profiler with and
    without its activation; and the GEMM's build (ping-pong or cooperative,
    tile, ring depth) with the host time of encoding x8's tensor map."""
    from dinov2_tpu_torch.ops.int8_matmul_kernel import (
        int8_gelu_lookup_kernel,
        int8_gemm_kernel,
        int8_gemm_variant,
        int8_matmul_kernel,
        quantize_rows_int8_kernel,
        x8_tensor_map_us,
    )
    from dinov2_tpu_torch.ops.qmatmul import (
        dequant_weight,
        gelu_tanh_f16,
        int8_epilogue,
        int8_matmul_reference,
        int8_product,
        quantize_rows_int8,
    )

    measured: dict = {}
    operands: dict = {}
    for name, (m, k, n, act, dtype) in INT8_SHAPES.items():
        x, il, bias = _int8_operands(m, k, n, dtype, seed=SEED + k + n)
        operands[name] = x, il, bias
        x8, sx = quantize_rows_int8_kernel(x)
        want8, want_sx = quantize_rows_int8(x)
        got = int8_gemm_kernel(x8, sx, il, bias, act, dtype)
        acc = int8_product(x8, il.codes)
        want = int8_epilogue(acc, sx, il.s, dtype, bias, act)
        int_mm = _int_mm_or_none(x8, il.codes)
        whole = int8_matmul_kernel(x, il, bias, act)
        torch.cuda.synchronize()
        require(torch.equal(x8, want8) and torch.equal(sx.view(torch.int32),
                                                       want_sx.view(torch.int32)),
                f"K9 {name}: the quantize differs from the plain quantize")
        require(int_mm is None or torch.equal(int_mm, acc),
                f"K9 {name}: torch._int_mm's s32 product differs from the f64 one")
        err = (got.float() - want.float()).abs().max().item()
        require(bool(torch.isfinite(got).all()) and torch.equal(got, want),
                f"K9 {name}: the GEMM differs from the plain epilogue by {err}")
        require(torch.equal(whole, got), f"K9 {name}: the one-call wrapper differs")

        out_bytes = m * n * got.element_size()
        ops = 2.0 * m * k * n
        bound = roofline(ops, nbytes(x, il, bias) + out_bytes, PEAK_INT8_OPS)
        bound_quantize = roofline(0.0, nbytes(x, x8, sx))
        bound_gemm = roofline(ops, nbytes(x8, sx, il, bias) + out_bytes, PEAK_INT8_OPS)
        run = partial(int8_matmul_kernel, x, il, bias, act)
        launch = device_ms_by_launch(
            run, {"int8_quantize_rows_kernel": "quantize", "int8_gemm_kernel": "gemm"}, "K9")
        w = dequant_weight(il, dtype)
        library = {
            "linear": cuda_median_ms(partial(torch.nn.functional.linear, x, w, bias.to(dtype))),
            "int_mm": None if int_mm is None else cuda_median_ms(
                partial(torch._int_mm, x8, il.codes.t())),
            "int_mm_epilogue": None if int_mm is None else cuda_median_ms(
                lambda: int8_epilogue(torch._int_mm(x8, il.codes.t()), sx, il.s, dtype, bias,
                                      act)),
        }
        measured[name] = {
            "max_abs_err": err, "ms": cuda_median_ms(run),
            "plain_ms": cuda_median_ms(partial(int8_matmul_reference, x, il, bias, act)),
            **bound, "ms_quantize": launch["quantize"], "ms_gemm": launch["gemm"],
            "bound_ms_quantize": bound_quantize["bound_ms"],
            "bound_ms_gemm": bound_gemm["bound_ms"],
            "library_ms": library["int_mm"],
            "library_ms_int_mm_epilogue": library["int_mm_epilogue"],
            "library_ms_linear": library["linear"],
        }
        r = measured[name]
        fmt = lambda v: "n/a" if v is None else f"{v:.4f}"  # noqa: E731
        print(
            f"kernel check: K9 {name} M={m} K={k} N={n} {str(dtype).removeprefix('torch.')} "
            f"{act}: codes, scales and output bit for bit the plain version's; median call "
            f"{r['ms']:.4f} ms (plain {r['plain_ms']:.4f}), roofline {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}, int8 at {PEAK_INT8_OPS / 1e12:.0f} TOPS), "
            f"{r['bound_ms'] / r['ms']:.1%}; device ms of a launch (torch.profiler, 10 calls): "
            f"quantize {r['ms_quantize']:.4f} (bound {r['bound_ms_quantize']:.4f}, "
            f"{r['bound_ms_quantize'] / r['ms_quantize']:.1%}), GEMM {r['ms_gemm']:.4f} "
            f"({ops / r['ms_gemm'] / 1e9:.0f} TOPS; bound {r['bound_ms_gemm']:.4f}, "
            f"{r['bound_ms_gemm'] / r['ms_gemm']:.1%}); one "
            f"{'f32' if dtype == torch.float32 else 'bf16'} torch.nn.functional.linear on the "
            f"dequantized weight {fmt(r['library_ms_linear'])}, torch._int_mm "
            f"{fmt(r['library_ms'])}, with the plain epilogue "
            f"{fmt(r['library_ms_int_mm_epilogue'])}"
            f" ({card})"
        )
    y = torch.arange(65536, dtype=torch.int32).to(torch.int16).view(torch.bfloat16).cuda()
    looked_up, plain_gelu = int8_gelu_lookup_kernel(y), gelu_tanh_f16(y)
    torch.cuda.synchronize()
    nan = plain_gelu.isnan()
    require(torch.equal(looked_up.isnan(), nan)
            and torch.equal(looked_up.view(torch.int16)[~nan], plain_gelu.view(torch.int16)[~nan]),
            "K9's table gelu_tanh_f16 differs from the plain gelu_tanh_f16 on some bf16 input")
    print(f"kernel check: K9 table gelu_tanh_f16 (the bf16 epilogue's lookup): all 65536 bf16 "
          f"inputs bit for bit the plain gelu_tanh_f16 on the card, NaN on the same "
          f"{int(nan.sum())} ({card})")

    m, k, n, act, dtype = INT8_SHAPES["fc1"]
    x, il, bias = operands["fc1"]
    x8, sx = quantize_rows_int8_kernel(x)
    gemm = {"int8_gemm_kernel": "gemm"}
    with_act = device_ms_by_launch(partial(int8_gemm_kernel, x8, sx, il, bias, act, dtype), gemm,
                                   "K9 fc1 with its activation")["gemm"]
    without = device_ms_by_launch(partial(int8_gemm_kernel, x8, sx, il, bias, None, dtype), gemm,
                                  "K9 fc1 without an activation")["gemm"]
    variant = int8_gemm_variant()
    encode_us = x8_tensor_map_us(x8)
    print(f"K9 GEMM build: {variant['variant']}, a {variant['tile'][0]} x {variant['tile'][1]} "
          f"tile, a {variant['stages']}-stage ring, {variant['shared_bytes']} bytes of shared "
          f"memory, {variant['producer_registers']} / {variant['consumer_registers']} registers a "
          f"producer / consumer thread (setmaxnreg); x8's tensor map encoded on the host in "
          f"{encode_us:.3f} us a call; fc1's GEMM (torch.profiler) {with_act:.4f} ms with "
          f"{act}, {without:.4f} ms without an activation: the activation costs "
          f"{with_act - without:.4f} ms ({card})")
    fc1 = measured["fc1"]
    return {
        **fc1,
        "ms_gemm_no_activation": without,
        "ms_gemm_with_activation": with_act,
        "gemm_variant": variant["variant"],
        "gemm_tile": list(variant["tile"]),
        "gemm_stages": variant["stages"],
        "x8_tensor_map_us": encode_us,
        "max_abs_err": max(v["max_abs_err"] for v in measured.values()),
        **{f"{key}_{name}": measured[name][key] for name in ("fc2", "head", "qkv_t1370")
           for key in ("ms", "plain_ms", "bound_ms", "ms_quantize", "ms_gemm", "library_ms",
                       "library_ms_int_mm_epilogue", "library_ms_linear")},
    }


def _int8_counters() -> dict:
    from dinov2_tpu_torch.ops.flash_attention import flash_attention
    from dinov2_tpu_torch.ops.fused_attention import (
        slab_attention,
        slab_attention_block,
        slab_layer_block,
        slab_mlp_block,
    )
    from dinov2_tpu_torch.ops.fused_quant_attention import slab_layer_block_quant
    from dinov2_tpu_torch.ops.int8_matmul_kernel import int8_gemm_kernel, quantize_rows_int8_kernel
    from dinov2_tpu_torch.ops.qmatmul_kernel import quant_matmul_kernel

    return {"quantize": quantize_rows_int8_kernel, "gemm": int8_gemm_kernel,
            "K1": slab_layer_block, "K2": slab_attention_block, "K3": slab_attention,
            "K4": flash_attention, "K5": slab_mlp_block, "K7": quant_matmul_kernel,
            "K8": slab_layer_block_quant}


def _expected(**counts) -> dict:
    """Every counter of _int8_counters at 0 but the given ones."""
    return {name: counts.get(name, 0) for name in _int8_counters()}


def _int8_cross_check(engine, cpu_params, dense_params, images, config, n: int) -> dict:
    """The first n images through the engine's forward on the card and
    through the port's plain f32 forward on the CPU with the engine's own
    options (the same int8 route), and with the dense f32 weights on the
    same route: max|dtokens|/max|tokens| and max|dprobs| of the card against
    the f32 int8 forward, the int8 envelope (f32 int8 against f32 dense) and
    the bounds made of both (the note above INT8_DENSE_PROB_GAP)."""
    from dinov2_tpu_torch.image.preprocess import classify_preprocess
    from dinov2_tpu_torch.models.vit import forward_features, forward_head

    sub = images[:n]
    opts32 = dataclasses.replace(engine.opts, compute_dtype=torch.float32)
    with torch.inference_mode():
        pre = classify_preprocess(torch.from_numpy(sub).cuda())
        tok = forward_features(engine.model.params, pre, config, engine.opts)
        prob = forward_head(engine.model.params, tok, config, engine.opts).cpu()
        tok = tok.cpu()
        pre32 = classify_preprocess(torch.from_numpy(sub))
        tok32 = forward_features(cpu_params, pre32, config, opts32)
        prob32 = forward_head(cpu_params, tok32, config, opts32)
        tok_d = forward_features(dense_params, pre32, config, opts32)
        prob_d = forward_head(dense_params, tok_d, config, opts32)
    envelope = ((tok32 - tok_d).abs().max() / tok_d.abs().max()).item()
    prob_envelope = (prob32 - prob_d).abs().max().item()
    return {"tok_rel": ((tok - tok32).abs().max() / tok32.abs().max()).item(),
            "prob_err": (prob - prob32).abs().max().item(),
            "envelope": envelope, "prob_envelope": prob_envelope,
            "tok_bound": TOKEN_REL_BOUND + envelope, "prob_bound": PROB_ABS_BOUND + prob_envelope}


def _cross_check_line(c: dict) -> str:
    return (f"max|dtokens|/max|tokens| {c['tok_rel']:.4g} (bound {c['tok_bound']:.4g} = "
            f"{TOKEN_REL_BOUND} + the f32 int8 mode's own {c['envelope']:.4g} from f32 dense), "
            f"max|dprobs| {c['prob_err']:.4g} (bound {c['prob_bound']:.4g} = {PROB_ABS_BOUND} + "
            f"{c['prob_envelope']:.4g})")


def _require_cross_check(c: dict, what: str) -> None:
    require(c["tok_rel"] <= c["tok_bound"], f"{what}: tokens differ from the CPU f32 int8 forward")
    require(c["prob_err"] <= c["prob_bound"], f"{what}: probs differ from the CPU f32 int8 forward")


def _int8_run(engine, images, batch: int) -> tuple[dict, list, np.ndarray, float, float]:
    """The classify path with every count at 0 just before and read just
    after: launches, top-5, probs, img/s and median ms of the timed calls."""
    engine.warmup((IMAGE_PX, IMAGE_PX), batch=batch)
    counters = _int8_counters()
    for counter in counters.values():
        counter.launches = 0
    top5 = engine.classify(images, topk=5)
    probs = engine.classify_probs(images)
    rate, median_ms = _timed_classify(engine, images)
    return ({name: c.launches for name, c in counters.items()}, top5, probs, rate, median_ms)


def phase_int8_slice(card: str, path: Path):
    """The ViT-B/14 file of the classify slice through
    DinoEngine(quant_mode="int8").classify on the card: per forward 25 K9
    quantize and 25 K9 GEMM launches (fc1, fc2 in each of the 12 layers, the
    head) and 12 of K1 on the dequantized qkv/proj, no other kernel; with
    quant_slab="off" 49 and 49 (qkv and proj too) around 12 of K3, no K1.
    Each route held against the port's plain f32 int8 forward on the CPU,
    and top-1 and the probs against the dense bf16 engine's; img/s beside
    the dense bf16 and q4_0 ("fused") engines' in this phase, the load's
    device MB and one call's peak. Returns the engine, the default route's
    launches and the numbers for the kernels line."""
    from dinov2_tpu_torch.models.params import Int8Linear, load_params
    from dinov2_tpu_torch.quant import quantize_gguf

    config = _vit_b14_config()
    images = _classify_images()
    layers, forwards = config.num_hidden_layers, 2 + TIMED_CALLS
    engine, load_peak_mb, held_mb = _load_engine(path, quant_mode="int8")
    dense, _, dense_held_mb = _load_engine(path)
    with tempfile.TemporaryDirectory() as tmp:
        q4 = quantize_gguf(path, Path(tmp) / f"vit_b14.{QUANT_SLICE_FORMAT}.gguf",
                           QUANT_SLICE_FORMAT)
        q4_engine, _, _ = _load_engine(q4, quant_mode="fused")
    cpu_model = load_params(path, dtype=torch.float32, device="cpu", quant_mode="int8")
    cpu_dense = load_params(path, dtype=torch.float32, device="cpu")
    require(not engine.loaded.quantized
            and isinstance(engine.loaded.params["layers"]["qkv"]["kernel"], Int8Linear)
            and isinstance(engine.loaded.params["classifier"]["kernel"], Int8Linear),
            "the int8 engine's linears are not Int8Linear")

    launches, top5, probs, rate, median_ms = _int8_run(engine, images, BATCH)
    per_forward = 2 * layers + 1
    require(launches == _expected(quantize=per_forward * forwards, gemm=per_forward * forwards,
                                  K1=layers * forwards),
            f"int8 classify launches {launches} in {forwards} forwards")
    row_err = _check_probs(top5, probs, config)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    engine.classify_probs(images)
    torch.cuda.synchronize()
    call_peak_mb = (torch.cuda.max_memory_allocated() - base) / 1e6
    print(
        f"int8 slice: ViT-B/14 (quant_mode=\"int8\") classify {BATCH}x{IMAGE_PX}px bf16 on "
        f"{card}: probs finite, max|row sum - 1| {row_err:.3g}, K9 quantize launches "
        f"{launches['quantize']} and GEMM launches {launches['gemm']} = {per_forward} x "
        f"{forwards} forwards each, K1 {launches['K1']} = {layers} x {forwards} on the "
        f"dequantized qkv/proj, every other kernel 0; {rate:.1f} img/s over {TIMED_CALLS} "
        f"timed classify_probs calls (median {median_ms:.2f} ms/call)"
    )
    check = _int8_cross_check(engine, cpu_model.params, cpu_dense.params, images, config,
                              CROSS_CHECK_IMAGES)
    print(f"int8 cross-check: {CROSS_CHECK_IMAGES} images, GPU bf16 int8 vs CPU f32 int8 (plain "
          f"versions, the same route) on the same file: {_cross_check_line(check)}")
    _require_cross_check(check, "int8 classify")

    dense.warmup((IMAGE_PX, IMAGE_PX), batch=BATCH)
    dense_probs = dense.classify_probs(images)
    gap = float(np.abs(probs - dense_probs).max())
    top1 = float((probs.argmax(-1) == dense_probs.argmax(-1)).mean())
    require(gap < INT8_DENSE_PROB_GAP, f"int8 probs {gap} from the dense bf16 probs")
    dense_rate, dense_ms = _timed_classify(dense, images)
    q4_engine.warmup((IMAGE_PX, IMAGE_PX), batch=BATCH)
    q4_rate, q4_ms = _timed_classify(q4_engine, images)
    rate_again, ms_again = _timed_classify(engine, images)
    print(
        f"int8 against dense: top-1 equal to the dense bf16 engine's on {top1:.1%} of "
        f"{BATCH} images, max|dprob| {gap:.4g} (bound {INT8_DENSE_PROB_GAP}, the JAX "
        f"package's 8-bit envelope); img/s in turns in this phase: int8 {rate:.1f} (median "
        f"{median_ms:.2f} ms/call), dense bf16 {dense_rate:.1f} ({dense_ms:.2f}), "
        f"{QUANT_SLICE_FORMAT} fused {q4_rate:.1f} ({q4_ms:.2f}), int8 again {rate_again:.1f} "
        f"({ms_again:.2f}) ({card})"
    )
    weight_mb = sum(t.numel() * t.element_size() for t in engine.model.buffers()) / 1e6
    print(
        f"int8 finding, not a check: device memory of the load, ViT-B/14: int8 {held_mb:.1f} "
        f"MB held ({weight_mb:.1f} MB of model buffers, peak {load_peak_mb:.1f} MB) against "
        f"dense bf16 {dense_held_mb:.1f} MB; one int8 classify_probs call of {BATCH} images "
        f"peaks {call_peak_mb:.1f} MB above what it starts from (activations, the codes and "
        f"scales of each K9 input, K1's dequantized bf16 qkv/proj) (torch.cuda memory "
        f"stats, {card})"
    )
    del dense, q4_engine

    off = _same_weights(engine, quant_slab="off")
    off_launches, off_top5, off_probs, off_rate, off_ms = _int8_run(off, images, BATCH)
    off_per_forward = 4 * layers + 1
    require(off_launches == _expected(quantize=off_per_forward * forwards,
                                      gemm=off_per_forward * forwards, K3=layers * forwards),
            f'int8 quant_slab="off" launches {off_launches} in {forwards} forwards')
    off_row_err = _check_probs(off_top5, off_probs, config)
    off_check = _int8_cross_check(off, cpu_model.params, cpu_dense.params, images, config,
                                  CROSS_CHECK_IMAGES)
    print(
        f"int8 slice, quant_slab=\"off\" (every linear on K9, K3 between): probs finite, "
        f"max|row sum - 1| {off_row_err:.3g}, K9 quantize launches {off_launches['quantize']} "
        f"and GEMM launches {off_launches['gemm']} = {off_per_forward} x {forwards} forwards "
        f"each, K3 {off_launches['K3']}, K1 and every other kernel 0; {off_rate:.1f} img/s "
        f"(median {off_ms:.2f} ms/call); against CPU f32 int8 on the same route: "
        f"{_cross_check_line(off_check)} ({card})"
    )
    _require_cross_check(off_check, 'int8 quant_slab="off"')
    found = {
        "img_per_s": rate, "img_per_s_dense_bf16": dense_rate,
        f"img_per_s_{QUANT_SLICE_FORMAT}": q4_rate, "img_per_s_off": off_rate,
        "launches_off": off_launches["gemm"], "quantize_launches_off": off_launches["quantize"],
        "load_mb": held_mb, "call_peak_mb": call_peak_mb,
    }
    return engine, launches, found


def phase_int8_features(card: str, engine, path: Path) -> dict:
    """The int8 ViT-B/14 engine's extract_features on 8 images of 512 px
    (518 px in, T=1370, the flash route): per forward 48 K9 GEMMs (qkv,
    proj, fc1, fc2 in 12 layers) after as many quantizes and 12 of K4, no
    K1; one image's tokens against the port's plain f32 int8 forward on the
    CPU (the plain attention, the same int8 linears). The dense bf16 engine
    on the same file and images is timed after it, a finding."""
    from dinov2_tpu_torch.image.preprocess import feature_preprocess
    from dinov2_tpu_torch.models.params import load_params
    from dinov2_tpu_torch.models.vit import forward

    config = engine.config
    hw = (FEATURE_PX, FEATURE_PX)
    images = np.random.default_rng(SEED + 2).integers(
        0, 256, (FEATURE_BATCH, *hw, 3), dtype=np.uint8
    )
    engine.warmup(hw, batch=FEATURE_BATCH, classify=False)
    counters = _int8_counters()
    for counter in counters.values():
        counter.launches = 0
    feats = engine.extract_features(images)
    seconds = []
    for _ in range(FEATURE_TIMED_CALLS):
        start = time.perf_counter()
        engine.extract_features(images)
        seconds.append(time.perf_counter() - start)
    launches = {name: c.launches for name, c in counters.items()}
    layers, forwards = config.num_hidden_layers, 1 + FEATURE_TIMED_CALLS
    dense, _, _ = _load_engine(path)
    dense.warmup(hw, batch=FEATURE_BATCH, classify=False)
    dense_seconds = []
    for _ in range(FEATURE_TIMED_CALLS):
        start = time.perf_counter()
        dense.extract_features(images)
        dense_seconds.append(time.perf_counter() - start)
    del dense
    dense_rate = FEATURE_BATCH * FEATURE_TIMED_CALLS / sum(dense_seconds)
    require(launches == _expected(quantize=4 * layers * forwards, gemm=4 * layers * forwards,
                                  K4=layers * forwards),
            f"int8 features launches {launches} in {forwards} forwards")
    tokens = feats["patch_tokens"]
    require(feats["grid"] == (37, 37) and tokens.shape == (FEATURE_BATCH, 37 * 37,
                                                           config.hidden_size),
            f"int8 features: grid {feats['grid']}, tokens {tokens.shape}")
    require(bool(np.isfinite(tokens).all() and np.isfinite(feats["cls_token"]).all()),
            "int8 features are not finite")
    with torch.inference_mode():
        opts32 = dataclasses.replace(engine.opts, flash_attention="vanilla",
                                     compute_dtype=torch.float32)
        pre32 = feature_preprocess(torch.from_numpy(images[:1]), config.patch_size)
        tok32, tok_d = (
            torch.cat([out["cls_token"][:, None], out["patch_tokens"]], dim=1)
            for out in (forward(load_params(path, dtype=torch.float32, device="cpu",
                                            quant_mode=mode).params, pre32, config, opts32)
                        for mode in ("int8", "dequant"))
        )
    tok = torch.from_numpy(np.concatenate([feats["cls_token"][:1, None], tokens[:1]], axis=1))
    tok_rel = ((tok - tok32).abs().max() / tok32.abs().max()).item()
    envelope = ((tok32 - tok_d).abs().max() / tok_d.abs().max()).item()
    rate = FEATURE_BATCH * FEATURE_TIMED_CALLS / sum(seconds)
    print(
        f"int8 features: ViT-B/14 (quant_mode=\"int8\") extract_features {FEATURE_BATCH}x"
        f"{FEATURE_PX}px -> grid (37, 37), T=1370, bf16 on {card}: tokens finite, K9 quantize "
        f"launches {launches['quantize']} and GEMM launches {launches['gemm']} = {4 * layers} "
        f"x {forwards} forwards each, K4 {launches['K4']} = {layers} x {forwards}, K1 and the "
        f"rest 0; {rate:.1f} img/s over {FEATURE_TIMED_CALLS} timed calls (dense bf16 on the "
        f"same file after them: {dense_rate:.1f}, a finding); 1 image against CPU "
        f"f32 int8 (plain attention): max|dtokens|/max|tokens| {tok_rel:.4g} (bound "
        f"{TOKEN_REL_BOUND + envelope:.4g} = {TOKEN_REL_BOUND} + the f32 int8 mode's own "
        f"{envelope:.4g} from f32 dense)"
    )
    require(tok_rel <= TOKEN_REL_BOUND + envelope,
            "int8 feature tokens differ from the CPU f32 int8 forward")
    return {"feature_launches": launches["gemm"], "feature_img_per_s": rate,
            "feature_img_per_s_dense_bf16": dense_rate}


def phase_int8_cli(card: str, path: Path, engine) -> None:
    """`inference -c --quant-mode int8` and `benchmark --quant-mode int8` as
    subprocesses on the card, held against the int8 engine in this process:
    the printed top-5 and probs, and the benchmark's weight MB."""
    import re

    from dinov2_tpu_torch.models.params import tree_leaves

    images = np.random.default_rng(SEED + 8).integers(0, 256, (1, IMAGE_PX, IMAGE_PX, 3),
                                                      dtype=np.uint8)
    with tempfile.TemporaryDirectory() as tmp:
        image = Path(tmp) / "im.png"
        image.write_bytes(_encode_images(images, ".png")[0])
        classify = _cli("inference", "-m", str(path), "-i", str(image), "-c",
                        "--quant-mode", "int8")
    line = re.compile(r"^ > (.*) : ([0-9.]+)$")
    top5 = [list(line.match(s).groups()) for s in classify.stdout.splitlines()]
    same, err = _top5_against([[(lb, float(p)) for lb, p in top5]],
                              engine.classify_probs(images), engine.id2label)
    require(len(top5) == 5 and err <= PRINTED_PROB_BOUND,
            f"CLI inference -c --quant-mode int8: printed probs {err} from the engine's")
    bench = _cli("benchmark", "-m", str(path), "--batch-sizes", "1,64", "--iters", "10",
                 "--json", "--quant-mode", "int8")
    rows = json.loads(bench.stdout)
    weights = sum(t.numel() * t.element_size() for leaf in tree_leaves(engine.loaded.params)
                  for t in (leaf.tensors().values() if hasattr(leaf, "tensors") else [leaf]))
    require(list(rows) == ["f16"], f"CLI benchmark --quant-mode int8: variants {list(rows)}")
    for r in rows["f16"]:
        require(r["hbm_weights_mb"] == round(weights / 2**20, 1)
                and r["hbm_peak_mb"] is not None and r["hbm_peak_mb"] >= r["hbm_weights_mb"],
                f"CLI benchmark --quant-mode int8: {r} (int8 weights {weights / 2**20:.1f} MiB)")
    print(
        f"int8 CLI slice, inference -c --quant-mode int8: exit 0, top-5 "
        f"{[lb for lb, _ in top5]} (the int8 engine's in order: {bool(same)}), max|printed "
        f"prob - engine prob| {err:.4g} (bound {PRINTED_PROB_BOUND:.4g}); benchmark "
        f"--quant-mode int8: exit 0, weights {weights / 2**20:.1f} MiB as the engine's, rows "
        f"{json.dumps(rows)} ({card})"
    )


def phase_int8_giant(card: str) -> dict:
    """ViT-g/14 at full width, 12 of its 40 layers (the giant slice's file,
    written again), DinoEngine(quant_mode="int8").classify on 16 images: per
    forward K9 for SwiGLU's win and wout in every layer and the head (25
    quantizes, 25 GEMMs) and 12 of K1 on the dequantized qkv/proj; one image
    against the port's plain f32 int8 forward on the CPU."""
    from dinov2_tpu_torch.io.synthetic import write_synthetic_gguf
    from dinov2_tpu_torch.models.config import PRESETS
    from dinov2_tpu_torch.models.params import load_params

    config = dataclasses.replace(PRESETS["giant"], num_hidden_layers=GIANT_LAYERS)
    images = np.random.default_rng(SEED + 3).integers(
        0, 256, (GIANT_BATCH, IMAGE_PX, IMAGE_PX, 3), dtype=np.uint8
    )
    with tempfile.TemporaryDirectory() as tmp:
        path = write_synthetic_gguf(Path(tmp) / "vit_g14.gguf", config, seed=SEED)
        engine, _, held_mb = _load_engine(path, quant_mode="int8")
        cpu_model = load_params(path, dtype=torch.float32, device="cpu", quant_mode="int8")
        cpu_dense = load_params(path, dtype=torch.float32, device="cpu")
    require(engine.config.swiglu, "the ViT-g/14 file did not load as SwiGLU")
    launches, top5, probs, rate, median_ms = _int8_run(engine, images, GIANT_BATCH)
    layers, forwards = config.num_hidden_layers, 2 + TIMED_CALLS
    per_forward = 2 * layers + 1
    require(launches == _expected(quantize=per_forward * forwards, gemm=per_forward * forwards,
                                  K1=layers * forwards),
            f"ViT-g/14 int8 launches {launches} in {forwards} forwards")
    row_err = _check_probs(top5, probs, config)
    check = _int8_cross_check(engine, cpu_model.params, cpu_dense.params, images, config,
                              INT8_GIANT_CROSS_CHECK_IMAGES)
    print(
        f"int8 giant slice: ViT-g/14 (quant_mode=\"int8\", {layers} layers, SwiGLU) classify "
        f"{GIANT_BATCH}x{IMAGE_PX}px bf16 on {card}: probs finite, max|row sum - 1| "
        f"{row_err:.3g}, K9 quantize and GEMM launches {launches['quantize']} and "
        f"{launches['gemm']} = {per_forward} x {forwards} forwards (win, wout, head), K1 "
        f"{launches['K1']}; {rate:.1f} img/s (median {median_ms:.2f} ms/call), {held_mb:.0f} MB "
        f"held; {INT8_GIANT_CROSS_CHECK_IMAGES} image against CPU f32 int8: "
        f"{_cross_check_line(check)}"
    )
    _require_cross_check(check, "ViT-g/14 int8")
    return {"giant_launches": launches["gemm"], "giant_img_per_s": rate}


def write_vit_b14(directory: Path) -> Path:
    """The full-width ViT-B/14 GGUF of the classify, serving, CLI and
    quantized slices (f16 weights from SEED), written once."""
    from dinov2_tpu_torch.io.synthetic import write_synthetic_gguf

    return write_synthetic_gguf(directory / "vit_b14.gguf", _vit_b14_config(), seed=SEED)


def phase_slice(card: str, path: Path) -> tuple[int, float, int]:
    """DinoEngine.classify on the card; returns K1 launches of that run (no
    other kernel of the port may launch: T=257 takes the slab route and
    fuse_mlp is off by default), its img/s, and the K5 launches of the
    second run, the same weights with fuse_mlp=True (K1 and K5 in every
    layer, no plain-torch op on the residual stream between them)."""
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


def phase_features(card: str) -> tuple[int, int]:
    """DinoEngine.extract_features and pca_visualizations with a full-width
    ViT-L/14 on 8 images of 512 px; returns K4 launches of that run (K1 must
    launch no time: T=1370 takes the flash route) and the f32 run's K4 f32
    launches. Then, as a routing finding and no check, the same
    batch on the slab route (K1 at T=1370); then the same file and images in
    f32 (K4 f32, 24 launches a forward), against the CPU f32 forward."""
    from dinov2_tpu_torch.image.pca import pca_visualization_batch, resize_nearest_host
    from dinov2_tpu_torch.image.preprocess import feature_preprocess
    from dinov2_tpu_torch.io.synthetic import write_synthetic_gguf
    from dinov2_tpu_torch.models.config import PRESETS
    from dinov2_tpu_torch.models.params import load_params
    from dinov2_tpu_torch.models.vit import ModelOptions, forward, forward_features
    from dinov2_tpu_torch.ops.attention import vanilla_route_warnings
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
        f32_engine = DinoEngine(path, dtype=torch.float32, parity="reference", device="cuda")
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

    # f32: the same file through DinoEngine(dtype=torch.float32): K4 f32
    # (the cross-check in parity "hf", as _f32_against_cpu says why)
    warnings = vanilla_route_warnings()
    f32_engine.warmup(hw, batch=FEATURE_BATCH, classify=False)
    _zero_counts()
    feats32 = f32_engine.extract_features(images)
    f32_seconds, f32_forward_ms = timed(f32_engine)
    forwards = 1 + FEATURE_TIMED_CALLS
    counts = _require_counts("f32 features", {"K4": config.num_hidden_layers * forwards})
    with torch.inference_mode():
        hf = dataclasses.replace(f32_engine.opts, parity="hf")
        tok_hf = forward_features(f32_engine.model.params, pre32.cuda(), config, hf).cpu()
        tok_hf32 = forward_features(cpu_model.params, pre32, config, hf)
    ref_err = (torch.from_numpy(np.concatenate(
        [feats32["cls_token"][:1, None], feats32["patch_tokens"][:1]], axis=1)) - tok32).abs().max()
    f32_err = (tok_hf - tok_hf32).abs().max().item()
    f32_bound = F32_TOKEN_TOL * max(1.0, tok_hf32.abs().max().item())
    print(
        f"f32 features: ViT-L/14 extract_features {FEATURE_BATCH}x{FEATURE_PX}px, f32 on "
        f"{card}: K4 f32 launches {counts.get('K4', 0)} = {config.num_hidden_layers} x "
        f"{forwards} forwards, every other kernel 0; "
        f"{FEATURE_BATCH * FEATURE_TIMED_CALLS / sum(f32_seconds):.1f} img/s (median "
        f"{1e3 * statistics.median(f32_seconds):.2f} ms/call, forward {f32_forward_ms:.2f} ms); "
        f"1 image against the CPU f32 forward on the same preprocessed input, parity hf: "
        f"max|dtokens| {f32_err:.3g} (bound {f32_bound:.3g}); a finding, not a check: the "
        f"engine's parity reference tokens against the CPU's {ref_err.item():.3g} (the f16 GELU)"
    )
    require(f32_err <= f32_bound, "f32 features: tokens differ from the CPU f32 forward")
    require(vanilla_route_warnings() == warnings, 'f32 features: an "auto" route fell to plain')
    return launches, counts["K4"]


def _http(url: str, data: bytes | None = None, timeout: float = 300) -> tuple[int, bytes]:
    """(status, body) of one GET (data None) or POST over localhost."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url, data=data, method="GET" if data is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _encode_images(images, ext: str) -> list[bytes]:
    import cv2

    out = []
    for img in images:
        ok, buf = cv2.imencode(ext, cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
        require(ok, f"cv2.imencode {ext}")
        out.append(buf.tobytes())
    return out


def _decode_image(data: bytes) -> np.ndarray:
    """RGB u8 from encoded bytes, as the server and the CLIs decode them."""
    import cv2

    return cv2.cvtColor(cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR),
                        cv2.COLOR_BGR2RGB)


def _top5_against(replies: list, probs: np.ndarray, id2label: dict) -> tuple[int, float]:
    """Each reply's [[label, prob], ...] top-5 against the direct probs row of
    the same image: (replies whose labels are the direct top-5 in its order,
    max|prob - direct prob| over their entries). A reply that differs from the
    direct order must differ only between classes whose direct probs lie
    within PROB_ABS_BOUND of each other (bf16 rounding of a near tie: the
    server's batches and the direct call's differ in size, and cuBLAS may
    pick another algorithm for another size)."""
    index = {label: i for i, label in id2label.items()}
    same, err = 0, 0.0
    for reply, row in zip(replies, probs):
        labels = [label for label, _ in reply]
        direct = np.argsort(row)[::-1][: len(labels)]
        same += labels == [id2label.get(int(i), str(int(i))) for i in direct]
        got = np.array([row[index[label]] for label in labels])
        require(bool(np.all(np.abs(got - row[direct]) <= PROB_ABS_BOUND)),
                f"a top-5 {labels} differs from the direct ranking beyond near ties")
        err = max(err, float(np.abs(np.array([p for _, p in reply]) - got).max()))
    return same, err


# A client process of the serving slice: it reads its request bodies, says
# "ready", waits for "go" on stdin, posts them to one endpoint from its own
# threads and prints [[status, body], ...] in its files' order as JSON. Its
# own interpreter, so the clients share no GIL with the server's threads.
CLIENT_SCRIPT = """
import json, sys, urllib.error, urllib.request
from concurrent.futures import ThreadPoolExecutor

url, threads, files = sys.argv[1], int(sys.argv[2]), sys.argv[3:]
bodies = [open(f, "rb").read() for f in files]

def post(data):
    try:
        with urllib.request.urlopen(urllib.request.Request(url, data=data), timeout=300) as r:
            return [r.status, r.read().decode()]
    except urllib.error.HTTPError as e:
        return [e.code, e.read().decode()]

print("ready", flush=True)
sys.stdin.readline()
with ThreadPoolExecutor(threads) as pool:
    print(json.dumps(list(pool.map(post, bodies))), flush=True)
"""
SERVE_CLIENT_PROCESSES = 8


def _client_burst(url: str, files: list, in_flight: int) -> tuple[list, float]:
    """Posts each file to url from SERVE_CLIENT_PROCESSES client processes
    with in_flight requests in flight in all: ((status, body) in the files'
    order, seconds from "go" until the last client printed its replies)."""
    procs = SERVE_CLIENT_PROCESSES
    clients = [
        subprocess.Popen([sys.executable, "-c", CLIENT_SCRIPT, url, str(in_flight // procs),
                          *map(str, files[i::procs])],
                         stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
        for i in range(procs)
    ]
    try:
        for c in clients:
            require(c.stdout.readline().strip() == "ready", "serving: a client did not start")
        start = time.perf_counter()
        for c in clients:
            c.stdin.write("go\n")
            c.stdin.flush()
        outputs = [json.loads(c.stdout.readline()) for c in clients]
        seconds = time.perf_counter() - start
        for c in clients:
            require(c.wait(timeout=60) == 0, "serving: a client process failed")
    finally:
        for c in clients:
            if c.poll() is None:
                c.kill()
                c.wait(timeout=60)
    replies = [None] * len(files)
    for i, out in enumerate(outputs):
        replies[i::procs] = [(code, body.encode()) for code, body in out]
    return replies, seconds


class _AnswerAtOnce:
    """An engine stand-in whose classify answers at once: the same burst
    against it is the rate of the server's HTTP side alone."""

    def __init__(self, config):
        self.config = config

    def classify(self, images, topk=5):
        return [[("class_0", 1.0)] * topk for _ in images]


def phase_serving(card: str, path: Path, dense_rate: float) -> tuple[int, int]:
    """BatchingServer(engine, port=0, max_batch=64, max_wait_ms=5) in this
    process on a bf16 DinoEngine on the card; clients post over localhost:
    256 JPEG images of 256 px to /classify, 64 in flight from 8 client
    processes of 8 threads each; then client threads of this process post 16
    PNG images of 512 px to /features (T=1370) and 8 to /pca; /healthz last.
    Every reply 200; /classify against a direct classify_probs on the
    client's own decode of the same bytes, /features against a direct
    extract_features, /pca against a direct pca_visualizations; fewer
    batches than requests. Returns the K1 and K4 launches of the traffic."""
    from dinov2_tpu_torch.ops.flash_attention import flash_attention
    from dinov2_tpu_torch.ops.fused_attention import (
        slab_attention,
        slab_attention_block,
        slab_layer_block,
        slab_mlp_block,
    )
    from dinov2_tpu_torch.runtime.engine import DinoEngine
    from dinov2_tpu_torch.runtime.server import BatchingServer

    engine = DinoEngine(path, dtype=torch.bfloat16, parity="reference", device="cuda")
    layers = engine.config.num_hidden_layers
    rng = np.random.default_rng(SEED + 7)
    jpegs = _encode_images(rng.integers(0, 256, (SERVE_CLASSIFY_REQUESTS, IMAGE_PX, IMAGE_PX, 3),
                                        dtype=np.uint8), ".jpg")
    pngs = _encode_images(rng.integers(0, 256, (SERVE_FEATURE_REQUESTS, FEATURE_PX, FEATURE_PX, 3),
                                       dtype=np.uint8), ".png")
    server = BatchingServer(engine, port=0, max_batch=SERVE_MAX_BATCH, max_wait_ms=5.0)
    url = f"http://127.0.0.1:{server.port}"
    engine.warmup((IMAGE_PX, IMAGE_PX), batch=SERVE_MAX_BATCH)
    counters = {"K1": slab_layer_block, "K4": flash_attention, "K2": slab_attention_block,
                "K3": slab_attention, "K5": slab_mlp_block}
    busy = []  # (images, seconds) of each engine.classify call, on the batcher thread
    classify = engine.classify

    def timed_classify(images, *args, **kwargs):
        start = time.perf_counter()
        out = classify(images, *args, **kwargs)  # host arrays out: the device has finished
        busy.append((len(images), time.perf_counter() - start))
        return out

    folder = Path(tempfile.mkdtemp(prefix="serve-"))
    files = []
    for i, data in enumerate(jpegs):
        files.append(folder / f"{i:03d}.jpg")
        files[-1].write_bytes(data)

    def burst(in_flight: int) -> tuple[list, float]:
        return _client_burst(f"{url}/classify", files, in_flight)

    engine.classify = timed_classify
    server.start()
    try:
        for counter in counters.values():
            counter.launches = 0
        classified, classify_s = burst(SERVE_IN_FLIGHT)
        classify_stats, classify_latency = dict(server.stats), server.latency_stats()
        classify_busy = list(busy)
        with ThreadPoolExecutor(SERVE_FEATURE_REQUESTS) as pool:
            features = list(pool.map(lambda d: _http(f"{url}/features", d), pngs))
            pcas = list(pool.map(lambda d: _http(f"{url}/pca", d), pngs[:SERVE_PCA_REQUESTS]))
        health = _http(f"{url}/healthz")
        torch.cuda.synchronize()
        launches = {name: counter.launches for name, counter in counters.items()}
        stats, latency = dict(server.stats), server.latency_stats()
        before = dict(server.stats)
        few = burst(SERVE_FEW_IN_FLIGHT)[1]  # a finding: the same traffic, fewer in flight
        few_batches = server.stats["batches"] - before["batches"]
        # a finding: the same burst with the device's work taken away
        http_only = BatchingServer(_AnswerAtOnce(engine.config), port=0,
                                   max_batch=SERVE_MAX_BATCH, max_wait_ms=5.0)
        http_only.start()
        try:
            bare = _client_burst(f"http://127.0.0.1:{http_only.port}/classify", files,
                                 SERVE_IN_FLIGHT)[1]
        finally:
            http_only.stop()
    finally:
        server.stop()
        del engine.classify
        shutil.rmtree(folder, ignore_errors=True)

    # the batcher's engine calls against the same calls made directly, in
    # this thread with the server stopped: the gap is what the server's own
    # threads (HTTP, decode) take from the batcher
    batch_ms = 1e3 * sum(sec for _, sec in classify_busy) / len(classify_busy)
    typical = round(statistics.mean(k for k, _ in classify_busy))
    decoded = [_decode_image(d) for d in jpegs[:typical]]
    direct_ms = []
    for _ in range(5):
        start = time.perf_counter()
        engine.classify(decoded)
        direct_ms.append(1e3 * (time.perf_counter() - start))

    replies = classified + features + pcas + [health]
    codes = sorted({code for code, _ in replies})
    require(codes == [200], f"serving: reply codes {codes}")
    require(stats["batches"] < stats["requests"],
            f"serving: {stats['batches']} batches for {stats['requests']} requests")
    require(launches["K1"] > 0 and launches["K1"] % layers == 0
            and launches["K4"] > 0 and launches["K4"] % layers == 0,
            f"serving: K1 and K4 launches {launches} are not positive multiples of {layers}")
    require(launches["K2"] == launches["K3"] == launches["K5"] == 0,
            f"serving: K2, K3 or K5 launched: {launches}")
    model = json.loads(health[1])["model"]
    require(model["hidden_size"] == engine.config.hidden_size, f"serving: /healthz {model}")

    topk = [json.loads(body)["topk"] for _, body in classified]
    direct = engine.classify_probs(np.stack([_decode_image(d) for d in jpegs]))
    same, prob_err = _top5_against(topk, direct, engine.id2label)
    require(prob_err <= PROB_ABS_BOUND, f"serving: /classify probs {prob_err} from direct")
    feats = engine.extract_features(np.stack([_decode_image(d) for d in pngs]))
    cls = np.stack([json.loads(body)["cls_token"] for _, body in features])
    grids = {tuple(json.loads(body)["grid"]) for _, body in features}
    tok_rel = float(np.abs(cls - feats["cls_token"]).max() / np.abs(feats["cls_token"]).max())
    require(grids == {feats["grid"]}, f"serving: /features grids {grids}")
    require(tok_rel <= TOKEN_REL_BOUND, f"serving: /features cls_token {tok_rel} from direct")
    vis = engine.pca_visualizations([_decode_image(d) for d in pngs[:SERVE_PCA_REQUESTS]])
    agree = min(_agree_u8(_decode_image(body), v) for (_, body), v in zip(pcas, vis))
    require(agree >= PCA_AGREE, f"serving: /pca agrees with the direct PCA on {agree:.2%}")

    n = SERVE_CLASSIFY_REQUESTS
    mean_batch = classify_stats["images"] / classify_stats["batches"]
    print(
        f"serving slice: BatchingServer(max_batch={SERVE_MAX_BATCH}, max_wait_ms=5) on ViT-B/14 "
        f"bf16 on {card}: {len(replies)} replies, all 200; {stats['batches']} batches for "
        f"{stats['requests']} requests; launches in the traffic {launches}"
    )
    print(
        f"serving /classify: {n} JPEG images of {IMAGE_PX} px, {SERVE_IN_FLIGHT} in flight: "
        f"{n / classify_s:.1f} requests/s, {n / classify_s:.1f} images/s over {classify_s:.3f} s, "
        f"mean batch {mean_batch:.2f} ({classify_stats['batches']} batches); direct "
        f"classify_probs {dense_rate:.1f} img/s in this run (classify slice, batches of {BATCH})"
    )
    print(f"serving latency of the /classify requests (ms, latency_stats): {classify_latency}; "
          f"of all requests: {latency}")
    busy_s = sum(sec for _, sec in classify_busy)
    print(
        f"serving finding, not a check: the batcher thread spent {busy_s:.3f} s of the "
        f"{classify_s:.3f} s /classify burst in engine.classify ({busy_s / classify_s:.1%}; "
        f"the rest it waited on the handler threads' HTTP and decode), {batch_ms:.2f} ms a "
        f"batch over {len(classify_busy)} batches; engine.classify of {typical} of the same "
        f"images called directly with the server stopped: median {statistics.median(direct_ms):.2f}"
        f" ms of 5; the same {n} requests with {SERVE_FEW_IN_FLIGHT} in flight: "
        f"{n / few:.1f} requests/s, mean batch {n / few_batches:.2f}; against an engine that "
        f"answers at once (the HTTP side alone), {SERVE_IN_FLIGHT} in flight: "
        f"{n / bare:.1f} requests/s ({card})"
    )
    print(
        f"serving checks: /classify top-5 as a direct classify_probs of {n} images in order in "
        f"{same} of {n} replies (the rest differ only within near ties), max|dprob| "
        f"{prob_err:.4g} (bound {PROB_ABS_BOUND}), bits equal: {prob_err == 0.0}; /features "
        f"{SERVE_FEATURE_REQUESTS} x {FEATURE_PX} px grid {feats['grid']} max|dcls|/max|cls| "
        f"{tok_rel:.4g} (bound {TOKEN_REL_BOUND}); /pca {SERVE_PCA_REQUESTS} within one level "
        f"of the direct PCA on >= {agree:.2%} of pixels (bound {PCA_AGREE:.0%})"
    )
    return launches["K1"], launches["K4"]


def _cli(name: str, *args: str, timeout: float = CLI_TIMEOUT_S) -> subprocess.CompletedProcess:
    """`python3 -m dinov2_tpu_torch.cli.<name> args` from the checkout on the
    card; a non-zero exit fails the phase."""
    proc = subprocess.run([sys.executable, "-m", f"dinov2_tpu_torch.cli.{name}", *args],
                          cwd=ROOT, capture_output=True, text=True, timeout=timeout)
    require(proc.returncode == 0,
            f"CLI {name} exited {proc.returncode}: {proc.stderr[-3000:]}")
    return proc


def _serve_cli(path: Path, image: bytes) -> str:
    """`cli.serve --warmup 1` on a free port: polls /healthz until it answers,
    posts one /classify, terminates it; it must exit on the signal."""
    import signal
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    start = time.perf_counter()
    with tempfile.TemporaryFile("w+") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "dinov2_tpu_torch.cli.serve", "-m", str(path),
             "--port", str(port), "--warmup", "1"],
            cwd=ROOT, stdout=log, stderr=subprocess.STDOUT, text=True)
        try:
            while _http_or_none(f"http://127.0.0.1:{port}/healthz") is None:
                require(proc.poll() is None, "CLI serve exited before it answered")
                require(time.perf_counter() - start < CLI_TIMEOUT_S, "CLI serve never answered")
                time.sleep(0.5)
            ready_s = time.perf_counter() - start
            code, body = _http(f"http://127.0.0.1:{port}/classify", image)
            require(code == 200 and len(json.loads(body)["topk"]) == 5,
                    f"CLI serve /classify: {code} {body[:200]}")
            require(proc.poll() is None, "CLI serve exited before the signal")
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=60)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=60)
        log.seek(0)
        require(rc == -signal.SIGTERM, f"CLI serve exited {rc}, not on SIGTERM: {log.read()[-2000:]}")
    return f"answered /healthz {ready_s:.1f} s after start, one /classify 200, exit on SIGTERM"


def _http_or_none(url: str):
    try:
        return _http(url, timeout=5)
    except OSError:
        return None


def _realtime_parts(engine, source) -> str:
    """Median ms of the parts of one realtime frame, each alone: making a
    synthetic frame on the host, engine.pca_visualization of it (upload,
    forward, PCA, copy back; synchronised), its forward alone, and the PCA's
    eigh of one (D, D) f32 covariance on the card."""
    from dinov2_tpu_torch.image.preprocess import feature_preprocess

    def median_ms(fn, reps=5):
        times = []
        for _ in range(reps):
            start = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - start))
        return statistics.median(times)

    frame = next(source)
    x = torch.from_numpy(frame[None]).to(engine.device)
    with torch.inference_mode():
        pre = feature_preprocess(x, engine.config.patch_size)
        tokens = engine.model(pre, classify=False)["patch_tokens"][0].float()
        cov = (tokens - tokens.mean(0)).T @ (tokens - tokens.mean(0))
        forward = median_ms(lambda: engine.model(pre, classify=False))
    return (f"make a frame {median_ms(lambda: next(source)):.2f} ms, "
            f"engine.pca_visualization {median_ms(lambda: engine.pca_visualization(frame)):.2f}, "
            f"of which the forward {forward:.2f} and the eigh of a {tuple(cov.shape)} "
            f"covariance {median_ms(lambda: torch.linalg.eigh(cov)):.2f}")


def phase_cli(card: str, path: Path) -> None:
    """Subprocesses of `python3 -m dinov2_tpu_torch.cli.<name>` on the card,
    each with a time limit: inference -c and its PCA mode, eval --dir,
    realtime --synthetic, benchmark and serve; outputs held against an
    engine in this process."""
    import argparse
    import itertools
    import re

    from dinov2_tpu_torch.cli.realtime import _frame_source
    from dinov2_tpu_torch.runtime.engine import DinoEngine
    from dinov2_tpu_torch.runtime.loader import BatchLoader, list_images

    engine = DinoEngine(path, dtype=torch.bfloat16, parity="reference", device="cuda")
    rng = np.random.default_rng(SEED + 8)
    images = rng.integers(0, 256, (CLI_EVAL_IMAGES, IMAGE_PX, IMAGE_PX, 3), dtype=np.uint8)
    with tempfile.TemporaryDirectory() as tmp:
        tmp, folder = Path(tmp), Path(tmp) / "images"
        folder.mkdir()
        for i, d in enumerate(_encode_images(images, ".png")):
            (folder / f"im{i:02d}.png").write_bytes(d)
        image = str(folder / "im00.png")
        model = ["-m", str(path)]
        with ThreadPoolExecutor(3) as pool:
            classify, pca, evaluated = pool.map(lambda a: _cli(*a), [
                ("inference", *model, "-i", image, "-c"),
                ("inference", *model, "-i", image, "-o", str(tmp / "pca.png")),
                ("eval", *model, "--dir", str(folder), "--batch", "8", "--output",
                 str(tmp / "eval.jsonl")),
            ])
        line = re.compile(r"^ > (.*) : ([0-9.]+)$")
        top5 = [list(line.match(s).groups()) for s in classify.stdout.splitlines()]
        same_c, err_c = _top5_against([[(lb, float(p)) for lb, p in top5]],
                                      engine.classify_probs(images[:1]), engine.id2label)
        # two printed decimals are within 0.005 of the value
        require(err_c <= PRINTED_PROB_BOUND,
                f"CLI inference -c: printed probs {err_c} from the engine's")
        agree = _agree_u8(_decode_image((tmp / "pca.png").read_bytes()),
                          engine.pca_visualization(images[0]))
        require(agree >= PCA_AGREE, f"CLI inference PCA agrees on {agree:.2%}")
        rows = [json.loads(s) for s in (tmp / "eval.jsonl").read_text().splitlines()]
        paths = list_images(folder)
        require([r["path"] for r in rows] == [str(p) for p in paths], "CLI eval: paths")
        direct = np.concatenate([engine.classify_probs(batch) for _, batch in BatchLoader(
            paths, batch_size=8, size=(IMAGE_PX, IMAGE_PX), interpolation="cubic-float")])
        same_e, eval_err = _top5_against([r["topk"] for r in rows], direct, engine.id2label)
        require(eval_err <= PROB_ABS_BOUND, f"CLI eval: probs {eval_err} from the engine's")
        print(
            f"CLI slice, inference -c: exit 0, top-5 {[lb for lb, _ in top5]} (the engine's in "
            f"order: {bool(same_c)}), max|printed prob - engine prob| {err_c:.4g} (bound "
            f"{PRINTED_PROB_BOUND:.4g}); inference PCA: exit 0, within one level of "
            f"engine.pca_visualization on {agree:.2%} (bound {PCA_AGREE:.0%}), "
            f"{classify.stderr.strip().splitlines()[-1]}; eval: exit 0, {len(rows)} rows, top-5 "
            f"as engine.classify_probs on BatchLoader's cubic-float batches in order in "
            f"{same_e} of {len(rows)}, max|dprob| {eval_err:.4g}, "
            f"{evaluated.stderr.strip().splitlines()[-1]} ({card})"
        )

        stream = _cli("realtime", *model, "--synthetic", "--no-display", "--frames",
                      str(CLI_REALTIME_FRAMES), "--save-last", str(tmp / "last.png"))
        fps = [s for s in stream.stderr.splitlines() if "FPS" in s]
        require(f"frame {CLI_REALTIME_FRAMES}:" in stream.stderr and fps,
                "CLI realtime: frames or FPS missing")
        frame_ms = [float(m) for m in re.findall(r"graph computation took ([0-9.]+) ms",
                                                 stream.stderr)]
        # the last frame the CLI composed: the same synthetic frame, and its
        # PCA as engine.pca_visualization gives it
        source = _frame_source(argparse.Namespace(synthetic=True))
        frame = next(itertools.islice(source, CLI_REALTIME_FRAMES - 1, None))
        last = _decode_image((tmp / "last.png").read_bytes())
        require(last.shape == (frame.shape[0], 2 * frame.shape[1], 3)
                and np.array_equal(last[:, :frame.shape[1]], frame),
                "CLI realtime --save-last: the frame half is not the last synthetic frame")
        agree_rt = _agree_u8(last[:, frame.shape[1]:], engine.pca_visualization(frame))
        require(agree_rt >= PCA_AGREE, f"CLI realtime --save-last: PCA agrees on {agree_rt:.2%}")
        parts = _realtime_parts(engine, source)
        print(f"CLI slice, realtime --synthetic 854x480 (T=2171): exit 0; {'; '.join(fps)}; "
              f"median of its per-frame 'graph computation' ms (upload, forward, PCA and the "
              f"copy back; pipelined frames: frame to frame) {statistics.median(frame_ms):.2f}; "
              f"--save-last: frame {CLI_REALTIME_FRAMES} as made, its PCA within one level of "
              f"engine.pca_visualization on {agree_rt:.2%} (bound {PCA_AGREE:.0%}) ({card})")
        print(f"CLI slice, realtime's frame in this process, a finding: {parts} ({card})")

        bench = _cli("benchmark", *model, "--batch-sizes", "1,64", "--iters", "10", "--json")
        bench_rows = json.loads(bench.stdout)
        for rows_ in bench_rows.values():
            for r in rows_:
                require(r["hbm_peak_mb"] is not None and r["hbm_peak_mb"] >= r["hbm_weights_mb"],
                        f"CLI benchmark: {r}")
        print(f"CLI slice, benchmark: exit 0; rows {json.dumps(bench_rows)} ({card})")
        print(f"CLI slice, serve --warmup 1: {_serve_cli(path, _encode_images(images[:1], '.jpg')[0])}")


AOT_TIMED_CALLS = 10


def _aot_counters() -> dict:
    from dinov2_tpu_torch.ops.flash_attention import flash_attention
    from dinov2_tpu_torch.ops.fused_attention import (
        slab_attention,
        slab_attention_block,
        slab_layer_block,
        slab_mlp_block,
    )
    from dinov2_tpu_torch.ops.fused_quant_attention import slab_layer_block_quant
    from dinov2_tpu_torch.ops.qmatmul_kernel import quant_matmul_kernel

    return {"K1": slab_layer_block, "K2": slab_attention_block, "K3": slab_attention,
            "K4": flash_attention, "K5": slab_mlp_block, "K7": quant_matmul_kernel,
            "K8": slab_layer_block_quant}


def _aot_artifact(tmp: Path, name: str, params, config, opts, x, classify: bool,
                  platforms: tuple) -> tuple[Any, dict]:
    """export_forward -> save -> load_artifact and its CUDA program: (the
    artifact, its export seconds, load seconds and KiB)."""
    from dinov2_tpu_torch.runtime.aot import export_forward, load_artifact, save_artifact

    start = time.perf_counter()
    data = export_forward(params, config, opts, *x.shape[:3], classify=classify,
                          platforms=platforms)
    export_s = time.perf_counter() - start
    save_artifact(tmp / name, data)
    start = time.perf_counter()
    art = load_artifact(tmp / name)
    art.program("cuda")  # deserialized at first use: count it in the load
    return art, {"export_s": export_s, "load_s": time.perf_counter() - start,
                 "kib": len(data) / 1024}


def _aot_against_eager(what: str, art, params, config, opts, x, expected: dict,
                       classify: bool) -> dict:
    """The artifact's CUDA program against the eager forward on the same
    weights and input: the graph's operator nodes against `expected` (kernel
    -> calls a forward) and no SDPA node; the launches of one call against
    `expected`, every other count 0; every output's max|d| (probs: identical
    top-5 and within PROB_ABS_BOUND; tokens: within TOKEN_REL_BOUND of
    max|token|); then img/s of the eager forward and of the artifact over
    AOT_TIMED_CALLS calls each (CUDA events) in blocks of half as many, in
    turns (eager, artifact, artifact, eager), the counts read around each
    of the artifact's blocks. Returns what it measured, with `launches`,
    the artifact's launches over its checked and timed calls."""
    from collections import Counter

    from dinov2_tpu_torch.models.vit import forward

    counters = _aot_counters()
    names = {"K1": "slab_layer_block", "K2": "slab_attention_block", "K3": "slab_attention",
             "K4": "flash_attention", "K5": "slab_mlp_block", "K7": "quant_matmul",
             "K8": "slab_layer_block_quant"}
    targets = [str(n.target) for n in art.program("cuda").graph.nodes if n.op == "call_function"]
    nodes = Counter(t.split(".")[1] for t in targets if t.startswith("dinov2_tpu_torch."))
    want_nodes = {names[k]: v for k, v in expected.items()}
    require(nodes == want_nodes, f"AOT {what}: the CUDA program's operator nodes {dict(nodes)}, "
            f"expected {want_nodes}")
    require(not any("scaled_dot_product" in t for t in targets),
            f"AOT {what}: the CUDA program holds an SDPA node")
    runs = {"eager": lambda: forward(params, x, config, opts, classify=classify),
            "artifact": lambda: art(params, x)}

    def zero():
        for counter in counters.values():
            counter.launches = 0

    def timed(run) -> float:
        """Seconds of AOT_TIMED_CALLS // 2 calls, by CUDA events."""
        events = []
        for _ in range(AOT_TIMED_CALLS // 2):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            run()
            end.record()
            events.append((start, end))
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in events) / 1e3

    with torch.inference_mode():
        want = runs["eager"]()
        torch.cuda.synchronize()
        zero()
        got = runs["artifact"]()
        torch.cuda.synchronize()
        one = {k: c.launches for k, c in counters.items()}
        require(one == {k: expected.get(k, 0) for k in counters},
                f"AOT {what}: one call launched {one}, expected {expected}")
        diffs = {k: (got[k].float() - want[k].float()).abs().max().item() for k in want}
        for key, value in want.items():
            require(bool(torch.isfinite(got[key]).all()) and got[key].shape == value.shape,
                    f"AOT {what}: {key} is not finite or of the eager shape")
        if classify:
            require(torch.equal(torch.topk(got["probs"], 5).indices,
                                torch.topk(want["probs"], 5).indices),
                    f"AOT {what}: top-5 differs from eager")
            require(diffs["probs"] <= PROB_ABS_BOUND,
                    f"AOT {what}: max|dprobs| {diffs['probs']} > {PROB_ABS_BOUND}")
        scale = want["patch_tokens"].abs().max().item()
        require(diffs["patch_tokens"] <= TOKEN_REL_BOUND * scale,
                f"AOT {what}: max|dtokens| {diffs['patch_tokens']} against max|token| {scale}")
        for run in runs.values():  # warm up both
            run()
        gc.collect()  # the exports' garbage, collected before the timing
        seconds = {"eager": [], "artifact": []}
        timed_launches = dict.fromkeys(counters, 0)
        for name in ("eager", "artifact", "artifact", "eager"):
            before = {k: c.launches for k, c in counters.items()}
            seconds[name].append(timed(runs[name]))
            if name == "artifact":
                for k, c in counters.items():
                    timed_launches[k] += c.launches - before[k]
    block = AOT_TIMED_CALLS // 2 * len(x)
    rate = {k: 2 * block / sum(v) for k, v in seconds.items()}
    blocks = {k: [round(block / s, 1) for s in v] for k, v in seconds.items()}
    require(timed_launches == {k: AOT_TIMED_CALLS * v for k, v in one.items()},
            f"AOT {what}: {AOT_TIMED_CALLS} calls launched {timed_launches}")
    return {"max_abs_diff": diffs, "per_call": {k: v for k, v in one.items() if v},
            "launches": {k: v + timed_launches[k] for k, v in one.items() if v},
            "img_s": rate, "img_s_blocks": blocks, "nodes": dict(nodes)}


def phase_aot(card: str, path: Path) -> dict:
    """The AOT slice on the classify slice's ViT-B/14 file: (a) classify at
    batch 64, 224 px, bf16 exported for cuda and cpu, (b) 518 px features
    (T=1370, K4) and (c) the q4_0 file in quant_mode="fused" (K8 and K7),
    each exported, saved, loaded and run on the card against the eager
    forward; (d) `python -m dinov2_tpu_torch.cli.aot` export, info and run
    as subprocesses, run's top-5 lines against `cli.inference`'s on the same
    image; (e) their cold starts. Returns each kernel's launches in the
    artifacts' calls."""
    import re

    from dinov2_tpu_torch.image.preprocess import classify_preprocess, feature_preprocess
    from dinov2_tpu_torch.models.params import load_params
    from dinov2_tpu_torch.models.vit import ModelOptions
    from dinov2_tpu_torch.quant import quantize_gguf

    config = _vit_b14_config()
    layers = config.num_hidden_layers
    opts = ModelOptions(parity="reference", compute_dtype=torch.bfloat16)
    gguf_mib = path.stat().st_size / 2**20
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        dense = load_params(path, dtype=torch.bfloat16, device="cuda").params
        x = classify_preprocess(torch.from_numpy(_classify_images()).cuda())
        art, made = _aot_artifact(tmp, "classify.aot", dense, config, opts, x, True,
                                  ("cuda", "cpu"))
        res = _aot_against_eager("classify", art, dense, config, opts, x, {"K1": layers}, True)
        launches.update(res["launches"])
        print(
            f"AOT slice, classify: ViT-B/14 {tuple(x.shape)} bf16, platforms cuda,cpu: export "
            f"{made['export_s']:.2f} s, artifact {made['kib']:.0f} KiB against the GGUF's "
            f"{gguf_mib:.1f} MiB, load {made['load_s']:.2f} s; the CUDA program's operator nodes "
            f"{res['nodes']}, no SDPA; one call launches {res['per_call']}; against "
            f"the eager forward on the same weights and input: top-5 identical, max|d| "
            f"{res['max_abs_diff']} (probs bound {PROB_ABS_BOUND}); img/s over "
            f"{AOT_TIMED_CALLS} calls each, in blocks in turns (CUDA events): artifact "
            f"{res['img_s']['artifact']:.1f}, eager {res['img_s']['eager']:.1f}; blocks "
            f"{res['img_s_blocks']} ({card})"
        )
        del art

        images = np.random.default_rng(SEED + 2).integers(
            0, 256, (FEATURE_BATCH, FEATURE_PX, FEATURE_PX, 3), dtype=np.uint8)
        xf = feature_preprocess(torch.from_numpy(images).cuda(), config.patch_size)
        art, made = _aot_artifact(tmp, "features.aot", dense, config, opts, xf, False, ("cuda",))
        res = _aot_against_eager("features", art, dense, config, opts, xf, {"K4": layers}, False)
        launches.update(res["launches"])
        print(
            f"AOT slice, features: ViT-B/14 {tuple(xf.shape)} (T=1370) bf16, platform cuda: "
            f"export {made['export_s']:.2f} s, {made['kib']:.0f} KiB, load {made['load_s']:.2f} "
            f"s; nodes {res['nodes']}; one call launches {res['per_call']}; max|d| "
            f"against eager {res['max_abs_diff']} (tokens bound {TOKEN_REL_BOUND} of max|token|);"
            f" img/s artifact {res['img_s']['artifact']:.1f}, eager {res['img_s']['eager']:.1f}; "
            f"blocks {res['img_s_blocks']} ({card})"
        )
        del art, dense, xf

        qpath = quantize_gguf(path, tmp / f"vit_b14.{QUANT_SLICE_FORMAT}.gguf", QUANT_SLICE_FORMAT)
        quant = load_params(qpath, dtype=torch.bfloat16, device="cuda", quant_mode="fused").params
        art, made = _aot_artifact(tmp, "q4_0.aot", quant, config, opts, x, True, ("cuda",))
        want = {"K8": layers, "K7": 2 * layers + 1}
        res = _aot_against_eager("q4_0 classify", art, quant, config, opts, x, want, True)
        launches.update(res["launches"])
        print(
            f"AOT slice, {QUANT_SLICE_FORMAT} classify (quant_mode=\"fused\"): platform cuda: "
            f"export {made['export_s']:.2f} s, {made['kib']:.0f} KiB against the "
            f"{QUANT_SLICE_FORMAT} GGUF's {qpath.stat().st_size / 2**20:.1f} MiB, load "
            f"{made['load_s']:.2f} s; nodes {res['nodes']}; one call launches "
            f"{res['per_call']}; top-5 identical to eager, max|d| {res['max_abs_diff']}; "
            f"img/s artifact {res['img_s']['artifact']:.1f}, eager {res['img_s']['eager']:.1f}; "
            f"blocks {res['img_s_blocks']} ({card})"
        )
        del art, quant

        image = tmp / "image.png"
        image.write_bytes(_encode_images(_classify_images()[:1], ".png")[0])
        artifact = tmp / "cli.aot"
        timed = {}
        for name, args in (
            ("export", ("aot", "export", "-m", str(path), "--batch", "1", "-o", str(artifact))),
            ("info", ("aot", "info", str(artifact))),
            ("run", ("aot", "run", str(artifact), "-m", str(path), "-i", str(image))),
            ("inference", ("inference", "-m", str(path), "-i", str(image), "-c")),
        ):
            start = time.perf_counter()
            timed[name] = (_cli(*args), time.perf_counter() - start)
        meta = json.loads(timed["info"][0].stdout)
        require(meta["kind"] == "dinov2_tpu_torch.forward" and meta["platforms"] == ["cuda", "cpu"]
                and meta["input"]["batch"] == 1, f"CLI aot info: {meta}")
        line = re.compile(r"^ > .* : [0-9.]+$")
        top5 = {k: [s for s in timed[k][0].stdout.splitlines() if line.match(s)]
                for k in ("run", "inference")}
        require(len(top5["run"]) == 5 and top5["run"] == top5["inference"],
                f"CLI aot run's top-5 {top5['run']} is not cli.inference's {top5['inference']}")
        print(
            f"AOT slice, CLI: aot export --batch 1 (cuda,cpu) exit 0 in {timed['export'][1]:.1f} "
            f"s ({timed['export'][0].stderr.strip().splitlines()[-1]}); info exit 0; aot run -i "
            f"<png> printed the top-5 lines of cli.inference -c on the same image: {top5['run']}; "
            f"cold start, process start to printed probabilities: aot run "
            f"{timed['run'][1]:.2f} s, cli.inference {timed['inference'][1]:.2f} s ({card})"
        )
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


# ---------------------------------------------------------------------------
# The mesh slice: multi-device inference, single-controller, with every
# shard of a mesh on this one card (make_mesh(axes, devices=[card] * n)): the
# same launches a mesh of n cards would issue, one after the other
# ---------------------------------------------------------------------------

MESH_TIMED_CALLS = 5
MESH_GIANT_AXES = ({"model": 2}, {"model": 4}, {"data": 2, "model": 2})
MESH_DP_AXES = {"data": 4}
MESH_DENSE_TP_AXES = {"data": 2, "model": 2}
MESH_FEATURE_AXES = {"model": 2}
PP_STAGES = 4
PP_MICROBATCHES = 4


def _mesh_counters() -> dict:
    from dinov2_tpu_torch.ops.flash_attention import flash_attention
    from dinov2_tpu_torch.ops.fused_attention import (
        slab_attention,
        slab_attention_block,
        slab_layer_block,
        slab_mlp_block,
    )
    from dinov2_tpu_torch.ops.fused_quant_attention import slab_layer_block_quant
    from dinov2_tpu_torch.ops.qmatmul_kernel import quant_matmul_kernel

    return {"K1": slab_layer_block, "K2": slab_attention_block, "K3": slab_attention,
            "K4": flash_attention, "K5": slab_mlp_block, "K7": quant_matmul_kernel,
            "K8": slab_layer_block_quant}


def _mesh_devices(axes: dict) -> list:
    """Every position of the mesh on this card."""
    return [torch.device("cuda", 0)] * int(np.prod(list(axes.values())))


def _peak_mb(run) -> float:
    """Device memory one call of run allocates above what it starts from."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    run()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 1e6


def _spread_rows(batch: int, n: int) -> list[int]:
    """n rows spread evenly over a batch, the first and the last included:
    the images a CPU f32 reference is made of, so that every 'data' slice
    of a mesh case holds some."""
    return sorted({round(i * (batch - 1) / max(n - 1, 1)) for i in range(n)})


def _apart(got: dict, want: dict) -> dict:
    """Two routes' outputs apart, on every image: max|d| of each token
    output over max|that output| of `want`, and max|d| of the probs."""
    d = {k: ((got[k].float() - want[k].float()).abs().max()
             / want[k].float().abs().max()).item() for k in ("cls_token", "patch_tokens")}
    if "probs" in want:
        d["probs"] = (got["probs"].float() - want["probs"].float()).abs().max().item()
    return d


def _mesh_case(card: str, label: str, run, single, expected: dict, shards: int,
               reference: dict | None = None, prob_bound: float | None = None) -> tuple:
    """One mesh case: `run()` (the sharded forward) with every launch count
    at 0 just before it and read just after, required to equal `expected`
    (the kernels not named: 0), and `single()` (the single-device route on
    the same weights and input, run before the counted call). Without a
    `reference`, the two must agree bit for bit. With one (the port's plain
    f32 forward on the CPU of the images `reference["rows"]`, as every bf16
    slice of this script is held), each route's rows are held to it: tokens
    within TOKEN_REL_BOUND of max|token|, probs within `prob_bound`. And the
    two routes are held to each other on every image, within twice those
    bounds: two routes each within b of the f32 forward lie within 2b of
    each other, which is all the f32 bounds allow on the images the f32
    check does not see (in bf16 each TP partial is rounded before the psum,
    so the routes are not bit for bit). Then the median ms of each beside
    the other and the peak device memory of one call of each. Returns
    (launches, the numbers)."""
    counters = _mesh_counters()
    with torch.inference_mode():
        want = single()
        torch.cuda.synchronize()
        for counter in counters.values():
            counter.launches = 0
        got = run()
        torch.cuda.synchronize()
        launches = {name: counter.launches for name, counter in counters.items()}
    require(launches == {name: expected.get(name, 0) for name in counters},
            f"{label}: launches {launches}, expected {expected}")
    require(set(got) == set(want) and all(got[k].shape == want[k].shape for k in want),
            f"{label}: output keys or shapes differ")
    require(all(bool(torch.isfinite(v).all()) for v in got.values()), f"{label}: not finite")
    diffs = {k: (got[k].float() - want[k].float()).abs().max().item() for k in want}
    if reference is None:
        require(all(torch.equal(got[k], want[k]) for k in want),
                f"{label}: not bit for bit the single-device forward: max|d| {diffs}")
        verdict = "bit for bit the single-device forward"
    else:
        rows = reference["rows"]

        def distance(out: dict) -> dict:
            tok = reference["patch_tokens"]
            d = {"tokens": ((out["patch_tokens"][rows].cpu() - tok).abs().max()
                            / tok.abs().max()).item()}
            if "probs" in reference:
                d["probs"] = (out["probs"][rows].cpu() - reference["probs"]).abs().max().item()
            return d

        sharded, alone = distance(got), distance(want)
        for name, d in (("sharded", sharded), ("single-device", alone)):
            require(d["tokens"] <= TOKEN_REL_BOUND,
                    f"{label}: {name} tokens {d['tokens']} of max|token| from CPU f32")
            require("probs" not in d or d["probs"] <= prob_bound,
                    f"{label}: {name} probs {d.get('probs')} from CPU f32")
        apart, images = _apart(got, want), want["cls_token"].shape[0]
        for key, value in apart.items():
            bound = 2 * (prob_bound if key == "probs" else TOKEN_REL_BOUND)
            require(value <= bound, f"{label}: sharded and single-device {key} {value} apart "
                                    f"on all {images} images (bound {bound})")
        verdict = (
            f"images {rows} against CPU f32 plain: max|dtokens|/max|tokens| sharded "
            f"{sharded['tokens']:.4g}, single-device {alone['tokens']:.4g} (bound "
            f"{TOKEN_REL_BOUND})"
            + (f", max|dprobs| sharded {sharded['probs']:.4g}, single-device "
               f"{alone['probs']:.4g} (bound {prob_bound})" if "probs" in reference else "")
            + f"; sharded against single-device bf16 on all {images} images: "
            f"max|d|/max|output| cls_token {apart['cls_token']:.4g}, patch_tokens "
            f"{apart['patch_tokens']:.4g} (bound {2 * TOKEN_REL_BOUND:.4g})"
            + (f", max|dprobs| {apart['probs']:.4g} (bound {2 * prob_bound:.4g})"
               if "probs" in apart else "")
        )
    with torch.inference_mode():
        ms = cuda_median_ms(run, warmup=1, reps=MESH_TIMED_CALLS)
        single_ms = cuda_median_ms(single, warmup=1, reps=MESH_TIMED_CALLS)
        peak, single_peak = _peak_mb(run), _peak_mb(single)
    counted = ", ".join(f"{k} {v}" for k, v in launches.items() if v)
    print(
        f"mesh slice: {label}: {verdict}; launches a forward {counted}, the other kernels 0; "
        f"{ms:.3f} ms a call with {shards} shard(s) on one card against {single_ms:.3f} ms "
        f"single-device (median of {MESH_TIMED_CALLS}); peak device memory of one call "
        f"{peak:.1f} MB against {single_peak:.1f} MB ({card})"
    )
    return launches, {"ms": ms, "single_ms": single_ms, "peak_mb": peak,
                      "single_peak_mb": single_peak, "max_abs_diff": diffs}


def _cpu_reference(path: Path, config, pre, rows: list[int], classify: bool) -> dict:
    """The port's plain f32 forward on the CPU (weights decoded at load) of
    the rows `rows` of the preprocessed batch `pre` (on the CPU), with
    those rows under "rows"."""
    from dinov2_tpu_torch.models.params import load_params
    from dinov2_tpu_torch.models.vit import ModelOptions, forward

    cpu = load_params(path, dtype=torch.float32, device="cpu")
    with torch.inference_mode():
        out = forward(cpu.params, pre[rows], config,
                      ModelOptions(parity="reference", compute_dtype=torch.float32),
                      classify=classify)
    return {**out, "rows": rows}


def _tp_case(card, label, loaded, config, opts, axes, x, classify, prepare, expected,
             reference, prob_bound):
    from dinov2_tpu_torch.models.vit import forward
    from dinov2_tpu_torch.parallel.mesh import make_mesh
    from dinov2_tpu_torch.parallel.mesh import place
    from dinov2_tpu_torch.parallel.tp_fused import make_tp_forward

    groups = axes.get("data", 1)
    require({row // (x.shape[0] // groups) for row in reference["rows"]} == set(range(groups)),
            f"{label}, TP {axes}: the CPU f32 images {reference['rows']} miss a 'data' slice")
    mesh = make_mesh(axes, devices=_mesh_devices(axes))
    params_tp, specs = prepare(loaded.params, config, axes["model"])
    placed = place(params_tp, mesh, specs)
    tp = make_tp_forward(config, opts, mesh)[classify]
    return _mesh_case(
        card, f"{label}, TP {axes}", lambda: tp(placed, x),
        lambda: forward(loaded.params, x, config, opts, classify=classify),
        expected, mesh.size, reference, prob_bound)


def _dp_case(card, label, loaded, config, opts, x, expected):
    """{"data": 4} on the card: each slice is the unchanged forward on its
    replica. Held bit for bit against the single-device forward on the
    whole batch; where that fails the per-slice forward is the contract
    (a matmul library may round by the batch's size), and is required."""
    from dinov2_tpu_torch.models.vit import forward
    from dinov2_tpu_torch.parallel.mesh import make_mesh, replicate, shard_map_data_parallel

    mesh = make_mesh(MESH_DP_AXES, devices=_mesh_devices(MESH_DP_AXES))

    def fn(params, xs):
        return forward(params, xs, config, opts, classify=True)

    dp = shard_map_data_parallel(fn, mesh)
    placed = replicate(loaded.params, mesh)
    require(all(p["layers"]["ls1"] is loaded.params["layers"]["ls1"] for p in placed),
            f"{label}: a replica on the card copied the weights")
    rows = x.shape[0] // MESH_DP_AXES["data"]

    def per_slice():
        outs = [fn(loaded.params, x[i: i + rows]) for i in range(0, x.shape[0], rows)]
        return {k: torch.cat([o[k] for o in outs]) for k in outs[0]}

    with torch.inference_mode():
        whole = fn(loaded.params, x)
        got = dp(placed, x)
    if all(torch.equal(got[k], whole[k]) for k in whole):
        return _mesh_case(card, f"{label}, DP {MESH_DP_AXES}", lambda: dp(placed, x),
                          lambda: fn(loaded.params, x), expected, mesh.size)
    d = {k: (got[k] - whole[k]).abs().max().item() for k in whole}
    print(f"mesh slice: {label}, DP: against the single-device forward on the whole batch "
          f"max|d| {d}, not bit for bit: a matmul library may pick its algorithm by the "
          f"rows, {rows} a slice against {x.shape[0]}; held bit for bit against the "
          f"single-device forward on each slice instead")
    return _mesh_case(card, f"{label}, DP {MESH_DP_AXES} (against each slice)",
                      lambda: dp(placed, x), per_slice, expected, mesh.size)


def _shard_kernel_checks(card: str) -> dict:
    """K3, K4 and K7 at the shard shapes of the mesh slice's TP cases
    against their plain versions (check_kernel), beside SDPA on the same
    head views (K3, K4) and one torch.nn.functional.linear call on the
    decoded weight (K7): K3 on ViT-g/14's 6-head slab at tp=4 and on
    ViT-B/14's at {"data": 2, "model": 2}; K4 on ViT-B/14's 6 heads at
    T=1370; K7 on ViT-g/14's weight shards at tp=4, the column-split packed
    qkv and win with their bias and the row-split int8-SoA proj and wout
    without. Returns {kernel: {shape: numbers}}."""
    from dinov2_tpu_torch.models.params import quantize_linear
    from dinov2_tpu_torch.ops.attention import split_heads, vanilla_attention
    from dinov2_tpu_torch.ops.flash_attention import flash_attention
    from dinov2_tpu_torch.ops.fused_attention import _slab_reference, slab_attention
    from dinov2_tpu_torch.ops.qmatmul import dequant_weight
    from dinov2_tpu_torch.ops.qmatmul_kernel import quant_matmul_kernel, quant_matmul_reference

    scale = 0.125
    found: dict = {"K3": {}, "K4": {}, "K7": {}}
    for b, t, heads in ((GIANT_BATCH, 257, 6), (BATCH // 2, 257, 6), (FEATURE_BATCH, 1370, 6)):
        rng = np.random.default_rng(SEED + b + heads)
        qkv = (torch.from_numpy(rng.standard_normal((b, t, 3 * 64 * heads)) * 1.5)
               .to("cuda", torch.bfloat16))
        q, k, v = split_heads(qkv, heads)
        shape = f"B={b} T={t} H={heads}"
        if t < 1024:
            found["K3"][shape] = check_kernel(
                f"mesh shard: slab_attention {shape} (a {3 * 64 * heads}-wide slab)", "K3",
                partial(slab_attention, qkv, heads, scale),
                partial(_slab_reference, qkv, heads, scale),
                partial(_slab_reference, qkv.float(), heads, scale),
                card, attention_flops(b, t, heads), nbytes(qkv, q),
                library=partial(sdpa, q, k, v, scale))
        else:
            found["K4"][shape] = check_kernel(
                f"mesh shard: flash_attention on a {3 * 64 * heads}-wide slab's head views "
                f"{shape}", "K4", partial(flash_attention, q, k, v, scale),
                partial(vanilla_attention, q, k, v, scale),
                partial(vanilla_attention, q.float(), k.float(), v.float(), scale),
                card, attention_flops(b, t, heads), nbytes(q, k, v, q),
                library=partial(sdpa, q, k, v, scale))
    m = GIANT_BATCH * 257
    for name, k, n, packed, bias in (("qkv", 1536, 1152, True, True),
                                     ("win", 1536, 2048, True, True),
                                     ("proj", 384, 1536, False, False),
                                     ("wout", 1024, 1536, False, False)):
        rng = np.random.default_rng(SEED + k + n)
        ql = quantize_linear(rng.standard_normal((n, k)) * 0.05, QUANT_SLICE_FORMAT,
                             packed=packed, device="cuda")
        x = torch.from_numpy(rng.standard_normal((m, k))).to("cuda", torch.bfloat16)
        b_ = (torch.from_numpy(rng.standard_normal(n) * 0.1).to("cuda", torch.float32)
              if bias else None)
        shape = f"{name} M={m} K={k} N={n}"
        found["K7"][shape] = check_kernel(
            f"mesh shard: quant_matmul_kernel {QUANT_SLICE_FORMAT} "
            f"{'packed' if packed else 'int8 SoA'} {shape}", "K7",
            partial(quant_matmul_kernel, x, ql, b_),
            partial(quant_matmul_reference, x, ql, b_),
            partial(quant_matmul_reference, x.float(), ql, b_),
            card, 2.0 * m * k * n, nbytes(x, ql, *([b_] if bias else [])) + 2 * m * n,
            library=partial(torch.nn.functional.linear, x, dequant_weight(ql, x.dtype),
                            None if b_ is None else b_.to(x.dtype)),
            library_name="torch.nn.functional.linear on the decoded weight")
    return found


def phase_mesh(card: str) -> dict:
    """The multi-device inference path, every mesh on this card: ViT-g/14
    q4_0 (full width, GIANT_LAYERS layers, 16 images) tensor-parallel at
    MESH_GIANT_AXES (K3 on each shard's heads, K7 on its weight shards);
    ViT-B/14 bf16, 64 images: data-parallel (K1 in each replica, bit for
    bit), dense TP (K3) and 518 px features at {"model": 2} (K4 on 6
    heads); ViT-B/14 q4_0 data-parallel (K8 and K7, bit for bit);
    pipeline_forward over PP_STAGES stages of PP_MICROBATCHES microbatches
    (K1); then DinoEngine(mesh_axes={"data": n, "model": 1}) for the dense
    and the q4_0 file and `cli.inference -c --mesh n,1` at the machine's
    card count n (and the ViT-g/14 TP through the engine where n >= 2).
    First K3, K4 and K7 at the TP cases' shard shapes against their plain
    versions. Returns {kernel: {case: launches}} and, under "shard checks",
    the kernels' numbers at those shapes."""
    import re

    from dinov2_tpu_torch.image.preprocess import classify_preprocess, feature_preprocess
    from dinov2_tpu_torch.io.synthetic import write_synthetic_gguf
    from dinov2_tpu_torch.models.config import PRESETS
    from dinov2_tpu_torch.models.params import load_params
    from dinov2_tpu_torch.models.vit import ModelOptions, forward
    from dinov2_tpu_torch.parallel.mesh import make_mesh
    from dinov2_tpu_torch.parallel.pipeline import pipeline_forward, place_pipeline_params
    from dinov2_tpu_torch.parallel.tp_fused import tp_prepare_dense_params, tp_prepare_params
    from dinov2_tpu_torch.quant import quantize_gguf
    from dinov2_tpu_torch.runtime.engine import DinoEngine

    found: dict = {"shard checks": _shard_kernel_checks(card)}

    def record(case: str, launches: dict) -> None:
        for name, count in launches.items():
            if count:
                found.setdefault(name, {})[case] = count

    opts = ModelOptions()  # the engine's: bf16, parity="reference", "auto" routes
    cards = torch.cuda.device_count()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        giant = dataclasses.replace(PRESETS["giant"], num_hidden_layers=GIANT_LAYERS)
        giant_q = quantize_gguf(write_synthetic_gguf(tmp / "vit_g14.gguf", giant, seed=SEED),
                                tmp / "vit_g14.q4_0.gguf", "q4_0")
        loaded = load_params(giant_q, dtype=torch.bfloat16, device="cuda", quant_mode="fused")
        images = np.random.default_rng(SEED + 3).integers(
            0, 256, (GIANT_BATCH, IMAGE_PX, IMAGE_PX, 3), dtype=np.uint8)
        x = classify_preprocess(torch.from_numpy(images).cuda())
        reference = _cpu_reference(giant_q, giant, classify_preprocess(torch.from_numpy(images)),
                                   _spread_rows(GIANT_BATCH, GIANT_CROSS_CHECK_IMAGES), True)
        layers = giant.num_hidden_layers
        for axes in MESH_GIANT_AXES:
            tp, groups = axes["model"], axes.get("data", 1)
            case = f"ViT-g/14 q4_0 TP {axes}"
            launches, _ = _tp_case(
                card, f"ViT-g/14 q4_0 classify {GIANT_BATCH}x{IMAGE_PX}px", loaded, giant, opts,
                axes, x, True, tp_prepare_params,
                {"K3": groups * tp * layers, "K7": groups * (4 * tp * layers + 1)},
                reference, GIANT_PROB_ABS_BOUND)
            record(case, launches)
        giant_reference = reference
        del loaded, x, reference

        config = _vit_b14_config()
        layers = config.num_hidden_layers
        vit_b = write_synthetic_gguf(tmp / "vit_b14.gguf", config, seed=SEED)
        vit_b_q = quantize_gguf(vit_b, tmp / f"vit_b14.{QUANT_SLICE_FORMAT}.gguf",
                                QUANT_SLICE_FORMAT)
        loaded = load_params(vit_b, dtype=torch.bfloat16, device="cuda")
        images = _classify_images()
        x = classify_preprocess(torch.from_numpy(images).cuda())
        reference = _cpu_reference(vit_b, config, classify_preprocess(torch.from_numpy(images)),
                                   _spread_rows(BATCH, CROSS_CHECK_IMAGES), True)
        label = f"ViT-B/14 bf16 classify {BATCH}x{IMAGE_PX}px"
        dp = MESH_DP_AXES["data"]
        record(f"ViT-B/14 DP {MESH_DP_AXES}",
               _dp_case(card, label, loaded, config, opts, x, {"K1": dp * layers})[0])
        axes = MESH_DENSE_TP_AXES
        record(f"ViT-B/14 dense TP {axes}", _tp_case(
            card, label, loaded, config, opts, axes, x, True, tp_prepare_dense_params,
            {"K3": axes["data"] * axes["model"] * layers}, reference, PROB_ABS_BOUND)[0])
        feature_images = np.random.default_rng(SEED + 4).integers(
            0, 256, (FEATURE_BATCH, FEATURE_PX, FEATURE_PX, 3), dtype=np.uint8)
        x518 = feature_preprocess(torch.from_numpy(feature_images).cuda(), config.patch_size)
        axes = MESH_FEATURE_AXES
        record(f"ViT-B/14 518 px features TP {axes}", _tp_case(
            card, f"ViT-B/14 bf16 features {FEATURE_BATCH}x{FEATURE_PX}px (T=1370)", loaded,
            config, opts, axes, x518, False, tp_prepare_dense_params,
            {"K4": axes["model"] * layers},
            _cpu_reference(vit_b, config, feature_preprocess(
                torch.from_numpy(feature_images[:1]), config.patch_size), [0], False),
            None)[0])
        del x518

        mesh = make_mesh({"stage": PP_STAGES}, devices=_mesh_devices({"stage": PP_STAGES}))
        placed = place_pipeline_params(loaded.params, mesh)
        require(placed[0]["layers"]["ls1"].shape[0] == layers // PP_STAGES,
                "pipeline: stage 0 does not hold its layers")

        def pipelined():
            return pipeline_forward(placed, x, config, opts, mesh,
                                    num_microbatches=PP_MICROBATCHES, classify=True)

        def sequential():
            return forward(loaded.params, x, config, opts, classify=True)

        with torch.inference_mode():
            exact = all(torch.equal(a, b) for a, b in zip(pipelined().values(),
                                                            sequential().values()))
        if not exact:
            print("mesh slice: pipeline: not bit for bit the sequential forward (a matmul "
                  f"library may pick its algorithm by the rows: {BATCH // PP_MICROBATCHES} "
                  f"images a microbatch against {BATCH}); held within the bound instead")
        record(f"ViT-B/14 pipeline {PP_STAGES} stages x {PP_MICROBATCHES} microbatches",
               _mesh_case(card, f"{label}, pipeline_forward {PP_STAGES} stages x "
                                f"{PP_MICROBATCHES} microbatches of {BATCH // PP_MICROBATCHES}",
                          pipelined, sequential, {"K1": PP_MICROBATCHES * layers}, PP_STAGES,
                          None if exact else reference, PROB_ABS_BOUND)[0])
        del placed, loaded

        quant = load_params(vit_b_q, dtype=torch.bfloat16, device="cuda", quant_mode="fused")
        record(f"ViT-B/14 {QUANT_SLICE_FORMAT} DP {MESH_DP_AXES}", _dp_case(
            card, f"ViT-B/14 {QUANT_SLICE_FORMAT} classify {BATCH}x{IMAGE_PX}px", quant, config,
            opts, x, {"K8": dp * layers, "K7": dp * (2 * layers + 1)})[0])
        del quant

        # the engine and the CLI at the machine's card count
        axes = {"data": cards, "model": 1}
        counters = _mesh_counters()
        for name, path, quant_mode, expected in (
            ("dense", vit_b, "dequant", {"K1": cards * layers}),
            # 'model' 1 is no TP for any format: K8 and K7 in each replica
            (QUANT_SLICE_FORMAT, vit_b_q, "fused",
             {"K8": cards * layers, "K7": cards * (2 * layers + 1)}),
        ):
            single = DinoEngine(path, dtype=torch.bfloat16, device="cuda", quant_mode=quant_mode)
            engine = DinoEngine(path, dtype=torch.bfloat16, device="cuda", quant_mode=quant_mode,
                                mesh_axes=axes)
            require(engine.mesh.shape == axes, f"engine {name}: mesh {engine.mesh}")
            want = single.classify_probs(images)
            engine.classify_probs(images)
            for counter in counters.values():
                counter.launches = 0
            top5 = engine.classify(images, topk=5)
            probs = engine.classify_probs(images)
            launches = {k: c.launches for k, c in counters.items()}
            require(launches == {k: 2 * expected.get(k, 0) for k in counters},
                    f"engine {name} {axes}: launches {launches} in 2 calls")
            _check_probs(top5, probs, config)
            err = float(np.abs(probs - want).max())
            require(err <= PROB_ABS_BOUND, f"engine {name} {axes}: probs differ by {err}")
            rate, median_ms = _timed_classify(engine, images)
            single_rate, single_ms = _timed_classify(single, images)
            record(f"engine {name} {axes}", {k: v // 2 for k, v in launches.items()})
            print(
                f"mesh slice: DinoEngine({name}, mesh_axes={axes}) classify {BATCH}x{IMAGE_PX}px "
                f"on {cards} card(s): max|dprobs| against the single-device engine {err:.4g} "
                f"(bound {PROB_ABS_BOUND}), launches in 2 calls {launches}; {rate:.1f} img/s "
                f"(median {median_ms:.2f} ms/call) against {single_rate:.1f} "
                f"(median {single_ms:.2f}) single-device ({card})"
            )
            if name == "dense":
                dense_engine = engine
            del single
        image = tmp / "im.png"
        image.write_bytes(_encode_images(images[:1], ".png")[0])
        proc = _cli("inference", "-m", str(vit_b), "-i", str(image), "-c", "--mesh",
                    f"{cards},1")
        line = re.compile(r"^ > (.*) : ([0-9.]+)$")
        top5 = [list(line.match(s).groups()) for s in proc.stdout.splitlines()]
        direct = dense_engine.classify_probs(_decode_image(image.read_bytes())[None])
        same, err = _top5_against([[(lb, float(p)) for lb, p in top5]], direct,
                                  dense_engine.id2label)
        require(same == 1, f"CLI inference --mesh {cards},1: top-5 {top5} is not the engine's")
        require(err <= PRINTED_PROB_BOUND, f"CLI inference --mesh: printed probs {err} off")
        print(f"mesh slice: cli.inference -c --mesh {cards},1: exit 0, top-5 "
              f"{[lb for lb, _ in top5]} the engine's in order, max|printed prob - engine "
              f"prob| {err:.4g} (bound {PRINTED_PROB_BOUND:.4g}) ({card})")
        if cards >= 2:
            tp = 4 if cards >= 4 else 2
            torch.cuda.synchronize()
            before = [torch.cuda.memory_allocated(i) for i in range(tp)]
            engine = DinoEngine(giant_q, dtype=torch.bfloat16, device="cuda", quant_mode="fused",
                                mesh_axes={"model": tp})
            torch.cuda.synchronize()
            held = [(torch.cuda.memory_allocated(i) - before[i]) / 1e6 for i in range(tp)]
            before = torch.cuda.memory_allocated(0)
            single = DinoEngine(giant_q, dtype=torch.bfloat16, device="cuda", quant_mode="fused")
            torch.cuda.synchronize()
            single_held = (torch.cuda.memory_allocated(0) - before) / 1e6
            giant_images = np.random.default_rng(SEED + 3).integers(
                0, 256, (GIANT_BATCH, IMAGE_PX, IMAGE_PX, 3), dtype=np.uint8)
            got, want = engine.classify_probs(giant_images), single.classify_probs(giant_images)
            rows = giant_reference["rows"]
            f32 = giant_reference["probs"].numpy()
            errs = [float(np.abs(p[rows] - f32).max()) for p in (got, want)]
            require(max(errs) <= GIANT_PROB_ABS_BOUND,
                    f"engine ViT-g/14 TP {tp}: probs {errs} from CPU f32")
            apart = float(np.abs(got - want).max())
            require(apart <= 2 * GIANT_PROB_ABS_BOUND,
                    f"engine ViT-g/14 TP {tp}: probs {apart} from one card's on all images")
            rate, median_ms = _timed_classify(engine, giant_images)
            single_rate, single_ms = _timed_classify(single, giant_images)
            print(f"mesh slice: DinoEngine(ViT-g/14 q4_0, mesh_axes={{'model': {tp}}}) across "
                  f"{tp} cards: max|dprobs| against CPU f32 on images {rows} {errs[0]:.4g}, one "
                  f"card {errs[1]:.4g} (bound {GIANT_PROB_ABS_BOUND}), against one card on all "
                  f"{GIANT_BATCH} {apart:.4g} (bound {2 * GIANT_PROB_ABS_BOUND:.4g}); weights "
                  f"held a card {[round(mb, 1) for mb in held]} MB against {single_held:.1f} MB "
                  f"on one card; {rate:.1f} img/s (median {median_ms:.2f} ms/call) against "
                  f"{single_rate:.1f} (median {single_ms:.2f}) on one card ({card})")
    return found


# ---------------------------------------------------------------------------
# The mesh training slice: Trainer(mesh=) and make_pipeline_train_step, every
# mesh's shards on this one card, each case's step held to the single-device
# step on the same batch
# ---------------------------------------------------------------------------

MESH_TRAIN_SHARD = (TRAIN_BATCH // 2, 257, 6)  # one shard's attention at {"data": 2, "model": 2}
MESH_TRAIN_TIMED_STEPS = 3
# the sharded f32 step against the single-device f32 step: the JAX package's
# CPU bounds on its sharded steps (tests/test_parallel.py)
F32_LOSS_RTOL = 1e-5
F32_GRAD_RTOL, F32_GRAD_ATOL = 1e-4, 1e-6
MESH_TRAIN_CLI_IMAGES = 8  # a class; two classes, batch 8: two steps
# (label, mesh axes, attention route, sequence_parallel)
MESH_TRAIN_CASES = (
    ("DP", {"data": 4}, "auto", False),
    ("TP", {"data": 2, "model": 2}, True, False),
    ("TP", {"data": 2, "model": 2}, "auto", False),
    ("TP + SP", {"data": 2, "model": 2}, True, True),
    ("pipeline", {"stage": PP_STAGES}, "auto", False),
)


class _SGD:
    """p -= g (learning rate 1): after one step, p0 - p1 is the step's raw
    gradient, which Adam's normalization would hide."""

    def init(self, params):
        return {}

    @torch.no_grad()
    def update_(self, params, grads, state):
        from dinov2_tpu_torch.models.params import tree_leaves

        torch._foreach_add_(tree_leaves(params), grads, alpha=-1.0)


def _replicas_identical(placed: list, mesh, specs) -> bool:
    """Every copy of each (leaf, shard) in a placed list bit for bit the
    first one (across cards each position holds its own copy)."""
    from dinov2_tpu_torch.parallel.mesh import _spec_of, _walk

    first: dict = {}
    same = []
    for position, tree in enumerate(placed):
        coords = mesh.coords(position)

        def visit(path, t):
            spec = () if specs is None else _spec_of(specs, path)
            ref = first.setdefault((path, tuple((a, coords[a]) for a in spec if a)), t)
            same.append(torch.equal(ref, t.to(ref.device)))

        _walk(visit, tree)
    return all(same)


def _mesh_train_runner(config, axes, opts, optimizer, spread=False):
    """(place, step, unplace, replicas_identical) of one case: a Trainer on
    the mesh `axes` (on the card alone for None), or
    make_pipeline_train_step for a 'stage' mesh; every position on this
    card, or position k on card k (`spread`). step takes the uint8 batch;
    unplace gives the logical tree."""
    from dinov2_tpu_torch.image.preprocess import classify_preprocess
    from dinov2_tpu_torch.parallel.mesh import make_mesh, unplace
    from dinov2_tpu_torch.parallel.pipeline import layer_pspecs, make_pipeline_train_step
    from dinov2_tpu_torch.parallel.train import Trainer

    mesh = None
    if axes is not None:
        n = int(np.prod(list(axes.values())))
        mesh = make_mesh(axes, devices=[torch.device("cuda", k) for k in range(n)] if spread
                         else _mesh_devices(axes))
    if mesh is None or "stage" not in axes:
        trainer = Trainer(config, opts, optimizer, mesh=mesh, device="cuda")
        return (trainer.place, trainer.step, lambda p: trainer.unplace(p)[0],
                lambda p: mesh is None or _replicas_identical(p, mesh, trainer.specs(p)))
    step, place = make_pipeline_train_step(config, opts, mesh, optimizer, PP_MICROBATCHES)

    def run(params, state, images, labels):
        return step(params, state, classify_preprocess(torch.from_numpy(images).cuda()), labels)

    return (place, run, lambda p: unplace(p, mesh, layer_pspecs(p[0])),
            lambda p: _replicas_identical(p, mesh, layer_pspecs(p[0])))


def _zero_launches() -> dict:
    counters = _train_counters()
    for counter in counters.values():
        counter.launches = 0
    return counters


def _raw_gradients(config, axes, opts, source, images, labels,
                   spread=False) -> tuple[float, dict, dict]:
    """One SGD(1.0) step: (loss, the raw gradient leaf by leaf on the first
    card, the step's launches)."""
    from dinov2_tpu_torch.models.params import tree_map

    place, step, unplace, _ = _mesh_train_runner(config, axes, opts, _SGD(), spread)
    params, state = place(source)
    torch.cuda.synchronize()
    counters = _zero_launches()
    params, state, metrics = step(params, state, images, labels)
    loss = float(metrics["loss"])
    launches = {name: counter.launches for name, counter in counters.items()}
    with torch.no_grad():
        grads = tree_map(lambda a, b: a.to(b.device) - b, source, unplace(params))
    return loss, grads, launches


def _timed_train_steps(config, axes, opts, source, images, labels,
                       spread=False) -> tuple[float, dict, float, bool]:
    """AdamW steps of one case after a warm-up step: (median ms a step over
    MESH_TRAIN_TIMED_STEPS, their launches, the peak device MB of one more
    step above the state it starts from on the first card, whether every
    replica is then bit for bit the others)."""
    from dinov2_tpu_torch.parallel.train import AdamW

    place, step, _, identical = _mesh_train_runner(config, axes, opts, AdamW(1e-4, 0.05), spread)
    params, state = place(source)
    params, state, metrics = step(params, state, images, labels)
    float(metrics["loss"])
    counters = _zero_launches()
    seconds = []
    for _ in range(MESH_TRAIN_TIMED_STEPS):
        start = time.perf_counter()
        params, state, metrics = step(params, state, images, labels)
        float(metrics["loss"])  # waits for the device
        seconds.append(time.perf_counter() - start)
    launches = {name: counter.launches for name, counter in counters.items()}
    peak = _peak_mb(lambda: step(params, state, images, labels))
    return 1e3 * statistics.median(seconds), launches, peak, identical(params)


def _leaf_distances(grads: dict, want: dict) -> list[float]:
    """max|g - w| of each leaf."""
    from dinov2_tpu_torch.models.params import tree_leaves

    return [(g - w).abs().max().item() for g, w in zip(tree_leaves(grads), tree_leaves(want))]


def _mesh_train_cli(card: str, config, device: str) -> None:
    """`cli.train --mesh 2,2 --device <device> --dtype bf16 --flash-attn`
    ("cuda:0": every position on this card; "cuda": one a card) on a folder
    of two classes with --export and --checkpoint-dir; the export must hold
    the checkpoint's logical tree (within its f16 rounding), and
    `cli.inference -c` on the export must print the top-5 of DinoEngine on
    the same file."""
    import re

    import cv2

    from dinov2_tpu_torch.io.synthetic import write_synthetic_gguf
    from dinov2_tpu_torch.models.params import load_params, tree_leaves
    from dinov2_tpu_torch.runtime.engine import DinoEngine

    rng = np.random.default_rng(SEED + 6)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        backbone = write_synthetic_gguf(tmp / "vit_b14.gguf",
                                        dataclasses.replace(config, num_classes=0), seed=SEED,
                                        with_classifier=False)
        for name, base in (("blue", (40, 40, 200)), ("red", (200, 40, 40))):
            (tmp / "data" / name).mkdir(parents=True)
            for i in range(MESH_TRAIN_CLI_IMAGES):
                img = np.clip(np.asarray(base, np.int16) + rng.integers(-30, 30, (64, 64, 3)),
                              0, 255).astype(np.uint8)
                cv2.imwrite(str(tmp / "data" / name / f"{i}.png"), img)
        export = tmp / "tuned.gguf"
        start = time.perf_counter()
        _cli("train", "-m", str(backbone), "--data", str(tmp / "data"), "--batch", "8",
             "--mesh", "2,2", "--device", device, "--dtype", "bf16", "--flash-attn",
             "--export", str(export), "--checkpoint-dir", str(tmp / "ck"), "--log-every", "1")
        train_s = time.perf_counter() - start
        saved = torch.load(tmp / "ck" / "step_00000002.pt", map_location="cpu",
                           weights_only=True)["params"]
        exported = load_params(export, dtype=torch.float32, device="cpu").params
        worst = 0.0
        for a, b in zip(tree_leaves(exported), tree_leaves(saved)):
            # f16 rounding: half an f16 step, 2^-11 of the value
            worst = max(worst, ((a - b).abs() - 2.0**-11 * b.abs()).max().item())
        require(worst <= 1e-7, f"cli.train --mesh 2,2: the export is not the checkpoint's "
                               f"logical tree ({worst} beyond f16 rounding)")
        image = tmp / "data" / "blue" / "0.png"
        proc = _cli("inference", "-m", str(export), "-i", str(image), "-c", "--parity", "hf")
        line = re.compile(r"^ > (.*) : ([0-9.]+)$")
        top5 = [list(line.match(s).groups()) for s in proc.stdout.splitlines() if line.match(s)]
        engine = DinoEngine(export, dtype=torch.bfloat16, parity="hf", device="cuda")
        direct = engine.classify_probs(_decode_image(image.read_bytes())[None])
        same, err = _top5_against([[(lb, float(p)) for lb, p in top5]], direct, engine.id2label)
        require(same == 1 and len(top5) == 2, f"cli.inference on the mesh export: top-5 {top5}")
        require(err <= PRINTED_PROB_BOUND, f"cli.inference on the mesh export: probs {err} off")
    print(f"mesh training slice: cli.train --mesh 2,2 --device {device} --dtype bf16 --flash-attn, "
          f"ViT-B/14 on {2 * MESH_TRAIN_CLI_IMAGES} images of 64 px (two steps of 8), exit 0 in "
          f"{train_s:.1f} s; the export is the checkpoint's unplaced tree within f16 rounding; "
          f"cli.inference -c --parity hf on it: top-5 {[lb for lb, _ in top5]} DinoEngine's in "
          f"order, max|printed prob - engine prob| {err:.4g} (bound {PRINTED_PROB_BOUND:.4g}) "
          f"({card})")


def phase_mesh_train(card: str, source) -> dict:
    """The multi-device training path, every mesh on this card: ViT-B/14 at
    full width, 32 uint8 images of 256 px, parity "hf", remat, through
    Trainer(mesh=...) (place, step, unplace) at MESH_TRAIN_CASES and
    make_pipeline_train_step over PP_STAGES stages of PP_MICROBATCHES
    microbatches. First K4 with lse and K6 at a TP shard's shape. For each
    case, with the single-device step on the same batch and parameters as
    the reference:
      - f32 (plain attention in full f32, no kernel): the sharded SGD(1.0)
        step's loss and raw gradient against the single-device one, at the
        JAX package's CPU bounds;
      - bf16 over f32 masters on the case's route: the loss and each leaf's
        raw gradient within twice the single-device bf16 step's distance
        from the f32 one, plus 1e-3 of the f32 value's max (the loss's, the
        leaf's max|g|); the step's exact launches;
      - AdamW steps: ms a step against the single-device step's (the shards
        run in turn on one card: not a scale-out rate) and the peak device
        memory of one step.
    On a machine with 4 cards each case runs across them instead, position
    k on card k, and its replicas (distinct tensors there) must be bit for
    bit each other after the AdamW steps.
    Then `cli.train --mesh 2,2` (on this card, or across 4 cards) and
    `cli.inference -c` on its export.
    Returns {kernel: {case: launches a step}} and, under "shard checks",
    K4's and K6's numbers at the shard shape."""
    from dinov2_tpu_torch.models.params import tree_leaves
    from dinov2_tpu_torch.models.vit import ModelOptions

    config = _vit_b14_config()
    layers = config.num_hidden_layers
    b, t, heads = MESH_TRAIN_SHARD
    k6, lse, forward = _flash_training_shape(card, b, t, heads, forward_check=True)
    shape = f"B={b} T={t} H={heads}"
    found: dict = {"shard checks": {"K4": {f"{shape} with lse": {**forward, **lse}},
                                    "K6": {shape: k6}}}
    rng = np.random.default_rng(SEED + 5)
    images = rng.integers(0, 256, (TRAIN_BATCH, IMAGE_PX, IMAGE_PX, 3), dtype=np.uint8)
    labels = rng.integers(0, config.num_classes, TRAIN_BATCH)

    def options(route, dtype, sp=False):
        return ModelOptions(parity="hf", flash_attention=route, compute_dtype=dtype, remat=True,
                            sequence_parallel=sp)

    loss32, grads32, _ = _raw_gradients(config, None, options(False, torch.float32), source,
                                        images, labels)
    scale32 = [g.abs().max().item() for g in tree_leaves(grads32)]
    singles: dict = {}
    spread = torch.cuda.device_count() >= 4  # then position k on card k
    for label, axes, route, sp in MESH_TRAIN_CASES:
        shards = int(np.prod(list(axes.values())))
        route_name = "flash_attention=True" if route is True else f'flash_attention="{route}"'
        case = f"ViT-B/14 {label} {axes} {route_name}"
        where = f"across {shards} cards" if spread else f"with {shards} shards in turn on one card"
        # remat: each forward kernel twice a step
        if label.startswith("TP"):
            expected = ({"K4": 2 * layers * shards, "K6": layers * shards} if route is True else
                        {"K3": 2 * layers * shards, "K4": layers * shards, "K6": layers * shards})
        else:  # K1 on each replica's slice, or each microbatch
            expected = {"K1": 2 * layers * (shards if label == "DP" else PP_MICROBATCHES)}

        loss_f, grads_f, _ = _raw_gradients(config, axes, options(False, torch.float32, sp),
                                            source, images, labels, spread)
        require(abs(loss_f - loss32) <= F32_LOSS_RTOL * abs(loss32),
                f"{case} f32: loss {loss_f} against {loss32} on one device")
        beyond = max(((g - w).abs() - F32_GRAD_ATOL - F32_GRAD_RTOL * w.abs()).max().item()
                     for g, w in zip(tree_leaves(grads_f), tree_leaves(grads32)))
        require(beyond <= 0, f"{case} f32: a raw gradient is {beyond} beyond rtol "
                             f"{F32_GRAD_RTOL}, atol {F32_GRAD_ATOL} of one device's")
        f32_apart = max(_leaf_distances(grads_f, grads32))
        del grads_f

        if route not in singles:
            loss_s, grads_s, _ = _raw_gradients(config, None, options(route, torch.bfloat16),
                                                source, images, labels)
            ms_s, _, peak_s, _ = _timed_train_steps(config, None, options(route, torch.bfloat16),
                                                    source, images, labels)
            singles[route] = (loss_s, _leaf_distances(grads_s, grads32), ms_s, peak_s)
            del grads_s
        loss_s, dist_s, ms_s, peak_s = singles[route]
        loss_b, grads_b, launches = _raw_gradients(
            config, axes, options(route, torch.bfloat16, sp), source, images, labels, spread)
        want = {name: expected.get(name, 0) for name in launches}
        require(launches == want, f"{case} bf16: launches a step {launches}, expected {want}")
        loss_bound = 2 * abs(loss_s - loss32) + 1e-3 * abs(loss32)
        require(abs(loss_b - loss32) <= loss_bound,
                f"{case} bf16: loss {loss_b}, f32 {loss32}, bound {loss_bound}")
        dist_b = _leaf_distances(grads_b, grads32)
        ratios = [d / (2 * s + 1e-3 * m) for d, s, m in zip(dist_b, dist_s, scale32)]
        require(max(ratios) <= 1, f"{case} bf16: a leaf's raw gradient is {max(ratios):.3g} "
                                  "of its bound from the f32 one")
        del grads_b

        ms, timed_launches, peak, identical = _timed_train_steps(
            config, axes, options(route, torch.bfloat16, sp), source, images, labels, spread)
        require(identical, f"{case} {where}: replicas differ after the AdamW steps")
        want = {name: MESH_TRAIN_TIMED_STEPS * n for name, n in want.items()}
        require(timed_launches == want,
                f"{case}: launches in {MESH_TRAIN_TIMED_STEPS} AdamW steps {timed_launches}")
        for name, count in launches.items():
            if count:
                found.setdefault(name, {})[case] = count
        counted = ", ".join(f"{k} {v}" for k, v in launches.items() if v)
        print(
            f"mesh training slice: {case} {where}, {TRAIN_BATCH}x{IMAGE_PX}px uint8, parity hf, "
            f"remat: f32 against one device: loss {loss_f:.6f} and {loss32:.6f}, max|dgrad| "
            f"{f32_apart:.3g} (rtol {F32_GRAD_RTOL}, atol {F32_GRAD_ATOL}); bf16 over f32 masters: "
            f"loss {loss_b:.6f} ({abs(loss_b - loss32):.3g} from f32, bound {loss_bound:.3g}; "
            f"one device {loss_s:.6f}), raw gradients at most {max(ratios):.3g} of the bound "
            f"(2 x one device's distance from f32 + 1e-3 max|g|, leaf by leaf); launches a step "
            f"{counted}, the other kernels 0; AdamW step {ms:.2f} ms against {ms_s:.2f} ms "
            f"single-device (median of {MESH_TRAIN_TIMED_STEPS}), replicas bit for bit after "
            f"them; peak device memory of one step {peak:.0f} MB (the first card's) against "
            f"{peak_s:.0f} MB ({card})"
        )
    _mesh_train_cli(card, config, "cuda" if spread else "cuda:0")
    return found


# ---------------------------------------------------------------------------
# The multi-process slice: two rank processes of their own
# (parallel/mesh.py::init_distributed), Trainer(mesh=) and the engine across
# them, each case held bit for bit to the one-process mesh of the same axes
# ---------------------------------------------------------------------------

MP_WORLD = 2
MP_STEPS = 3
MP_RANK_TIMEOUT_S = 420
MP_REFUSAL_TIMEOUT_S = 120
# (label, mesh axes, attention route, sequence_parallel); with two ranks DP
# puts a 'data' slice on each, TP a 'model' shard on each, and DP x TP a
# whole 'model' group on each (two positions a rank)
MP_CASES = (
    ("DP", {"data": 2}, "auto", False),
    ("TP", {"data": 1, "model": 2}, True, False),
    ("TP", {"data": 1, "model": 2}, "auto", False),
    ("TP + SP", {"data": 1, "model": 2}, True, True),
    ("DP x TP", {"data": 2, "model": 2}, True, False),
)
MP_CHECKPOINT_CASE = 1  # the ranks save this case's state; this process restores it
# the pipeline across the ranks, {"stage": PP_STAGES}: (what, attention route,
# the rank of each stage; None: make_mesh's blocks, stages 0, 1 on rank 0 and
# 2, 3 on rank 1)
MP_PIPELINE_CASES = (
    ("pipeline_forward", "auto", None),
    ("make_pipeline_train_step", "auto", None),
    ("make_pipeline_train_step", "auto", (0, 1, 0, 1)),
    ("make_pipeline_train_step", True, None),
)


def _mp_case_name(label, axes, route) -> str:
    route_name = "flash_attention=True" if route is True else f'flash_attention="{route}"'
    return f"ViT-B/14 {label} {axes} {route_name}"


def _mp_expected(label, route, positions: int, layers: int) -> dict:
    """Launches a step of `positions` positions (remat: each forward kernel
    twice a step)."""
    if "TP" not in label:
        return {"K1": 2 * layers * positions}
    if route is True:
        return {"K4": 2 * layers * positions, "K6": layers * positions}
    return {"K3": 2 * layers * positions, "K4": layers * positions, "K6": layers * positions}


def _mp_batch(config):
    rng = np.random.default_rng(SEED + 7)
    return (rng.integers(0, 256, (TRAIN_BATCH, IMAGE_PX, IMAGE_PX, 3), dtype=np.uint8),
            rng.integers(0, config.num_classes, TRAIN_BATCH))


def _digest(tree) -> str:
    """A hash of a tree's leaves' bytes, in tree order (any dtype)."""
    import hashlib

    from dinov2_tpu_torch.models.params import tree_leaves

    h = hashlib.blake2b(digest_size=16)
    for leaf in tree_leaves(tree):
        h.update(leaf.detach().contiguous().reshape(-1).view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def _mp_trainer(config, axes, route, sp, device):
    from dinov2_tpu_torch.models.vit import ModelOptions
    from dinov2_tpu_torch.parallel.mesh import make_mesh
    from dinov2_tpu_torch.parallel.train import AdamW, Trainer

    opts = ModelOptions(parity="hf", flash_attention=route, compute_dtype=torch.bfloat16,
                        remat=True, sequence_parallel=sp)
    n = int(np.prod(list(axes.values())))
    return Trainer(config, opts, AdamW(1e-4, 0.05),
                   mesh=make_mesh(axes, devices=[device] * n), device=device)


def _mp_run_case(config, case, source, images, labels, device) -> tuple[dict, Any, Any, Any]:
    """MP_STEPS AdamW steps of one case (this process's positions): the
    losses, ms a step, launches, peak device MB and each own position's
    digest; and the trainer and its state."""
    label, axes, route, sp = case
    trainer = _mp_trainer(config, axes, route, sp, device)
    params, state = trainer.place(source)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters = _zero_launches()
    losses, seconds = [], []
    for _ in range(MP_STEPS):
        start = time.perf_counter()
        params, state, metrics = trainer.step(params, state, images, labels)
        losses.append(float(metrics["loss"]))  # waits for the device
        seconds.append(time.perf_counter() - start)
    found = {
        "losses": losses, "ms": 1e3 * statistics.median(seconds),
        "launches": {k: c.launches for k, c in counters.items() if c.launches},
        "peak_mb": torch.cuda.max_memory_allocated() / 1e6,
        "digests": {p: _digest(params[p]) for p in trainer.mesh.local_positions},
    }
    return found, trainer, params, state


def _mp_pipeline_name(what, route, placement) -> str:
    route_name = "flash_attention=True" if route is True else f'flash_attention="{route}"'
    ranks = list(placement or [s * MP_WORLD // PP_STAGES for s in range(PP_STAGES)])
    return (f"ViT-B/14 {what} {{'stage': {PP_STAGES}}} x {PP_MICROBATCHES} microbatches, "
            f"stage ranks {ranks}, {route_name}")


def _mp_pipeline_expected(what, route, layers: int) -> dict:
    """Launches a call or a step of `layers` layers (remat in training: each
    forward kernel twice a step)."""
    if what == "pipeline_forward":
        return {"K1": PP_MICROBATCHES * layers}
    if route is True:
        return {"K4": 2 * layers * PP_MICROBATCHES, "K6": layers * PP_MICROBATCHES}
    return {"K1": 2 * layers * PP_MICROBATCHES}


def _mp_pipeline_run(config, case, path: Path, source, device) -> dict:
    """MP_STEPS calls of one pipeline case on this process's stages (every
    stage in one process, as make_mesh's blocks over the ranks otherwise):
    pipeline_forward classify on BATCH images (the engine's options) or
    make_pipeline_train_step AdamW steps on the _mp_batch (bf16 over f32
    masters, remat, parity "hf"). The launches, ms a call, peak device MB,
    the outputs' digest or the losses, and each own position's digest."""
    from dinov2_tpu_torch.image.preprocess import classify_preprocess
    from dinov2_tpu_torch.models.params import load_params
    from dinov2_tpu_torch.models.vit import ModelOptions
    from dinov2_tpu_torch.parallel.mesh import Mesh, make_mesh, process_count
    from dinov2_tpu_torch.parallel.pipeline import (
        make_pipeline_train_step,
        pipeline_forward,
        place_pipeline_params,
    )
    from dinov2_tpu_torch.parallel.train import AdamW

    what, route, placement = case
    if placement is None or process_count() == 1:
        mesh = make_mesh({"stage": PP_STAGES}, devices=[device] * PP_STAGES)
    else:
        grid = np.empty(PP_STAGES, dtype=object)
        grid[:] = [device] * PP_STAGES
        mesh = Mesh(grid, ("stage",), ranks=list(placement))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    seconds, found = [], {}
    if what == "pipeline_forward":
        opts = ModelOptions(flash_attention=route)  # the engine's: bf16, parity "reference"
        placed = place_pipeline_params(
            load_params(path, dtype=torch.bfloat16, device=device).params, mesh)
        x = classify_preprocess(torch.from_numpy(_classify_images()).to(device))
        counters = _zero_launches()
        with torch.inference_mode():
            for _ in range(MP_STEPS):
                start = time.perf_counter()
                out = pipeline_forward(placed, x, config, opts, mesh,
                                       num_microbatches=PP_MICROBATCHES, classify=True)
                found["digest"] = _digest(out)  # waits for the device
                seconds.append(time.perf_counter() - start)
        found["finite"] = all(bool(torch.isfinite(v).all()) for v in out.values())
        found["shape"] = list(out["probs"].shape)
    else:
        opts = ModelOptions(parity="hf", flash_attention=route, compute_dtype=torch.bfloat16,
                            remat=True)
        step, place = make_pipeline_train_step(config, opts, mesh, AdamW(1e-4, 0.05),
                                               PP_MICROBATCHES)
        placed, state = place(source)
        images, labels = _mp_batch(config)
        x = classify_preprocess(torch.from_numpy(images).to(device))
        counters = _zero_launches()
        found["losses"] = []
        for _ in range(MP_STEPS):
            start = time.perf_counter()
            placed, state, metrics = step(placed, state, x, labels)
            found["losses"].append(float(metrics["loss"]))  # waits for the device
            seconds.append(time.perf_counter() - start)
    found.update({
        "ms": 1e3 * statistics.median(seconds),
        "launches": {k: c.launches for k, c in counters.items() if c.launches},
        "peak_mb": torch.cuda.max_memory_allocated() / 1e6,
        "digests": {p: _digest(placed[p]) for p in mesh.local_positions},
    })
    return found


def _mp_kernel_checks(card: str) -> None:
    """The slice's kernels at the shapes each rank gives them, against their
    plain versions, on this rank's card: K1 on a DP slice (B=16), K3 and K4
    with lse and K6 on a TP shard's 6 heads (B=32)."""
    from dinov2_tpu_torch.ops.fused_attention import (
        _slab_reference,
        slab_attention,
        slab_layer_block,
        slab_layer_reference,
    )
    from dinov2_tpu_torch.ops.attention import split_heads

    b, t, d, heads = TRAIN_BATCH // 2, 257, 768, 12
    args = _half_layer_args(np.random.default_rng(SEED + 8), b, t, d)
    args32 = [a.float() for a in args]
    check_kernel(
        f"rank slab_layer_block B={b} T={t} D={d} H={heads}", "K1",
        lambda: slab_layer_block(*args, heads, 0.125, 1e-6),
        lambda: slab_layer_reference(*args, heads, 0.125, 1e-6),
        lambda: slab_layer_reference(*args32, heads, 0.125, 1e-6),
        card, half_layer_flops(b, t, d, heads), nbytes(*args, args[0]))
    b, heads = TRAIN_BATCH, 6
    rng = np.random.default_rng(SEED + 9)
    qkv = torch.from_numpy(rng.standard_normal((b, t, 3 * 64 * heads)) * 1.5).to("cuda",
                                                                              torch.bfloat16)
    q, k, v = split_heads(qkv, heads)
    check_kernel(
        f"rank slab_attention B={b} T={t} H={heads}", "K3",
        partial(slab_attention, qkv, heads, 0.125), partial(_slab_reference, qkv, heads, 0.125),
        partial(_slab_reference, qkv.float(), heads, 0.125),
        card, attention_flops(b, t, heads), nbytes(qkv, q), library=partial(sdpa, q, k, v, 0.125))
    _flash_training_shape(card, b, t, heads, forward_check=True)
    # the pipeline train step's microbatch: K1, and K4 with lse and K6, at B=8
    b, heads = TRAIN_BATCH // PP_MICROBATCHES, 12
    args = _half_layer_args(np.random.default_rng(SEED + 10), b, t, d)
    args32 = [a.float() for a in args]
    check_kernel(
        f"rank pipeline slab_layer_block B={b} T={t} D={d} H={heads}", "K1",
        lambda: slab_layer_block(*args, heads, 0.125, 1e-6),
        lambda: slab_layer_reference(*args, heads, 0.125, 1e-6),
        lambda: slab_layer_reference(*args32, heads, 0.125, 1e-6),
        card, half_layer_flops(b, t, d, heads), nbytes(*args, args[0]))
    _flash_training_shape(card, b, t, heads, forward_check=True)


def mp_rank(argv: list) -> int:
    """One rank of the multi-process slice (`chip_smoke.py --rank R WORLD
    PORT DIR BACKEND [refusal]`): init_distributed, the kernel checks, every
    MP_CASES case through Trainer(mesh=) on this rank's positions, the
    checkpoint of MP_CHECKPOINT_CASE, and DinoEngine(mesh_axes={"model":
    WORLD}) classify; its numbers into DIR/rank<R>.json, the probs into
    DIR/probs<R>.npy. `refusal`: init_distributed alone (the NCCL check)."""
    from dinov2_tpu_torch.models.params import load_params
    from dinov2_tpu_torch.parallel import mesh
    from dinov2_tpu_torch.parallel.checkpoint import save_train_state
    from dinov2_tpu_torch.runtime.engine import DinoEngine

    rank, world, port = (int(a) for a in argv[:3])
    out, backend = Path(argv[3]), argv[4]
    mesh.init_distributed(f"127.0.0.1:{port}", num_processes=world, process_id=rank,
                          backend=backend)
    device = torch.device("cuda", torch.cuda.current_device())
    if argv[5:] == ["refusal"]:
        torch.distributed.all_reduce(torch.ones(1, device=device))
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
                          "-i", str(device.index)], capture_output=True, text=True, check=True,
                         timeout=60).stdout.strip()
    card = smi.replace(",", "")
    found: dict = {"rank": mesh.process_index(), "count": mesh.process_count(),
                   "backend": torch.distributed.get_backend(), "device": str(device),
                   "card": smi}
    _mp_kernel_checks(card)
    config = _vit_b14_config()
    source = load_params(out / "vit_b14.gguf", dtype=torch.float32, device="cpu").params
    images, labels = _mp_batch(config)
    for i, case in enumerate(MP_CASES):
        got, trainer, params, state = _mp_run_case(config, case, source, images, labels, device)
        found[_mp_case_name(*case[:3])] = got
        if i == MP_CHECKPOINT_CASE:
            save_train_state(out / "ck", MP_STEPS, params, state, trainer=trainer)
        del trainer, params, state
        gc.collect()
    for case in MP_PIPELINE_CASES:
        found[_mp_pipeline_name(*case)] = _mp_pipeline_run(
            config, case, out / "vit_b14.gguf", source, device)
        gc.collect()
    engine = DinoEngine(out / "vit_b14.gguf", dtype=torch.bfloat16, device=device,
                        mesh_axes={"model": world})
    counters = _zero_launches()
    np.save(out / f"probs{rank}.npy", engine.classify_probs(_classify_images()))
    found["engine"] = {"mesh": repr(engine.mesh),
                       "launches": {k: c.launches for k, c in counters.items() if c.launches}}
    (out / f"rank{rank}.json").write_text(json.dumps(found))
    return 0


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _run_ranks(directory: Path, backend: str, timeout: float, one_card: bool,
               refusal: bool = False) -> list:
    """MP_WORLD rank processes of this script under one time limit;
    (returncode, stdout, stderr) of each. `one_card`: every rank sees only
    this process's first card (else rank k takes card k). Once one rank
    fails the others are stopped (they would wait on its collectives until
    the group's timeout), unless `refusal` (each rank's own failure is the
    point); a rank still running at the limit is killed and its returncode
    is None."""
    import os

    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    if one_card:
        env["CUDA_VISIBLE_DEVICES"] = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]
    logs = [(directory / f"rank{r}.out", directory / f"rank{r}.err") for r in range(MP_WORLD)]
    procs = []
    for r, (out, err) in enumerate(logs):
        with open(out, "w") as stdout, open(err, "w") as stderr:
            procs.append(subprocess.Popen(
                [sys.executable, str(ROOT / "chip_smoke.py"), "--rank", str(r), str(MP_WORLD),
                 str(port), str(directory), backend, *(["refusal"] if refusal else [])],
                stdout=stdout, stderr=stderr, env=env, cwd=ROOT))
    deadline = time.monotonic() + timeout
    while any(p.poll() is None for p in procs) and time.monotonic() < deadline:
        if not refusal and any(p.poll() not in (None, 0) for p in procs):
            break
        time.sleep(0.2)
    codes = [p.poll() for p in procs]
    for p in procs:  # no rank outlives the phase
        if p.poll() is None:
            p.kill()
            p.wait()
    return [(code, out.read_text(), err.read_text()) for code, (out, err) in zip(codes, logs)]


def phase_multi_process(card: str) -> dict:
    """The multi-process path: two rank processes of this script
    (parallel/mesh.py::init_distributed, backend="gloo": both ranks on this
    card), ViT-B/14 at full width from a synthetic GGUF, 32 uint8 images of
    256 px, bf16 over f32 masters, remat, AdamW, MP_STEPS steps through
    Trainer(mesh=) at MP_CASES, and DinoEngine(mesh_axes={"model": 2})
    classify on 64 images (K3). Each rank first checks K1, K3, K4 with lse
    and K6 at its shapes. This process runs every case's one-process mesh on
    this card first (the reference) and frees its caches; then for each case
    both ranks' losses must equal each other and the reference's step by
    step, each rank's positions (parameters) must be bit for bit the
    reference's at those positions, and each rank's launches a step must be
    exact. The checkpoint the ranks save restores here bit for bit; the
    engine's probs are bit for bit on both ranks and the one-process
    engine's. The pipeline cases (MP_PIPELINE_CASES, {"stage": PP_STAGES}
    across the ranks, two stages a rank) likewise: each rank's
    pipeline_forward outputs, or its losses, equal the one-process
    pipeline's on this card and each rank's stages are bit for bit its
    stages there, with exact launches a rank (K1 24 a forward; K1 48, or
    K4 with lse 48 and K6 24, a train step). Then two ranks ask NCCL for
    this one card, which must fail in both. With 2 or more cards the cases
    also run over NCCL, rank k on card k (the gloo ranks keep to the first
    card). Returns {kernel: {case: launches a step a rank}}, the pipeline
    cases' under "pipeline"."""
    from dinov2_tpu_torch.models.params import load_params
    from dinov2_tpu_torch.parallel.checkpoint import restore_train_state
    from dinov2_tpu_torch.runtime.engine import DinoEngine

    config = _vit_b14_config()
    layers = config.num_hidden_layers
    device = torch.device("cuda", 0)
    found: dict = {"pipeline": {}}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        write_vit_b14(tmp)
        source = load_params(tmp / "vit_b14.gguf", dtype=torch.float32, device="cpu").params
        images, labels = _mp_batch(config)
        reference = {}
        for i, case in enumerate(MP_CASES):
            got, trainer, params, state = _mp_run_case(config, case, source, images, labels,
                                                       device)
            name = _mp_case_name(*case[:3])
            n = trainer.mesh.size
            want = _mp_expected(case[0], case[2], n, layers)
            require(got["launches"] == {k: MP_STEPS * v for k, v in want.items()},
                    f"{name} in one process: launches {got['launches']}")
            if i == MP_CHECKPOINT_CASE:
                logical, logical_state = trainer.unplace(params, state)
                got["state_digest"] = _digest({"p": logical, "mu": logical_state["mu"],
                                               "nu": logical_state["nu"]})
                del logical, logical_state
            reference[name] = got
            del trainer, params, state
            gc.collect()
        for case in MP_PIPELINE_CASES:
            name = _mp_pipeline_name(*case)
            got = _mp_pipeline_run(config, case, tmp / "vit_b14.gguf", source, device)
            want = {k: MP_STEPS * v
                    for k, v in _mp_pipeline_expected(case[0], case[1], layers).items()}
            require(got["launches"] == want,
                    f"{name} in one process: launches {got['launches']}, expected {want}")
            if case[0] == "pipeline_forward":
                require(got["finite"] and got["shape"] == [BATCH, config.num_classes],
                        f"{name} in one process: probs {got['shape']}, finite {got['finite']}")
            else:
                require(all(np.isfinite(got["losses"])),
                        f"{name} in one process: losses {got['losses']}")
            reference[name] = got
            gc.collect()
        engine = DinoEngine(tmp / "vit_b14.gguf", dtype=torch.bfloat16, device=device,
                            mesh_axes={"model": MP_WORLD})
        probs = engine.classify_probs(_classify_images())
        del engine
        gc.collect()
        torch.cuda.empty_cache()

        runs = [("gloo", "both ranks on this card")]
        if torch.cuda.device_count() >= MP_WORLD:
            runs.append(("nccl", f"rank k on card k of {torch.cuda.device_count()}"))
        for backend, where in runs:
            shutil.rmtree(tmp / "ck", ignore_errors=True)
            start = time.perf_counter()
            results = _run_ranks(tmp, backend, MP_RANK_TIMEOUT_S, one_card=backend == "gloo")
            ranks_s = time.perf_counter() - start
            for rank, (code, out, err) in enumerate(results):
                for line in out.splitlines():
                    print(f"multi-process slice: rank {rank}: {line}")
                require(code == 0, f"multi-process slice: rank {rank} ({backend}) "
                                   f"{'timed out' if code is None else f'exited {code}'}:\n"
                                   f"{err[-4000:]}")
            ranks = [json.loads((tmp / f"rank{r}.json").read_text()) for r in range(MP_WORLD)]
            print(f"multi-process slice: {MP_WORLD} ranks over {backend} "
                  f"({ranks[0]['backend']}), {where}: "
                  f"{[(r['rank'], r['device'], r['card']) for r in ranks]}, the ranks' "
                  f"processes {ranks_s:.1f} s from start to exit")
            for case in MP_CASES:
                name = _mp_case_name(*case[:3])
                want = reference[name]
                positions = int(np.prod(list(case[1].values()))) // MP_WORLD
                expected = _mp_expected(case[0], case[2], positions, layers)
                for r in ranks:
                    got = r[name]
                    require(got["losses"] == want["losses"],
                            f"{name} rank {r['rank']} ({backend}): losses {got['losses']}, one "
                            f"process {want['losses']}")
                    require(all(want["digests"][int(p)] == d for p, d in got["digests"].items())
                            and len(got["digests"]) == positions,
                            f"{name} rank {r['rank']} ({backend}): its positions' parameters "
                            "are not the one-process mesh's bit for bit")
                    require(got["launches"] == {k: MP_STEPS * v for k, v in expected.items()},
                            f"{name} rank {r['rank']} ({backend}): launches in {MP_STEPS} steps "
                            f"{got['launches']}, expected {expected} a step")
                if backend == "gloo":
                    for kernel, count in expected.items():
                        found.setdefault(kernel, {})[name] = count
                counted = ", ".join(f"{k} {v}" for k, v in expected.items())
                print(
                    f"multi-process slice: {name}, {MP_WORLD} ranks over {backend} ({where}), "
                    f"{TRAIN_BATCH}x{IMAGE_PX}px uint8, bf16 over f32 masters, remat, AdamW: "
                    f"losses {want['losses']} on both ranks and in one process, each rank's "
                    f"{positions} position(s) bit for bit the one-process mesh's after "
                    f"{MP_STEPS} steps; launches a step a rank {counted}, the other kernels 0; "
                    f"ms a step (median of {MP_STEPS}) rank 0 {ranks[0][name]['ms']:.1f}, rank 1 "
                    f"{ranks[1][name]['ms']:.1f}, one-process mesh {want['ms']:.1f}; peak device "
                    f"MB rank 0 {ranks[0][name]['peak_mb']:.0f}, rank 1 "
                    f"{ranks[1][name]['peak_mb']:.0f}, one process {want['peak_mb']:.0f} ({card})"
                )
            for case in MP_PIPELINE_CASES:
                name = _mp_pipeline_name(*case)
                want = reference[name]
                expected = _mp_pipeline_expected(case[0], case[1], layers // MP_WORLD)
                same = "digest" if case[0] == "pipeline_forward" else "losses"
                for r in ranks:
                    got = r[name]
                    require(got[same] == want[same],
                            f"{name} rank {r['rank']} ({backend}): {same} {got[same]}, one "
                            f"process {want[same]}")
                    require(len(got["digests"]) == PP_STAGES // MP_WORLD
                            and all(want["digests"][int(p)] == d
                                    for p, d in got["digests"].items()),
                            f"{name} rank {r['rank']} ({backend}): its stages' parameters are "
                            "not the one-process pipeline's bit for bit")
                    require(got["launches"] == {k: MP_STEPS * v for k, v in expected.items()},
                            f"{name} rank {r['rank']} ({backend}): launches in {MP_STEPS} calls "
                            f"{got['launches']}, expected {expected} a call")
                if backend == "gloo":
                    for kernel, count in expected.items():
                        found["pipeline"].setdefault(kernel, {})[name] = count
                counted = ", ".join(f"{k} {v}" for k, v in expected.items())
                outcome = (f"probs digest {want['digest']} on both ranks and in one process"
                           if same == "digest" else
                           f"losses {want['losses']} on both ranks and in one process, each "
                           f"rank's {PP_STAGES // MP_WORLD} stages bit for bit the one-process "
                           f"pipeline's after {MP_STEPS} AdamW steps")
                kind = (f"{BATCH}x{IMAGE_PX}px classify, bf16, parity reference"
                        if same == "digest" else f"{TRAIN_BATCH}x{IMAGE_PX}px uint8, bf16 over "
                        "f32 masters, remat, parity hf")
                print(
                    f"multi-process slice: {name}, {MP_WORLD} ranks over {backend} ({where}), "
                    f"{kind}: {outcome}; launches a call a rank {counted}, the other kernels "
                    f"0; ms a call (median of {MP_STEPS}) rank 0 {ranks[0][name]['ms']:.1f}, "
                    f"rank 1 {ranks[1][name]['ms']:.1f}, one process {want['ms']:.1f}; peak "
                    f"device MB rank 0 {ranks[0][name]['peak_mb']:.0f}, rank 1 "
                    f"{ranks[1][name]['peak_mb']:.0f}, one process {want['peak_mb']:.0f} ({card})"
                )
            name = _mp_case_name(*MP_CASES[MP_CHECKPOINT_CASE][:3])
            label, axes, route, sp = MP_CASES[MP_CHECKPOINT_CASE]
            trainer = _mp_trainer(config, axes, route, sp, device)
            step, params, state = restore_train_state(tmp / "ck", *trainer.place(source),
                                                      trainer=trainer)
            logical, logical_state = trainer.unplace(params, state)
            restored = _digest({"p": logical, "mu": logical_state["mu"],
                                "nu": logical_state["nu"]})
            require(step == MP_STEPS and restored == reference[name]["state_digest"],
                    f"{name}: the checkpoint the ranks saved ({backend}) does not restore into "
                    "one process bit for bit")
            del trainer, params, state, logical, logical_state
            gc.collect()
            got = [np.load(tmp / f"probs{r}.npy") for r in range(MP_WORLD)]
            engine_launches = [r["engine"]["launches"] for r in ranks]
            require(all(np.array_equal(g, probs) for g in got),
                    f"DinoEngine across {MP_WORLD} ranks ({backend}): probs differ from the "
                    "one-process engine's")
            require(all(e == {"K3": layers} for e in engine_launches),
                    f"DinoEngine across ranks ({backend}): launches {engine_launches}")
            if backend == "gloo":
                found.setdefault("K3", {})["ViT-B/14 DinoEngine classify {'model': 2}"] = layers
            print(f"multi-process slice: the checkpoint of {name} saved by the {MP_WORLD} ranks "
                  f"({backend}) restores into one process bit for bit (params, mu, nu after "
                  f"{MP_STEPS} steps); DinoEngine(mesh_axes={{'model': {MP_WORLD}}}) classify "
                  f"b{len(probs)} 224 px across the ranks ({ranks[0]['engine']['mesh']}): probs "
                  f"bit for bit on both ranks and the one-process engine's, K3 {layers} a rank "
                  f"a call ({card})")

        start = time.perf_counter()
        results = _run_ranks(tmp, "nccl", MP_REFUSAL_TIMEOUT_S, one_card=True, refusal=True)
        refused = [err.strip().splitlines()[-1] if err.strip() else "" for _, _, err in results]
        require(all(code not in (0, None) for code, _, _ in results),
                f"init_distributed(backend='nccl') with two ranks on one card: exit codes "
                f"{[code for code, _, _ in results]} ({refused})")
        print(f"multi-process slice: init_distributed(backend='nccl') with {MP_WORLD} ranks on "
              f"one card fails in both ranks in {time.perf_counter() - start:.1f} s, as it should "
              f"(no fallback to gloo): {refused}")
    return found


# ---------------------------------------------------------------------------
# The f32 slice: f32 activations on the f32 kernels of K1 to K4 and K6 (the
# trainer's defaults, cli.train, every --dtype f32 run), each kernel against
# its plain f32 version, then the paths against the CPU f32 run
# ---------------------------------------------------------------------------

# forward and lse, of max(1, max|plain|): the f32 bound of tests/test_torch_flash_tiles.py
F32_TOL = 1e-5
F32_GRAD_TOL = 2e-5  # gradients, likewise
F32_TOKEN_TOL = 2e-5  # tokens against the CPU f32 forward, of max(1, max|token|)
F32_PROB_TOL = 1e-5  # probs against the CPU f32 forward, absolute
F32_LOSS_TOL = 1e-5  # step 1's loss against the CPU f32 step, absolute
# raw gradients against the CPU f32 step, leaf by leaf, with the leaf bound of
# tests/test_torch_train.py::test_three_trainer_steps_match_jax: at most one
# element in 10^4 beyond 1e-5 (here of max(1, max|g|) of the leaf)
F32_GRAD_ELEMENT_TOL = 1e-5
F32_GRAD_OUTLIER_SHARE = 1e-4
F32_CROSS_CHECK_IMAGES = 4
F32_FUSE_MLP_STEPS = 3
REGISTER_TOKENS = 4


def _f32_check(label, kernel, plain, card, flops, moved_bytes, library=None,
               tol=F32_TOL, library_name="scaled_dot_product_attention f32") -> dict:
    """One f32 kernel call (an output or a tuple of them) against its plain
    f32 version on the same inputs: every output within tol of
    max(1, max|plain|). Then CUDA-event medians of the kernel, the plain
    version and, where given, the library call, and the bound at the rate
    of f32-accurate products on the tensor cores (3xTF32), the FFMA bound
    beside it."""
    got, ref = kernel(), plain()
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    worst, parts = 0.0, []
    for i, (a, r) in enumerate(zip(got, ref)):
        require(a.dtype == torch.float32, f"{label}: output {i} is {a.dtype}")
        require(bool(torch.isfinite(a).all()), f"{label}: output {i} is not finite")
        err = (a.reshape(r.shape) - r).abs().max().item()
        bound = tol * max(1.0, r.abs().max().item())
        parts.append(f"max|d| {err:.3g} (bound {bound:.3g})")
        require(err <= bound, f"{label}: output {i} error {err} exceeds {bound}")
        worst = max(worst, err)
    measured = {
        "max_abs_err": worst,
        "ms": cuda_median_ms(kernel),
        "plain_ms": cuda_median_ms(plain, reps=10),
        **roofline(flops, moved_bytes, PEAK_TF32X3_FLOPS),
        "ffma_bound_ms": roofline(flops, moved_bytes, PEAK_F32_FLOPS)["bound_ms"],
        "library_ms": cuda_median_ms(library) if library else None,
    }
    line = (f"f32 kernel check: {label}: {'; '.join(parts)}; median {measured['ms']:.4f} ms, "
            f"plain f32 {measured['plain_ms']:.4f} ms, bound {measured['bound_ms']:.4f} ms "
            f"({measured['bound_by']}, 3xTF32 at {PEAK_TF32X3_FLOPS / 1e12:.1f} TFLOP/s; FFMA "
            f"at 67 TFLOP/s {measured['ffma_bound_ms']:.4f} ms)")
    if library:
        line += f", {library_name} {measured['library_ms']:.4f} ms"
    print(f"{line} ({card})")
    return measured


def _f32_linear_ms(a2, w) -> float:
    """One f32 torch.nn.functional.linear on a GEMM launch's operands (a
    (M, K) and an (in, out) weight), TF32 off: a yardstick beside the FFMA
    GEMMs, which the port never calls."""
    wt = w.t().contiguous()
    return cuda_median_ms(lambda: torch.nn.functional.linear(a2, wt))


def phase_f32_kernel_checks(card: str) -> dict:
    """Each f32 kernel against its plain f32 version on the card: K1 at the
    classify shape, K3 at ViT-B's and ViT-g's slab shapes, K2 at ViT-g's, K4
    at the feature shape with and without lse, K6 (3xTF32) at the two
    training shapes, and run twice there, bit for bit. Returns {kernel:
    numbers} for the JSON line."""
    from dinov2_tpu_torch.ops.attention import split_heads, vanilla_attention
    from dinov2_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_slab,
        flash_backward,
        flash_backward_reference,
        flash_forward_lse,
        flash_forward_reference,
    )
    from dinov2_tpu_torch.ops.fused_attention import (
        _slab_block_reference,
        _slab_reference,
        slab_attention,
        slab_attention_block,
        slab_layer_block,
        slab_layer_reference,
    )

    require(not torch.backends.cuda.matmul.allow_tf32, "TF32 is on for f32 matmuls")
    scale, eps = 0.125, 1e-6
    found = {}

    b, t, d, heads = BATCH, 257, 768, 12
    args = [a.float() for a in _half_layer_args(np.random.default_rng(SEED), b, t, d)]
    found["K1"] = _f32_check(
        f"slab_layer_block f32 B={b} T={t} D={d} H={heads}",
        lambda: slab_layer_block(*args, heads, scale, eps),
        lambda: slab_layer_reference(*args, heads, scale, eps),
        card, half_layer_flops(b, t, d, heads), nbytes(*args, args[0]))
    x2 = args[0].reshape(-1, d)
    found["K1"]["qkv_linear_ms"] = _f32_linear_ms(x2, args[3])
    found["K1"]["proj_linear_ms"] = _f32_linear_ms(x2, args[5])
    print(f"f32 kernel check: K1's two GEMM launches beside one f32 linear call each: qkv "
          f"{found['K1']['qkv_linear_ms']:.4f} ms, proj {found['K1']['proj_linear_ms']:.4f} ms "
          f"({card})")

    for b, t, heads in ((BATCH, 257, 12), (GIANT_BATCH, 257, 24)):
        rng = np.random.default_rng(SEED + heads)
        qkv = torch.from_numpy(rng.standard_normal((b, t, 3 * 64 * heads)) * 1.5).to(
            "cuda", torch.float32)
        q, k, v = split_heads(qkv, heads)
        shape = f"B={b} T={t} D={64 * heads} H={heads}"
        k3 = _f32_check(
            f"slab_attention f32 {shape}", partial(slab_attention, qkv, heads, scale),
            partial(_slab_reference, qkv, heads, scale), card, attention_flops(b, t, heads),
            nbytes(qkv, q), library=partial(sdpa, q, k, v, scale))
        if heads == 12:
            found["K3"] = k3
            continue
        worst = max(found["K3"]["max_abs_err"], k3["max_abs_err"])
        found["K3"].update({f"{key}_giant": value for key, value in k3.items()})
        found["K3"]["max_abs_err"] = worst
        d = 64 * heads
        x = torch.from_numpy(rng.standard_normal((b, t, d))).to("cuda", torch.float32)
        w_proj = torch.from_numpy(rng.standard_normal((d, d)) * 0.05).to("cuda", torch.float32)
        b_proj = torch.from_numpy(rng.standard_normal(d) * 0.1).to("cuda", torch.float32)
        ls1 = torch.from_numpy(rng.uniform(0.1, 1.0, d)).to("cuda", torch.float32)
        block = (x, qkv, w_proj, b_proj, ls1)
        found["K2"] = _f32_check(
            f"slab_attention_block f32 {shape}",
            lambda: slab_attention_block(*block, heads, scale),
            lambda: _slab_block_reference(*block, heads, scale), card,
            attention_flops(b, t, heads) + 2.0 * b * t * d * d, nbytes(*block, x))
        found["K2"]["proj_linear_ms"] = _f32_linear_ms(x.reshape(-1, d), w_proj)

    b, t, heads = FEATURE_BATCH, 1370, 16
    rng = np.random.default_rng(SEED + t)
    qkv = torch.from_numpy(rng.standard_normal((b, t, 3 * 64 * heads)) * 1.5).to(
        "cuda", torch.float32)
    q, k, v = split_heads(qkv, heads)
    shape = f"B={b} T={t} H={heads} hd=64"
    found["K4"] = _f32_check(
        f"flash_attention_slab f32 {shape}", partial(flash_attention_slab, qkv, heads, scale),
        partial(vanilla_attention, q, k, v, scale), card, attention_flops(b, t, heads),
        nbytes(q, k, v, q), library=partial(sdpa, q, k, v, scale))
    out, _ = flash_forward_lse(q, k, v, scale)
    same = torch.equal(out, flash_attention(q, k, v, scale))
    print(f"f32 kernel check: flash_forward_lse f32 {shape}: out equals K4's without lse bit "
          f"for bit: {same}")
    require(same, f"the f32 with_lse forward's out differs from K4's at {shape}")
    found["K4-lse"] = _f32_check(
        f"flash_forward_lse f32 {shape} (out, lse)", partial(flash_forward_lse, q, k, v, scale),
        partial(flash_forward_reference, q, k, v, scale), card, attention_flops(b, t, heads),
        nbytes(q, k, v, q) + b * heads * t * 4, library=partial(sdpa, q, k, v, scale))

    for b, t, heads in ((TRAIN_BATCH, 257, 12), (TRAIN_LONG_BATCH, 1370, 16)):
        rng = np.random.default_rng(SEED + t + heads)
        qkv = torch.from_numpy(rng.standard_normal((b, t, 3 * 64 * heads)) * 1.5).to(
            "cuda", torch.float32)
        g = torch.from_numpy(rng.standard_normal((b, t, heads, 64))).to("cuda", torch.float32)
        q, k, v = split_heads(qkv, heads)
        out, lse = flash_forward_lse(q, k, v, scale)
        shape = f"B={b} T={t} H={heads} hd=64"
        k6 = _f32_check(
            f"flash_backward f32 {shape} (dq, dk, dv)",
            partial(flash_backward, q, k, v, out, lse, g, scale),
            partial(flash_backward_reference, q, k, v, out, lse, g, scale), card,
            10.0 * b * heads * t * t * 64, nbytes(q, k, v, out, g, lse, q, q, q),
            library=sdpa_backward(q, k, v, g, scale), tol=F32_GRAD_TOL,
            library_name="scaled_dot_product_attention f32 backward")
        # deterministic: no atomics, every sum over T taken in one order
        first, second = (flash_backward(q, k, v, out, lse, g, scale) for _ in range(2))
        same = all(torch.equal(a, c) for a, c in zip(first, second))
        print(f"f32 kernel check: flash_backward f32 {shape}: two calls on the same inputs "
              f"equal bit for bit: {same}")
        require(same, f"K6 f32 at {shape} differs between two calls on the same inputs")
        del first, second
        if t == 257:
            found["K6"] = k6
        else:
            worst = max(found["K6"]["max_abs_err"], k6["max_abs_err"])
            found["K6"].update({f"{key}_t1370": value for key, value in k6.items()})
            found["K6"]["max_abs_err"] = worst
    return found


# gelu_tanh_f16 rounds g to f16: where the kernel's and the plain version's
# f32 sums of fc1 straddle an f16 boundary, g moves by one f16 step and fc2
# carries it into the output (tests/test_torch_mlp_tiles.py's
# F32_ATOL_F16_GELU); the share of elements past F32_TOL is printed beside it
F32_GELU_F16_TOL = 5e-4
F32_MLP_RAGGED = (3, 43)  # (B, T): 129 rows, one past the FFMA GEMM's 128-row tile


def phase_f32_mlp_quant_checks(card: str) -> dict:
    """K5 f32 against its plain f32 version at the fuse_mlp slice's shape
    (B=64, T=257, D=768) and at a ragged M, for the three activations; K8
    f32 at the classify shape for q4_0, q5_1 (packed) and q8_0 (int8 SoA),
    bit for bit K1 f32 on the dequantized weights and within F32_TOL of its
    plain version; K7's f32 route (3xTF32) at the f32 q4_0 path's fc1, fc2
    and head, its two launches apart by torch.profiler. Each timed beside
    its bound, its plain version and one f32 F.linear per GEMM. Returns
    {kernel: numbers} for the JSON line."""
    from dinov2_tpu_torch.models.params import quantize_linear
    from dinov2_tpu_torch.ops.fused_attention import (
        slab_layer_block,
        slab_mlp_block,
        slab_mlp_reference,
    )
    from dinov2_tpu_torch.ops.fused_quant_attention import (
        quant_layer_reference,
        slab_layer_block_quant,
    )
    from dinov2_tpu_torch.ops.qmatmul import apply_activation, dequant_weight
    from dinov2_tpu_torch.ops.qmatmul_kernel import quant_matmul_kernel, quant_matmul_reference

    require(not torch.backends.cuda.matmul.allow_tf32, "TF32 is on for f32 matmuls")
    eps, found = 1e-6, {}
    d = 768
    for b, t in ((BATCH, 257), F32_MLP_RAGGED):
        args = [a.float() for a in _mlp_args(b, t, d)]
        for act in ("gelu_tanh_f16", "gelu_erf", "gelu_tanh"):
            run = partial(slab_mlp_block, *args, act, eps)
            plain = partial(slab_mlp_reference, *args, act, eps)
            label = f"slab_mlp_block f32 B={b} T={t} D={d} DH={4 * d} {act}"
            numbers = _f32_check(
                label, run, plain, card, 4.0 * b * t * d * 4 * d, nbytes(*args, args[0]),
                tol=F32_GELU_F16_TOL if act == "gelu_tanh_f16" else F32_TOL)
            if act == "gelu_tanh_f16":
                ref = plain()
                past = (run() - ref).abs() > F32_TOL * max(1.0, ref.abs().max().item())
                print(f"f32 kernel check: {label}: {past.float().mean().item():.3g} of the "
                      f"elements past {F32_TOL} of max(1, max|y|) (one f16 step of g)")
            found[b, act] = numbers
    main = found[BATCH, "gelu_tanh_f16"]
    x, lns, lnb, w1, b1, w2, _, _ = [a.float() for a in _mlp_args(BATCH, 257, d)]
    x2 = x.reshape(-1, d)
    h = torch.nn.functional.layer_norm(x2, (d,), lns, lnb, eps)
    hidden = apply_activation(torch.matmul(h, w1) + b1, "gelu_tanh_f16")
    k5 = {
        **main,
        "max_abs_err": max(v["max_abs_err"] for v in found.values()),
        **{f"{key}_{act}": found[BATCH, act][key] for act in ("gelu_erf", "gelu_tanh")
           for key in ("ms", "plain_ms")},
        "ms_ragged": found[F32_MLP_RAGGED[0], "gelu_tanh_f16"]["ms"],
        "fc1_linear_ms": _f32_linear_ms(h, w1),
        "fc2_linear_ms": _f32_linear_ms(hidden, w2),
    }
    print(f"f32 kernel check: K5 f32's two GEMM launches beside one f32 linear call each: fc1 "
          f"{k5['fc1_linear_ms']:.4f} ms, fc2 {k5['fc2_linear_ms']:.4f} ms ({card})")
    del args, x, x2, h, hidden

    b, t, heads = BATCH, 257, 12
    scale = 1.0 / 64**0.5
    quant = {}
    for fmt in ("q4_0", "q5_1", "q8_0"):
        rng = np.random.default_rng(SEED)
        x, lns, lnb, _, bq, _, bp, ls = [a.float() for a in _half_layer_args(rng, b, t, d)]
        wq = quantize_linear(rng.standard_normal((3 * d, d)) * 0.05, fmt, device="cuda")
        wp = quantize_linear(rng.standard_normal((d, d)) * 0.05, fmt, device="cuda")
        rest = (lns, lnb, wq, bq, wp, bp, ls, heads, scale, eps)
        dense = [dequant_weight(w, torch.float32).T.contiguous() for w in (wq, wp)]
        k1 = slab_layer_block(x, lns, lnb, dense[0], bq, dense[1], bp, ls, heads, scale, eps)
        same = torch.equal(slab_layer_block_quant(x, *rest), k1)
        layout = "packed" if wq.packed else "int8 SoA"
        print(f"f32 kernel check: slab_layer_block_quant f32 {fmt} ({layout}) B={b} T={t} D={d}: "
              f"bit for bit K1 f32 on dequant_weight(W, f32).T: {same}")
        require(same, f"K8 f32 {fmt} differs from K1 f32 on the dequantized weights")
        quant[fmt] = _f32_check(
            f"slab_layer_block_quant f32 {fmt} ({layout}) B={b} T={t} D={d} H={heads}",
            partial(slab_layer_block_quant, x, *rest), partial(quant_layer_reference, x, *rest),
            card, half_layer_flops(b, t, d, heads), nbytes(x, lns, lnb, wq, bq, wp, bp, ls, x))
        if fmt == QUANT_SLICE_FORMAT:
            x2 = x.reshape(-1, d)
            quant["qkv_linear_ms"] = _f32_linear_ms(x2, dense[0])
            quant["proj_linear_ms"] = _f32_linear_ms(x2, dense[1])
    k8 = {
        **quant[QUANT_SLICE_FORMAT],
        "max_abs_err": max(quant[fmt]["max_abs_err"] for fmt in ("q4_0", "q5_1", "q8_0")),
        **{f"ms_{fmt}": quant[fmt]["ms"] for fmt in ("q5_1", "q8_0")},
        "qkv_linear_ms": quant["qkv_linear_ms"], "proj_linear_ms": quant["proj_linear_ms"],
    }
    print(f"f32 kernel check: K8 f32's two GEMM launches beside one f32 linear call each on "
          f"the decoded weights: qkv {k8['qkv_linear_ms']:.4f} ms, proj "
          f"{k8['proj_linear_ms']:.4f} ms ({card})")

    shapes = {  # name -> (M, K, N, activation): the f32 q4_0 classify path's K7 launches
        "fc1": (BATCH * 257, 768, 3072, "gelu_tanh_f16"),
        "fc2": (BATCH * 257, 3072, 768, None),
        "head": (BATCH, 1536, 1000, None),
    }
    k7 = {}
    for name, (m, k, n, act) in shapes.items():
        rng = np.random.default_rng(SEED + k)
        ql = quantize_linear(rng.standard_normal((n, k)) * 0.05, QUANT_SLICE_FORMAT, device="cuda")
        x = torch.from_numpy(rng.standard_normal((m, k))).to("cuda", torch.float32)
        bias = torch.from_numpy(rng.standard_normal(n) * 0.1).to("cuda", torch.float32)
        k7[name] = _f32_check(
            f"quant_matmul_kernel f32 {QUANT_SLICE_FORMAT} {name} M={m} K={k} N={n} {act}",
            partial(quant_matmul_kernel, x, ql, bias, act),
            partial(quant_matmul_reference, x, ql, bias, act), card, 2.0 * m * k * n,
            nbytes(x, ql, bias) + m * n * 4,
            library=partial(torch.nn.functional.linear, x, dequant_weight(ql, torch.float32),
                            bias),
            library_name="one f32 F.linear on the decoded weight (no activation)",
            tol=F32_GELU_F16_TOL if act == "gelu_tanh_f16" else F32_TOL)
        # the two launches one by one: the TF32 planes of the weight, the GEMM
        ms = device_ms_by_launch(
            partial(quant_matmul_kernel, x, ql, bias, act),
            {"Tf32SplitRows": "dequantize", "quant_matmul_tf32x3_kernel": "gemm"}, "K7 f32")
        print(f"f32 kernel check: K7 f32 launch by launch, {QUANT_SLICE_FORMAT} {name} M={m} "
              f"K={k} N={n} {act}: device ms of a launch (torch.profiler, 10 calls): dequantize "
              f"to the TF32 planes {ms['dequantize']:.4f}, 3xTF32 GEMM {ms['gemm']:.4f} "
              f"({2e-9 * m * k * n / ms['gemm']:.1f} TFLOP/s of f32 products), sum "
              f"{sum(ms.values()):.4f} ({card})")
        k7[name].update({f"ms_{key}": value for key, value in ms.items()})
    k7_f32 = {
        **k7["fc1"],
        "max_abs_err": max(v["max_abs_err"] for v in k7.values()),
        **{f"{key}_{name}": k7[name][key] for name in ("fc2", "head")
           for key in ("ms", "plain_ms", "bound_ms", "library_ms")},
        **{f"{key}_{name}": k7[name][key] for name in ("fc2", "head")
           for key in ("ms_dequantize", "ms_gemm")},
    }
    return {"K5": k5, "K8": k8, "K7": k7_f32}


def _all_counters() -> dict:
    """Every kernel wrapper of the port, by kernel."""
    from dinov2_tpu_torch.ops.flash_attention import flash_backward

    return {**_int8_counters(), "K6": flash_backward}


def _zero_counts() -> None:
    """Every kernel count of the port at 0, bf16 and f32."""
    for counter in _all_counters().values():
        counter.launches = 0
        if hasattr(counter, "f32_launches"):
            counter.f32_launches = 0


def _read_counts() -> tuple[dict, dict]:
    """(the f32 counts of K1 to K6 and K8; every other count that is not
    0)."""
    f32, other = {}, {}
    for name, counter in _all_counters().items():
        if hasattr(counter, "f32_launches"):
            f32[name] = counter.f32_launches
        if counter.launches:
            other[name] = counter.launches
    return f32, other


def _require_counts(what: str, want: dict, other_want: dict | None = None) -> dict:
    """The f32 counts since _zero_counts are `want`, the rest 0, and the
    other counts (`.launches`: K7 counts its f32 kernel there) are
    `other_want`, no other kernel launched; returns the counts that are not
    0."""
    f32, other = _read_counts()
    expected = {name: want.get(name, 0) for name in f32}
    require(f32 == expected, f"{what}: f32 launches {f32}, expected {expected}")
    require(other == (other_want or {}),
            f"{what}: other kernels launched {other}, expected {other_want or {}}")
    return {**{name: n for name, n in f32.items() if n}, **other}


def _f32_against_cpu(engine, cpu_params, images, config, what: str) -> str:
    """The first F32_CROSS_CHECK_IMAGES images through the engine's f32
    forward on the card (its device weights and kernels) and the port's
    plain f32 forward on the CPU, both on the CPU's preprocessed input and
    in parity "hf": tokens within F32_TOKEN_TOL of max(1, max|token|), probs
    within F32_PROB_TOL and the same top-5. Parity "reference" rounds the
    GELU's input and output to f16 (ggml's lookup table), which turns a
    last-bit difference of f32 sums into an f16 step of an activation, so
    its distance is printed as a finding beside the check, as is the
    preprocess's on the card."""
    from dinov2_tpu_torch.image.preprocess import classify_preprocess
    from dinov2_tpu_torch.models.vit import forward_features, forward_head

    sub = images[:F32_CROSS_CHECK_IMAGES]
    hf = dataclasses.replace(engine.opts, parity="hf")
    with torch.inference_mode():
        pre32 = classify_preprocess(torch.from_numpy(sub))
        pre_err = (classify_preprocess(torch.from_numpy(sub).cuda()).cpu() - pre32).abs().max()
        ref_err = (forward_features(engine.model.params, pre32.cuda(), config, engine.opts).cpu()
                   - forward_features(cpu_params, pre32, config, engine.opts)).abs().max()
        tok = forward_features(engine.model.params, pre32.cuda(), config, hf)
        prob = forward_head(engine.model.params, tok, config, hf).cpu()
        tok = tok.cpu()
        tok32 = forward_features(cpu_params, pre32, config, hf)
        prob32 = forward_head(cpu_params, tok32, config, hf)
    tok_err = (tok - tok32).abs().max().item()
    tok_bound = F32_TOKEN_TOL * max(1.0, tok32.abs().max().item())
    prob_err = (prob - prob32).abs().max().item()
    same_top5 = torch.equal(prob.topk(5).indices, prob32.topk(5).indices)
    line = (f"{what}: {len(sub)} images against the CPU f32 forward, the same preprocessed "
            f"input, parity hf: max|dtokens| {tok_err:.3g} (bound {tok_bound:.3g}), max|dprobs| "
            f"{prob_err:.3g} (bound {F32_PROB_TOL}), top-5 identical: {same_top5}; findings, not "
            f"checks: parity reference max|dtokens| {ref_err.item():.3g} (the f16 GELU), the "
            f"preprocess on the card against the CPU's max|d| {pre_err.item():.3g}")
    print(line)
    require(tok_err <= tok_bound, f"{what}: tokens differ from the CPU f32 forward")
    require(prob_err <= F32_PROB_TOL, f"{what}: probs differ from the CPU f32 forward")
    require(same_top5, f"{what}: the top-5 differ from the CPU f32 forward's")
    return line


def phase_f32_classify(card: str, path: Path) -> dict:
    """DinoEngine(path, dtype=torch.float32, device="cuda").classify on the
    classify slice's 64 images (T=257): K1 f32 12 times a forward; the same
    weights at slab_fusion "proj" (K2 f32) and "core" (K3 f32), and with
    fuse_mlp=True (K1 f32 and K5 f32 12 each). The same file quantized to
    q4_0 through quant_mode="fused" in f32: K8 f32 12 and K7 (its 3xTF32
    route, both kernels named in a profiler window) 25 a forward; with
    fuse_mlp=True K8 f32 12, K5 f32 12 (on the
    dequantized fc1/fc2) and K7 1 (the head); and `cli.inference -c --dtype
    f32 --quant-mode fused` on that file against the engine. Then ViT-B/14
    with REGISTER_TOKENS register tokens (T=261: a masked tail) in bf16 and
    f32 through K1. Each against the CPU f32 forward. Returns the launches
    of each run."""
    import re

    from dinov2_tpu_torch.io.synthetic import write_synthetic_gguf
    from dinov2_tpu_torch.models.params import load_params
    from dinov2_tpu_torch.ops.attention import vanilla_route_warnings
    from dinov2_tpu_torch.quant import quantize_gguf
    from dinov2_tpu_torch.runtime.engine import DinoEngine

    warnings = vanilla_route_warnings()
    config = _vit_b14_config()
    layers = config.num_hidden_layers
    images = _classify_images()
    engine = DinoEngine(path, dtype=torch.float32, parity="reference", device="cuda")
    cpu_params = load_params(path, dtype=torch.float32, device="cpu").params
    found = {}

    def run(eng, what, want, other_want=None):
        eng.warmup((IMAGE_PX, IMAGE_PX), batch=BATCH)
        _zero_counts()
        top5 = eng.classify(images, topk=5)
        probs = eng.classify_probs(images)
        rate, median_ms = _timed_classify(eng, images)
        forwards = 2 + TIMED_CALLS
        counts = _require_counts(
            what, {name: n * forwards for name, n in want.items()},
            {name: n * forwards for name, n in (other_want or {}).items()})
        row_err = _check_probs(top5, probs, eng.config)
        print(f"{what}: {BATCH}x{IMAGE_PX}px on {card}: probs finite, max|row sum - 1| "
              f"{row_err:.3g}; launches in {forwards} forwards {counts}, every other kernel 0; "
              f"{rate:.1f} img/s (median {median_ms:.2f} ms/call)")
        return counts

    found["layer"] = run(engine, "f32 classify: ViT-B/14 f32", {"K1": layers})
    _f32_against_cpu(engine, cpu_params, images, config, "f32 classify cross-check")
    for level, kernel in (("proj", "K2"), ("core", "K3")):
        other = _same_weights(engine, slab_fusion=level)
        found[level] = run(other, f'f32 classify: ViT-B/14 f32 slab_fusion="{level}"',
                           {kernel: layers})
        _f32_against_cpu(other, cpu_params, images, config,
                         f'f32 classify cross-check, slab_fusion="{level}"')
        del other
    fused = _same_weights(engine, fuse_mlp=True)
    found["fuse_mlp"] = run(fused, "f32 classify: ViT-B/14 f32 fuse_mlp=True",
                            {"K1": layers, "K5": layers})
    _f32_against_cpu(fused, cpu_params, images, config, "f32 classify cross-check, fuse_mlp=True")
    del engine, fused, cpu_params

    start = time.perf_counter()
    q_path = quantize_gguf(path, path.parent / f"vit_b14.{QUANT_SLICE_FORMAT}.f32.gguf",
                           QUANT_SLICE_FORMAT)
    print(f"f32 quantized classify: quantize_gguf to {QUANT_SLICE_FORMAT} took "
          f"{time.perf_counter() - start:.1f} s")
    engine = DinoEngine(q_path, dtype=torch.float32, parity="reference", device="cuda",
                        quant_mode="fused")
    require(engine.loaded.quantized, "the q4_0 file did not load as QuantLinear weights")
    q_cpu = load_params(q_path, dtype=torch.float32, device="cpu", quant_mode="fused").params
    name = f"ViT-B/14 {QUANT_SLICE_FORMAT} f32 (quant_mode=\"fused\")"
    found[QUANT_SLICE_FORMAT] = run(engine, f"f32 classify: {name}", {"K8": layers},
                                    {"K7": 2 * layers + 1})
    _f32_against_cpu(engine, q_cpu, images, config, f"f32 {QUANT_SLICE_FORMAT} cross-check")
    require_kernels_in_window(
        partial(engine.classify_probs, images),
        {"Tf32SplitRows": "K7's dequantize to TF32 planes",
         "quant_matmul_tf32x3_kernel": "K7's 3xTF32 GEMM"},
        f"f32 classify: {name}", card)
    fused = _same_weights(engine, fuse_mlp=True)
    found[f"{QUANT_SLICE_FORMAT} fuse_mlp"] = run(
        fused, f"f32 classify: {name} fuse_mlp=True", {"K8": layers, "K5": layers}, {"K7": 1})
    _f32_against_cpu(fused, q_cpu, images, config,
                     f"f32 {QUANT_SLICE_FORMAT} cross-check, fuse_mlp=True")
    del fused, q_cpu
    one = images[:1]
    with tempfile.TemporaryDirectory() as tmp:
        image = Path(tmp) / "im.png"
        image.write_bytes(_encode_images(one, ".png")[0])
        start = time.perf_counter()
        proc = _cli("inference", "-m", str(q_path), "-i", str(image), "-c", "--dtype", "f32",
                    "--quant-mode", "fused")
        cli_s = time.perf_counter() - start
    line = re.compile(r"^ > (.*) : ([0-9.]+)$")
    top5 = [list(line.match(row).groups()) for row in proc.stdout.splitlines()]
    same, err = _top5_against([[(label, float(p)) for label, p in top5]],
                              engine.classify_probs(one), engine.id2label)
    require(len(top5) == 5 and same == 1 and err <= PRINTED_PROB_BOUND,
            f"CLI inference -c --dtype f32 on the {QUANT_SLICE_FORMAT} file: top-5 {top5}")
    print(f"f32 quantized CLI: inference -c --dtype f32 --quant-mode fused on the "
          f"{QUANT_SLICE_FORMAT} file: exit 0 in {cli_s:.1f} s, top-5 "
          f"{[label for label, _ in top5]}, the f32 engine's in order, max|printed prob - "
          f"engine prob| {err:.4g} (bound {PRINTED_PROB_BOUND:.4g}) ({card})")
    del engine

    reg_config = dataclasses.replace(config, num_register_tokens=REGISTER_TOKENS)
    reg_path = write_synthetic_gguf(path.parent / "vit_b14_reg4.gguf", reg_config, seed=SEED + 7)
    reg_cpu = load_params(reg_path, dtype=torch.float32, device="cpu").params
    for dtype in (torch.bfloat16, torch.float32):
        name = "bf16" if dtype == torch.bfloat16 else "f32"
        eng = DinoEngine(reg_path, dtype=dtype, parity="reference", device="cuda")
        require(eng.config.num_register_tokens == REGISTER_TOKENS, "the register tokens")
        eng.warmup((IMAGE_PX, IMAGE_PX), batch=BATCH)
        _zero_counts()
        probs = eng.classify_probs(images)
        top5 = eng.classify(images, topk=5)
        f32, other = _read_counts()
        want = 2 * layers
        if dtype == torch.float32:
            require(f32 == {**{k: 0 for k in f32}, "K1": want} and not other,
                    f"register tokens f32: f32 launches {f32}, other {other}")
            found["registers f32"] = {"K1": want}
            line = _f32_against_cpu(eng, reg_cpu, images, reg_config,
                                    "register-token cross-check f32")
        else:
            require(other == {"K1": want} and not any(f32.values()),
                    f"register tokens bf16: launches {other}, f32 {f32}")
            found["registers bf16"] = {"K1": want}
            tok_rel, prob_err = _cpu_cross_check(eng, reg_cpu, images, reg_config)
            require(tok_rel <= TOKEN_REL_BOUND and prob_err <= PROB_ABS_BOUND,
                    f"register tokens bf16: tokens {tok_rel}, probs {prob_err} from the CPU f32")
            line = (f"cross-check: {CROSS_CHECK_IMAGES} images against the CPU f32 forward: "
                    f"max|dtokens|/max|tokens| {tok_rel:.4g} (bound {TOKEN_REL_BOUND}), "
                    f"max|dprobs| {prob_err:.4g} (bound {PROB_ABS_BOUND})")
        row_err = _check_probs(top5, probs, reg_config)
        print(f"register tokens: ViT-B/14 with {REGISTER_TOKENS} registers (T=261), {name}, "
              f"{BATCH}x{IMAGE_PX}px classify on {card}: max|row sum - 1| {row_err:.3g}, K1 "
              f"launches {want} in 2 forwards, every other kernel 0; {line}")
        del eng
    require(vanilla_route_warnings() == warnings, 'f32 classify: an "auto" route fell to plain')
    return found


def _raw_step(trainer, params, images, labels) -> tuple[float, list]:
    """Step 1's loss and raw gradients (leaf by leaf, on the CPU) of a
    trainer's loss on a batch, with no update."""
    from dinov2_tpu_torch.models.params import tree_leaves

    x, y = trainer.shard_batch(images, labels)
    leaves = tree_leaves(params)
    loss, _ = trainer.loss_fn(params, x, y)
    grads = torch.autograd.grad(loss, leaves)
    return float(loss.detach()), [g.detach().cpu() for g in grads]


def _against_cpu_step(what: str, got, want) -> str:
    """Step 1's loss within F32_LOSS_TOL of the CPU f32 step's; each leaf's
    raw gradient with at most F32_GRAD_OUTLIER_SHARE of its elements beyond
    F32_GRAD_ELEMENT_TOL of max(1, max|g|)."""
    (loss, grads), (loss32, grads32) = got, want
    loss_bound = F32_LOSS_TOL
    require(abs(loss - loss32) <= loss_bound,
            f"{what}: step-1 loss {loss} against {loss32} on the CPU")
    worst_share, worst = 0.0, 0.0
    for g, w in zip(grads, grads32):
        require(bool(torch.isfinite(g).all()), f"{what}: a gradient is not finite")
        delta = (g - w).abs()
        bound = F32_GRAD_ELEMENT_TOL * max(1.0, w.abs().max().item())
        worst_share = max(worst_share, (delta > bound).float().mean().item())
        worst = max(worst, delta.max().item())
    require(worst_share <= F32_GRAD_OUTLIER_SHARE,
            f"{what}: {worst_share:.3g} of a leaf's raw gradient beyond {F32_GRAD_ELEMENT_TOL}")
    return (f"step-1 loss {loss:.7f} against {loss32:.7f} on the CPU (bound {loss_bound:.3g}); "
            f"raw gradients: max|dg| {worst:.3g}, at most {worst_share:.3g} of a leaf beyond "
            f"{F32_GRAD_ELEMENT_TOL} (bound {F32_GRAD_OUTLIER_SHARE})")


def phase_f32_train(card: str, source) -> dict:
    """The trainer's defaults on the card: make_trainer(ViT-B/14) (f32
    compute over f32 masters, parity "hf", remat, "auto") takes TRAIN_STEPS
    steps on the training slice's 32 images (T=257: K1 f32 24 times a step,
    the recompute backward plain); the same with flash_attention=True (K4
    with lse 24, K6 12 a step); F32_FUSE_MLP_STEPS with fuse_mlp=True (K1
    f32 and K5 f32 24 each a step, K5's backward the plain recompute; the
    flash run's 3xTF32 K6 kernels named in a profiler window);
    then TRAIN_LONG_STEPS default steps on 8
    preprocessed 518 px images (T=1370: the flash route). Step 1's loss and
    raw gradients against the CPU f32 step on the same images (at T=1370 one
    image's loss). Returns the launches of each run and the default step's
    wall, device and idle ms."""
    from dinov2_tpu_torch.image.preprocess import classify_preprocess, feature_preprocess
    from dinov2_tpu_torch.models.vit import ModelOptions
    from dinov2_tpu_torch.ops.attention import vanilla_route_warnings
    from dinov2_tpu_torch.parallel.train import make_trainer

    warnings = vanilla_route_warnings()
    config = _vit_b14_config()
    layers = config.num_hidden_layers
    rng = np.random.default_rng(SEED)
    images = rng.integers(0, 256, (TRAIN_BATCH, IMAGE_PX, IMAGE_PX, 3), dtype=np.uint8)
    labels = rng.integers(0, config.num_classes, TRAIN_BATCH)
    # the cross-check takes the CPU's preprocessed images on both sides (see
    # _f32_against_cpu), through trainers with the step's own options
    n = TRAIN_CROSS_CHECK_IMAGES
    x_check = classify_preprocess(torch.from_numpy(images[:n]))
    start = time.perf_counter()
    cpu = make_trainer(config, preprocess_in_step=False, device="cpu")
    cpu_params, _ = cpu.place(source)
    want = _raw_step(cpu, cpu_params, x_check, labels[:n])
    del cpu_params
    print(f"f32 training reference: the default trainer's step-1 loss and raw gradients on "
          f"the CPU on {n} images in {time.perf_counter() - start:.1f} s")
    found = {}
    f32 = {"parity": "hf", "compute_dtype": torch.float32, "remat": True}
    runs = (
        ("make_trainer(config) defaults", None, {"K1": 2 * layers}, TRAIN_STEPS),
        ("flash_attention=True", ModelOptions(**f32, flash_attention=True),
         {"K4": 2 * layers, "K6": layers}, TRAIN_STEPS),
        ("fuse_mlp=True", ModelOptions(**f32, fuse_mlp=True),
         {"K1": 2 * layers, "K5": 2 * layers}, F32_FUSE_MLP_STEPS),
    )
    for name, opts, per_step, steps in runs:
        trainer = make_trainer(config, opts=opts)
        require(trainer.opts.compute_dtype == torch.float32 and trainer.opts.remat
                and trainer.opts.parity == "hf", "make_trainer's defaults")
        params, opt_state = trainer.place(source)
        checker = make_trainer(config, opts=opts, preprocess_in_step=False)
        line = _against_cpu_step(f"f32 training {name}",
                                 _raw_step(checker, params, x_check, labels[:n]), want)
        _zero_counts()
        params, opt_state, losses, seconds, _, peak = _timed_steps(
            trainer, params, opt_state, images, labels, steps)
        counts = _require_counts(f"f32 training {name}",
                                 {k: v * steps for k, v in per_step.items()})
        found[name] = counts
        require(all(np.isfinite(losses)) and all(b < a for a, b in zip(losses, losses[1:])),
                f"f32 training {name}: losses {losses} are not finite and falling")
        step_ms = 1e3 * statistics.median(seconds[1:])
        print(f"f32 training: ViT-B/14 {name}, {TRAIN_BATCH}x{IMAGE_PX}px uint8, f32 over f32 "
              f"masters, parity hf, remat on {card}: losses "
              f"{', '.join(f'{v:.5f}' for v in losses)} (falling); {line}; launches in "
              f"{steps} steps {counts}, every other kernel 0; median step "
              f"{step_ms:.2f} ms (steps 2-{steps}), peak memory {peak / 1e6:.0f} MB")
        state = [params, opt_state]

        def step():
            state[0], state[1], _ = trainer.step(state[0], state[1], images, labels)

        if name == "flash_attention=True":
            require_kernels_in_window(
                step, {"tf32x3_backward_dkv_kernel": "K6 f32's dK/dV",
                       "tf32x3_backward_dq_kernel": "K6 f32's dQ"},
                f"f32 training {name}", card)
        if opts is None:
            device_ms = device_ms_per_call(step, calls=3)
            found["default step ms"] = {"wall": step_ms, "device": device_ms,
                                        "idle": step_ms - device_ms}
            print(f"f32 training, where the time goes: the default step {step_ms:.2f} ms wall, "
                  f"{device_ms:.2f} ms of kernels on the card (torch.profiler, 3 steps), "
                  f"{step_ms - device_ms:.2f} ms idle ({card})")
        del trainer, params, opt_state, state

    rng = np.random.default_rng(SEED + 4)
    long_images = rng.integers(0, 256, (TRAIN_LONG_BATCH, FEATURE_PX, FEATURE_PX, 3),
                               dtype=np.uint8)
    long_labels = rng.integers(0, config.num_classes, TRAIN_LONG_BATCH)
    x = feature_preprocess(torch.from_numpy(long_images).cuda(), config.patch_size)
    trainer = make_trainer(config, preprocess_in_step=False)
    params, opt_state = trainer.place(source)
    with torch.no_grad():
        loss1 = float(trainer.loss_fn(params, x[:1], torch.from_numpy(long_labels[:1]).cuda())[0])
        cpu = make_trainer(config, preprocess_in_step=False, device="cpu")
        cpu_params, _ = cpu.place(source)
        loss32 = float(cpu.loss_fn(cpu_params, x[:1].cpu(), torch.from_numpy(long_labels[:1]))[0])
        del cpu_params
    loss_bound = F32_LOSS_TOL
    require(abs(loss1 - loss32) <= loss_bound,
            f"f32 training at T=1370: loss {loss1} against {loss32} on the CPU")
    _zero_counts()
    params, opt_state, losses, seconds, _, peak = _timed_steps(
        trainer, params, opt_state, x, long_labels, TRAIN_LONG_STEPS)
    counts = _require_counts("f32 training at T=1370", {"K4": 2 * layers * TRAIN_LONG_STEPS,
                                                        "K6": layers * TRAIN_LONG_STEPS})
    found["T=1370"] = counts
    require(all(np.isfinite(losses)) and losses[-1] < losses[0],
            f"f32 training at T=1370: losses {losses} are not finite and falling")
    print(f"f32 training at T=1370: make_trainer(config, preprocess_in_step=False), "
          f"{TRAIN_LONG_BATCH} preprocessed images of 518 px, \"auto\" -> flash on {card}: loss "
          f"of one image {loss1:.7f} against {loss32:.7f} on the CPU (bound {loss_bound:.3g}); "
          f"losses {', '.join(f'{v:.5f}' for v in losses)}; launches in {TRAIN_LONG_STEPS} steps "
          f"{counts}, "
          f"every other kernel 0; steps {', '.join(f'{1e3 * v:.1f}' for v in seconds)} ms, "
          f"peak memory {peak / 1e6:.0f} MB")
    require(vanilla_route_warnings() == warnings, 'f32 training: an "auto" route fell to plain')
    return found


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
    if sys.argv[1:2] == ["--rank"]:
        return mp_rank(sys.argv[2:])
    start = time.perf_counter()
    smi = phase_device()
    card = smi.replace(",", "")
    phase_image_decoders()
    timed_phase("build", phase_build)
    k1_measured = timed_phase("K1 check", phase_kernel_check, card)
    k1_measured.update(timed_phase("K1 launch by launch", phase_half_layer_split, card))
    k3_measured, k2_measured = timed_phase("K3 and K2 checks", phase_slab_attention_check, card)
    k5_measured = timed_phase("K5 check", phase_slab_mlp_check, card)
    k5_measured.update(timed_phase("K5 launch by launch", phase_mlp_split, card))
    k4_measured = timed_phase("K4 check", phase_flash_check, card)
    k6_measured, lse_measured = timed_phase(
        "K4 with lse and K6 checks", phase_flash_backward_check, card)
    k3_backward = timed_phase("autograd Function checks", phase_function_checks, card)
    k7_measured = timed_phase("K7 check", phase_quant_matmul_check, card)
    k8_measured = timed_phase("K8 check", phase_quant_layer_check, card)
    k8_measured.update(timed_phase("K8 launch by launch", phase_quant_layer_split, card))
    k9_measured = timed_phase("K9 check", phase_int8_check, card)
    f32_measured = timed_phase("f32 kernel checks", phase_f32_kernel_checks, card)
    f32_measured.update(timed_phase("K5 f32, K8 f32 and K7 f32 checks",
                                    phase_f32_mlp_quant_checks, card))
    timed_phase("output digests", phase_output_digests)
    with tempfile.TemporaryDirectory() as tmp:
        vit_b14 = timed_phase("ViT-B/14 GGUF", write_vit_b14, Path(tmp))
        k1_launches, dense_rate, k5_launches = timed_phase(
            "classify slices", phase_slice, card, vit_b14)
        k1_serve, k4_serve = timed_phase("serving slice", phase_serving, card, vit_b14, dense_rate)
        timed_phase("CLI slice", phase_cli, card, vit_b14)
        aot_launches = timed_phase("AOT slice", phase_aot, card, vit_b14)
        k7_launches, k8_launches = timed_phase(
            "quantized slice", phase_quant_slice, card, vit_b14, dense_rate)
        int8_engine, k9_launches, k9_found = timed_phase(
            "int8 slice", phase_int8_slice, card, vit_b14)
        k9_found.update(timed_phase(
            "int8 feature slice", phase_int8_features, card, int8_engine, vit_b14))
        timed_phase("int8 CLI slice", phase_int8_cli, card, vit_b14, int8_engine)
        del int8_engine
        f32_classify = timed_phase("f32 classify slice", phase_f32_classify, card, vit_b14)
    k4_launches, k4_f32_launches = timed_phase("feature slice", phase_features, card)
    k3_launches, k2_launches = timed_phase("ViT-g/14 slice", phase_giant, card)
    k9_found.update(timed_phase("ViT-g/14 int8 slice", phase_int8_giant, card))
    mesh_launches = timed_phase("mesh slice", phase_mesh, card)
    train_launches, source = timed_phase("training slice", phase_train, card)
    timed_phase("long-sequence training", phase_train_long, card, source)
    f32_train = timed_phase("f32 training slice", phase_f32_train, card, source)
    mesh_train = timed_phase("mesh training slice", phase_mesh_train, card, source)
    del source
    gc.collect()
    torch.cuda.empty_cache()  # the ranks share this card
    mp_train = timed_phase("multi-process slice", phase_multi_process, card)
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
            "mesh_launches": mesh_launches.get("K1", {}),
            "mesh_train_launches": mesh_train.get("K1", {}),
            "mp_train_launches": mp_train.get("K1", {}),
            "mp_pipeline_launches": mp_train["pipeline"].get("K1", {}),
            "serve_launches": k1_serve,
            "aot_launches": aot_launches["K1"],
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
            "mesh_launches": mesh_launches.get("K3", {}),
            "mesh_train_launches": mesh_train.get("K3", {}),
            "mp_train_launches": mp_train.get("K3", {}),
            "mesh_shard_checks": mesh_launches["shard checks"]["K3"],
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
            "mesh_launches": mesh_launches.get("K4", {}),
            "mesh_train_launches": mesh_train.get("K4", {}),
            "mp_train_launches": mp_train.get("K4", {}),
            "mp_pipeline_launches": mp_train["pipeline"].get("K4", {}),
            "mesh_shard_checks": {**mesh_launches["shard checks"]["K4"],
                                  **mesh_train["shard checks"]["K4"]},
            "serve_launches": k4_serve,
            "aot_launches": aot_launches["K4"],
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
            "mesh_train_launches": mesh_train.get("K6", {}),
            "mp_train_launches": mp_train.get("K6", {}),
            "mp_pipeline_launches": mp_train["pipeline"].get("K6", {}),
            "mesh_shard_checks": mesh_train["shard checks"]["K6"],
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
            "mesh_launches": mesh_launches.get("K7", {}),
            "mesh_shard_checks": mesh_launches["shard checks"]["K7"],
            "aot_launches": aot_launches["K7"],
            **k7_measured,
        },
        {
            "name": "slab_layer_block_quant",
            "route": "cuda",
            "source": "dinov2_tpu_torch/csrc/quant_layer.cu",
            "replaces": "dinov2_tpu/ops/fused_quant_attention.py:183",
            "launches": k8_launches,
            "mesh_launches": mesh_launches.get("K8", {}),
            "aot_launches": aot_launches["K8"],
            **k8_measured,
        },
        {
            "name": "int8_matmul_kernel",
            "route": "cuda",
            "source": "dinov2_tpu_torch/csrc/int8_matmul.cu",
            "also_source": "dinov2_tpu_torch/csrc/tma_pipeline.cuh",
            "replaces": "dinov2_tpu/ops/qmatmul.py:139",
            "replaces_what": "int8_matmul: an XLA s8 x s8 -> s32 dot_general with its epilogue "
                             "fused by XLA, no pallas_call",
            "launches": k9_launches["gemm"],
            "quantize_launches": k9_launches["quantize"],
            "library_call": "torch._int_mm (the s32 product alone)",
            **k9_measured,
            **k9_found,
        },
    ]
    # the f32 variants: their own C entries in the same sources, their own
    # counts (`.f32_launches`) from the f32 paths
    headers = "dinov2_tpu_torch/csrc/f32_gemm.cuh, dinov2_tpu_torch/csrc/f32_attention.cuh"
    defaults, flash = f32_train["make_trainer(config) defaults"], f32_train["flash_attention=True"]
    kernels += [
        {
            "name": "slab_layer_block_f32",
            "route": "cuda",
            "source": "dinov2_tpu_torch/csrc/slab_layer.cu",
            "also_source": headers,
            "replaces": f"{fused}:593",
            "launches": f32_classify["layer"]["K1"],
            "train_launches": defaults["K1"],
            "register_token_launches": f32_classify["registers f32"]["K1"],
            "library_call": "one f32 torch.nn.functional.linear per GEMM launch "
                            "(qkv_linear_ms, proj_linear_ms)",
            **f32_measured["K1"],
        },
        {
            "name": "slab_attention_block_f32",
            "route": "cuda",
            "source": "dinov2_tpu_torch/csrc/slab_attention.cu",
            "also_source": headers,
            "replaces": f"{fused}:478",
            "launches": f32_classify["proj"]["K2"],
            **f32_measured["K2"],
        },
        {
            "name": "slab_attention_f32",
            "route": "cuda",
            "source": "dinov2_tpu_torch/csrc/slab_attention.cu",
            "also_source": "dinov2_tpu_torch/csrc/f32_attention.cuh",
            "replaces": f"{fused}:331",
            "launches": f32_classify["core"]["K3"],
            **f32_measured["K3"],
        },
        {
            "name": "flash_attention_f32",
            "route": "cuda",
            "source": "dinov2_tpu_torch/csrc/flash_attention.cu",
            "also_source": "dinov2_tpu_torch/csrc/f32_attention.cuh",
            "replaces": "dinov2_tpu/ops/flash_attention.py:95",
            "also_replaces": "dinov2_tpu/ops/flash_attention.py:34",
            "launches": k4_f32_launches,
            **f32_measured["K4"],
            "lse_launches": flash["K4"],
            "lse_launches_t1370": f32_train["T=1370"]["K4"],
            **{f"lse_{key}": value for key, value in f32_measured["K4-lse"].items()},
        },
        {
            "name": "flash_backward_f32",
            "route": "cuda",
            "source": "dinov2_tpu_torch/csrc/flash_backward.cu",
            "also_source": "dinov2_tpu_torch/csrc/f32_backward.cuh, "
                           "dinov2_tpu_torch/csrc/tf32x3.cuh",
            "replaces": "dinov2_tpu/ops/flash_attention.py:468",
            "also_replaces": "dinov2_tpu/ops/flash_attention.py:499",
            "launches": flash["K6"],
            "launches_t1370": f32_train["T=1370"]["K6"],
            **f32_measured["K6"],
        },
    ]
    q4_classify, q4_fused = f32_classify[QUANT_SLICE_FORMAT], f32_classify[
        f"{QUANT_SLICE_FORMAT} fuse_mlp"]
    kernels += [
        {
            "name": "slab_mlp_block_f32",
            "route": "cuda",
            "source": "dinov2_tpu_torch/csrc/slab_mlp.cu",
            "also_source": "dinov2_tpu_torch/csrc/f32_gemm.cuh",
            "replaces": f"{fused}:811",
            "also_replaces": f"{fused}:859",
            "launches": f32_classify["fuse_mlp"]["K5"],
            "quant_launches": q4_fused["K5"],
            "train_launches": f32_train["fuse_mlp=True"]["K5"],
            "library_call": "one f32 torch.nn.functional.linear per GEMM launch "
                            "(fc1_linear_ms, fc2_linear_ms)",
            **f32_measured["K5"],
        },
        {
            "name": "slab_layer_block_quant_f32",
            "route": "cuda",
            "source": "dinov2_tpu_torch/csrc/quant_layer.cu",
            "also_source": "dinov2_tpu_torch/csrc/dequant_tile.cuh, "
                           "dinov2_tpu_torch/csrc/half_layer.cuh, " + headers,
            "replaces": "dinov2_tpu/ops/fused_quant_attention.py:183",
            "launches": q4_classify["K8"],
            "fuse_mlp_launches": q4_fused["K8"],
            "library_call": "one f32 torch.nn.functional.linear per GEMM launch on the decoded "
                            "weights (qkv_linear_ms, proj_linear_ms)",
            **f32_measured["K8"],
        },
        {
            "name": "quant_matmul_kernel_f32",
            "route": "cuda",
            "source": "dinov2_tpu_torch/csrc/quant_matmul.cu",
            "also_source": "dinov2_tpu_torch/csrc/dequant_tile.cuh, "
                           "dinov2_tpu_torch/csrc/tf32x3.cuh, "
                           "dinov2_tpu_torch/csrc/tma_pipeline.cuh",
            "replaces": "dinov2_tpu/ops/pallas_qmatmul.py:215",
            "also_replaces": "dinov2_tpu/ops/pallas_qmatmul.py:81, "
                             "dinov2_tpu/ops/pallas_qmatmul.py:104",
            "launches": q4_classify["K7"],
            "fuse_mlp_launches": q4_fused["K7"],
            "library_call": "one f32 torch.nn.functional.linear on the decoded weight, no "
                            "activation",
            **f32_measured["K7"],
        },
    ]
    print(f"f32 training, the default step: {f32_train['default step ms']} ({card})")
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
