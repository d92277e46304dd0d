"""Bring-up check of the PyTorch/CUDA port (dinov2_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path once through the Python API a user calls:
DinoEngine.classify on 64 RGB images of 256x256 with a full-width ViT-B/14
(random f16 weights from a seed, 1000 classes), bf16, parity="reference".
On the way it builds every hand-written kernel of that path from the sources
in this checkout and holds each against its plain PyTorch version on the card.

Phases, one line each: device, build, kernel check, slice. Any failure exits
non-zero. The line before the last is a JSON object with one entry per
kernel; the last line is {"ok": true, "device": {...}}. With no CUDA device,
or run from a directory that holds only this file, it exits non-zero and
prints no result.
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
    from dinov2_tpu_torch.ops import _kernels

    start = time.perf_counter()
    lib = _kernels.build("slab_layer")
    _kernels.slab_layer_lib()
    print(f"build: {lib.relative_to(ROOT)} in {time.perf_counter() - start:.2f} s")


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


def phase_slice(card: str) -> int:
    """DinoEngine.classify on the card; returns K1 launches of that run."""
    from dinov2_tpu_torch.image.preprocess import classify_preprocess
    from dinov2_tpu_torch.io.synthetic import write_synthetic_gguf
    from dinov2_tpu_torch.models.config import PRESETS, DinoConfig
    from dinov2_tpu_torch.models.params import load_params
    from dinov2_tpu_torch.models.vit import ModelOptions, forward_features, forward_head
    from dinov2_tpu_torch.ops.fused_attention import slab_layer_block
    from dinov2_tpu_torch.runtime.engine import DinoEngine

    config = DinoConfig(**{**PRESETS["base"].__dict__, "num_classes": 1000, "img_size": 518})
    images = np.random.default_rng(SEED + 1).integers(
        0, 256, (BATCH, IMAGE_PX, IMAGE_PX, 3), dtype=np.uint8
    )
    with tempfile.TemporaryDirectory() as tmp:
        path = write_synthetic_gguf(Path(tmp) / "vit_b14.gguf", config, seed=SEED)
        engine = DinoEngine(path, dtype=torch.bfloat16, parity="reference", device="cuda")
        cpu_model = load_params(path, dtype=torch.float32, device="cpu")

    engine.warmup((IMAGE_PX, IMAGE_PX), batch=BATCH)
    slab_layer_block.launches = 0
    top5 = engine.classify(images, topk=5)
    probs = engine.classify_probs(images)
    seconds = []
    for _ in range(TIMED_CALLS):
        start = time.perf_counter()
        engine.classify_probs(images)
        seconds.append(time.perf_counter() - start)
    launches = slab_layer_block.launches
    forwards = 2 + TIMED_CALLS

    require(len(top5) == BATCH and all(len(r) == 5 for r in top5), "classify top-5 shape")
    require(probs.shape == (BATCH, config.num_classes), f"probs shape {probs.shape}")
    require(bool(np.isfinite(probs).all()), "probs are not finite")
    row_err = float(np.abs(probs.sum(axis=-1) - 1.0).max())
    require(row_err <= 1e-3, f"probs rows sum to 1 within {row_err}")
    require(
        launches == config.num_hidden_layers * forwards,
        f"K1 launched {launches} times in {forwards} forwards",
    )
    print(
        f"slice: ViT-B/14 classify {BATCH}x{IMAGE_PX}px bf16 on {card}: probs finite, "
        f"max|row sum - 1| {row_err:.3g}, K1 launches {launches} = "
        f"{config.num_hidden_layers} x {forwards} forwards; "
        f"{BATCH * TIMED_CALLS / sum(seconds):.1f} img/s over {TIMED_CALLS} timed "
        f"classify_probs calls (median {1e3 * statistics.median(seconds):.2f} ms/call)"
    )

    # the same images through the port's plain f32 forward on the CPU
    sub = images[:CROSS_CHECK_IMAGES]
    with torch.inference_mode():
        pre = classify_preprocess(torch.from_numpy(sub).cuda())
        tok = forward_features(engine.model.params, pre, config, engine.opts)
        prob = forward_head(engine.model.params, tok, config, engine.opts)
        opts32 = ModelOptions(parity="reference", compute_dtype=torch.float32)
        pre32 = classify_preprocess(torch.from_numpy(sub))
        tok32 = forward_features(cpu_model.params, pre32, config, opts32)
        prob32 = forward_head(cpu_model.params, tok32, config, opts32)
    tok_rel = ((tok.cpu() - tok32).abs().max() / tok32.abs().max()).item()
    prob_err = (prob.cpu() - prob32).abs().max().item()
    print(
        f"cross-check: {CROSS_CHECK_IMAGES} images, GPU bf16 vs CPU f32 plain: "
        f"max|dtokens|/max|tokens| {tok_rel:.4g} (bound {TOKEN_REL_BOUND}), "
        f"max|dprobs| {prob_err:.4g} (bound {PROB_ABS_BOUND})"
    )
    require(tok_rel <= TOKEN_REL_BOUND, "tokens differ from the CPU f32 forward")
    require(prob_err <= PROB_ABS_BOUND, "probs differ from the CPU f32 forward")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    smi = phase_device()
    card = smi.replace(",", "")
    phase_build()
    measured = phase_kernel_check(card)
    launches = phase_slice(card)
    kernels = [{
        "name": "slab_layer_block",
        "route": "cuda",
        "source": "dinov2_tpu_torch/csrc/slab_layer.cu",
        "replaces": "dinov2_tpu/ops/fused_attention.py:593",
        "launches": launches,
        **measured,
    }]
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
