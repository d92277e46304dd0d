"""Bring-up check of the PyTorch/CUDA port (dinov2_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's two user paths once each through the Python API a user
calls, with random f16 weights from a seed, bf16, parity="reference":
  - classify: DinoEngine.classify on 64 RGB images of 256x256 with a
    full-width ViT-B/14 (1000 classes); the attention half-layer is K1;
  - features and PCA: DinoEngine.extract_features and pca_visualizations on
    8 RGB images of 512x512 (518 px in, a 37x37 grid, T=1370) with a
    full-width ViT-L/14; its attention core is K4.
On the way it builds every hand-written kernel of those paths from the
sources in this checkout (one nvcc per source, all at once) and holds each
against its plain PyTorch version on the card. Each path runs with the
launch counts set to 0 just before it and read just after.

Phases, one line each: device, build, kernel checks, classify slice and its
cross-check, feature slice, PCA, feature cross-check. Any failure exits
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
KERNELS = ("slab_layer", "flash_attention")


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
    """Both kernel libraries, one nvcc each, started together."""
    from dinov2_tpu_torch.ops import _kernels

    start = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        libs = list(pool.map(_kernels.build, KERNELS))
    _kernels.slab_layer_lib()
    _kernels.flash_attention_lib()
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


def phase_slice(card: str) -> int:
    """DinoEngine.classify on the card; returns K1 launches of that run (K4
    must launch no time: T=257 takes the slab route)."""
    from dinov2_tpu_torch.image.preprocess import classify_preprocess
    from dinov2_tpu_torch.io.synthetic import write_synthetic_gguf
    from dinov2_tpu_torch.models.config import PRESETS, DinoConfig
    from dinov2_tpu_torch.models.params import load_params
    from dinov2_tpu_torch.models.vit import ModelOptions, forward_features, forward_head
    from dinov2_tpu_torch.ops.flash_attention import flash_attention
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
    slab_layer_block.launches = flash_attention.launches = 0
    top5 = engine.classify(images, topk=5)
    probs = engine.classify_probs(images)
    seconds = []
    for _ in range(TIMED_CALLS):
        start = time.perf_counter()
        engine.classify_probs(images)
        seconds.append(time.perf_counter() - start)
    launches, k4_launches = slab_layer_block.launches, flash_attention.launches
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
    require(k4_launches == 0, f"K4 launched {k4_launches} times in the classify path")
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
    k1_launches = phase_slice(card)
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
