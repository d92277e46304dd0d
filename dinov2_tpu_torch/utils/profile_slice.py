"""Where the time goes in the port's classify, feature or training path on
one CUDA GPU.

    python3 -m dinov2_tpu_torch.utils.profile_slice [--mode classify|features|train]
        [--quant q4_0|q4_1|q5_0|q5_1|q8_0|int8] [--model giant]
        [--slab-fusion layer|proj|core] [--fuse-mlp]
        [--flash-attn] [--no-remat] [--long]

classify (the default): a random-weight ViT-B/14 at its published widths
(PRESETS["base"], 1000 classes, img_size 518, f16 weights from seed 0) in
DinoEngine(device="cuda", bf16, parity="reference"), `classify_probs` on 64
random 256x256 uint8 images, as chip_smoke.py runs it.
features: a random-weight ViT-L/14 (PRESETS["large"]) in the same engine,
`extract_features` on 8 random 512x512 images (518 px in, T=1370, the K4
route), as chip_smoke.py runs it.
--quant FMT: the same checkpoint quantized with quantize_gguf and loaded
with quant_mode="fused" (K8 for the attention half-layer, K7 for the other
linears), as chip_smoke.py's quantized slice runs it. --quant int8: the
f16 checkpoint itself in quant_mode="int8" (W8A8: K1 on the dequantized
qkv/proj on the slab route, K9 for the other linears; every linear on the
flash route), as chip_smoke.py's int8 slice runs it.
--model giant (classify): a random-weight ViT-g/14 (PRESETS["giant"], 40
layers, SwiGLU, 1000 classes) on 16 images, as chip_smoke.py's ViT-g slice
runs it. --slab-fusion picks the level of the slab route (K1 | K2 | K3) and
--fuse-mlp runs the MLP half-layer as the K5 kernel (models/vit.py).
train: `Trainer.step` (parallel/train.py) on one batch of 32 random 256x256
uint8 images with a ViT-B/14 from init_params seed 0 (1000 classes),
parity="hf", bf16 compute over f32 masters, remat, AdamW, as chip_smoke.py's
training slice runs it: on the "auto" route (K1 forward, recompute backward)
or with --flash-attn (the K4 with_lse forward and K6); --no-remat turns
remat off; --long takes 8 preprocessed images of 518 px (T=1370).

Each mode makes two warm-up calls, 10 calls on the host clock without the
profiler, then 3 calls under torch.profiler. It prints the card, the median
wall ms per call, the device time per call (the sum of every kernel's and
copy's own device time, one stream, so nothing overlaps), the idle share
1 - device/wall, and every device op with its launches, ms per call and ms
per launch. The profiler's full table and a Chrome trace go into
OUT/<mode>[_<model>][_<quant>][_<slab fusion>][_fuse_mlp][_flash][_no_remat][_long]/
under the working directory (.gitignore lists OUT).
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from dinov2_tpu_torch.quant import QUANT_TYPE_NAMES

SEED = 0
TIMED_CALLS = 10
PROFILED_CALLS = 3
OUT = Path("chiprun_out/profile_slice")
# mode -> (preset, classifier overrides, batch, image px, engine call, label)
MODES = {
    "classify": ("base", {"num_classes": 1000, "img_size": 518}, 64, 256,
                 "classify_probs", "ViT-B/14 classify_probs"),
    "features": ("large", {}, 8, 512, "extract_features", "ViT-L/14 extract_features"),
    "train": ("base", {"num_classes": 1000, "img_size": 518}, 32, 256, None,
              "ViT-B/14 Trainer.step"),
}
TRAIN_LONG_BATCH = 8  # --long: 512 px images preprocessed to 518 px, T=1370
GIANT_BATCH = 16  # the ViT-g/14 classify slice's batch


def _engine(preset: str, overrides: dict, seed: int, quant: str | None, **options):
    from dinov2_tpu_torch.io.synthetic import write_synthetic_gguf
    from dinov2_tpu_torch.models.config import PRESETS, DinoConfig
    from dinov2_tpu_torch.quant import quantize_gguf
    from dinov2_tpu_torch.runtime.engine import DinoEngine

    config = DinoConfig(**{**PRESETS[preset].__dict__, **overrides})
    with tempfile.TemporaryDirectory() as tmp:
        path = write_synthetic_gguf(Path(tmp) / f"{preset}.gguf", config, seed=seed)
        if quant and quant != "int8":
            path = quantize_gguf(path, Path(tmp) / f"{preset}.{quant}.gguf", quant)
        mode = "int8" if quant == "int8" else "fused" if quant else "dequant"
        return DinoEngine(path, dtype=torch.bfloat16, parity="reference", device="cuda",
                          quant_mode=mode, **options)


def _train_step(overrides: dict, seed: int, batch: int, px: int, flash: bool, remat: bool,
                long: bool):
    """A closure that takes one Trainer.step on a fixed batch and waits for
    it, the state carried from call to call."""
    from dinov2_tpu_torch.image.preprocess import feature_preprocess
    from dinov2_tpu_torch.models.config import PRESETS, DinoConfig
    from dinov2_tpu_torch.models.params import init_params
    from dinov2_tpu_torch.models.vit import ModelOptions
    from dinov2_tpu_torch.parallel.train import make_trainer

    config = DinoConfig(**{**PRESETS["base"].__dict__, **overrides})
    trainer = make_trainer(
        config, preprocess_in_step=not long,
        opts=ModelOptions(parity="hf", compute_dtype=torch.bfloat16, remat=remat,
                          flash_attention=True if flash else "auto"),
    )
    state = list(trainer.place(init_params(config, seed=seed, dtype=torch.float32)))
    rng = np.random.default_rng(seed + 1)
    images = rng.integers(0, 256, (batch, px, px, 3), dtype=np.uint8)
    labels = rng.integers(0, config.num_classes, batch)
    if long:
        images = feature_preprocess(torch.from_numpy(images).cuda(), config.patch_size)

    def step(_):
        state[0], state[1], metrics = trainer.step(*state, images, labels)
        return float(metrics["loss"])  # waits for the device

    return step


def main(argv=()) -> int:
    if not torch.cuda.is_available():
        print("profile_slice: no CUDA device available", file=sys.stderr)
        return 1
    parser = argparse.ArgumentParser(prog="profile_slice")
    parser.add_argument("--mode", choices=sorted(MODES), default="classify")
    parser.add_argument("--quant", choices=[*sorted(QUANT_TYPE_NAMES), "int8"], default=None)
    parser.add_argument("--model", choices=["giant"], default=None)
    parser.add_argument("--slab-fusion", choices=["layer", "proj", "core"], default=None)
    parser.add_argument("--fuse-mlp", action="store_true")
    parser.add_argument("--flash-attn", action="store_true", help="train: the flash route")
    parser.add_argument("--no-remat", action="store_true", help="train: remat off")
    parser.add_argument("--long", action="store_true", help="train: T=1370 at batch 8")
    args = parser.parse_args(list(argv))
    mode, quant = args.mode, args.quant
    preset, overrides, batch, px, call, label = MODES[mode]
    tags = [mode]
    options = {}
    if args.model == "giant":
        if mode != "classify":
            parser.error("--model giant goes with --mode classify")
        preset, batch, label = "giant", GIANT_BATCH, "ViT-g/14 classify_probs"
        tags.append("giant")
    if quant:
        label = f"{label}, {'W8A8 int8' if quant == 'int8' else quant + ' fused'}"
        tags.append(quant)
    if args.slab_fusion:
        options["slab_fusion"] = args.slab_fusion
        label = f'{label}, slab_fusion="{args.slab_fusion}"'
        tags.append(args.slab_fusion)
    if args.fuse_mlp:
        options["fuse_mlp"] = True
        label = f"{label}, fuse_mlp"
        tags.append("fuse_mlp")
    if mode == "train":
        if quant or args.model or options:
            parser.error("--mode train takes only --flash-attn, --no-remat and --long")
        if args.long:
            batch, px = TRAIN_LONG_BATCH, 512
        for flag, tag in ((args.flash_attn, "flash"), (args.no_remat, "no_remat"),
                          (args.long, "long")):
            if flag:
                tags.append(tag)
        label = (f"{label}, {'flash_attention=True' if args.flash_attn else 'auto route'}, "
                 f"remat {'off' if args.no_remat else 'on'}" + (", T=1370" if args.long else ""))
    elif args.flash_attn or args.no_remat or args.long:
        parser.error("--flash-attn, --no-remat and --long go with --mode train")

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"{card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    images = np.random.default_rng(SEED + 1).integers(0, 256, (batch, px, px, 3), dtype=np.uint8)
    if mode == "train":
        run = _train_step(overrides, SEED, batch, px, args.flash_attn, not args.no_remat, args.long)
    else:
        run = getattr(_engine(preset, overrides, SEED, quant, **options), call)
    for _ in range(2):
        run(images)
    seconds = []
    for _ in range(TIMED_CALLS):
        start = time.perf_counter()
        run(images)
        seconds.append(time.perf_counter() - start)
    wall_ms = 1e3 * statistics.median(seconds)

    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        for _ in range(PROFILED_CALLS):
            run(images)
        torch.cuda.synchronize()

    averages = prof.key_averages()
    device = [e for e in averages if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in device) / 1e3 / PROFILED_CALLS
    if device_ms == 0:
        print("profile_slice: the profiler recorded no device time", file=sys.stderr)
        return 1
    print(
        f"{label}, {batch} images of {px} px, bf16 ({card}): "
        f"wall {wall_ms:.3f} ms per call (median of {TIMED_CALLS}, no profiler); "
        f"device {device_ms:.3f} ms per call (mean of {PROFILED_CALLS} profiled); "
        f"idle {1 - device_ms / wall_ms:.1%}"
    )
    print("| device op | launches/call | ms/call | ms/launch | share |")
    print("|---|---:|---:|---:|---:|")
    for e in sorted(device, key=lambda e: -e.self_device_time_total):
        ms = e.self_device_time_total / 1e3 / PROFILED_CALLS
        print(
            f"| `{e.key[:90]}` | {e.count / PROFILED_CALLS:g} | {ms:.4f} | "
            f"{ms * PROFILED_CALLS / e.count:.4f} | {ms / device_ms:.1%} |"
        )
    print("| aten op (device time incl. children) | calls/call | ms/call |")
    print("|---|---:|---:|")
    host = [e for e in averages if e.key.startswith("aten::") and e.device_time_total > 0]
    for e in sorted(host, key=lambda e: -e.device_time_total)[:15]:
        print(f"| `{e.key}` | {e.count / PROFILED_CALLS:g} | {e.device_time_total / 1e3 / PROFILED_CALLS:.4f} |")

    out = OUT / "_".join(tags)
    out.mkdir(parents=True, exist_ok=True)
    (out / "key_averages.txt").write_text(
        averages.table(sort_by="self_device_time_total", row_limit=-1, max_name_column_width=120)
    )
    prof.export_chrome_trace(str(out / "trace.json"))
    print(f"profile_slice: table and trace in {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
