"""Where the time goes in the port's classify path on one CUDA GPU.

    python3 -m dinov2_tpu_torch.utils.profile_slice

Builds a random-weight ViT-B/14 at its published widths (PRESETS["base"],
1000 classes, img_size 518, f16 weights from seed 0), loads it with
DinoEngine(device="cuda", bf16, parity="reference") and runs
classify_probs on 64 random 256x256 uint8 images, as chip_smoke.py does:
two warm-up calls, 10 calls on the host clock without the profiler, then 3
calls under torch.profiler. Prints the card, the median wall ms per call, the
device time per call (the sum of every kernel's and copy's own device time,
one stream, so nothing overlaps), the idle share 1 - device/wall, and every
device op with its launches, ms per call and ms per launch. The profiler's
full table and a Chrome trace go into chiprun_out/profile_slice/.
"""

from __future__ import annotations

import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

SEED = 0
BATCH = 64
IMAGE_PX = 256
TIMED_CALLS = 10
PROFILED_CALLS = 3
OUT = Path("chiprun_out/profile_slice")


def _engine(seed: int):
    from dinov2_tpu_torch.io.synthetic import write_synthetic_gguf
    from dinov2_tpu_torch.models.config import PRESETS, DinoConfig
    from dinov2_tpu_torch.runtime.engine import DinoEngine

    config = DinoConfig(**{**PRESETS["base"].__dict__, "num_classes": 1000, "img_size": 518})
    with tempfile.TemporaryDirectory() as tmp:
        path = write_synthetic_gguf(Path(tmp) / "vit_b14.gguf", config, seed=seed)
        return DinoEngine(path, dtype=torch.bfloat16, parity="reference", device="cuda")


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_slice: no CUDA device available", file=sys.stderr)
        return 1

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"{card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    engine = _engine(SEED)
    images = np.random.default_rng(SEED + 1).integers(
        0, 256, (BATCH, IMAGE_PX, IMAGE_PX, 3), dtype=np.uint8
    )
    for _ in range(2):
        engine.classify_probs(images)
    seconds = []
    for _ in range(TIMED_CALLS):
        start = time.perf_counter()
        engine.classify_probs(images)
        seconds.append(time.perf_counter() - start)
    wall_ms = 1e3 * statistics.median(seconds)

    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        for _ in range(PROFILED_CALLS):
            engine.classify_probs(images)
        torch.cuda.synchronize()

    averages = prof.key_averages()
    device = [e for e in averages if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in device) / 1e3 / PROFILED_CALLS
    if device_ms == 0:
        print("profile_slice: the profiler recorded no device time", file=sys.stderr)
        return 1
    print(
        f"ViT-B/14 classify_probs, {BATCH} images of {IMAGE_PX} px, bf16 ({card}): "
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

    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "key_averages.txt").write_text(
        averages.table(sort_by="self_device_time_total", row_limit=-1, max_name_column_width=120)
    )
    prof.export_chrome_trace(str(OUT / "trace.json"))
    print(f"profile_slice: table and trace in {OUT}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
