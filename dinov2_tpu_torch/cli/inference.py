"""One-shot classify / feature extraction with PCA (port of
dinov2_tpu/cli/inference.py, `dinov2-inference`; the reference's
inference.cpp): classify prints the top-k " > label : prob" lines, feature
mode writes the PCA visualization image, and the compute bracket is reported
as "graph computation took X ms" on stderr (the reference's benchmark.sh
scrapes that line).

    python -m dinov2_tpu_torch.cli.inference -m model.gguf -i img.jpg [-c] \\
        [-o pca.png] [--profile DIR] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import contextlib
import sys
from pathlib import Path

import numpy as np

from dinov2_tpu_torch.cli._common import (
    add_common_args,
    engine_from_args,
    load_image_rgb,
    save_image_rgb,
)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    add_common_args(parser)
    parser.add_argument("--batch", type=int, default=1,
                        help="replicate the input to this batch size (throughput mode)")
    parser.add_argument("--profile", default=None, metavar="DIR",
                        help="write a torch.profiler Chrome trace of the timed run "
                        "into DIR/trace.json")
    args = parser.parse_args(argv)

    img = load_image_rgb(args.inp)
    engine = engine_from_args(args)
    batch = np.repeat(img[None], args.batch, axis=0)

    profiler = None
    profile_ctx = contextlib.nullcontext()
    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if engine.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        profile_ctx = profiler = profile(activities=activities)

    if args.classify:
        engine.classify_probs(batch)  # warmup: kernel builds, allocator
        with profile_ctx:
            results = engine.classify(batch, topk=args.topk)
        print(file=sys.stderr)
        for label, prob in results[0]:
            print(f" > {label} : {prob:.2f}")
    else:
        engine.pca_visualization(img)  # warmup
        with profile_ctx:
            vis = engine.pca_visualization(img)
        save_image_rgb(args.out, vis)
        print(f"wrote PCA visualization to {args.out}", file=sys.stderr)

    if profiler is not None:
        Path(args.profile).mkdir(parents=True, exist_ok=True)
        profiler.export_chrome_trace(str(Path(args.profile) / "trace.json"))
    print(
        f"graph computation took {engine.last_compute_ms:.2f} ms", file=sys.stderr
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
