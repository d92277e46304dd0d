"""Batched classification over a directory of images (port of
dinov2_tpu/cli/eval.py, `dinov2-eval`): threaded decode overlaps device
compute (runtime/loader.py), each batch runs as one forward, results stream
out as JSON lines (path, top-k labels and probs). With --labels (a JSON
{filename: class_index} map) it also reports top-1/top-5 accuracy.

    python -m dinov2_tpu_torch.cli.eval -m model.gguf --dir IMAGES \\
        [--batch 32] [--labels labels.json] [--output out.jsonl] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

from dinov2_tpu_torch.cli._common import add_common_args, engine_from_args


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    add_common_args(p)
    p.add_argument("--dir", required=True, help="directory of images (recursive)")
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--decode-threads", type=int, default=8)
    p.add_argument("--labels", default=None, help="JSON {filename: class_index}")
    p.add_argument("--output", default="-", help="JSONL output path (- = stdout)")
    args = p.parse_args(argv)

    from dinov2_tpu_torch.runtime.loader import BatchLoader, list_images

    engine = engine_from_args(args)

    paths = list_images(args.dir)
    if not paths:
        print(f"no images under {args.dir}", file=sys.stderr)
        return 1
    # cubic-float host resize = the reference's float/255 -> INTER_CUBIC
    # order; the engine's 256 -> 256 bicubic is then the identity, so batched
    # eval classifies the same pixels as single-image classify
    loader = BatchLoader(
        paths,
        batch_size=args.batch,
        size=(256, 256),
        num_threads=args.decode_threads,
        interpolation="cubic-float",
    )

    labels = None
    if args.labels:
        labels = {k: int(v) for k, v in json.loads(Path(args.labels).read_text()).items()}

    out = sys.stdout if args.output == "-" else open(args.output, "w")
    total = top1 = top5 = 0
    t0 = time.perf_counter()
    try:
        for batch_paths, images in loader:
            probs = engine.classify_probs(images)
            for path, row in zip(batch_paths, probs):
                # the ranking does not depend on -k: top-5 must not become
                # top-k when the user prints fewer than 5 classes
                ranked = row.argsort()[::-1]
                rec = {
                    "path": str(path),
                    "topk": [
                        [engine.id2label.get(int(i), str(int(i))), float(row[i])]
                        for i in ranked[: args.topk]
                    ],
                }
                if labels is not None and path.name in labels:
                    want = labels[path.name]
                    total += 1
                    top1 += int(ranked[0] == want)
                    top5 += int(want in ranked[:5])
                    rec["label"] = want
                out.write(json.dumps(rec) + "\n")
    finally:
        if out is not sys.stdout:
            out.close()
    dt = time.perf_counter() - t0
    print(
        f"{len(paths)} images in {dt:.2f}s = {len(paths) / dt:.1f} img/s",
        file=sys.stderr,
    )
    if total:
        print(
            f"top-1 {top1 / total:.4f}  top-5 {top5 / total:.4f}  (n={total})",
            file=sys.stderr,
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
