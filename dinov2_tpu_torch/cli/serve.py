"""Batching HTTP inference server (port of dinov2_tpu/cli/serve.py,
`dinov2-serve`): coalesces concurrent requests into batched forwards on the
card (runtime/server.py).

    python -m dinov2_tpu_torch.cli.serve -m model.gguf [--port 8000] \\
        [--max-batch 32] [--warmup 1] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import sys

from dinov2_tpu_torch.cli._common import add_common_args, engine_from_args


def _warmup_buckets(spec: str, max_batch: int) -> list[int]:
    """Parse --warmup into the sorted batch buckets to run at boot."""
    if spec == "0":
        return []
    if spec == "full":
        out, b = [], 1
        while b < max_batch:
            out.append(b)
            b *= 2
        out.append(b)  # the bucket that covers max_batch itself
        return out
    try:
        vals = sorted({int(v) for v in spec.split(",") if v.strip()})
    except ValueError:
        raise SystemExit(f"--warmup {spec!r}: expected '0', 'full', or a comma list of ints")
    if any(v < 1 for v in vals):
        raise SystemExit(f"--warmup {spec!r}: buckets must be >= 1")
    # the batcher never builds a batch beyond max_batch, so the largest
    # reachable bucket is the one covering max_batch: warming past it would
    # spend boot time on shapes no request takes
    cap, usable = 1, []
    while cap < max_batch:
        cap *= 2
    for v in vals:
        if v > cap:
            print(f"warmup: dropping bucket {v} (> max reachable bucket {cap} "
                  f"for --max-batch {max_batch})", file=sys.stderr)
        else:
            usable.append(v)
    return usable


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    add_common_args(p)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--max-batch", type=int, default=32)
    p.add_argument("--max-wait-ms", type=float, default=5.0)
    p.add_argument("--max-body-mb", type=float, default=32.0,
                   help="reject request bodies larger than this (413)")
    p.add_argument("--max-side", type=int, default=4096,
                   help="reject images with a side longer than this (400); "
                   "the device's time and memory grow with the image's tokens")
    p.add_argument("--warmup", default="1", metavar="SPEC",
                   help="batch buckets to run at boot: a comma list (e.g. "
                   "1,8,32), 'full' = every power-of-2 bucket up to "
                   "--max-batch, or '0' = none. Unless '0', every kernel "
                   "library is built first (nvcc at first use otherwise) and "
                   "each bucket's classify forward fills the caching "
                   "allocator, so no request waits on either")
    args = p.parse_args(argv)
    buckets = _warmup_buckets(args.warmup, args.max_batch)

    from dinov2_tpu_torch.runtime.server import BatchingServer

    engine = engine_from_args(args)
    if buckets and engine.device.type == "cuda":
        from dinov2_tpu_torch.ops import _kernels

        _kernels.build_all()
    if engine.loaded.has_classifier:
        for b in buckets:
            engine.warmup((256, 256), batch=b, classify=True)

    server = BatchingServer(
        engine,
        host=args.host,
        port=args.port,
        max_batch=args.max_batch,
        max_wait_ms=args.max_wait_ms,
        topk=args.topk,
        max_body_mb=args.max_body_mb,
        max_side=args.max_side,
    )
    print(f"serving on http://{args.host}:{server.port}", file=sys.stderr)
    server.serve_forever()
    return 0


if __name__ == "__main__":
    sys.exit(main())
