"""Throughput/latency sweep with markdown output (port of
dinov2_tpu/cli/benchmark.py, `dinov2-benchmark`; the reference's
scripts/benchmark.py and benchmark.sh): weights come from synthetic GGUFs
when no checkpoint is given (op speed does not depend on weight values), and
batch is a swept axis.

Each batch size: one warmup repeat, then two timed repeats of `--iters`
forwards on a fresh input, each repeat bracketed by CUDA events (the host
clock on the CPU); the best repeat counts. Memory columns: the bytes of the
loaded parameter tensors, and the device's peak allocation over the warmup
repeat (`torch.cuda.max_memory_allocated`, weights included) and that peak
above what was allocated before it; None on the CPU.

    python -m dinov2_tpu_torch.cli.benchmark [-m model.gguf | --size base] \\
        [--batch-sizes 1,8,32,64] [--iters 10] [--quant q4_0,...] [--json] \\
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch


def _param_bytes(tree) -> int:
    """Bytes of the loaded parameter tensors (a QuantLinear's packed fields
    and an Int8Linear's codes and scales included)."""
    from dinov2_tpu_torch.models.params import tree_leaves

    total = 0
    for leaf in tree_leaves(tree):
        parts = leaf.tensors().values() if hasattr(leaf, "tensors") else [leaf]
        total += sum(t.numel() * t.element_size() for t in parts)
    return total


def _timed_ms(fn, device: torch.device) -> float:
    """Milliseconds of fn(): CUDA events on a card, the host clock on the CPU."""
    if device.type != "cuda":
        start = time.perf_counter()
        fn()
        return (time.perf_counter() - start) * 1e3
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def _bench_model(model_path, batch_sizes, iters, dtype_name, flash, quant_mode, device,
                 px=224):
    from dinov2_tpu_torch.models.params import load_params
    from dinov2_tpu_torch.models.vit import DinoViT, ModelOptions

    dtype = {"bf16": torch.bfloat16, "f32": torch.float32}[dtype_name]
    loaded = load_params(model_path, dtype=dtype, device=device, quant_mode=quant_mode)
    opts = ModelOptions(parity="reference", compute_dtype=dtype, flash_attention=flash)
    model = DinoViT(loaded.params, loaded.config, opts)
    classify = loaded.has_classifier
    weights_mb = _param_bytes(loaded.params) / 2**20
    on_card = device.type == "cuda"

    rows = []
    for batch in batch_sizes:
        x = torch.from_numpy(
            np.random.default_rng(0).standard_normal((batch, px, px, 3)).astype(np.float32)
        ).to(device)

        @torch.inference_mode()
        def loop(x):
            for _ in range(iters):
                out = model(x, classify=classify)
            probe = out["probs"] if classify else out["cls_token"]
            return float(probe.float().sum())  # waits for the last forward

        if on_card:
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
            before = torch.cuda.memory_allocated(device)
        loop(x)  # warmup: kernel builds, the caching allocator
        if on_card:
            peak = torch.cuda.max_memory_allocated(device)
            peak_mb, temp_mb = peak / 2**20, (peak - before) / 2**20
        else:  # no device memory statistics on the CPU
            peak_mb = temp_mb = None

        best = float("inf")
        for r in range(2):
            xf = x * (1.0 + 1e-6 * (r + 1))  # a fresh input each repeat
            best = min(best, _timed_ms(lambda: loop(xf), device))
        ms_per_batch = best / iters
        rows.append(
            {
                "batch": batch,
                "ms_per_batch": round(ms_per_batch, 3),
                "ms_per_image": round(ms_per_batch / batch, 3),
                "images_per_sec": round(batch * iters / (best / 1e3), 1),
                "hbm_weights_mb": round(weights_mb, 1),
                "hbm_peak_mb": None if peak_mb is None else round(peak_mb, 1),
                "hbm_temp_mb": None if temp_mb is None else round(temp_mb, 1),
            }
        )
    return loaded.config, rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("-m", "--model", default=None, help="GGUF checkpoint to benchmark")
    p.add_argument("--size", default="base", choices=["small", "base", "large", "giant"],
                   help="synthetic model size when no checkpoint is given")
    p.add_argument("--batch-sizes", default="1,8,32,64")
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--dtype", default="bf16", choices=["bf16", "f32"])
    p.add_argument("--quant", default=None,
                   help="also quantize+benchmark: comma list of q4_0,q4_1,q5_0,q5_1,q8_0")
    p.add_argument("--quant-mode", default="dequant",
                   choices=["dequant", "fused", "int8"],
                   help="'int8' = W8A8 (per-row int8 weights, int8 GEMMs) for "
                        "any checkpoint, the synthetic one included")
    p.add_argument("-fa", "--flash-attn", action="store_true")
    p.add_argument("--registers", type=int, default=0,
                   help="synthetic checkpoints: number of register tokens "
                        "(the reference benches reg and no-reg variants)")
    p.add_argument("--px", type=int, default=224,
                   help="input resolution fed to the forward (224 classify, "
                        "518 feature mode)")
    p.add_argument("--features", action="store_true",
                   help="synthetic checkpoints: no classifier head; bench the "
                        "backbone feature tap instead of classify")
    p.add_argument("--json", action="store_true", help="emit JSON instead of markdown")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on: 'cuda' (default) or 'cpu'")
    args = p.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("benchmark: no CUDA device is available "
                         "(use --device cpu for the plain PyTorch path)")
    batch_sizes = [int(b) for b in args.batch_sizes.split(",")]
    tmpdir = Path(tempfile.mkdtemp(prefix="dinov2-bench-"))
    try:
        return _run(args, batch_sizes, device, tmpdir)
    finally:
        # synthetic and quantized checkpoints can be GBs (giant); repeated
        # sweeps must not fill the temporary directory
        shutil.rmtree(tmpdir, ignore_errors=True)


def _run(args, batch_sizes, device, tmpdir: Path) -> int:
    if args.model:
        model_path = Path(args.model)
    else:
        from dinov2_tpu_torch.io.synthetic import write_synthetic_gguf
        from dinov2_tpu_torch.models.config import PRESETS, DinoConfig

        cfg = PRESETS[args.size]
        cfg = DinoConfig(**{
            **cfg.__dict__,
            "num_classes": 0 if args.features else 1000,
            "num_register_tokens": args.registers,
        })
        model_path = tmpdir / f"{args.size}.gguf"
        print(f"writing synthetic {args.size} checkpoint...", file=sys.stderr)
        write_synthetic_gguf(model_path, cfg)

    if args.model:
        # honor --quant-mode for a user-supplied checkpoint (it may already be
        # quantized; load_params decodes fp16/fp32 files whatever the mode)
        # and label the row by the file's ftype
        from dinov2_tpu_torch.io.gguf import GGMLType, GGUFReader

        with GGUFReader(model_path) as r:
            # % 1000 strips the old-convention quant-version factor, as
            # DinoConfig.from_gguf_kv does
            base_label = GGMLType(
                int(r.kv.get("ftype", GGMLType.F16)) % 1000
            ).name.lower()
        variants = [(base_label, model_path, args.quant_mode)]
    elif args.quant_mode == "int8":
        # int8 is a runtime mode for any ftype, the synthetic f16 file included
        variants = [("f16-int8", model_path, "int8")]
    else:
        variants = [("f16", model_path, "dequant")]
    if args.quant:
        from dinov2_tpu_torch.quant import quantize_gguf

        for q in args.quant.split(","):
            qpath = tmpdir / f"{model_path.stem}-{q}.gguf"
            print(f"quantizing {q}...", file=sys.stderr)
            quantize_gguf(model_path, qpath, q.strip())
            variants.append((q, qpath, args.quant_mode))

    results = {}
    for name, path, qmode in variants:
        print(f"benchmarking {name}...", file=sys.stderr)
        _, rows = _bench_model(
            path, batch_sizes, args.iters, args.dtype,
            True if args.flash_attn else "auto", qmode, device, px=args.px
        )
        results[name] = rows

    if args.json:
        print(json.dumps(results, indent=2))
    else:
        for name, rows in results.items():
            print(f"\n### {name}\n")
            print(
                "| batch | ms/batch | ms/image | images/sec "
                "| weights MB | peak device MB | temps MB |"
            )
            print(
                "|------:|---------:|---------:|-----------:"
                "|-----------:|---------------:|---------:|"
            )
            for r in rows:
                fmt = lambda v: "-" if v is None else v  # noqa: E731
                print(
                    f"| {r['batch']} | {r['ms_per_batch']} | "
                    f"{r['ms_per_image']} | {r['images_per_sec']} | "
                    f"{fmt(r['hbm_weights_mb'])} | {fmt(r['hbm_peak_mb'])} | "
                    f"{fmt(r['hbm_temp_mb'])} |"
                )
    return 0


if __name__ == "__main__":
    sys.exit(main())
