"""Shared CLI plumbing (the port's own copy of dinov2_tpu/cli/_common.py's
argument helpers): flag names mirror the reference's dino_params_parse, with
the `-o` bug fixed (quirk Q7: upstream `-o` overwrote the input path; here
it sets the output path as documented). `--device` is the port's own flag:
the CLIs run on the card unless the caller asks for the CPU."""

from __future__ import annotations

import argparse

import torch


def add_common_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("-m", "--model", default="./ggml-model-f16.gguf", help="model path (GGUF)")
    p.add_argument("-i", "--inp", default="assets/tench.jpg", help="input image path")
    p.add_argument("-o", "--out", default="pca_visual.jpg", help="output image for PCA features")
    p.add_argument("-k", "--topk", type=int, default=5, help="top-k classes to print")
    p.add_argument("-s", "--seed", type=int, default=42, help="rng seed")
    p.add_argument("-t", "--threads", type=int, default=0,
                   help="host thread hint (the device runs its own parallelism)")
    p.add_argument("-c", "--classify", action="store_true",
                   help="classify instead of PCA feature extraction")
    p.add_argument("-fa", "--flash-attn", action="store_true",
                   help="use the flash-attention kernels (K4, and K6 in training)")
    p.add_argument("--parity", choices=["reference", "hf"], default="reference",
                   help="numerics parity target (ggml quirks vs HF semantics)")
    p.add_argument("--dtype", choices=["bf16", "f32"], default="bf16")
    p.add_argument("--quant-mode", choices=["dequant", "fused", "int8"], default="dequant",
                   help="quantized checkpoints: dequant at load, or the fused "
                   "dequant-matmul kernels; 'int8' (W8A8) is not ported")
    p.add_argument("--data-parallel", action="store_true",
                   help="shard the batch over all devices (not ported: one device only)")
    p.add_argument("--mesh", default=None, metavar="DP[,TP]",
                   help="explicit mesh: 'dp' or 'dp,tp' device counts "
                   "(not ported: one device only)")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on: 'cuda' (default) or 'cpu'")


def dtype_of(args) -> torch.dtype:
    return {"bf16": torch.bfloat16, "f32": torch.float32}[args.dtype]


def mesh_axes_of(args) -> dict[str, int] | None:
    """Parse --mesh 'dp[,tp]' into mesh axes (validated)."""
    if not getattr(args, "mesh", None):
        return None
    try:
        parts = [int(v) for v in args.mesh.split(",")]
    except ValueError:
        raise SystemExit(f"--mesh {args.mesh!r}: expected 'dp' or 'dp,tp' integers")
    if not 1 <= len(parts) <= 2 or any(v < 1 for v in parts):
        raise SystemExit(
            f"--mesh {args.mesh!r}: expected 1-2 positive values 'dp[,tp]'"
        )
    axes = {"data": parts[0]}
    if len(parts) > 1 and parts[1] > 1:
        axes["model"] = parts[1]
    return axes
