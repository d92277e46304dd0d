"""Shared CLI plumbing (the port's own copy of dinov2_tpu/cli/_common.py):
flag names mirror the reference's dino_params_parse, with the `-o` bug
fixed (quirk Q7: upstream `-o` overwrote the input path; here it sets the
output path as documented). `--device` is the port's own flag: the CLIs run
on the card unless the caller asks for the CPU."""

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
                   "dequant-matmul kernels (K7, K8); 'int8' = W8A8 for any "
                   "checkpoint: per-row int8 weights, int8 GEMMs (K9)")
    p.add_argument("--data-parallel", action="store_true",
                   help="shard the batch over all visible cards")
    p.add_argument("--mesh", default=None, metavar="DP[,TP]",
                   help="explicit mesh: 'dp' or 'dp,tp' device counts "
                   "(tensor-parallel weights on the tp axis; composes with "
                   "--quant-mode fused); with --device cpu, or a card named by its "
                   "index (cuda:0), every position is that device")
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


def resolve_asset(path: str) -> str:
    """Resolve an input path against the reference's sample images.

    The reference ships sample images in `assets/` and defaults to
    `assets/tench.jpg`. This repo does not copy them: a relative path under
    `assets/` that does not exist locally is looked up (by its relative
    path, then its basename) under $DINOV2_TPU_ASSETS, the reference
    checkout's assets directory. Unlike the JAX package, which falls back to
    a default location, the port looks only where the variable points.

    Only that documented default-input form takes the fallback: a missing
    absolute path, or any other missing relative path, is a user error, and
    substituting a same-named sample would classify the wrong image. Those
    come back unchanged and fail with the honest file-not-found."""
    import os

    if os.path.exists(path) or os.path.isabs(path):
        return path
    if not path.replace(os.sep, "/").startswith("assets/"):
        return path
    root = os.environ.get("DINOV2_TPU_ASSETS")
    if not root:
        return path
    for cand in (
        os.path.join(os.path.dirname(root), path),  # e.g. assets/tench.jpg
        os.path.join(root, os.path.basename(path)),
    ):
        if os.path.exists(cand):
            return cand
    return path


def load_image_rgb(path: str):
    """Read an image as RGB uint8 (quirk Q1 lives in loader.decode_rgb);
    paths that do not exist locally resolve against the sample images."""
    from dinov2_tpu_torch.runtime.loader import decode_rgb

    try:
        return decode_rgb(resolve_asset(path))
    except ValueError as e:
        raise FileNotFoundError(str(e)) from None


def save_image_rgb(path: str, img_rgb) -> None:
    import cv2

    # cv2.imwrite reports a failure (missing directory, bad extension) by
    # returning False: raise, so no caller prints "wrote <path>" for a file
    # that does not exist
    if not cv2.imwrite(path, cv2.cvtColor(img_rgb, cv2.COLOR_RGB2BGR)):
        raise OSError(f"failed to write image: {path}")


def engine_from_args(args):
    """The DinoEngine the inference CLIs run, from the common flags."""
    from dinov2_tpu_torch.runtime.engine import DinoEngine

    return DinoEngine(
        args.model,
        dtype=dtype_of(args),
        quant_mode=args.quant_mode,
        parity=args.parity,
        flash_attention=True if args.flash_attn else "auto",
        device=args.device,
        data_parallel=args.data_parallel,
        mesh_axes=mesh_axes_of(args),
    )
