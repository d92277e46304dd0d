"""`dinov2-aot` on the port: export / inspect / run AOT deployment artifacts
(port of dinov2_tpu/cli/aot.py).

`export` traces the forward ONCE at a fixed shape with torch.export and
writes a self-describing artifact (runtime/aot.py), by default with a CUDA
and a CPU program, from any box (the CUDA program is traced on fake
tensors); `info` prints an artifact's header without importing torch; `run`
loads artifact + GGUF weights and classifies an image through the program
of `--device` (the card by default; with none it raises, it never falls
back to the CPU), with no model-building Python (models/vit.py is never
imported).

    python -m dinov2_tpu_torch.cli.aot export -m model.gguf --batch 64 -o model.aot
    python -m dinov2_tpu_torch.cli.aot info model.aot
    python -m dinov2_tpu_torch.cli.aot run model.aot -m model.gguf -i assets/tench.jpg
    (on a box with no card: export --platforms cpu --dtype f32, run --device cpu)
"""

from __future__ import annotations

import argparse
import json
import sys

_DTYPES = {"bf16": "bfloat16", "f32": "float32"}


def _add_model_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("-m", "--model", required=True, help="model path (GGUF)")
    p.add_argument("--parity", choices=["reference", "hf"], default="reference")
    p.add_argument("--dtype", choices=["bf16", "f32"], default="bf16")
    p.add_argument("--quant-mode", choices=["dequant", "fused"], default="dequant")
    p.add_argument("-fa", "--flash-attn", action="store_true",
                   help="force the flash-attention path (default: per-shape auto)")


def _load(model: str, dtype_name: str, quant_mode: str, device: str = "cpu"):
    """The weight tree of the GGUF, as the artifact's header recipe says."""
    import torch

    from dinov2_tpu_torch.models.params import load_params

    return load_params(model, dtype=getattr(torch, _DTYPES[dtype_name]), device=device,
                       quant_mode=quant_mode)


def _export(args) -> int:
    import torch

    from dinov2_tpu_torch.models.vit import ModelOptions
    from dinov2_tpu_torch.runtime.aot import export_forward, save_artifact

    try:
        h, w = (int(v) for v in args.size.lower().split("x"))
    except ValueError:
        raise SystemExit(f"--size {args.size!r}: expected HxW integers")
    platforms = tuple(p.strip() for p in args.platforms.split(",") if p.strip())
    if not platforms:
        raise SystemExit(f"--platforms {args.platforms!r}: nothing to trace for")
    # only shapes and dtypes are read: the weights load on the host
    loaded = _load(args.model, args.dtype, args.quant_mode)
    opts = ModelOptions(
        parity=args.parity,
        compute_dtype=getattr(torch, _DTYPES[args.dtype]),
        flash_attention=True if args.flash_attn else "auto",
    )
    data = export_forward(
        loaded.params, loaded.config, opts, batch=args.batch, height=h, width=w,
        classify=not args.features, platforms=platforms,
        # run-time loading recipe: the artifact's programs are fixed, so
        # `run` must rebuild the SAME weight tree (dtype + quant layout)
        extra_meta={"load": {"dtype": args.dtype, "quant_mode": args.quant_mode}},
    )
    save_artifact(args.out, data)
    print(
        f"wrote {args.out} ({len(data) / 1024:.0f} KiB, platforms={','.join(platforms)}, "
        f"batch={args.batch}, {h}x{w}, {'features' if args.features else 'classify'})",
        file=sys.stderr,
    )
    return 0


def _run(args) -> int:
    import numpy as np
    import torch

    from dinov2_tpu_torch.cli._common import load_image_rgb
    from dinov2_tpu_torch.image.preprocess import classify_preprocess, feature_preprocess
    from dinov2_tpu_torch.runtime.aot import load_artifact

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("aot run --device cuda: no CUDA device is available "
                           "(use --device cpu with an artifact that has a cpu program)")
    art = load_artifact(args.artifact)
    load_spec = art.meta.get("load", {})
    loaded = _load(args.model, load_spec.get("dtype", "bf16"),
                   load_spec.get("quant_mode", "dequant"), device=args.device)
    meta = art.meta["input"]
    img = load_image_rgb(args.inp)
    # the batch is the image repeated on the host, preprocessed on the
    # device, as DinoEngine does it
    batch = torch.from_numpy(np.repeat(img[None], meta["batch"], axis=0)).to(device)
    if art.meta["classify"]:
        x = classify_preprocess(batch)
    else:
        x = feature_preprocess(batch, art.meta["model"]["patch_size"])
    if tuple(x.shape[1:3]) != (meta["height"], meta["width"]):
        raise SystemExit(
            f"preprocessed input {tuple(x.shape[1:3])} does not match the artifact's "
            f"({meta['height']}, {meta['width']}) bucket — export an artifact for this size"
        )
    with torch.inference_mode():
        out = art(loaded.params, x)
    if art.meta["classify"]:
        probs = out["probs"][0].float().cpu().numpy()
        order = np.argsort(probs)[::-1][: args.topk]
        id2label = loaded.id2label or {}
        print(file=sys.stderr)
        for idx in order:
            label = id2label.get(int(idx), str(int(idx)))
            print(f" > {label} : {probs[idx]:.2f}")
    else:
        feats = out["patch_tokens"][0]
        print(f"patch tokens: {tuple(feats.shape)}, cls: {tuple(out['cls_token'][0].shape)}")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = parser.add_subparsers(dest="cmd", required=True)

    pe = sub.add_parser("export", help="trace the forward, write an artifact")
    _add_model_flags(pe)
    pe.add_argument("--batch", type=int, default=1)
    pe.add_argument("--size", default="224x224", metavar="HxW",
                    help="preprocessed input size (classify default 224x224; "
                    "feature mode: the Q4 one-extra-patch size for your input)")
    pe.add_argument("--features", action="store_true",
                    help="export the feature tap instead of the classify head")
    pe.add_argument("--platforms", default="cuda,cpu",
                    help="comma-separated programs to trace (default cuda,cpu)")
    pe.add_argument("-o", "--out", default="model.aot")

    pi = sub.add_parser("info", help="print an artifact's JSON header")
    pi.add_argument("artifact")

    pr = sub.add_parser(
        "run",
        help="classify an image through an artifact (weight dtype, quant "
        "layout, and numerics come from the artifact header — the traced "
        "program fixed them at export time)",
    )
    pr.add_argument("artifact")
    pr.add_argument("-m", "--model", required=True, help="model path (GGUF)")
    pr.add_argument("-i", "--inp", default="assets/tench.jpg")
    pr.add_argument("-k", "--topk", type=int, default=5)
    pr.add_argument("--device", default="cuda",
                    help="torch device to run on: 'cuda' (default) or 'cpu'")

    args = parser.parse_args(argv)
    if args.cmd == "info":
        from dinov2_tpu_torch.runtime.aot import aot_info

        print(json.dumps(aot_info(args.artifact), indent=2, sort_keys=True))
        return 0
    if args.cmd == "export":
        return _export(args)
    return _run(args)


if __name__ == "__main__":
    sys.exit(main())
