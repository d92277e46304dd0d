"""Fine-tune a DINOv2 classifier on an image-folder dataset (port of
dinov2_tpu/cli/train.py, `dinov2-train`):

    python -m dinov2_tpu_torch.cli.train -m backbone.gguf --data DATA_DIR \\
        [--epochs 1] [--batch 32] [--lr 1e-4] [--weight-decay 0.05] [--dtype bf16] \\
        [-fa] [--checkpoint-dir DIR] [--export tuned.gguf] [--device cuda|cpu]

Loads a GGUF backbone (its classifier replaced to match the dataset's
classes), runs the cross-entropy + AdamW training step (parallel/train.py)
on one device with threaded host-side decode, saves checkpoints
(parallel/checkpoint.py) and exports the result back to GGUF so the
inference paths (and the reference C++ loader) can consume it. It runs on
the card unless `--device cpu` is given. Decoding needs OpenCV (`cv2`),
imported at the first batch.

Dataset layout: DATA_DIR/<class_name>/*.jpg; classes are sorted subdir names.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np

from dinov2_tpu_torch.cli._common import add_common_args


def _folder_dataset(root: Path):
    classes = sorted(p.name for p in root.iterdir() if p.is_dir())
    if not classes:
        raise ValueError(f"no class subdirectories under {root}")
    from dinov2_tpu_torch.runtime.loader import IMAGE_EXTENSIONS

    samples = []
    for label, name in enumerate(classes):
        for p in sorted((root / name).rglob("*")):
            if p.suffix.lower() in IMAGE_EXTENSIONS:
                samples.append((p, label))
    return classes, samples


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    add_common_args(p)
    p.add_argument("--data", required=True, help="folder-per-class dataset root")
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--weight-decay", type=float, default=0.05)
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--export", default=None, help="write the fine-tuned model as GGUF")
    p.add_argument("--decode-threads", type=int, default=8)
    p.add_argument("--log-every", type=int, default=10)
    # training defaults differ from the inference CLIs: parity is 'hf'
    # (true-mean pooling; the reference divisor quirk Q3 is an
    # inference-compat behavior, not a training semantic) and the default
    # compute dtype is f32 (opt into bf16 compute with --dtype bf16;
    # master weights are f32 either way); on a card f32 activations take
    # the plain PyTorch attention route (ops/attention.py)
    p.set_defaults(parity="hf", dtype="f32")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import torch

    from dinov2_tpu_torch.cli._common import dtype_of, mesh_axes_of
    from dinov2_tpu_torch.models.config import DinoConfig
    from dinov2_tpu_torch.models.params import load_params
    from dinov2_tpu_torch.models.vit import ModelOptions
    from dinov2_tpu_torch.parallel import train as parallel_train
    from dinov2_tpu_torch.runtime.loader import decode_rgb
    from dinov2_tpu_torch.utils.logging import get_logger

    log = get_logger()
    root = Path(args.data)
    classes, samples = _folder_dataset(root)
    log.info("dataset: %d samples, %d classes", len(samples), len(classes))
    if len(samples) < args.batch:
        # the drop-last step loop would run ZERO times and the export below
        # would silently write the random-init classifier
        raise SystemExit(
            f"dataset has {len(samples)} samples < --batch {args.batch}; "
            f"lower --batch (incomplete trailing batches are dropped)"
        )
    if mesh_axes_of(args) is not None or args.data_parallel:
        raise SystemExit("--mesh and --data-parallel: multi-device training is not ported; "
                         "this CLI trains on one device")
    # flags train deliberately does not honor (vs. silently ignoring them):
    # master weights stay f32 regardless of --dtype (--dtype sets the compute
    # dtype below); fused-quant weights aren't trainable; parity is fixed 'hf'
    if args.quant_mode != "dequant":
        log.warning("--quant-mode %s ignored: training uses dequantized weights",
                    args.quant_mode)
    if args.parity != "hf":
        log.warning("--parity is fixed to 'hf' for training")

    loaded = load_params(args.model, dtype=torch.float32, device="cpu")
    config = DinoConfig(**{**loaded.config.__dict__, "num_classes": len(classes)})
    params = dict(loaded.params)
    # (re)initialize the classifier for this label set
    rng = np.random.default_rng(args.seed)
    d = config.hidden_size
    params["classifier"] = {
        "kernel": torch.from_numpy(
            (rng.standard_normal((2 * d, len(classes))) * 0.02).astype(np.float32)
        ),
        "bias": torch.zeros((len(classes),), dtype=torch.float32),
    }

    # --dtype selects the COMPUTE dtype (bf16 activations on the tensor cores
    # with f32 master weights is the standard mixed-precision recipe);
    # --flash-attn routes attention like the inference paths
    trainer = parallel_train.make_trainer(
        config,
        mesh=None,
        learning_rate=args.lr,
        weight_decay=args.weight_decay,
        opts=ModelOptions(
            parity="hf",
            compute_dtype=dtype_of(args),
            remat=True,
            flash_attention=True if args.flash_attn else "auto",
        ),
        preprocess_in_step=True,
        device=args.device,
    )
    params, opt_state = trainer.place(params)

    import concurrent.futures

    pool = concurrent.futures.ThreadPoolExecutor(args.decode_threads)

    def load_batch(batch_samples):
        import cv2

        def one(item):
            path, label = item
            img = decode_rgb(path)
            return cv2.resize(img, (256, 256), interpolation=cv2.INTER_NEAREST), label

        # keep uint8: classify_preprocess's to_float divides by 255 only for
        # uint8 input; a float32 [0,255] batch would skip the divide and feed
        # the backbone values 255x off-distribution
        pairs = list(pool.map(one, batch_samples))
        imgs = np.stack([im for im, _ in pairs])
        labels = np.asarray([lb for _, lb in pairs])
        return imgs, labels

    step = 0
    t0 = time.perf_counter()
    for epoch in range(args.epochs):
        order = rng.permutation(len(samples))
        for i in range(0, len(samples) - args.batch + 1, args.batch):
            batch = [samples[j] for j in order[i : i + args.batch]]
            images, labels = load_batch(batch)
            params, opt_state, metrics = trainer.step(params, opt_state, images, labels)
            step += 1
            if step % args.log_every == 0:
                log.info(
                    "epoch %d step %d loss %.4f acc %.3f (%.1f img/s)",
                    epoch, step, float(metrics["loss"]), float(metrics["accuracy"]),
                    step * args.batch / (time.perf_counter() - t0),
                )
        if args.checkpoint_dir:
            from dinov2_tpu_torch.parallel.checkpoint import save_train_state

            save_train_state(args.checkpoint_dir, step, params, opt_state)
            log.info("checkpoint @ step %d -> %s", step, args.checkpoint_dir)
    pool.shutdown()

    if args.export:
        from dinov2_tpu_torch.io.export import export_gguf

        id2label = {i: name for i, name in enumerate(classes)}
        export_gguf(args.export, params, config, id2label)
        log.info("exported fine-tuned model -> %s", args.export)
    return 0


if __name__ == "__main__":
    sys.exit(main())
