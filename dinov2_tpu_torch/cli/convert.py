"""HuggingFace checkpoint -> GGUF (port of dinov2_tpu/cli/convert.py,
`dinov2-convert`; the reference's scripts/dinov2-to-gguf.py, whose tensor
naming and dtype policy io/convert.py keeps). Adds --output (the reference
writes ./ggml-model.gguf).

    python -m dinov2_tpu_torch.cli.convert --model_name CHECKPOINT_DIR \\
        [--output ggml-model.gguf]
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument(
        "--model_name",
        default="facebook/dinov2-small-imagenet1k-1-layer",
        help="HuggingFace model name or local checkpoint directory (a name "
        "downloads from the hub)",
    )
    parser.add_argument("--output", default="./ggml-model.gguf")
    args = parser.parse_args(argv)

    from dinov2_tpu_torch.io.convert import convert_hf_name

    out = convert_hf_name(args.model_name, args.output)
    print(f"Done. Output file: {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
