"""GGUF -> quantized GGUF (port of dinov2_tpu/cli/quantize.py,
`dinov2-quantize`; the reference's quantize.cpp, argv: input, output, type).
Takes the ggml integer type ids the reference uses and the names
q4_0/.../q8_0; writes the JAX package's bytes (quant/quantize.py).

    python -m dinov2_tpu_torch.cli.quantize in.gguf out.gguf q4_0
"""

from __future__ import annotations

import argparse
import sys

from dinov2_tpu_torch.io.gguf import GGMLType
from dinov2_tpu_torch.quant.quantize import QUANT_TYPE_NAMES, quantize_gguf


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("input", help="input GGUF (fp16/fp32)")
    parser.add_argument("output", help="output GGUF path")
    parser.add_argument(
        "type",
        help="quant type: q4_0|q4_1|q5_0|q5_1|q8_0 or ggml integer id (2|3|6|7|8)",
    )
    args = parser.parse_args(argv)

    t = args.type.lower()
    if t in QUANT_TYPE_NAMES:
        qt = QUANT_TYPE_NAMES[t]
    else:
        try:
            qt = GGMLType(int(t))
        except ValueError:
            raise SystemExit(
                f"unknown quant type {args.type!r}: expected "
                f"{'|'.join(sorted(QUANT_TYPE_NAMES))} or a ggml id (2|3|6|7|8)"
            )
        if qt not in set(QUANT_TYPE_NAMES.values()):
            raise SystemExit(
                f"{args.type} is not a supported quantization target "
                f"({'|'.join(sorted(QUANT_TYPE_NAMES))})"
            )
    out = quantize_gguf(args.input, args.output, qt)
    print(f"wrote {out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
