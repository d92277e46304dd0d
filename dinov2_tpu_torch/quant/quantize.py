"""GGUF -> GGUF post-hoc quantizer (reference: dino_model_quantize,
the reference dinov2.cpp:355-453 and quantize.cpp).

Behavior reproduced exactly:
  - a tensor is quantized iff its name matches the regex `.*weight` AND it is 2D
    (do_quantize, dinov2.cpp:227-236 + PATTERN dinov2.h:18) — biases, LayerScale
    lambdas, norms, cls/pos/register embeddings stay fp16/fp32 (quirk Q10)
  - fp16 sources are expanded to fp32 before quantizing (dinov2.cpp:400-411)
  - every quantized tensor is validated (ggml_validate_row_data, dinov2.cpp:423-427)
  - all KVs are copied and `ftype` is overwritten with the new type (dinov2.cpp:375-377)
  - everything else is byte-copied untouched

The port's own copy of dinov2_tpu/quant/quantize.py.
"""

from __future__ import annotations

import re
from pathlib import Path

from dinov2_tpu_torch.io.gguf import GGMLType, GGUFReader, GGUFWriter
from dinov2_tpu_torch.quant.blocks import quantize, validate_quantized

QUANTIZE_PATTERN = re.compile(r".*weight")

QUANT_TYPE_NAMES = {
    "q4_0": GGMLType.Q4_0,
    "q4_1": GGMLType.Q4_1,
    "q5_0": GGMLType.Q5_0,
    "q5_1": GGMLType.Q5_1,
    "q8_0": GGMLType.Q8_0,
}


def do_quantize(name: str, shape: tuple[int, ...]) -> bool:
    return bool(QUANTIZE_PATTERN.fullmatch(name)) and len(shape) == 2


def quantize_gguf(
    input_path: str | Path, output_path: str | Path, quant_type: GGMLType | str
) -> Path:
    if isinstance(quant_type, str):
        try:
            quant_type = QUANT_TYPE_NAMES[quant_type.lower()]
        except KeyError:
            raise ValueError(
                f"unsupported quantization type {quant_type!r} "
                f"(expected {'|'.join(sorted(QUANT_TYPE_NAMES))})"
            ) from None
    if quant_type not in QUANT_TYPE_NAMES.values():
        raise ValueError(f"unsupported quantization type {quant_type}")

    reader = GGUFReader(input_path)
    writer = GGUFWriter(output_path, arch="")
    for key, value in reader.kv.items():
        if key == "ftype":
            writer.add_uint32("ftype", int(quant_type))
        else:
            writer.add_kv(
                key,
                value,
                reader.kv_types[key],
                elem_type=reader.kv_array_types.get(key),
            )
    if "ftype" not in reader.kv:
        writer.add_uint32("ftype", int(quant_type))

    for name, tensor in reader.tensors.items():
        if do_quantize(name, tensor.shape):
            if tensor.ggml_type not in (GGMLType.F16, GGMLType.F32, GGMLType.BF16):
                # the reference aborts here (ggml_get_data_f32 asserts F32,
                # dinov2.cpp:400-411) — transparently dequantizing and
                # re-quantizing would silently stack quantization error
                raise ValueError(
                    f"{name} is already quantized ({tensor.ggml_type.name}); "
                    f"refusing to re-quantize — convert back to fp16 first"
                )
            data_f32 = tensor.as_numpy()  # fp16 -> fp32 expand happens here
            raw = quantize(data_f32, quant_type)
            if not validate_quantized(raw, quant_type):
                raise RuntimeError(f"quantized data validation failed for {name}")
            writer.add_tensor(name, raw, quant_type, tensor.shape)
        else:
            writer.add_tensor(name, tensor.data, tensor.ggml_type, tensor.shape)

    writer.write()
    reader.close()
    return Path(output_path)
