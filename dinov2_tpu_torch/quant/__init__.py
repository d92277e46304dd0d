"""ggml block quantization for the port: the codecs (quant/blocks.py) and the
GGUF -> GGUF quantizer (quant/quantize.py), numpy only. They use the C++ host
codec in csrc/ where it is built (utils/native.py) and numpy otherwise."""

# the submodule first: importing it binds the name `quantize` on this package
# to the module, and the codec function of that name must come out on top
from dinov2_tpu_torch.quant.quantize import QUANT_TYPE_NAMES, quantize_gguf  # noqa: F401, I001
from dinov2_tpu_torch.quant.blocks import (  # noqa: F401
    block_dtype,
    dequantize,
    quantize,
    unpack_codes,
)
