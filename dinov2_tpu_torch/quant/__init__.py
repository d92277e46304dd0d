"""ggml block quantization for the port: the JAX package's codecs
(`dinov2_tpu.quant.blocks`) and GGUF -> GGUF quantizer
(`dinov2_tpu.quant.quantize`), which are numpy only and import no jax,
re-exported. They use the C++ host codec in csrc/ where it is built and
numpy otherwise."""

from dinov2_tpu.quant.blocks import (  # noqa: F401
    block_dtype,
    dequantize,
    quantize,
    unpack_codes,
)
from dinov2_tpu.quant.quantize import QUANT_TYPE_NAMES, quantize_gguf  # noqa: F401
