"""GGUF reading for the port: the JAX package's `dinov2_tpu.io.gguf`, which is
numpy only and imports no jax, re-exported."""

from dinov2_tpu.io.gguf import (  # noqa: F401
    QUANTIZED_TYPES,
    GGMLType,
    GGUFReader,
    GGUFTensor,
)
