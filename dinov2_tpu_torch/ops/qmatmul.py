"""Dense linear apply and activations (port of dinov2_tpu/ops/qmatmul.py).

Only the dense path is ported: quantized weights (QuantLinear, Int8Linear)
and their kernels are listed in ROADMAP.md. Matmuls accumulate in f32 and
round once to the compute dtype, then the bias is added in that dtype, the
JAX package's ordering (`jnp.dot(..., preferred_element_type=x.dtype)` +
`bias.astype(x.dtype)`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def set_cuda_matmul_precision() -> None:
    """Make CUDA matmuls as exact as the JAX package asks for.

    The JAX code requests `Precision.HIGHEST` f32 products (image/resize.py)
    and f32 accumulation for bf16 products. On CUDA that means: no TF32 for
    f32 matmuls or cuDNN, and no reduced-precision (bf16) split-K reductions
    inside cuBLAS bf16 GEMMs. These are process-wide PyTorch switches."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def gelu_tanh_f16(y: torch.Tensor) -> torch.Tensor:
    """ggml's fp16-lookup-table tanh-GELU, f16(gelu_tanh(f16(x))), with real
    f16 casts (the JAX package's Veltkamp emulation exists only for Mosaic)."""
    g = F.gelu(y.to(torch.float16).float(), approximate="tanh")
    return g.to(torch.float16).to(y.dtype)


def apply_activation(y: torch.Tensor, activation: str | None) -> torch.Tensor:
    """The one home of activation-name dispatch."""
    if activation is None:
        return y
    if activation == "gelu_tanh":
        return F.gelu(y, approximate="tanh")
    if activation == "gelu_erf":
        return F.gelu(y)
    if activation == "gelu_tanh_f16":
        return gelu_tanh_f16(y)
    raise ValueError(f"unknown activation {activation!r}")


def apply_linear(
    x: torch.Tensor, layer: dict, activation: str | None = None
) -> torch.Tensor:
    """x @ kernel (+ bias) (+ activation) for a dense (in, out) kernel.

    The kernel is cast to x's dtype first, so f32 features meet an f32
    classifier (JAX promotes the bf16 kernel the same way)."""
    y = torch.matmul(x, layer["kernel"].to(x.dtype))
    if "bias" in layer:
        y = y + layer["bias"].to(x.dtype)
    return apply_activation(y, activation)
