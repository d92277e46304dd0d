"""Linear apply, dense or ggml-quantized, and activations (port of
dinov2_tpu/ops/qmatmul.py).

Matmuls accumulate in f32 and round once to the compute dtype, then the
bias is added in that dtype, the JAX package's ordering
(`jnp.dot(..., preferred_element_type=x.dtype)` + `bias.astype(x.dtype)`).

A `QuantLinear` kernel (models/params.py) goes through `quant_matmul`, the
one dispatch point of quantized matmuls. Its backends:
  - "kernel": the K7 dequant-matmul (ops/qmatmul_kernel.py), which reads the
    ggml blocks straight from their packed form on a card and runs its plain
    version on the CPU;
  - "dequant": `dequant_weight` into a dense weight of x's dtype, then a
    plain matmul (the JAX package's "xla" backend);
  - "auto": "kernel", so a card always reaches the kernel. The JAX package's
    "auto" is "dequant", a choice measured on a TPU that does not carry over.

An `Int8Linear` kernel (the W8A8 mode) goes through `int8_matmul`: the
activations are quantized per row (`quantize_rows_int8`), multiplied with
the int8 codes into exact s32 sums and rescaled in f32 by both scales
(`int8_matmul_reference`, the plain version of the K9 kernel,
ops/int8_matmul_kernel.py). It has no backend choice: the JAX package
leaves it to XLA, the port to K9.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from dinov2_tpu_torch.models.params import Int8Linear, QuantLinear, decode_packed_planes


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


QUANT_BACKENDS = ("auto", "kernel", "dequant")


def needs_grad(*tensors: torch.Tensor | None) -> bool:
    """Whether autograd is recording and one of the tensors (None is skipped)
    requires grad: where the kernel wrappers take their autograd Functions."""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


def refuse_quant_grad(what: str, *tensors: torch.Tensor | None) -> None:
    """Raise where a tensor that requires grad meets a QuantLinear or an
    Int8Linear path: the quantized kernels have no backward, and returning
    their result would cut the graph without a word (the JAX package:
    "fused-quant weights aren't trainable")."""
    if needs_grad(*tensors):
        raise RuntimeError(
            f"{what}: fused-quant weights aren't trainable, and an input requires grad; "
            "load the checkpoint with quant_mode='dequant' to train, or run under torch.no_grad()"
        )


def dequant_weight(ql, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """A QuantLinear -> its dense (out, in) weight in `dtype`, in the JAX
    package's order: integer codes -> f32, times d, plus m for q4_1/q5_1,
    each in f32, then one cast. Both layouts; dims come from the tensors.
    An Int8Linear: codes -> f32, times its row's s, one cast (the route
    that feeds int8 weights into the dense slab kernels K1, K2 and K5)."""
    if isinstance(ql, Int8Linear):
        return (ql.codes.float() * ql.s.unsqueeze(-1)).to(dtype)
    out_dim = ql.codes.shape[0]
    in_dim = ql.codes.shape[1] * (2 if ql.packed else 1)
    if ql.packed:
        q = decode_packed_planes(ql.codes, ql.qh_lo, ql.qh_hi, ql.zero_point)
    else:
        q = ql.codes
    w = q.to(torch.float32).reshape(out_dim, in_dim // 32, 32) * ql.d.unsqueeze(-1)
    if ql.m is not None:
        w = w + ql.m.unsqueeze(-1)
    return w.reshape(out_dim, in_dim).to(dtype)


def quant_matmul(
    x: torch.Tensor,
    ql,
    backend: str = "auto",
    bias: torch.Tensor | None = None,
    activation: str | None = None,
) -> torch.Tensor:
    """x (..., in) @ W^T (+ bias) (+ activation) for an (out, in)
    QuantLinear W: the one dispatch point of quantized matmuls (module
    docstring for the backends)."""
    from dinov2_tpu_torch.ops.qmatmul_kernel import quant_matmul_kernel, quant_matmul_reference

    if backend not in QUANT_BACKENDS:
        raise ValueError(f"quant backend must be one of {QUANT_BACKENDS}, got {backend!r}")
    refuse_quant_grad("quant_matmul", x, bias)
    if backend == "dequant":
        return quant_matmul_reference(x, ql, bias, activation)
    return quant_matmul_kernel(x, ql, bias, activation)


# np.float32(1 / 127) and np.float32(1e-12), the JAX package's constants,
# written out so that the kernel's (csrc/int8_matmul.cu) are checkably the same
INT8_SCALE_STEP = 0.007874015718698502  # 0x3c010204
INT8_SCALE_FLOOR = 9.99999996e-13  # 0x2b8cbccc


def quantize_rows_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Dynamic per-row symmetric int8 activation quantization, the JAX
    package's order: in f32, sx = max(absmax, 1e-12) * f32(1/127), codes =
    round-half-even(x / sx) (|x / sx| <= 127 by construction, so no clip).
    Returns (codes int8 like x, sx f32 with the last axis kept as 1)."""
    xf = x.float()
    ax = xf.abs().amax(dim=-1, keepdim=True)
    sx = torch.clamp_min(ax, INT8_SCALE_FLOOR) * INT8_SCALE_STEP
    return torch.round(xf / sx).to(torch.int8), sx


def int8_product(x8: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """The exact s32 product x8 @ codes^T for int8 x8 (..., K) and codes
    (N, K). The sums run in f64, where every partial sum is an integer of
    at most 127 * 127 * K < 2^53 and so exact, on the CPU and on a card
    alike; then one cast to int32."""
    return torch.matmul(x8.double(), codes.double().T).to(torch.int32)


def int8_epilogue(
    acc: torch.Tensor, sx: torch.Tensor, s: torch.Tensor, dtype: torch.dtype,
    bias: torch.Tensor | None = None, activation: str | None = None,
) -> torch.Tensor:
    """What the s32 sums become, in the JAX package's order: f32(acc) * sx
    * s (two f32 multiplies, in that order), one cast to `dtype`, + bias
    cast to `dtype`, then the activation."""
    y = (acc.float() * sx * s).to(dtype)
    if bias is not None:
        y = y + bias.to(dtype)
    return apply_activation(y, activation)


def int8_matmul_reference(
    x: torch.Tensor, il, bias: torch.Tensor | None = None, activation: str | None = None
) -> torch.Tensor:
    """The plain PyTorch version of K9: y = act(x @ W^T + bias) for an
    (N, K) Int8Linear W, in x's dtype (the JAX package's int8_matmul)."""
    x8, sx = quantize_rows_int8(x)
    return int8_epilogue(int8_product(x8, il.codes), sx, il.s, x.dtype, bias, activation)


def int8_matmul(
    x: torch.Tensor, il, bias: torch.Tensor | None = None, activation: str | None = None
) -> torch.Tensor:
    """x (..., in) @ W^T (+ bias) (+ activation) for an (out, in)
    Int8Linear W: the K9 kernel on a card, its plain version on the CPU
    (ops/int8_matmul_kernel.py), which refuses inputs that require grad."""
    from dinov2_tpu_torch.ops.int8_matmul_kernel import int8_matmul_kernel

    return int8_matmul_kernel(x, il, bias, activation)


def apply_linear(
    x: torch.Tensor, layer: dict, activation: str | None = None, backend: str = "auto"
) -> torch.Tensor:
    """x @ kernel (+ bias) (+ activation) for a dense (in, out) kernel, an
    (out, in) Int8Linear (through int8_matmul) or an (out, in) QuantLinear
    (through quant_matmul with `backend`); both carry the bias and the
    activation into the kernel's epilogue.

    A dense kernel is cast to x's dtype first, so f32 features meet an f32
    classifier (JAX promotes the bf16 kernel the same way)."""
    kernel = layer["kernel"]
    if isinstance(kernel, Int8Linear):
        return int8_matmul(x, kernel, layer.get("bias"), activation)
    if isinstance(kernel, QuantLinear):
        return quant_matmul(x, kernel, backend, layer.get("bias"), activation)
    y = torch.matmul(x, kernel.to(x.dtype))
    if "bias" in layer:
        y = y + layer["bias"].to(x.dtype)
    return apply_activation(y, activation)
