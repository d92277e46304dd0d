"""The dequant-matmul, K7 (port of dinov2_tpu/ops/pallas_qmatmul.py).

    quant_matmul_kernel(x, ql, bias, activation)
        = act(x @ dequant_weight(ql, x.dtype)^T + bias)

for x (..., K) bf16 or f32 and an (N, K) QuantLinear (models/params.py) in
any of the five ggml formats and either layout. On a CUDA tensor it launches
the hand-written kernels in csrc/quant_matmul.cu, which replace the Pallas
TPU kernels `_make_kernel_sym`, `_make_kernel_affine` and
`_make_packed_kernel` (`quant_matmul_pallas`) and read the weight from its
ggml blocks: for bf16 x a kernel dequantizes the whole weight once into an
(N, K) bf16 buffer that lives for the call (`dequant_weight_kernel` is that
launch alone), then the wgmma GEMM of csrc/wgmma_gemm.cuh takes it with the
bias/activation epilogue; f32 x (the classifier head) runs an f32 FMA kernel
on f32 tiles dequantized as they are staged. The held weights stay packed.
On a CPU tensor it runs the plain PyTorch version, `quant_matmul_reference`.

Numerics: the kernel dequantizes in `dequant_weight`'s order (code -> f32,
x d, + m, one cast), the JAX package's "xla" backend and K8's contract. The
TPU kernels round the scale to bf16 first and add blocksums(x)·mᵀ in f32 for
q4_1/q5_1, artefacts of the MXU's indicator-matmul broadcasts: they sit
within bf16 noise of this (ROADMAP.md, section 3). Epilogue as the TPU
kernel's `_epilogue`: bf16(acc), + bf16(bias), then the activation.
"""

from __future__ import annotations

import torch

from dinov2_tpu_torch.models.params import QuantLinear
from dinov2_tpu_torch.ops._library import check_device, define
from dinov2_tpu_torch.ops.qmatmul import apply_activation, dequant_weight, refuse_quant_grad

# activation name -> the kernels' code (csrc/activation.cuh; K5 takes them too)
ACTIVATIONS = {None: 0, "gelu_tanh_f16": 1, "gelu_erf": 2, "gelu_tanh": 3}
K_TILE = 64  # the kernels' k-step: a packed weight's planes must hold whole steps


def quant_matmul_reference(
    x: torch.Tensor, ql, bias: torch.Tensor | None = None, activation: str | None = None
) -> torch.Tensor:
    """The plain PyTorch version of K7: dequant_weight in x's dtype, a matmul
    (f32 accumulate, one cast), + bias in x's dtype, then the activation."""
    y = torch.matmul(x, dequant_weight(ql, x.dtype).T)
    if bias is not None:
        y = y + bias.to(x.dtype)
    return apply_activation(y, activation)


def check_quant_weight(ql, name: str, device: torch.device, n: int | None = None,
                       k: int | None = None, aligned: bool = True) -> tuple[int, int]:
    """What the CUDA kernels take of a QuantLinear; returns its (N, K).
    `aligned` False skips the data pointers' alignment (fields with no
    storage: the operators' fake implementations)."""
    codes = ql.codes
    if codes.dim() != 2:
        raise ValueError(f"{name}: codes must be 2-D (one layer), got {tuple(codes.shape)}")
    rows = codes.shape[0]
    cols = codes.shape[1] * (2 if ql.packed else 1)
    if (n is not None and rows != n) or (k is not None and cols != k):
        raise ValueError(f"{name}: expected a ({n}, {k}) weight, got ({rows}, {cols})")
    step = 2 * K_TILE if ql.packed else K_TILE
    if cols % step:
        raise NotImplementedError(
            f"{name}: the CUDA kernels need K/2 % {K_TILE} == 0 for a packed weight and "
            f"K % {K_TILE} == 0 for an int8 one (a k-step lies inside one plane), got K={cols}"
        )
    expected = {
        "codes": (codes, (rows, codes.shape[1]), torch.uint8 if ql.packed else torch.int8),
        "d": (ql.d, (rows, cols // 32), torch.float32),
    }
    if ql.m is not None:
        expected["m"] = (ql.m, (rows, cols // 32), torch.float32)
    if (ql.qh_lo is None) != (ql.qh_hi is None) or (ql.qh_lo is not None and not ql.packed):
        raise ValueError(f"{name}: qh_lo and qh_hi come together, in the packed layout only")
    if ql.qh_lo is not None:
        expected["qh_lo"] = (ql.qh_lo, (rows, cols // 16), torch.uint8)
        expected["qh_hi"] = (ql.qh_hi, (rows, cols // 16), torch.uint8)
    for field, (tensor, shape, dtype) in expected.items():
        if tuple(tensor.shape) != shape or tensor.dtype != dtype:
            raise ValueError(
                f"{name}.{field}: expected {shape} {dtype}, "
                f"got {tuple(tensor.shape)} {tensor.dtype}"
            )
        if tensor.device != device:
            raise ValueError(f"{name}.{field} is on {tensor.device}, the input on {device}")
        if not tensor.is_contiguous() or (aligned and tensor.data_ptr() % 16):
            raise ValueError(f"{name}.{field} must be contiguous and 16-byte aligned")
    return rows, cols


# a QuantLinear as the operators take it (quant_op_args), `p` its name's prefix
QUANT_OP_SCHEMA = ("Tensor {p}codes, Tensor {p}d, Tensor? {p}m, Tensor? {p}qh_lo, "
                   "Tensor? {p}qh_hi, int {p}ggml_type, bool {p}packed")


def quant_op_args(ql) -> list:
    """A QuantLinear as the operators take it: its tensor fields, its ggml
    type and its layout flag (`QUANT_OP_SCHEMA`); `quant_linear` rebuilds it."""
    return [ql.codes, ql.d, ql.m, ql.qh_lo, ql.qh_hi, int(ql.ggml_type), bool(ql.packed)]


def quant_linear(codes, d, m, qh_lo, qh_hi, ggml_type: int, packed: bool) -> QuantLinear:
    """The QuantLinear of `quant_op_args`; its (N, K) from the tensors."""
    cols = codes.shape[-1] * (2 if packed else 1)
    return QuantLinear(codes=codes, d=d, m=m, ggml_type=ggml_type, shape=(codes.shape[-2], cols),
                       packed=packed, qh_lo=qh_lo, qh_hi=qh_hi)


def quant_weight_args(ql) -> list:
    """A checked QuantLinear as the C entry points take it (_kernels.py)."""
    return [
        ql.codes.data_ptr(), ql.d.data_ptr(),
        *(None if t is None else t.data_ptr() for t in (ql.m, ql.qh_lo, ql.qh_hi)),
        int(ql.packed), ql.zero_point,
    ]


def quant_matmul_kernel(
    x: torch.Tensor, ql, bias: torch.Tensor | None = None, activation: str | None = None
) -> torch.Tensor:
    """act(x @ dequant(W)^T + bias): x (..., K), W an (N, K) QuantLinear,
    bias (N,) f32 or None -> (..., N) in x's dtype.

    CPU tensors run the plain version. CUDA tensors launch the K7 kernels
    (bf16 or f32 x; anything else raises; bf16 x: the dequantize kernel into
    an (N, K) bf16 scratch allocated here, then the GEMM) and add one to
    `quant_matmul_kernel.launches`. Both go through the operator
    `dinov2_tpu_torch::quant_matmul` (ops/_library.py). An input that
    requires grad raises: the quantized weights are not trainable and the
    kernel has no backward."""
    refuse_quant_grad("quant_matmul_kernel", x, bias)
    check_device(x, "quant_matmul_kernel")
    return _QUANT_MATMUL_OP(x, *quant_op_args(ql), bias, activation)


def _check_quant_matmul_args(x, ql, bias, activation, aligned: bool = True) -> tuple[int, int]:
    """What the CUDA dequant-matmul takes; returns the weight's (N, K)."""
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise NotImplementedError(f"the CUDA dequant-matmul takes bf16 or f32 x, got {x.dtype}")
    if activation not in ACTIVATIONS:
        raise ValueError(f"unknown activation {activation!r}")
    n, k = check_quant_weight(ql, "weight", x.device, k=x.shape[-1], aligned=aligned)
    if not x.is_contiguous() or (aligned and x.data_ptr() % 16):
        raise ValueError("x must be contiguous and 16-byte aligned")
    if bias is not None and (
        tuple(bias.shape) != (n,) or bias.dtype != torch.float32 or bias.device != x.device
        or not bias.is_contiguous()
    ):
        raise ValueError(f"bias: expected ({n},) f32 on {x.device}, got "
                         f"{tuple(bias.shape)} {bias.dtype} on {bias.device}")
    return n, k


def _quant_matmul_cpu(x, codes, d, m, qh_lo, qh_hi, ggml_type, packed, bias, activation):
    ql = quant_linear(codes, d, m, qh_lo, qh_hi, ggml_type, packed)
    return quant_matmul_reference(x, ql, bias, activation)


def _quant_matmul_fake(x, codes, d, m, qh_lo, qh_hi, ggml_type, packed, bias, activation):
    if x.device.type == "cuda":
        ql = quant_linear(codes, d, m, qh_lo, qh_hi, ggml_type, packed)
        _check_quant_matmul_args(x, ql, bias, activation, aligned=False)
    return x.new_empty((*x.shape[:-1], codes.shape[0]))


def _quant_matmul_cuda(x, codes, d, m, qh_lo, qh_hi, ggml_type, packed, bias, activation):
    """The K7 launches."""
    ql = quant_linear(codes, d, m, qh_lo, qh_hi, ggml_type, packed)
    n, k = _check_quant_matmul_args(x, ql, bias, activation)
    from dinov2_tpu_torch.ops._kernels import check_status, quant_matmul_lib

    lib = quant_matmul_lib()
    lead = x.shape[:-1]
    m = x.numel() // k
    out = torch.empty((*lead, n), dtype=x.dtype, device=x.device)
    if m:
        f32 = x.dtype == torch.float32
        scratch = None if f32 else torch.empty((n, k), dtype=x.dtype, device=x.device)
        with torch.cuda.device(x.device):  # the launches go to the current device
            code = lib.dinov2_quant_matmul(
                x.data_ptr(), int(f32), *quant_weight_args(ql),
                None if bias is None else bias.data_ptr(), ACTIVATIONS[activation],
                out.data_ptr(), m, n, k, torch.cuda.current_stream(x.device).cuda_stream,
                None if scratch is None else scratch.data_ptr(),
            )
        check_status(lib, code, "quant_matmul_kernel")
        quant_matmul_kernel.launches += 1
    return out


quant_matmul_kernel.launches = 0  # kernel launches on CUDA tensors
_QUANT_MATMUL_OP = define(
    f"quant_matmul(Tensor x, {QUANT_OP_SCHEMA.format(p='')}, Tensor? bias, str? activation) "
    "-> Tensor",
    _quant_matmul_cpu, _quant_matmul_cuda, _quant_matmul_fake,
)


def dequant_weight_kernel(ql) -> torch.Tensor:
    """dequant_weight(ql, torch.bfloat16), (N, K): the first of K7's two
    bf16 launches alone (the port's paths reach it only through
    quant_matmul_kernel; tests and timing call it here).

    A weight on the CPU runs the plain version, dequant_weight. On a card
    the kernel launches and `dequant_weight_kernel.launches` gains one."""
    device = ql.codes.device
    if device.type == "cpu":
        return dequant_weight(ql, torch.bfloat16)
    if device.type != "cuda":
        raise ValueError(f"no dequant_weight_kernel for device {device}")
    n, k = check_quant_weight(ql, "weight", device)
    from dinov2_tpu_torch.ops._kernels import check_status, dequant_weight_entry, quant_matmul_lib

    entry = dequant_weight_entry()
    out = torch.empty((n, k), dtype=torch.bfloat16, device=device)
    with torch.cuda.device(device):  # the launch goes to the current device
        code = entry(
            *quant_weight_args(ql), out.data_ptr(), n, k,
            torch.cuda.current_stream(device).cuda_stream,
        )
    check_status(quant_matmul_lib(), code, "dequant_weight_kernel")
    dequant_weight_kernel.launches += 1
    return out


dequant_weight_kernel.launches = 0  # kernel launches on CUDA tensors
