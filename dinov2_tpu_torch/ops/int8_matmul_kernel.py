"""The W8A8 int8 matmul, K9 (port of dinov2_tpu/ops/qmatmul.py::int8_matmul).

    int8_matmul_kernel(x, il, bias, activation)
        = act(f32(q(x) @ il.codes^T) * sx * il.s + bias)

for x (..., K) bf16 or f32 and an (N, K) Int8Linear `il` (models/params.py),
in x's dtype. The JAX function is no Pallas kernel: it leaves its
s8 x s8 -> s32 dot_general to XLA. On a CUDA tensor it is two launches of
the hand-written kernels in csrc/int8_matmul.cu:
  - `quantize_rows_int8_kernel`: x -> (x8 (..., K) int8, sx (..., 1) f32),
    the row's absmax in f32, sx = max(absmax, 1e-12) * f32(1/127), codes
    rounded half to even (ops/qmatmul.py::quantize_rows_int8);
  - `int8_gemm_kernel`: the s8 x s8 -> s32 product on wgmma with the
    rescale, the bias and the activation in its epilogue
    (ops/qmatmul.py::int8_epilogue).
Each adds one to its own `launches` where it launches. On a CPU tensor each
runs its plain version (ops/qmatmul.py), bit for bit what the kernels give.
A CUDA tensor the kernels do not take raises; nothing falls back.
"""

from __future__ import annotations

import torch

from dinov2_tpu_torch.ops.qmatmul import (
    int8_epilogue,
    int8_matmul_reference,
    int8_product,
    quantize_rows_int8,
    refuse_quant_grad,
)
from dinov2_tpu_torch.ops.qmatmul_kernel import ACTIVATIONS

K_DEPTH = 128  # the GEMM's k-step: one 128-byte swizzle row of codes
QUANTIZE_PIECE = 16  # the quantize reads 16-byte pieces of a row


def _check_input(x: torch.Tensor, name: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no K9 kernel for device {x.device}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def quantize_rows_int8_kernel(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(x8, sx) = quantize_rows_int8(x) for x (..., K) bf16 or f32: codes
    (..., K) int8 and row scales (..., 1) f32. A CPU tensor runs the plain
    version; a CUDA tensor launches K9's quantize kernel and adds one to
    `quantize_rows_int8_kernel.launches` (K % 16 == 0)."""
    if x.device.type == "cpu":
        return quantize_rows_int8(x)
    _check_input(x, "x")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise NotImplementedError(f"the CUDA int8 quantize takes bf16 or f32 x, got {x.dtype}")
    k = x.shape[-1]
    if k % QUANTIZE_PIECE:
        raise NotImplementedError(
            f"the CUDA int8 quantize needs K % {QUANTIZE_PIECE} == 0, got {k}")
    x8 = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    sx = torch.empty((*x.shape[:-1], 1), dtype=torch.float32, device=x.device)
    m = x.numel() // k if k else 0
    if m:
        from dinov2_tpu_torch.ops._kernels import check_status, int8_matmul_lib

        lib = int8_matmul_lib()
        with torch.cuda.device(x.device):  # the launch goes to the current device
            code = lib.dinov2_int8_quantize_rows(
                x.data_ptr(), int(x.dtype == torch.float32), x8.data_ptr(), sx.data_ptr(), m, k,
                torch.cuda.current_stream(x.device).cuda_stream,
            )
        check_status(lib, code, "quantize_rows_int8_kernel")
        quantize_rows_int8_kernel.launches += 1
    return x8, sx


quantize_rows_int8_kernel.launches = 0  # kernel launches on CUDA tensors


def check_int8_weight(il, device: torch.device, k: int) -> int:
    """What the GEMM takes of an Int8Linear: codes (N, K) int8 and s (N,)
    f32, contiguous and 16-byte aligned on `device`, K % 128 == 0; returns
    N."""
    codes, s = il.codes, il.s
    if codes.dim() != 2 or codes.shape[1] != k or codes.dtype != torch.int8:
        raise ValueError(f"weight codes: expected (N, {k}) int8, got "
                         f"{tuple(codes.shape)} {codes.dtype}")
    n = codes.shape[0]
    if tuple(s.shape) != (n,) or s.dtype != torch.float32:
        raise ValueError(f"weight s: expected ({n},) f32, got {tuple(s.shape)} {s.dtype}")
    if k % K_DEPTH:
        raise NotImplementedError(
            f"the CUDA int8 GEMM needs K % {K_DEPTH} == 0 (a k-step is one 128-byte row "
            f"of codes), got K={k}"
        )
    for name, t in (("codes", codes), ("s", s)):
        if t.device != device:
            raise ValueError(f"weight {name} is on {t.device}, the input on {device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"weight {name} must be contiguous and 16-byte aligned")
    return n


def int8_gemm_kernel(
    x8: torch.Tensor, sx: torch.Tensor, il, bias: torch.Tensor | None = None,
    activation: str | None = None, dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """act(f32(x8 @ il.codes^T) * sx * il.s + bias) in `dtype` (bf16 or
    f32): x8 (..., K) int8 and sx (..., 1) f32 from the quantize, bias (N,)
    f32 or None -> (..., N). A CPU tensor runs the plain version (an exact
    s32 product, then int8_epilogue); a CUDA tensor launches K9's GEMM and
    adds one to `int8_gemm_kernel.launches`."""
    if x8.device.type == "cpu":
        return int8_epilogue(int8_product(x8, il.codes), sx, il.s, dtype, bias, activation)
    _check_input(x8, "x8")
    if x8.dtype != torch.int8:
        raise ValueError(f"x8 must be int8, got {x8.dtype}")
    if dtype not in (torch.bfloat16, torch.float32):
        raise NotImplementedError(f"the CUDA int8 GEMM writes bf16 or f32, got {dtype}")
    if activation not in ACTIVATIONS:
        raise ValueError(f"unknown activation {activation!r}")
    k = x8.shape[-1]
    n = check_int8_weight(il, x8.device, k)
    lead = x8.shape[:-1]
    if tuple(sx.shape) != (*lead, 1) or sx.dtype != torch.float32 or sx.device != x8.device \
            or not sx.is_contiguous():
        raise ValueError(f"sx: expected {(*lead, 1)} f32 on {x8.device}, got "
                         f"{tuple(sx.shape)} {sx.dtype} on {sx.device}")
    if bias is not None and (
        tuple(bias.shape) != (n,) or bias.dtype != torch.float32 or bias.device != x8.device
        or not bias.is_contiguous()
    ):
        raise ValueError(f"bias: expected ({n},) f32 on {x8.device}, got "
                         f"{tuple(bias.shape)} {bias.dtype} on {bias.device}")
    out = torch.empty((*lead, n), dtype=dtype, device=x8.device)
    m = x8.numel() // k
    if m and n:
        from dinov2_tpu_torch.ops._kernels import check_status, int8_matmul_lib

        lib = int8_matmul_lib()
        with torch.cuda.device(x8.device):  # the launch goes to the current device
            code = lib.dinov2_int8_gemm(
                x8.data_ptr(), sx.data_ptr(), il.codes.data_ptr(), il.s.data_ptr(),
                None if bias is None else bias.data_ptr(), ACTIVATIONS[activation],
                out.data_ptr(), int(dtype == torch.float32), m, n, k,
                torch.cuda.current_stream(x8.device).cuda_stream,
            )
        check_status(lib, code, "int8_gemm_kernel")
        int8_gemm_kernel.launches += 1
    return out


int8_gemm_kernel.launches = 0  # kernel launches on CUDA tensors


def int8_matmul_kernel(
    x: torch.Tensor, il, bias: torch.Tensor | None = None, activation: str | None = None
) -> torch.Tensor:
    """act(x @ W^T + bias) for x (..., K) bf16 or f32 and an (N, K)
    Int8Linear W, in x's dtype: on a card K9's two launches (the shapes are
    checked before the first), on the CPU the plain version. An input that
    requires grad raises: int8 weights are not trainable and K9 has no
    backward."""
    refuse_quant_grad("int8_matmul_kernel", x, bias)
    if x.device.type == "cpu":
        return int8_matmul_reference(x, il, bias, activation)
    _check_input(x, "x")
    check_int8_weight(il, x.device, x.shape[-1])
    x8, sx = quantize_rows_int8_kernel(x)
    return int8_gemm_kernel(x8, sx, il, bias, activation, x.dtype)
