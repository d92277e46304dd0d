"""The quantized attention half-layer, K8 (port of
dinov2_tpu/ops/fused_quant_attention.py).

    slab_layer_block_quant(x, ...) = x + ls1 * (proj(attention(qkv(LN1 x))) + b_proj)

with the qkv (3D, D) and proj (D, D) weights as QuantLinear (models/
params.py), dequantized in `dequant_weight`'s order (code -> f32, x d, + m,
one cast to x's dtype). On a CUDA tensor it launches the hand-written kernel
in csrc/quant_layer.cu, which replaces the Pallas TPU kernel
`_quant_layer_kernel`: both weights dequantized once a call into a (4D, D)
bf16 scratch buffer (K7's dequantize kernel, one launch each), then K1's
four launches (ops/fused_attention.py) on that scratch. f32 activations
take the f32 entry, K1 f32's six launches with each weight dequantized
straight into its two TF32 planes (K7 f32's dequantize kernel) in 6 D^2 f32
of scratch just before the 3xTF32 GEMM that reads them: K1 f32 splits
`dequant_weight(W, f32).T` into the same planes, so the output is bit for
bit that of K1 f32 on those weights (quant_slab "dequant"). The dense
weights exist only for the call, in that buffer: the TPU kernel's VMEM
scratch, in HBM.
On a CPU tensor it runs the plain PyTorch version, `quant_layer_reference`:
dequant_weight, then K1's plain version, as the JAX package's reference
does.

The TPU kernel keeps the qkv slab and the attention output on chip; this
version writes and re-reads both through HBM, as K1 does.
"""

from __future__ import annotations

import torch

from dinov2_tpu_torch.ops._library import check_device, count_launch, define
from dinov2_tpu_torch.ops.fused_attention import check_half_layer_args, slab_layer_reference
from dinov2_tpu_torch.ops.qmatmul import dequant_weight, refuse_quant_grad
from dinov2_tpu_torch.ops.qmatmul_kernel import (
    QUANT_OP_SCHEMA,
    check_quant_weight,
    quant_linear,
    quant_op_args,
    quant_weight_args,
)


def quant_layer_reference(
    x, ln_scale, ln_bias, qkv_ql, b_qkv, proj_ql, b_proj, ls1, num_heads, scale, eps
):
    """The plain PyTorch version of K8: K1's plain version on the
    dequantized (in, out) weights (what quant_mode="dequant" computes)."""
    wq = dequant_weight(qkv_ql, x.dtype).T
    wp = dequant_weight(proj_ql, x.dtype).T
    return slab_layer_reference(x, ln_scale, ln_bias, wq, b_qkv, wp, b_proj, ls1, num_heads,
                                scale, eps)


def slab_layer_block_quant(
    x: torch.Tensor,
    ln_scale: torch.Tensor,
    ln_bias: torch.Tensor,
    qkv_ql,
    b_qkv: torch.Tensor,
    proj_ql,
    b_proj: torch.Tensor,
    ls1: torch.Tensor,
    num_heads: int,
    scale: float,
    eps: float,
) -> torch.Tensor:
    """x + ls1 * proj(attention(qkv(LN(x)))): x (B, T, D); qkv_ql (3D, D) and
    proj_ql (D, D) QuantLinear; ln_scale, ln_bias, b_proj, ls1 (D,) and b_qkv
    (3D,) in f32.

    CPU tensors run the plain version. CUDA tensors launch the K8 kernel
    (bf16 or f32; anything else raises; its six launches share scratch of
    x's dtype allocated here for the call: the qkv slab, the attention
    output and the dequantized weights, 4 D^2 in bf16, 6 D^2 of TF32 planes
    in f32) and add one to
    `slab_layer_block_quant.launches` (bf16) or `.f32_launches` (f32).
    Both go through the operator `dinov2_tpu_torch::slab_layer_block_quant`
    (ops/_library.py). An input
    that requires grad raises: the quantized weights are not trainable and
    the kernel has no backward."""
    refuse_quant_grad("slab_layer_block_quant", x, ln_scale, ln_bias, b_qkv, b_proj, ls1)
    check_device(x, "slab_layer_block_quant")
    return _QUANT_LAYER_OP(
        x, ln_scale, ln_bias, *quant_op_args(qkv_ql), b_qkv, *quant_op_args(proj_ql), b_proj,
        ls1, num_heads, scale, eps,
    )


def _operator_args(args: tuple) -> tuple:
    """The operator's arguments -> quant_layer_reference's: each weight's
    seven fields (quant_op_args) as one QuantLinear."""
    x, ln_scale, ln_bias, *rest = args
    qkv_ql, (b_qkv, *rest) = quant_linear(*rest[:7]), rest[7:]
    proj_ql, (b_proj, ls1, num_heads, scale, eps) = quant_linear(*rest[:7]), rest[7:]
    return x, ln_scale, ln_bias, qkv_ql, b_qkv, proj_ql, b_proj, ls1, num_heads, scale, eps


def _check_quant_layer_args(x, ln_scale, ln_bias, qkv_ql, b_qkv, proj_ql, b_proj, ls1, num_heads,
                            aligned: bool = True) -> None:
    check_half_layer_args(x, ln_scale, ln_bias, b_qkv, b_proj, ls1, num_heads, aligned=aligned)
    d = x.shape[-1]
    check_quant_weight(qkv_ql, "qkv", x.device, 3 * d, d, aligned=aligned)
    check_quant_weight(proj_ql, "proj", x.device, d, d, aligned=aligned)


def _quant_layer_fake(*args):
    x, *checked, _, _ = _operator_args(args)
    if x.device.type == "cuda":
        _check_quant_layer_args(x, *checked, aligned=False)
    return torch.empty_like(x, memory_format=torch.contiguous_format)


def _quant_layer_cuda(*args):
    """The K8 launches."""
    x, ln_scale, ln_bias, qkv_ql, b_qkv, proj_ql, b_proj, ls1, num_heads, scale, eps = (
        _operator_args(args))
    _check_quant_layer_args(x, ln_scale, ln_bias, qkv_ql, b_qkv, proj_ql, b_proj, ls1, num_heads)
    b, t, d = x.shape
    from dinov2_tpu_torch.ops._kernels import check_status, entry, quant_layer_lib

    lib = quant_layer_lib()
    launch = entry(lib, "dinov2_quant_layer_bf16", x.dtype == torch.float32)
    qkv = torch.empty((b, t, 3 * d), dtype=x.dtype, device=x.device)
    attn = torch.empty((b, t, d), dtype=x.dtype, device=x.device)
    # bf16: qkv's (3D, D) rows, then proj's; f32: the TF32 planes of one
    # weight at a time, qkv's (2, 3D, D), then proj's (2, D, D) over them
    weights = torch.empty((4 * d if x.dtype == torch.bfloat16 else 6 * d, d), dtype=x.dtype,
                          device=x.device)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):  # the launches go to the current device
        code = launch(
            x.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(),
            *quant_weight_args(qkv_ql), b_qkv.data_ptr(),
            *quant_weight_args(proj_ql), b_proj.data_ptr(), ls1.data_ptr(),
            qkv.data_ptr(), attn.data_ptr(), out.data_ptr(),
            b, t, d, num_heads, scale, eps, torch.cuda.current_stream(x.device).cuda_stream,
            weights.data_ptr(),
        )
    check_status(lib, code, "slab_layer_block_quant")
    count_launch(slab_layer_block_quant, x.dtype)
    return out


slab_layer_block_quant.launches = 0  # bf16 kernel calls on CUDA tensors
slab_layer_block_quant.f32_launches = 0  # f32 kernel calls on CUDA tensors
_QUANT_LAYER_OP = define(
    "slab_layer_block_quant(Tensor x, Tensor ln_scale, Tensor ln_bias, "
    f"{QUANT_OP_SCHEMA.format(p='qkv_')}, Tensor b_qkv, {QUANT_OP_SCHEMA.format(p='proj_')}, "
    "Tensor b_proj, Tensor ls1, int num_heads, float scale, float eps) -> Tensor",
    lambda *args: quant_layer_reference(*_operator_args(args)), _quant_layer_cuda,
    _quant_layer_fake,
)
