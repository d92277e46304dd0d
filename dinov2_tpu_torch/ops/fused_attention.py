"""The attention half-layer, K1 (port of dinov2_tpu/ops/fused_attention.py).

    slab_layer_block(x, ...) = x + ls1 * (proj(attention(qkv(LN1 x))) + b_proj)

On a CUDA tensor it launches the hand-written kernel in
csrc/slab_layer.cu, which replaces the Pallas TPU kernel
`dinov2_tpu/ops/fused_attention.py::_slab_layer_kernel`. On a CPU tensor it
runs the plain PyTorch version, `slab_layer_reference`, which keeps the
JAX package's unfused ordering (`_slab_layer_reference` followed by
`_slab_block_reference`).

What bounds the kernel on an H100, at the main path's shape (B=64, T=257,
D=768, H=12): ~91 GFLOP per call (58 in the QKV GEMM, 19 in proj, 13 in
attention), 1.1 of the forward's 2.9 TFLOP over 12 layers. This first
version runs in three launches (LN+QKV GEMM, attention, proj GEMM with the
bias/LayerScale/residual epilogue) and so writes and re-reads the 76 MB qkv
slab and the 25 MB attention output in HBM each call, which the TPU kernel
keeps on chip. Its GEMMs use mma.sync without pipelined loads. Keeping the
slab on chip, wgmma and TMA are later work (ROADMAP.md).

The kernel's softmax takes the exact running row max, so the JAX package's
CLS-shift overflow rescue has no counterpart here.
"""

from __future__ import annotations

import torch

from dinov2_tpu_torch.ops.attention import split_heads, vanilla_attention


def _slab_reference(qkv: torch.Tensor, num_heads: int, scale: float) -> torch.Tensor:
    """(B, T, 3D) qkv slab -> (B, T, D) attention output, plain."""
    b, t, three_d = qkv.shape
    q, k, v = split_heads(qkv, num_heads)
    return vanilla_attention(q, k, v, scale).reshape(b, t, three_d // 3)


def _slab_block_reference(x, qkv, w_proj, b_proj, ls1, num_heads, scale):
    """Attention core, then proj (f32 accumulate, cast), + bias, x LayerScale,
    + residual, each in x's dtype."""
    out = _slab_reference(qkv, num_heads, scale)
    y = torch.matmul(out, w_proj.to(out.dtype)).to(x.dtype) + b_proj.to(x.dtype)
    return x + y * ls1.to(x.dtype)


def slab_layer_reference(
    x, ln_scale, ln_bias, w_qkv, b_qkv, w_proj, b_proj, ls1, num_heads, scale, eps
):
    """The plain PyTorch version of K1: f32 LN statistics and affine, one cast;
    QKV matmul accumulated in f32 and cast before the bias add; then the
    attention block above."""
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(dim=-1, keepdim=True)
    h = ((x32 - mu) * torch.rsqrt(var + eps) * ln_scale + ln_bias).to(x.dtype)
    qkv = torch.matmul(h, w_qkv.to(h.dtype)).to(h.dtype) + b_qkv.to(h.dtype)
    return _slab_block_reference(x, qkv, w_proj, b_proj, ls1, num_heads, scale)


def check_half_layer_args(
    x, ln_scale, ln_bias, b_qkv, b_proj, ls1, num_heads, w_qkv=None, w_proj=None
):
    """What the CUDA half-layer kernels (K1, and K8 with quantized weights)
    take: bf16 x (B, T, D) with head_dim 64 and f32 rows; the dense (in, out)
    weights too where they are given."""
    if x.dtype != torch.bfloat16:
        raise NotImplementedError(
            f"the CUDA half-layer kernel takes bf16 activations, got {x.dtype}"
        )
    if x.dim() != 3:
        raise ValueError(f"x must be (B, T, D), got {tuple(x.shape)}")
    b, t, d = x.shape
    if d != 64 * num_heads:
        raise NotImplementedError(
            f"the CUDA half-layer kernel needs head_dim 64, got D={d}, H={num_heads}"
        )
    expected = {
        "ln_scale": (ln_scale, (d,), torch.float32),
        "ln_bias": (ln_bias, (d,), torch.float32),
        "b_qkv": (b_qkv, (3 * d,), torch.float32),
        "b_proj": (b_proj, (d,), torch.float32),
        "ls1": (ls1, (d,), torch.float32),
    }
    if w_qkv is not None:
        expected["w_qkv"] = (w_qkv, (d, 3 * d), torch.bfloat16)
        expected["w_proj"] = (w_proj, (d, d), torch.bfloat16)
    for name, (tensor, shape, dtype) in expected.items():
        if tuple(tensor.shape) != shape or tensor.dtype != dtype:
            raise ValueError(
                f"{name}: expected {shape} {dtype}, got {tuple(tensor.shape)} {tensor.dtype}"
            )
    for name, tensor in (("x", x), *((n, v[0]) for n, v in expected.items())):
        if tensor.device != x.device:
            raise ValueError(f"{name} is on {tensor.device}, x on {x.device}")
        if not tensor.is_contiguous() or tensor.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def slab_layer_block(
    x: torch.Tensor,
    ln_scale: torch.Tensor,
    ln_bias: torch.Tensor,
    w_qkv: torch.Tensor,
    b_qkv: torch.Tensor,
    w_proj: torch.Tensor,
    b_proj: torch.Tensor,
    ls1: torch.Tensor,
    num_heads: int,
    scale: float,
    eps: float,
) -> torch.Tensor:
    """x + ls1 * proj(attention(qkv(LN(x)))): x (B, T, D); w_qkv (D, 3D) and
    w_proj (D, D) stored (in, out); ln_scale, ln_bias, b_proj, ls1 (D,) and
    b_qkv (3D,) in f32.

    CPU tensors run the plain version. CUDA tensors launch the K1 kernel
    (bf16 only; anything else raises) and add one to
    `slab_layer_block.launches`."""
    if x.device.type == "cpu":
        return slab_layer_reference(
            x, ln_scale, ln_bias, w_qkv, b_qkv, w_proj, b_proj, ls1,
            num_heads, scale, eps,
        )
    if x.device.type != "cuda":
        raise ValueError(f"no slab_layer_block for device {x.device}")
    check_half_layer_args(x, ln_scale, ln_bias, b_qkv, b_proj, ls1, num_heads, w_qkv, w_proj)
    from dinov2_tpu_torch.ops._kernels import check_status, slab_layer_lib

    lib = slab_layer_lib()
    b, t, d = x.shape
    qkv = torch.empty((b, t, 3 * d), dtype=x.dtype, device=x.device)
    attn = torch.empty((b, t, d), dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):  # the launches go to the current device
        code = lib.dinov2_slab_layer_bf16(
            x.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(), w_qkv.data_ptr(),
            b_qkv.data_ptr(), w_proj.data_ptr(), b_proj.data_ptr(), ls1.data_ptr(),
            qkv.data_ptr(), attn.data_ptr(), out.data_ptr(),
            b, t, d, num_heads, scale, eps, torch.cuda.current_stream(x.device).cuda_stream,
        )
    check_status(lib, code, "slab_layer_block")
    slab_layer_block.launches += 1
    return out


slab_layer_block.launches = 0  # kernel launches on CUDA tensors
