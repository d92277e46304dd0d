"""Flash attention, K4 (port of dinov2_tpu/ops/flash_attention.py, forward).

    flash_attention(q, k, v, scale)          (B, T, H, hd) -> (B, T, H, hd)
    flash_attention_slab(qkv, heads, scale)  (B, T, 3D)   -> (B, T, D)

On CUDA tensors both launch the hand-written kernel in
csrc/flash_attention.cu, which replaces the Pallas TPU kernels
`_attn_kernel_1kv` and `_attn_kernel`. It reads q, k and v through their
strides, so `flash_attention_slab` hands it the head views of the qkv slab
(`split_heads`) and no head transpose goes through HBM, for any head_dim
(the JAX package gates its slab variant to hd % 128 for a Mosaic rule only).
On CPU tensors both run the plain version, `vanilla_attention`'s math: f32
scores and softmax, probabilities rounded to the inputs' dtype for the P.V
product with f32 accumulation.

The kernel streams 64-key tiles with an exact online softmax (running row
max, f32 statistics), so the TPU kernels' block picking, their CLS-shift
core and its overflow rescue have no counterpart here. The `with_lse`
forward belongs to training and the K6 backward, which are not ported.
"""

from __future__ import annotations

import torch

from dinov2_tpu_torch.ops.attention import split_heads, vanilla_attention

HEAD_DIM = 64  # the kernel's head_dim: every DINOv2 preset has it


def _check_cuda_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> tuple[int, ...]:
    """What the kernel takes; returns the (batch, token, head) strides in
    elements that q, k and v share."""
    for name, tensor in (("q", q), ("k", k), ("v", v)):
        if tensor.dtype != torch.bfloat16:
            raise NotImplementedError(
                f"the CUDA flash attention kernel takes bf16, got {name} {tensor.dtype}"
            )
        if tensor.dim() != 4 or tensor.shape != q.shape:
            raise ValueError(
                f"q, k and v must share one (B, T, H, hd) shape, got {name} {tuple(tensor.shape)}"
            )
        if tensor.device != q.device:
            raise ValueError(f"{name} is on {tensor.device}, q on {q.device}")
    if q.shape[-1] != HEAD_DIM:
        raise NotImplementedError(
            f"the CUDA flash attention kernel needs head_dim {HEAD_DIM}, got {q.shape[-1]}"
        )

    def strides(tensor):
        # a stride over a dimension of size 1 is never used: normalize it
        return tuple(s if n > 1 else 0 for s, n in zip(tensor.stride(), tensor.shape))

    shared = strides(q)
    for name, tensor in (("q", q), ("k", k), ("v", v)):
        if strides(tensor) != shared or shared[3] != 1:
            raise ValueError(
                f"q, k and v must share their strides with unit stride over head_dim, "
                f"got {name} {tensor.stride()} against q {q.stride()}"
            )
        if any(s % 8 for s in shared[:3]) or tensor.data_ptr() % 16:
            raise ValueError(
                f"{name}: strides {tensor.stride()} must be multiples of 8 elements "
                "and the data 16-byte aligned"
            )
    return shared[:3]


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float
) -> torch.Tensor:
    """softmax(q kᵀ · scale) v per (image, head): (B, T, H, hd) each ->
    (B, T, H, hd), contiguous.

    CPU tensors run the plain version. CUDA tensors launch the K4 kernel
    (bf16 and head_dim 64 only; anything else raises) and add one to
    `flash_attention.launches`. q, k and v may be strided views (e.g. of a
    qkv slab); they are never copied."""
    if q.device.type == "cpu":
        return vanilla_attention(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"no flash_attention for device {q.device}")
    batch_stride, token_stride, head_stride = _check_cuda_args(q, k, v)
    b, t, heads, hd = q.shape
    out = torch.empty((b, t, heads, hd), dtype=q.dtype, device=q.device)
    from dinov2_tpu_torch.ops._kernels import check_status, flash_attention_lib

    lib = flash_attention_lib()
    with torch.cuda.device(q.device):  # the launch goes to the current device
        code = lib.dinov2_flash_attention_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, t, heads,
            batch_stride, token_stride, head_stride, scale,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    check_status(lib, code, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0  # kernel launches on CUDA tensors, from either entry


def flash_attention_slab(qkv: torch.Tensor, num_heads: int, scale: float) -> torch.Tensor:
    """(B, T, 3D) fused qkv slab, laid out [q | k | v] -> (B, T, D): the K4
    kernel on the slab's head views, with no transposes in HBM."""
    b, t, three_d = qkv.shape
    q, k, v = split_heads(qkv, num_heads)
    return flash_attention(q, k, v, scale).reshape(b, t, three_d // 3)
