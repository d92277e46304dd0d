"""Flash attention, K4 forward and K6 backward (port of
dinov2_tpu/ops/flash_attention.py).

    flash_attention(q, k, v, scale)          (B, T, H, hd) -> (B, T, H, hd)
    flash_attention_slab(qkv, heads, scale)  (B, T, 3D)   -> (B, T, D)

On CUDA tensors both launch the hand-written kernel in
csrc/flash_attention.cu, which replaces the Pallas TPU kernels
`_attn_kernel_1kv` and `_attn_kernel`: in bf16 its wgmma tile loop, in f32
its f32 entries (csrc/f32_attention.cuh, full f32 products on the CUDA
cores, P kept in f32 as the JAX kernels keep it). It reads q, k and v through their
strides, so `flash_attention_slab` hands it the head views of the qkv slab
(`split_heads`) and no head transpose goes through HBM, for any head_dim
(the JAX package gates its slab variant to hd % 128 for a Mosaic rule only).
On CPU tensors both run the plain version, `vanilla_attention`'s math: f32
scores and softmax, probabilities rounded to the inputs' dtype for the P.V
product with f32 accumulation.

The kernel streams 64-key tiles with an exact online softmax (running row
max, f32 statistics), so the TPU kernels' block picking, their CLS-shift
core and its overflow rescue have no counterpart here. In bf16 K4 and K6 run
their products as wgmma on 128-byte-swizzled shared tiles filled by a cp.async
ring (csrc/wgmma_tiles.cuh); a block's rows (64 or 128) are picked by shape
in the C entry points (`kernel_tile_rows` reports them).

Both are differentiable, as the JAX functions are through their custom_vjp.
When an input requires grad the forward is the kernel's `with_lse` variant
(`flash_forward_lse`: the same `out` bit for bit, and the f32 row logsumexp
of the scaled scores, (B, H, T)), which saves q, k, v, out and lse; the
backward is K6 (`flash_backward`, csrc/flash_backward.cu), which replaces
`_dkv_kernel` and `_dq_kernel`: no (T, T) tensor reaches HBM, and the slab
variant's gradient is written as one (B, T, 3D) slab through strides. On CPU
tensors the same Functions run the plain versions `flash_forward_reference`
and `flash_backward_reference`, which follow the kernels' math from lse and
delta = rowsum(dO * O), not autograd through `vanilla_attention`.

Rounding contract of the backward: p = exp(s * scale - lse) and dS =
p * (dO v^T - delta) * scale are computed in f32 and rounded to the inputs'
dtype before the products p^T dO, dS^T q and dS k, which accumulate in f32
(the JAX kernels multiply them as f32; tensor cores take bf16 operands, as
the forward's P.V does). In f32 nothing rounds and the plain version meets
the JAX kernels'; K6's f32 variant (csrc/f32_backward.cuh) rounds nowhere
either: its products are 3xTF32 on the tensor cores (csrc/tf32x3.cuh),
f32-accurate. dS carries `scale`; dQ and dK take no second one. K6 is
two deterministic kernels (dK/dV over query tiles, dQ over key tiles) and a
delta prologue, no atomics: the same inputs give the same bits every run,
in f32 too.
Each wrapper counts its kernel calls in `.launches` (bf16) and
`.f32_launches` (f32).
"""

from __future__ import annotations

from functools import partial

import torch
from torch.autograd.function import once_differentiable

from dinov2_tpu_torch.ops._library import check_device, count_launch, define
from dinov2_tpu_torch.ops.attention import KERNEL_DTYPES, split_heads, vanilla_attention
from dinov2_tpu_torch.ops.qmatmul import needs_grad

HEAD_DIM = 64  # the kernels' head_dim: every DINOv2 preset has it


def kernel_tile_rows(b: int, t: int, heads: int) -> dict:
    """Rows a block of the variants the C entries take at this shape:
    {"forward": K4's query rows, "backward_keys": the dK/dV kernel's,
    "backward_queries": the dQ kernel's}. Builds the libraries, so it needs
    the card's machine. A report for checks and scripts: no path calls it."""
    from dinov2_tpu_torch.ops._kernels import flash_attention_lib, flash_backward_lib

    # the two report entries take and return C ints, ctypes' defaults
    keys, queries = divmod(flash_backward_lib().dinov2_flash_backward_rows(), 1000)
    return {
        "forward": flash_attention_lib().dinov2_flash_attention_query_rows(b, t, heads),
        "backward_keys": keys,
        "backward_queries": queries,
    }


def flash_forward_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of the `with_lse` forward: (out, lse) with
    out `vanilla_attention`'s and lse[b, h, i] = logsumexp_k(scale * q_i . k_k)
    in f32, (B, H, T)."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    lse = torch.logsumexp(scores, dim=-1)
    weights = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", weights.to(v.dtype), v), lse


def flash_backward_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor, lse: torch.Tensor,
    g: torch.Tensor, scale: float,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of K6: (dq, dk, dv) from q, k, v, the
    forward's output o and row logsumexp lse (B, H, T), and the output's
    gradient g, with the rounding contract of the module docstring."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    p = torch.exp(s - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", g.float(), v.float())
    delta = (g.float() * o.float()).sum(dim=-1).permute(0, 2, 1)  # (B, H, T)
    ds = p * (dp - delta[..., None]) * scale
    p, ds = p.to(q.dtype), ds.to(q.dtype)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, g.to(q.dtype))
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k)
    return dq, dk, dv


def _check_cuda_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     names=("q", "k", "v"), aligned: bool = True) -> tuple[int, ...]:
    """What the kernels take of three tensors read (or written) through one
    set of strides, all bf16 or all f32; returns the (batch, token, head)
    strides in elements that they share (multiples of 16 bytes). `aligned`
    False skips the data pointers' alignment (a tensor with no storage: the
    operators' fake implementations)."""
    named = tuple(zip(names, (q, k, v)))
    for name, tensor in named:
        if tensor.dtype not in KERNEL_DTYPES:
            raise NotImplementedError(
                f"the CUDA flash attention kernel takes bf16 or f32, got {name} {tensor.dtype}"
            )
        if tensor.dtype != q.dtype:
            raise ValueError(f"{name} is {tensor.dtype}, {names[0]} {q.dtype}")
        if tensor.dim() != 4 or tensor.shape != q.shape:
            raise ValueError(
                f"{', '.join(names)} must share one (B, T, H, hd) shape, "
                f"got {name} {tuple(tensor.shape)}"
            )
        if tensor.device != q.device:
            raise ValueError(f"{name} is on {tensor.device}, {names[0]} on {q.device}")
    if q.shape[-1] != HEAD_DIM:
        raise NotImplementedError(
            f"the CUDA flash attention kernel needs head_dim {HEAD_DIM}, got {q.shape[-1]}"
        )

    def strides(tensor):
        # a stride over a dimension of size 1 is never used: normalize it
        return tuple(s if n > 1 else 0 for s, n in zip(tensor.stride(), tensor.shape))

    shared = strides(q)
    step = 16 // q.element_size()  # elements in 16 bytes
    for name, tensor in named:
        if strides(tensor) != shared or shared[3] != 1:
            raise ValueError(
                f"{', '.join(names)} must share their strides with unit stride over head_dim, "
                f"got {name} {tensor.stride()} against {names[0]} {q.stride()}"
            )
        if any(s % step for s in shared[:3]) or (aligned and tensor.data_ptr() % 16):
            raise ValueError(
                f"{name}: strides {tensor.stride()} must be multiples of {step} elements "
                "and the data 16-byte aligned"
            )
    return shared[:3]


def _launch_forward(q, k, v, scale: float, with_lse: bool):
    """One K4 launch on CUDA tensors: out, or (out, lse) from the kernel's
    `with_lse` variant, bf16 or f32. Adds one to `flash_attention.launches`
    or `.f32_launches`."""
    batch_stride, token_stride, head_stride = _check_cuda_args(q, k, v)
    b, t, heads, hd = q.shape
    out = torch.empty((b, t, heads, hd), dtype=q.dtype, device=q.device)
    from dinov2_tpu_torch.ops._kernels import check_status, entry, flash_attention_lib

    lib = flash_attention_lib()
    f32 = q.dtype == torch.float32
    shape_and_strides = (b, t, heads, batch_stride, token_stride, head_stride, scale)
    with torch.cuda.device(q.device):  # the launch goes to the current device
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if with_lse:
            lse = torch.empty((b, heads, t), dtype=torch.float32, device=q.device)
            code = entry(lib, "dinov2_flash_attention_lse_bf16", f32)(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
                *shape_and_strides, stream,
            )
        else:
            code = entry(lib, "dinov2_flash_attention_bf16", f32)(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                *shape_and_strides, stream,
            )
    check_status(lib, code, "flash_attention")
    count_launch(flash_attention, q.dtype)
    return (out, lse) if with_lse else out


def flash_forward_lse(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """The training forward: (out, lse), out as `flash_attention`'s bit for
    bit and lse the (B, H, T) f32 row logsumexp of the scaled scores. CPU
    tensors run `flash_forward_reference`; CUDA tensors launch the K4
    kernel's `with_lse` variant (counted in `flash_attention.launches`, or
    `.f32_launches` in f32);
    both through the operator `dinov2_tpu_torch::flash_attention_lse`."""
    check_device(q, "flash_attention")
    return _FLASH_LSE_OP(q, k, v, scale)


def _forward_fake(q, k, v, scale: float) -> torch.Tensor:
    if q.device.type == "cuda":
        _check_cuda_args(q, k, v, aligned=False)
    return q.new_empty(q.shape)


def _forward_lse_fake(q, k, v, scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    b, t, heads, _ = q.shape
    return _forward_fake(q, k, v, scale), q.new_empty((b, heads, t), dtype=torch.float32)


def _forward_lse_cpu(q, k, v, scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    out, lse = flash_forward_reference(q, k, v, scale)
    return out.contiguous(), lse


def flash_backward(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor, lse: torch.Tensor,
    g: torch.Tensor, scale: float, into: tuple[torch.Tensor, ...] | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of softmax(q kᵀ · scale) v from the saved forward: o and
    lse as `flash_forward_lse` returns them, g the gradient of o. `into`
    gives three (B, T, H, hd) tensors (e.g. the head views of one gradient
    slab) to write them to; otherwise they are new and contiguous.

    CPU tensors run `flash_backward_reference`. CUDA tensors launch the K6
    kernels (bf16 or f32 and head_dim 64 only; anything else raises) and add
    one to `flash_backward.launches` (bf16) or `.f32_launches` (f32); q, k,
    v and the outputs may be strided views and are never copied."""
    if q.device.type == "cpu":
        grads = flash_backward_reference(q, k, v, o, lse, g, scale)
        if into is None:
            return grads
        for dst, src in zip(into, grads):
            dst.copy_(src)
        return tuple(into)
    if q.device.type != "cuda":
        raise ValueError(f"no flash_backward for device {q.device}")
    strides = _check_cuda_args(q, k, v)
    b, t, heads, hd = q.shape
    g = g.contiguous()
    for name, tensor in (("o", o), ("g", g)):
        if (tensor.dtype != q.dtype or tensor.shape != q.shape
                or tensor.device != q.device or not tensor.is_contiguous()
                or tensor.data_ptr() % 16):
            raise ValueError(
                f"{name} must be a contiguous {q.dtype} {tuple(q.shape)} tensor on {q.device}, "
                f"got {tensor.dtype} {tuple(tensor.shape)} on {tensor.device}"
            )
    if (lse.dtype != torch.float32 or tuple(lse.shape) != (b, heads, t)
            or lse.device != q.device or not lse.is_contiguous()):
        raise ValueError(
            f"lse must be a contiguous f32 {(b, heads, t)} tensor on {q.device}, got "
            f"{lse.dtype} {tuple(lse.shape)} on {lse.device}"
        )
    if into is None:
        into = tuple(torch.empty_like(o) for _ in range(3))
    out_strides = _check_cuda_args(*into, names=("dq", "dk", "dv"))
    if into[0].shape != q.shape or into[0].dtype != q.dtype:
        raise ValueError(
            f"dq, dk, dv must be {q.dtype} {tuple(q.shape)}, got {into[0].dtype} "
            f"{tuple(into[0].shape)}"
        )
    if q.numel() == 0:
        return tuple(into)
    delta = torch.empty((b, heads, t), dtype=torch.float32, device=q.device)
    from dinov2_tpu_torch.ops._kernels import check_status, entry, flash_backward_lib

    lib = flash_backward_lib()
    launch = entry(lib, "dinov2_flash_backward_bf16", q.dtype == torch.float32)
    with torch.cuda.device(q.device):  # the launches go to the current device
        code = launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), g.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), *(d.data_ptr() for d in into),
            b, t, heads, *strides, *out_strides, scale,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    check_status(lib, code, "flash_backward")
    count_launch(flash_backward, q.dtype)
    return tuple(into)


flash_backward.launches = 0  # bf16 K6 calls on CUDA tensors (three kernel launches each)
flash_backward.f32_launches = 0  # f32 K6 calls on CUDA tensors


class _FlashAttention(torch.autograd.Function):
    """flash_attention with its gradient: the `with_lse` forward saves q, k,
    v, out and lse; the backward is K6."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        out, lse = flash_forward_lse(q, k, v, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        return (*flash_backward(q, k, v, out, lse, g, ctx.scale), None)


class _FlashAttentionSlab(torch.autograd.Function):
    """flash_attention_slab with its gradient as one (B, T, 3D) slab: K6
    writes dq, dk and dv into the slab's head views."""

    @staticmethod
    def forward(ctx, qkv, num_heads, scale):
        b, t, three_d = qkv.shape
        out, lse = flash_forward_lse(*split_heads(qkv, num_heads), scale)
        ctx.save_for_backward(qkv, out, lse)
        ctx.num_heads, ctx.scale = num_heads, scale
        return out.reshape(b, t, three_d // 3)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        qkv, out, lse = ctx.saved_tensors
        d_qkv = torch.empty(qkv.shape, dtype=qkv.dtype, device=qkv.device)
        flash_backward(
            *split_heads(qkv, ctx.num_heads), out, lse, g.reshape(out.shape), ctx.scale,
            into=split_heads(d_qkv, ctx.num_heads),
        )
        return d_qkv, None, None


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float
) -> torch.Tensor:
    """softmax(q kᵀ · scale) v per (image, head): (B, T, H, hd) each ->
    (B, T, H, hd), contiguous.

    CPU tensors run the plain version. CUDA tensors launch the K4 kernel
    (bf16 or f32 and head_dim 64 only; anything else raises) and add one to
    `flash_attention.launches` (bf16) or `.f32_launches` (f32). q, k and v
    may be strided views (e.g. of a qkv slab); they are never copied. Where
    an input requires grad the result carries the gradient of the module
    docstring (the `with_lse` forward, K6 backward). Without grad both go through the operator
    `dinov2_tpu_torch::flash_attention` (ops/_library.py)."""
    if needs_grad(q, k, v):
        return _FlashAttention.apply(q, k, v, scale)
    check_device(q, "flash_attention")
    return _FLASH_OP(q, k, v, scale)


flash_attention.launches = 0  # bf16 K4 launches on CUDA tensors, any entry, with lse or without
flash_attention.f32_launches = 0  # f32 K4 launches likewise
_FLASH_OP = define(
    "flash_attention(Tensor q, Tensor k, Tensor v, float scale) -> Tensor",
    lambda q, k, v, scale: vanilla_attention(q, k, v, scale).contiguous(),
    partial(_launch_forward, with_lse=False), _forward_fake,
)
_FLASH_LSE_OP = define(
    "flash_attention_lse(Tensor q, Tensor k, Tensor v, float scale) -> (Tensor, Tensor)",
    _forward_lse_cpu, partial(_launch_forward, with_lse=True), _forward_lse_fake,
)


def flash_attention_slab(qkv: torch.Tensor, num_heads: int, scale: float) -> torch.Tensor:
    """(B, T, 3D) fused qkv slab, laid out [q | k | v] -> (B, T, D): the K4
    kernel on the slab's head views, with no transposes in HBM; differentiable
    as `flash_attention` is, the gradient one (B, T, 3D) slab."""
    if needs_grad(qkv):
        return _FlashAttentionSlab.apply(qkv, num_heads, scale)
    b, t, three_d = qkv.shape
    q, k, v = split_heads(qkv, num_heads)
    return flash_attention(q, k, v, scale).reshape(b, t, three_d // 3)
