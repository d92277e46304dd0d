"""Multi-head self-attention (port of dinov2_tpu/ops/attention.py).

`vanilla_attention` is the plain attention core: the plain version of the
K1 to K4 kernels (ops/fused_attention.py, ops/flash_attention.py) and the
"vanilla" route. `self_attention` and `self_attention_block` run the
half-layer after LN1 (fused QKV, attention core, proj, LayerScale,
residual): models/vit.py takes them on the flash and vanilla routes and, on
the slab route, at the "proj" (K2) and "core" (K3) levels of
`ModelOptions.slab_fusion`. QuantLinear qkv and proj weights go through
ops/qmatmul.py::quant_matmul with `backend`.
"""

from __future__ import annotations

import functools

import torch

from dinov2_tpu_torch.models.params import QuantLinear
from dinov2_tpu_torch.ops.qmatmul import apply_linear, dequant_weight, refuse_quant_grad
from dinov2_tpu_torch.utils.logging import get_logger

# "auto" takes the flash kernel (K4) from this many tokens on: the JAX
# package's long-sequence threshold (ops/attention.py::resolve_attention_path)
# without its VMEM gates, which describe a TPU. It puts classify at 224 px
# (T=257) on the slab route and 518 px feature mode (T=1370) on flash, as the
# JAX package routes them for every preset.
FLASH_MIN_TOKENS = 1024
KERNEL_DTYPE = torch.bfloat16  # what the CUDA attention kernels (K1 to K4, K6, K8) take
KERNEL_HEAD_DIM = 64


@functools.cache
def _warn_vanilla_route(reason: str) -> None:
    """One warning per reason for the life of the process."""
    get_logger().warning(
        'attention route "auto": %s, which the CUDA attention kernels do not take (they take '
        "bf16 at head_dim 64); taking the plain PyTorch route (\"vanilla\")", reason,
    )


def vanilla_route_warnings() -> int:
    """How many reasons "auto" has given so far in this process for taking
    the plain route on a card: 0 says every "auto" there took a kernel."""
    return _warn_vanilla_route.cache_info().currsize


def split_heads(qkv: torch.Tensor, num_heads: int) -> tuple[torch.Tensor, ...]:
    """(B, T, 3D) fused qkv, laid out [q | k | v] along features ->
    three (B, T, H, hd) views."""
    b, t, three_d = qkv.shape
    hd = three_d // 3 // num_heads
    q, k, v = qkv.chunk(3, dim=-1)
    shape = (b, t, num_heads, hd)
    return q.reshape(shape), k.reshape(shape), v.reshape(shape)


def vanilla_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float
) -> torch.Tensor:
    """(B, T, H, hd) -> (B, T, H, hd): f32 scores and softmax, probabilities
    cast to v's dtype for the P.V product (f32 accumulate), output in v's
    dtype."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    weights = torch.softmax(scores * scale, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", weights.to(v.dtype), v)


def resolve_attention_path(
    flash, t: int, dtype: torch.dtype | None = None, head_dim: int | None = None,
    device_type: str | None = None,
) -> str:
    """The attention route, "slab" | "flash" | "vanilla", for T tokens of
    activations of `dtype` at `head_dim` on a device of `device_type`.

    True is the reference's `-fa` flag (the flash kernel), False the plain
    einsum; the three names select themselves, whatever the input (a kernel
    route with an input its kernel does not take raises in the wrapper).
    "auto" takes "flash" from FLASH_MIN_TOKENS tokens on and "slab" (the K1
    half-layer, which takes any T) below; on a CUDA device it takes "vanilla"
    instead for an input the kernels do not take (not bf16, or head_dim other
    than 64), with one warning, as the JAX package's resolver takes the item
    size and the backend into account and lands on its plain route. The
    arguments left None are not considered. Plain f32 attention on the card
    runs its products in full f32 (TF32 stays off)."""
    if flash is True:
        return "flash"
    if flash is False:
        return "vanilla"
    if flash in ("slab", "vanilla", "flash"):
        return flash
    if flash != "auto":
        raise ValueError(f"unknown attention route {flash!r}")
    if device_type == "cuda":
        if dtype is not None and dtype != KERNEL_DTYPE:
            _warn_vanilla_route(f"activations are {dtype}")
            return "vanilla"
        if head_dim is not None and head_dim != KERNEL_HEAD_DIM:
            _warn_vanilla_route(f"head_dim is {head_dim}")
            return "vanilla"
    return "flash" if t >= FLASH_MIN_TOKENS else "slab"


def self_attention(
    x: torch.Tensor,
    qkv_params: dict,
    proj_params: dict,
    num_heads: int,
    flash=False,
    backend: str = "auto",
) -> torch.Tensor:
    """fused QKV -> attention core -> output projection, (B, T, D) -> (B, T, D).

    The slab route runs the K3 core (ops/fused_attention.py::slab_attention)
    and the flash route K4 (flash_attention_slab); both read q/k/v straight
    out of the qkv slab, with no head transposes, and both carry their
    gradient (K3's recompute routes; K4 with lse and K6)."""
    b, t, d = x.shape
    scale = 1.0 / (d // num_heads) ** 0.5
    path = resolve_attention_path(flash, t, x.dtype, d // num_heads, x.device.type)
    qkv = apply_linear(x, qkv_params, backend=backend)
    if path == "slab":
        from dinov2_tpu_torch.ops.fused_attention import slab_attention

        out = slab_attention(qkv, num_heads, scale)
    elif path == "flash":
        from dinov2_tpu_torch.ops.flash_attention import flash_attention_slab

        out = flash_attention_slab(qkv, num_heads, scale)
    else:
        out = vanilla_attention(*split_heads(qkv, num_heads), scale).reshape(b, t, d)
    return apply_linear(out, proj_params, backend=backend)


def self_attention_block(
    x_res: torch.Tensor,
    x_norm: torch.Tensor,
    qkv_params: dict,
    proj_params: dict,
    ls1: torch.Tensor,
    num_heads: int,
    flash=False,
    backend: str = "auto",
    fuse_proj: bool = True,
    dequant_proj: bool = True,
) -> torch.Tensor:
    """x_res + ls1 * proj(attention(qkv(x_norm))), LayerScale and residual in
    x_res's dtype.

    On the slab route with `fuse_proj` and a proj bias, the core, proj, bias,
    LayerScale and residual are one call of the K2 kernel
    (ops/fused_attention.py::slab_attention_block) on the QKV GEMM's slab. A
    QuantLinear proj is dequantized into it when `dequant_proj` (the JAX
    package's rule: every DINOV2_TPU_QUANT_SLAB mode but "off"); otherwise,
    and without `fuse_proj`, the unfused order runs: the K3 core, then proj
    through apply_linear. Same numerics ordering either way."""
    b, t, d = x_norm.shape
    flash = resolve_attention_path(flash, t, x_norm.dtype, d // num_heads, x_norm.device.type)
    if fuse_proj and "bias" in proj_params and flash == "slab":
        proj_kernel = proj_params["kernel"]
        if isinstance(proj_kernel, QuantLinear):
            refuse_quant_grad("self_attention_block", x_res, x_norm, proj_params["bias"], ls1)
            proj_kernel = (
                dequant_weight(proj_kernel, x_norm.dtype).T.contiguous() if dequant_proj else None
            )
        if proj_kernel is not None:
            from dinov2_tpu_torch.ops.fused_attention import slab_attention_block

            qkv = apply_linear(x_norm, qkv_params, backend=backend)
            return slab_attention_block(
                x_res, qkv, proj_kernel, proj_params["bias"], ls1, num_heads,
                1.0 / (d // num_heads) ** 0.5,
            )
    out = self_attention(x_norm, qkv_params, proj_params, num_heads, flash=flash, backend=backend)
    return x_res + out * ls1.to(x_res.dtype)
