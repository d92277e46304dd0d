"""Plain multi-head attention core (port of dinov2_tpu/ops/attention.py:18-46).

This is the attention that the K1 kernel's plain version uses
(ops/fused_attention.py::slab_layer_reference).
"""

from __future__ import annotations

import torch


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
