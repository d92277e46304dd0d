"""ggml's q4_0 format: blocks of 32 values along a row, an f16 scale d and
32 four-bit codes q, the value d * (q - 8).

`encode` is quantize_row_q4_0_ref of ggml: d = (the value of largest
magnitude, sign kept) / -8, q = min(15, trunc(x / d + 8.5)) with 1 / d taken
in f32 before d is rounded to f16. Code j of a block sits in the low nibble
of byte j, code j + 16 in its high nibble."""

from __future__ import annotations

import numpy as np
import torch

BLOCK = 32


def encode(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(out, in) float32 -> d (out, in/32) f16 and qs (out, in/32, 16) u8."""
    out, k = w.shape
    blocks = w.float().reshape(-1, BLOCK)
    peak = blocks.gather(1, blocks.abs().argmax(dim=1, keepdim=True)).squeeze(1)
    d = peak / -8.0
    inv = torch.where(d != 0, 1.0 / d, torch.zeros_like(d))
    q = torch.clamp(torch.trunc(blocks * inv[:, None] + 8.5), max=15).to(torch.uint8)
    qs = q[:, :16] | (q[:, 16:] << 4)
    return d.to(torch.float16).reshape(out, k // BLOCK), qs.reshape(out, k // BLOCK, 16)


def to_bytes(d: torch.Tensor, qs: torch.Tensor) -> np.ndarray:
    """The blocks as ggml lays them out: 2 bytes of d, then the 16 of qs."""
    n = d.numel()
    raw = np.empty((n, 2 + 16), dtype=np.uint8)
    raw[:, :2] = d.reshape(n).cpu().numpy().view(np.uint8).reshape(n, 2)
    raw[:, 2:] = qs.reshape(n, 16).cpu().numpy()
    return raw.ravel()


def decode(d: torch.Tensor, qs: torch.Tensor) -> torch.Tensor:
    """d (out, nb) f16, qs (out, nb, 16) u8 -> (out, nb * 32) float32."""
    q = torch.cat([qs & 0xF, qs >> 4], dim=-1).float() - 8.0
    return (q * d.float().unsqueeze(-1)).reshape(d.shape[0], -1)
