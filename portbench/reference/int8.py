"""W8A8 int8 as the program documents it, in plain float32: each rule
returns the values its codes stand for (codes times scale), so that a plain
f32 product of them is the int8 product rescaled.

  - a weight, per output row: s = max(absmax / qmax, 1e-12), codes
    rint(w / s) (round half to even) clipped to +-qmax;
  - an activation, per row (last axis): sx = max(absmax, 1e-12) *
    f32(1 / qmax), codes round-half-even(x / sx), which |x / sx| <= qmax
    keeps in range.

qmax is 127 for int8; a smaller one (31: 6-bit codes, 7: int4) is a
control of the comparison, never the reference.
"""

from __future__ import annotations

import torch

INT8_MAX = 127
SCALE_FLOOR = 1e-12


def weight_rows(w: torch.Tensor, qmax: int = INT8_MAX) -> torch.Tensor:
    """(out, in) -> the float32 values of its per-row codes."""
    w = w.float()
    s = torch.clamp_min(w.abs().amax(dim=1, keepdim=True) / qmax, SCALE_FLOOR)
    return torch.clamp(torch.round(w / s), -qmax, qmax) * s


def activation_rows(x: torch.Tensor, qmax: int = INT8_MAX) -> torch.Tensor:
    """(..., K) -> the float32 values of its per-row codes."""
    x = x.float()
    step = torch.tensor(1.0 / qmax, dtype=torch.float32, device=x.device)
    sx = torch.clamp_min(x.abs().amax(dim=-1, keepdim=True), SCALE_FLOOR) * step
    return torch.round(x / sx) * sx


def covers(linear: str, names) -> bool:
    """Whether the linear `linear` (a GGUF name without .weight) is one of
    `names`, each a whole name or its last dotted parts ("mlp.fc1" covers
    every layer's fc1)."""
    return any(linear == n or linear.endswith("." + n) for n in names)
