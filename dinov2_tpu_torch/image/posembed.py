"""Positional-embedding interpolation (port of dinov2_tpu/image/posembed.py).

The CLS row is copied verbatim; the patch grid is resized bicubically
(OpenCV INTER_CUBIC); the resize is skipped when the new patch COUNT equals
the model's count (the reference compares counts, not shapes).
"""

from __future__ import annotations

import torch

from dinov2_tpu_torch.image.resize import resize_bicubic


def interpolate_pos_embed(
    pos_embed: torch.Tensor, orig_grid: int, new_hw: tuple[int, int]
) -> torch.Tensor:
    """(M*M+1, D) -> (h*w+1, D) for the runtime patch grid (h, w)."""
    h, w = new_hw
    m = orig_grid
    if h * w == m * m:  # reference early-return on equal counts
        return pos_embed
    d = pos_embed.shape[-1]
    grid = resize_bicubic(pos_embed.narrow(0, 1, m * m).reshape(m, m, d), h, w)
    return torch.cat([pos_embed.narrow(0, 0, 1), grid.reshape(h * w, d)], dim=0)
