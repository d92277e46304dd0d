"""OpenCV-compatible bicubic resize as two f32 matmuls (port of
dinov2_tpu/image/resize.py).

cv2.resize(INTER_CUBIC) on float images uses the A = -0.75 cubic kernel,
sample centers at (i+0.5)*scale-0.5, replicated borders and no antialiasing
(quirk Q2). A separable resize is linear, so each axis is a (dst, src)
weight matrix built in numpy; `_cubic_coeffs` and `cubic_resize_matrix` are
copied verbatim from the JAX package, whose module imports jax.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from dinov2_tpu_torch.ops.qmatmul import set_cuda_matmul_precision

_A = -0.75  # OpenCV's fixed bicubic coefficient


def _cubic_coeffs(t: np.ndarray) -> np.ndarray:
    """OpenCV interpolateCubic: 4 tap weights for fractional offset t in [0,1)."""
    w0 = ((_A * (t + 1) - 5 * _A) * (t + 1) + 8 * _A) * (t + 1) - 4 * _A
    w1 = ((_A + 2) * t - (_A + 3)) * t * t + 1
    w2 = ((_A + 2) * (1 - t) - (_A + 3)) * (1 - t) * (1 - t) + 1
    w3 = 1.0 - w0 - w1 - w2
    return np.stack([w0, w1, w2, w3], axis=-1)


@functools.lru_cache(maxsize=256)
def cubic_resize_matrix(src: int, dst: int) -> np.ndarray:
    """(dst, src) float32 matrix M with out = M @ in, matching cv2 INTER_CUBIC."""
    scale = src / dst
    fx = (np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5
    sx = np.floor(fx).astype(np.int64)
    t = fx - sx
    # border handling: out-of-range taps are clamped to the edge pixel
    # (BORDER_REPLICATE); the fractional offset t is kept as-is.
    coeffs = _cubic_coeffs(t)  # (dst, 4)
    m = np.zeros((dst, src), dtype=np.float64)
    rows = np.arange(dst)
    for k in range(4):
        idx = np.clip(sx - 1 + k, 0, src - 1)
        np.add.at(m, (rows, idx), coeffs[:, k])
    return m.astype(np.float32)


def resize_bicubic(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """cv2.resize(..., INTER_CUBIC) on float images; img is (..., H, W, C).

    On CUDA the two f32 matmuls run without TF32 (set_cuda_matmul_precision),
    as the JAX code's Precision.HIGHEST asks."""
    if img.is_cuda:
        set_cuda_matmul_precision()
    h, w = img.shape[-3], img.shape[-2]
    mh = torch.from_numpy(cubic_resize_matrix(h, out_h)).to(img.device)
    mw = torch.from_numpy(cubic_resize_matrix(w, out_w)).to(img.device)
    x = img.float()
    x = torch.einsum("Oh,...hwc->...Owc", mh, x)
    return torch.einsum("Ow,...hwc->...hOc", mw, x)
