"""PCA feature visualization (port of dinov2_tpu/image/pca.py; the
reference's cv::PCA path).

A 3-component PCA over the patch tokens of one image (rows = patches), the
projection min-max normalized over the WHOLE projected matrix to u8 (global,
not per component, as NORM_MINMAX), reshaped to the patch grid as a
3-channel image and nearest-upscaled. Each component's sign is made
canonical (its largest-magnitude loading is positive, quirk Q11), so the
output does not depend on the eigensolver's sign choice.

Everything runs on the tokens' device in f32; the eigendecomposition is
`torch.linalg.eigh` (the JAX package computes it outside any Pallas kernel
too). The functions take any leading batch dimensions, so a batch of images
gets one batched eigh with a basis per image and no Python loop.
"""

from __future__ import annotations

import numpy as np
import torch

from dinov2_tpu_torch.image.resize import resize_nearest


def pca_project(patch_tokens: torch.Tensor, n_components: int = 3) -> torch.Tensor:
    """(..., N, D) -> (..., N, n_components) PCA projection with sign
    canonicalization; f32 covariance, top components first."""
    x = patch_tokens.float()
    xc = x - x.mean(dim=-2, keepdim=True)
    cov = xc.transpose(-1, -2) @ xc
    _, eigvecs = torch.linalg.eigh(cov)  # ascending eigenvalues
    comps = eigvecs[..., -n_components:].flip(-1)  # (..., D, k), top-k first
    # canonical sign: the largest-|loading| entry of each component is positive
    idx = comps.abs().argmax(dim=-2, keepdim=True)
    comps = comps * torch.sign(comps.gather(-2, idx))
    return xc @ comps


def pca_to_u8_grid(projected: torch.Tensor, grid_hw: tuple[int, int]) -> torch.Tensor:
    """(..., N, 3) -> (..., h, w, 3) uint8 via min-max normalization over each
    image's whole projection (NORM_MINMAX), rounded half to even."""
    h, w = grid_hw
    lo = projected.amin(dim=(-2, -1), keepdim=True)
    hi = projected.amax(dim=(-2, -1), keepdim=True)
    scaled = (projected - lo) / torch.clamp(hi - lo, min=1e-12) * 255.0
    u8 = torch.clamp(torch.round(scaled), 0, 255).to(torch.uint8)
    return u8.reshape(*projected.shape[:-2], h, w, 3)


def pca_visualization(
    patch_tokens: torch.Tensor, grid_hw: tuple[int, int], out_hw: tuple[int, int]
) -> torch.Tensor:
    """(N, D) -> (out_h, out_w, 3) uint8: project -> u8 grid -> nearest upscale."""
    grid = pca_to_u8_grid(pca_project(patch_tokens, 3), grid_hw)
    return resize_nearest(grid, out_hw[0], out_hw[1])


def pca_visualization_batch(
    patch_tokens: torch.Tensor,
    grid_hw: tuple[int, int],
    out_hw: tuple[int, int] | None = None,
) -> torch.Tensor:
    """(B, N, D) -> (B, h, w, 3) uint8, each image with its own PCA basis and
    min-max range, as the reference's per-image cv::PCA.

    out_hw=None (or == grid_hw) skips the nearest upscale and returns
    patch-grid-sized images, so the device-to-host copy is ~p² smaller and
    the host resizes (resize_nearest_host)."""
    grid = pca_to_u8_grid(pca_project(patch_tokens, 3), grid_hw)
    if out_hw is None or tuple(out_hw) == tuple(grid_hw):
        return grid
    return resize_nearest(grid, out_hw[0], out_hw[1])


def resize_nearest_host(grid_u8, out_h: int, out_w: int) -> np.ndarray:
    """(..., h, w, 3) uint8 -> (..., out_h, out_w, 3) with cv2 INTER_NEAREST
    semantics (source index = floor(dst * src/dst), clamped) on the host: the
    reference resizes the grid-sized visualization straight to the original
    image size, generally a non-integer factor."""
    grid_u8 = np.asarray(grid_u8)
    h, w = grid_u8.shape[-3], grid_u8.shape[-2]
    iy = np.minimum((np.arange(out_h) * (h / out_h)).astype(np.int64), h - 1)
    ix = np.minimum((np.arange(out_w) * (w / out_w)).astype(np.int64), w - 1)
    return grid_u8[..., iy[:, None], ix[None, :], :]
