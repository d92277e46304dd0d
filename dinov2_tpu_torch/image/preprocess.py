"""Classify preprocessing on the tensor's device (port of
dinov2_tpu/image/preprocess.py).

float/255 -> bicubic resize to 256x256 -> center-crop 224 -> ImageNet
normalize; the 256/224 sizes are fixed whatever the model's img_size
(quirk Q9). Inputs are RGB (..., H, W, 3) uint8 or float tensors.
"""

from __future__ import annotations

import torch

from dinov2_tpu_torch.models.config import IMAGENET_DEFAULT_MEAN, IMAGENET_DEFAULT_STD
from dinov2_tpu_torch.image.resize import resize_bicubic

CLASSIFY_RESIZE = 256
CLASSIFY_CROP = 224


def normalize(img: torch.Tensor) -> torch.Tensor:
    """(..., H, W, 3) float RGB in [0,1] -> ImageNet-standardized."""
    mean = torch.tensor(IMAGENET_DEFAULT_MEAN, dtype=torch.float32, device=img.device)
    std = torch.tensor(IMAGENET_DEFAULT_STD, dtype=torch.float32, device=img.device)
    return (img - mean) / std


def to_float(img: torch.Tensor) -> torch.Tensor:
    if img.dtype == torch.uint8:
        return img.float() / 255.0
    return img.float()


def classify_preprocess(img: torch.Tensor) -> torch.Tensor:
    """uint8/float RGB (..., H, W, 3) -> (..., 224, 224, 3) normalized f32."""
    x = resize_bicubic(to_float(img), CLASSIFY_RESIZE, CLASSIFY_RESIZE)
    off = (CLASSIFY_RESIZE - CLASSIFY_CROP) // 2
    x = x[..., off : off + CLASSIFY_CROP, off : off + CLASSIFY_CROP, :]
    return normalize(x)
