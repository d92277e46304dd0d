"""The one generator of the benchmark's inputs, driven by a traffic file.

A pool of `pool` batches is made in set-up and the window cycles through
it. Each batch holds `batch` uint8 RGB images (H, W, 3) as separate host
arrays, as a decoder hands them over: `images` lists each size and how many
of the batch have it, the same counts in every batch, in an order shuffled
from the seed. Pixels look like a photograph more than noise: a coarse
random field, one value a `cell` x `cell` square, smoothed by a bilinear
resize, plus Gaussian noise of `noise` levels. A training mix adds labels
uniform over the classes.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from portbench import seeds


def _pixels(n: int, h: int, w: int, spec: dict, gen: torch.Generator, device) -> torch.Tensor:
    cell = spec["cell"]
    coarse = torch.rand(n, 3, h // cell + 2, w // cell + 2, generator=gen, device=device)
    img = F.interpolate(coarse, size=(h, w), mode="bilinear", align_corners=False) * 255.0
    img = img + torch.randn(n, 3, h, w, generator=gen, device=device) * spec["noise"]
    return img.clamp(0, 255).round().to(torch.uint8).permute(0, 2, 3, 1).contiguous()


def image_pool(traffic: dict, seed: int, device) -> list[list[np.ndarray]]:
    """`pool` batches of images, each a list of host arrays."""
    gen = torch.Generator(device=device).manual_seed(seeds.derive(seed, "images"))
    if sum(s["count"] for s in traffic["images"]) != traffic["batch"]:
        raise ValueError("the traffic's image counts do not add up to its batch")
    pool = []
    for _ in range(traffic["pool"]):
        images = []
        for size in traffic["images"]:
            block = _pixels(size["count"], size["height"], size["width"], traffic["pixels"],
                            gen, device).cpu().numpy()
            images += list(block)
        order = torch.randperm(len(images), generator=gen, device=device).cpu().tolist()
        pool.append([images[i].copy() for i in order])
    return pool


def train_pool(traffic: dict, seed: int, num_classes: int, device) -> list[tuple]:
    """`pool` (images (B, H, W, 3) uint8, labels (B,) int64) host batches,
    as cli.train's loader gives them."""
    label_rng = seeds.rng(seed, "labels")
    return [
        (np.stack(images), label_rng.integers(0, num_classes, len(images)))
        for images in image_pool(traffic, seed, device)
    ]
