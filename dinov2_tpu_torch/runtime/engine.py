"""Inference engine: load -> classify (port of dinov2_tpu/runtime/engine.py).

Classify mode only. Batches are padded on the host to a power of two (the
JAX engine's bucket, which bounds its jit cache; here it keeps the kernels'
shapes to a few), preprocessed on the device, and run through one forward.
Mixed-size images are preprocessed per size group and merged into one
forward batch. Feature mode and PCA are not ported yet (ROADMAP.md).

`device="cuda"` runs the K1 CUDA kernel and needs a GPU: with none, the
constructor raises; it never falls back to the CPU. `device="cpu"` runs
the plain PyTorch versions.
"""

from __future__ import annotations

from pathlib import Path
from typing import Sequence

import numpy as np
import torch

from dinov2_tpu_torch.image.preprocess import classify_preprocess
from dinov2_tpu_torch.models.params import load_params
from dinov2_tpu_torch.models.vit import DinoViT, ModelOptions
from dinov2_tpu_torch.ops.qmatmul import set_cuda_matmul_precision
from dinov2_tpu_torch.utils.timing import time_blocked

_NOT_PORTED = "is not ported to dinov2_tpu_torch yet (see ROADMAP.md)"


def _bucket(n: int) -> int:
    """Round a batch up to a power of two (1, 2, 4, ...)."""
    b = 1
    while b < n:
        b *= 2
    return b


class DinoEngine:
    def __init__(
        self,
        model_path: str | Path,
        dtype: torch.dtype = torch.bfloat16,
        parity: str = "reference",
        device="cuda",
    ):
        self.device = torch.device(device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "DinoEngine(device='cuda'): no CUDA device is available "
                    "(use device='cpu' for the plain PyTorch path)"
                )
            set_cuda_matmul_precision()
        self.loaded = load_params(model_path, dtype=dtype, device=self.device)
        self.config = self.loaded.config
        self.id2label = self.loaded.id2label
        self.opts = ModelOptions(parity=parity, compute_dtype=dtype)
        self.model = DinoViT(self.loaded.params, self.config, self.opts)
        self.last_compute_ms = 0.0

    # ------------------------------------------------------------------
    @staticmethod
    def _group_by_shape(images) -> list[tuple[list[int], np.ndarray]]:
        """Group images by (H, W): one preprocess per size group."""
        if isinstance(images, np.ndarray):
            images = [images] if images.ndim == 3 else list(images)
        groups: dict[tuple[int, int], list[int]] = {}
        for i, img in enumerate(images):
            groups.setdefault((img.shape[0], img.shape[1]), []).append(i)
        return [
            (idxs, np.stack([images[i] for i in idxs], axis=0))
            for idxs in groups.values()
        ]

    @staticmethod
    def _pad_rows(batch: np.ndarray, target: int) -> np.ndarray:
        """Pad a host batch to `target` rows by repeating the last row."""
        if target == batch.shape[0]:
            return batch
        return np.concatenate(
            [batch, np.repeat(batch[-1:], target - batch.shape[0], axis=0)], axis=0
        )

    def _preprocess(self, batch: np.ndarray, rows: int) -> torch.Tensor:
        """Host RGB batch padded to `rows` -> preprocessed tensor on device."""
        x = torch.from_numpy(self._pad_rows(batch, rows)).to(self.device)
        return classify_preprocess(x)

    # ------------------------------------------------------------------
    def classify(
        self, images: Sequence[np.ndarray] | np.ndarray, topk: int = 5
    ) -> list[list[tuple[str, float]]]:
        """RGB uint8 images -> per-image top-k (label, prob)."""
        out = []
        for row in self.classify_probs(images):
            idx = np.argsort(row)[::-1][:topk]
            out.append(
                [(self.id2label.get(int(i), str(int(i))), float(row[i])) for i in idx]
            )
        return out

    def classify_probs(self, images) -> np.ndarray:
        """RGB uint8 images, (B, H, W, 3) or a list of mixed sizes ->
        (B, num_classes) f32 probabilities."""
        if not self.loaded.has_classifier:
            raise ValueError("checkpoint has no classifier head")
        groups = self._group_by_shape(images)
        if not groups:
            return np.zeros((0, self.config.num_classes), dtype=np.float32)

        @torch.inference_mode()
        def run():
            if len(groups) == 1:
                idxs, batch = groups[0]
                pre = self._preprocess(batch, _bucket(len(idxs)))
                return self.model(pre, classify=True), len(idxs)
            order, parts = [], []
            for idxs, batch in groups:
                order.extend(idxs)
                # pad each group to its bucket before preprocessing, slice after
                parts.append(self._preprocess(batch, _bucket(len(idxs)))[: len(idxs)])
            inv = torch.from_numpy(np.argsort(np.asarray(order))).to(self.device)
            pre = torch.cat(parts)[inv]
            n = pre.shape[0]
            pad = pre[-1:].expand(_bucket(n) - n, *pre.shape[1:])
            return self.model(torch.cat([pre, pad]), classify=True), n

        (out, n), ms = time_blocked(run, device=self.device)
        self.last_compute_ms = ms
        return out["probs"][:n].cpu().numpy()

    # ------------------------------------------------------------------
    def extract_features(self, images):
        raise NotImplementedError(f"feature mode {_NOT_PORTED}")

    def pca_visualization(self, image):
        raise NotImplementedError(f"PCA visualization {_NOT_PORTED}")

    def warmup(self, image_hw: tuple[int, int], batch: int = 1, classify: bool = True):
        """Run one classify batch of the given input size (builds the kernel
        library and warms the caching allocator)."""
        if not (classify and self.loaded.has_classifier):
            raise NotImplementedError(f"feature mode {_NOT_PORTED}")
        self.classify_probs(np.zeros((batch, *image_hw, 3), dtype=np.uint8))
