"""A reference for DinoEngine's staging, for the tests that hold the engine to
it: each size group stacked on the host (`np.stack`), padded there to its
bucket by repeating its last row, and copied to the device from pageable
memory (`torch.from_numpy(...).to`); mixed-size classify preprocesses each
group at its bucket and slices the padding off after. Preprocess, the
forward (`DinoEngine._forward`) and the PCA are the engine's own, so only
the staging differs."""

import numpy as np
import torch

from dinov2_tpu_torch.image.pca import resize_nearest_host
from dinov2_tpu_torch.image.preprocess import classify_preprocess, feature_preprocess
from dinov2_tpu_torch.runtime.engine import _bucket


def _groups(images):
    """(indices, stacked batch) of each (H, W) group, in first-seen order."""
    groups: dict[tuple[int, int], list[int]] = {}
    for i, img in enumerate(images):
        groups.setdefault(img.shape[:2], []).append(i)
    return [(idxs, np.stack([images[i] for i in idxs])) for idxs in groups.values()]


def _upload(engine, batch, target):
    """A host batch padded on the host to `target` rows -> the device."""
    pad = np.repeat(batch[-1:], target - batch.shape[0], axis=0)
    return torch.from_numpy(np.concatenate([batch, pad])).to(engine.device)


@torch.inference_mode()
def classify_probs(engine, images) -> np.ndarray:
    groups = _groups(list(images))
    if len(groups) == 1:
        idxs, batch = groups[0]
        pre = classify_preprocess(_upload(engine, batch, engine._target_batch(len(idxs))))
        return engine._forward(pre, classify=True)["probs"][: len(idxs)].cpu().numpy()
    order, parts = [], []
    for idxs, batch in groups:
        order.extend(idxs)
        pre = classify_preprocess(_upload(engine, batch, _bucket(len(idxs))))
        parts.append(pre[: len(idxs)])
    inv = torch.from_numpy(np.argsort(np.asarray(order))).to(engine.device)
    pre = torch.cat(parts)[inv]
    n = pre.shape[0]
    pad = pre[-1:].expand(engine._target_batch(n) - n, *pre.shape[1:])
    out = engine._forward(torch.cat([pre, pad]), classify=True)
    return out["probs"][:n].cpu().numpy()


@torch.inference_mode()
def extract_features(engine, batch) -> dict[str, np.ndarray]:
    batch = np.stack(list(batch))
    n = batch.shape[0]
    pre = feature_preprocess(_upload(engine, batch, engine._target_batch(n)),
                             engine.config.patch_size)
    out = engine._forward(pre, classify=False)
    return {key: out[key][:n].cpu().numpy() for key in ("cls_token", "patch_tokens")}


def pca_visualizations(engine, images) -> list[np.ndarray]:
    out = [None] * len(images)
    for idxs, batch in _groups(list(images)):
        n, h, w = batch.shape[:3]
        x = _upload(engine, batch, engine._target_batch(n))
        vis = engine._pca_grid(x, engine._feature_grid(batch))[:n].cpu().numpy()
        for row, i in zip(resize_nearest_host(vis, h, w), idxs):
            out[i] = row
    return out
