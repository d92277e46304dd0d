"""Debug utilities (port of dinov2_tpu/utils/debug.py).

print_tensor mirrors the reference's print_t_f32: dims in ggml order
(innermost first), the first and last n elements and an element-sum
"checksum", so traces can be diffed against the reference's debug output.

check_finite raises on NaN/inf in any tensor of a (nested dict/list/tuple)
output. It is a no-op unless DINOV2_TPU_DEBUG_NAN is set, as in the JAX
package, because it reads every value back to the host.
"""

from __future__ import annotations

import os

import numpy as np
import torch


def print_tensor(title: str, t, n: int = 10) -> None:
    if isinstance(t, torch.Tensor):
        t = t.detach().float().cpu().numpy()
    arr = np.asarray(t, dtype=np.float32)
    # ggml ne[] order: innermost dimension first, so a (197, 384) activation
    # prints "dims: 384 197 1 1"
    dims = list(reversed(arr.shape)) + [1] * (4 - arr.ndim)
    print(title)
    print(f"dims: {dims[0]} {dims[1]} {dims[2]} {dims[3]} f32")
    flat = arr.ravel()
    k = min(n, flat.size)
    print(f"First & Last {n} elements:")
    print(" ".join(f"{v:.5f}" for v in flat[:k]))
    print(" ".join(f"{v:.5f}" for v in flat[-k:]))
    print(f"sum:  {flat.sum(dtype=np.float64):f}\n")


def nan_debug_enabled() -> bool:
    return bool(os.environ.get("DINOV2_TPU_DEBUG_NAN"))


def _leaves(tree, path: str = ""):
    """(path, tensor) for every tensor of a nested dict/list/tuple, paths in
    the JAX keystr form (['key'][0])."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    elif isinstance(tree, torch.Tensor):
        yield path, tree


def check_finite(tree, where: str = "") -> None:
    """Raise if any floating tensor contains NaN/inf. No-op unless
    DINOV2_TPU_DEBUG_NAN is set."""
    if not nan_debug_enabled():
        return
    for path, leaf in _leaves(tree):
        if leaf.is_floating_point() and not bool(torch.isfinite(leaf).all()):
            raise FloatingPointError(f"non-finite values at {where}{path}")
