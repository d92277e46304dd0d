"""The numbers that decide `correct`: the program's outputs against the
plain reference's, each held to its limit from workloads/<cell>.json.

classify: logp_gap, the widest gap |log p - log p_ref| over the sampled
calls' images and classes.
features: cls_rel and patch_rel, the largest over the sampled calls'
images of |x - x_ref| / |x_ref| (Frobenius norms) of the CLS token and of
the patch tokens.
training (the first steps of set-up, as the reference follows them):
loss_rel, the largest |loss - loss_ref| / |loss_ref| over the steps;
grad_gap, the first gradient; change_gap, each parameter's change over the
steps. A gradient or change gap is taken by the worst leaf: the gap
between the program's norm of the leaf and the reference's, over the
larger of the reference's norm of that leaf and of the median leaf. A leaf
is one layer's slice of a stacked tensor. The change leaves out leaves
whose reference gradient is under a thousandth of the median leaf's: Adam
moves them by rounding alone.
"""

from __future__ import annotations

import numpy as np
import torch

# the program's training tree -> the GGUF names the reference uses; "{i}"
# is the layer of a stacked leaf
TRAIN_LEAVES = {
    "patch_embed/kernel": "embeddings.patch_embeddings.projection.weight",
    "patch_embed/bias": "embeddings.patch_embeddings.projection.bias",
    "cls_token": "embeddings.cls_token",
    "pos_embed": "embeddings.position_embeddings",
    "register_tokens": "embeddings.register_tokens",
    "final_norm/scale": "layernorm.weight",
    "final_norm/bias": "layernorm.bias",
    "classifier/kernel": "classifier.weight",
    "classifier/bias": "classifier.bias",
    "layers/norm1/scale": "encoder.layer.{i}.norm1.weight",
    "layers/norm1/bias": "encoder.layer.{i}.norm1.bias",
    "layers/qkv/kernel": "encoder.layer.{i}.attention.attention.qkv.weight",
    "layers/qkv/bias": "encoder.layer.{i}.attention.attention.qkv.bias",
    "layers/proj/kernel": "encoder.layer.{i}.attention.output.dense.weight",
    "layers/proj/bias": "encoder.layer.{i}.attention.output.dense.bias",
    "layers/ls1": "encoder.layer.{i}.layer_scale1.lambda1",
    "layers/norm2/scale": "encoder.layer.{i}.norm2.weight",
    "layers/norm2/bias": "encoder.layer.{i}.norm2.bias",
    "layers/mlp/fc1/kernel": "encoder.layer.{i}.mlp.fc1.weight",
    "layers/mlp/fc1/bias": "encoder.layer.{i}.mlp.fc1.bias",
    "layers/mlp/fc2/kernel": "encoder.layer.{i}.mlp.fc2.weight",
    "layers/mlp/fc2/bias": "encoder.layer.{i}.mlp.fc2.bias",
    "layers/mlp/win/kernel": "encoder.layer.{i}.mlp.weights_in.weight",
    "layers/mlp/win/bias": "encoder.layer.{i}.mlp.weights_in.bias",
    "layers/mlp/wout/kernel": "encoder.layer.{i}.mlp.weights_out.weight",
    "layers/mlp/wout/bias": "encoder.layer.{i}.mlp.weights_out.bias",
    "layers/ls2": "encoder.layer.{i}.layer_scale2.lambda1",
}


def leaf_norms(tree: dict, prefix: str = "") -> dict[str, float]:
    """Norms of a program tree's leaves by reference name, a stacked leaf
    split into its layers."""
    out: dict[str, float] = {}
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, dict):
            out.update(leaf_norms(value, f"{path}/"))
            continue
        name = TRAIN_LEAVES[path]
        t = value.detach().float()
        if "{i}" in name:
            norms = torch.linalg.vector_norm(t.reshape(t.shape[0], -1), dim=1).tolist()
            out.update({name.format(i=i): n for i, n in enumerate(norms)})
        else:
            out[name] = float(torch.linalg.vector_norm(t))
    return out


def reference_norms(tensors: dict[str, torch.Tensor]) -> dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.float())) for k, v in tensors.items()}


def worst_leaf_gap(program: dict[str, float], reference: dict[str, float],
                   leaves: list[str] | None = None) -> float:
    """max over leaves |n - n_ref| / max(n_ref, median n_ref)."""
    names = leaves if leaves is not None else list(reference)
    if set(program) != set(reference):
        return float("inf")  # a leaf missing on one side
    median = float(np.median([reference[k] for k in reference]))
    return max(abs(program[k] - reference[k]) / max(reference[k], median) for k in names)


def moved_leaves(first_grad_norms: dict[str, float]) -> list[str]:
    """The leaves whose reference gradient is at least a thousandth of the
    median leaf's."""
    median = float(np.median(list(first_grad_norms.values())))
    return [k for k, n in first_grad_norms.items() if n >= 1e-3 * median]


def classify_numbers(samples: list[tuple[np.ndarray, torch.Tensor]]) -> dict[str, float]:
    """samples: (program probs (N, C), reference log-probs (N, C) float64)."""
    gap = 0.0
    for probs, ref in samples:
        logp = torch.from_numpy(np.asarray(probs, dtype=np.float64)).log()
        gap = max(gap, float((logp - ref.cpu()).abs().max()))
    return {"logp_gap": gap}


def _rel(x: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Per image |x - ref| / |ref| over all but the first axis."""
    n = ref.shape[0]
    diff = torch.linalg.vector_norm((x - ref).reshape(n, -1), dim=1)
    return diff / torch.linalg.vector_norm(ref.reshape(n, -1), dim=1)


def features_numbers(samples: list[tuple[dict, tuple[torch.Tensor, torch.Tensor]]]) -> dict:
    """samples: (the program's output dict, the reference's (cls, patches))."""
    cls_rel = patch_rel = 0.0
    for out, (ref_cls, ref_patch) in samples:
        cls = torch.from_numpy(np.asarray(out["cls_token"], dtype=np.float32))
        patch = torch.from_numpy(np.asarray(out["patch_tokens"], dtype=np.float32))
        if cls.shape != ref_cls.shape or patch.shape != ref_patch.shape:
            return {"cls_rel": float("inf"), "patch_rel": float("inf")}
        cls_rel = max(cls_rel, float(_rel(cls, ref_cls.cpu()).max()))
        patch_rel = max(patch_rel, float(_rel(patch, ref_patch.cpu()).max()))
    return {"cls_rel": cls_rel, "patch_rel": patch_rel}


def train_numbers(program: dict, reference: dict) -> dict[str, float]:
    """program: {"losses", "grad_norms", "change_norms"} by reference name;
    reference: train_steps' result."""
    losses = [abs(a - b) / abs(b) for a, b in zip(program["losses"], reference["losses"])]
    if len(program["losses"]) != len(reference["losses"]):
        losses.append(float("inf"))
    grad_ref = reference_norms(reference["first_grads"])
    change_ref = reference_norms(reference["changes"])
    return {
        "loss_rel": max(losses),
        "grad_gap": worst_leaf_gap(program["grad_norms"], grad_ref),
        "change_gap": worst_leaf_gap(program["change_norms"], change_ref,
                                     moved_leaves(grad_ref)),
    }


def judge(numbers: dict[str, float], limits: dict[str, float]) -> bool:
    """Every number at or under its limit (NaN fails)."""
    return set(numbers) == set(limits) and all(
        numbers[k] <= limits[k] for k in limits)
