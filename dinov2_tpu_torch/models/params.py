"""GGUF -> parameter tree of torch tensors (port of dinov2_tpu/models/params.py).

The tree has the JAX pytree's layout, so the two packages can be compared
leaf by leaf:
  - encoder layers stacked on axis 0 (`params["layers"]["qkv"]["kernel"]` is
    (L, D, 3D));
  - dense kernels stored (in, out) in the compute dtype (the GGUF/torch
    layout is (out, in); it is transposed once at load);
  - norms, biases, LayerScale, cls_token, pos_embed and register tokens in f32.

Only dense f16/f32 checkpoints with the MLP FFN are ported. Quantized
checkpoints and the SwiGLU FFN (ViT-g) raise NotImplementedError; both are
listed in ROADMAP.md.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Any

import numpy as np
import torch

from dinov2_tpu_torch.io.gguf import GGMLType, GGUFReader, GGUFTensor, QUANTIZED_TYPES
from dinov2_tpu_torch.models.config import DinoConfig, id2label_from_kv

_NOT_PORTED = "not ported to dinov2_tpu_torch yet (see ROADMAP.md, 'Modules to port')"


@dataclass
class LoadedModel:
    config: DinoConfig
    params: dict[str, Any]
    id2label: dict[int, str]
    has_classifier: bool


def _stack(dicts: list[dict[str, Any]]) -> dict[str, Any]:
    """Stack identically-structured trees of tensors along a new axis 0."""
    first = dicts[0]
    if isinstance(first, dict):
        return {k: _stack([d[k] for d in dicts]) for k in first}
    return torch.stack(dicts, dim=0)


def _tensor(arr: np.ndarray, dtype: torch.dtype, device) -> torch.Tensor:
    """An owned copy of a (possibly mmap-backed) numpy array, on `device`."""
    return torch.tensor(np.ascontiguousarray(arr)).to(device=device, dtype=dtype)


def init_params(
    config: DinoConfig,
    seed: int = 0,
    dtype: torch.dtype = torch.bfloat16,
    scale: float = 0.02,
    device="cpu",
) -> dict[str, Any]:
    """Random weights with load_params' structure, drawn from
    np.random.default_rng(seed) in the JAX init_params' order, so one seed
    gives the same weights in both packages."""
    if config.swiglu:
        raise NotImplementedError(f"SwiGLU FFN is {_NOT_PORTED}")
    rng = np.random.default_rng(seed)
    d = config.hidden_size
    p = config.patch_size
    inter = int(d * config.mlp_ratio)
    n_pos = config.num_model_patches + 1

    def w(*shape, f32=False):
        arr = rng.standard_normal(shape) * scale
        return torch.from_numpy(arr).to(
            device=device, dtype=torch.float32 if f32 else dtype
        )

    def ones(*shape):
        return torch.ones(shape, dtype=torch.float32, device=device)

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    params: dict[str, Any] = {
        "patch_embed": {"kernel": w(p * p * 3, d), "bias": zeros(d)},
        "cls_token": w(d, f32=True),
        "pos_embed": w(n_pos, d, f32=True),
        "final_norm": {"scale": ones(d), "bias": zeros(d)},
    }
    if config.num_register_tokens > 0:
        params["register_tokens"] = w(config.num_register_tokens, d, f32=True)

    def layer():
        mlp = {  # drawn before qkv/proj, as in the JAX init
            "fc1": {"kernel": w(d, inter), "bias": zeros(inter)},
            "fc2": {"kernel": w(inter, d), "bias": zeros(d)},
        }
        return {
            "norm1": {"scale": ones(d), "bias": zeros(d)},
            "qkv": {"kernel": w(d, 3 * d), "bias": zeros(3 * d)},
            "proj": {"kernel": w(d, d), "bias": zeros(d)},
            "ls1": ones(d),
            "norm2": {"scale": ones(d), "bias": zeros(d)},
            "mlp": mlp,
            "ls2": ones(d),
        }

    params["layers"] = _stack([layer() for _ in range(config.num_hidden_layers)])
    if config.num_classes > 0:
        params["classifier"] = {
            "kernel": w(2 * d, config.num_classes),
            "bias": zeros(config.num_classes),
        }
    return params


def params_from_numpy(tree: Any, device="cpu") -> Any:
    """A tree of numpy arrays (e.g. the JAX params through np.asarray) ->
    the same tree of torch tensors, dtypes kept. bfloat16 arrays (numpy's
    ml_dtypes extension type) are moved bit for bit."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    arr = np.asarray(tree)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr.copy()).to(device)


def _linear(
    tensors: dict[str, GGUFTensor], name: str, dtype: torch.dtype, device
) -> dict[str, torch.Tensor]:
    """`{name}.weight` (out, in) as an (in, out) kernel, plus its f32 bias."""
    out = {"kernel": _tensor(tensors[f"{name}.weight"].as_numpy().T, dtype, device)}
    b = tensors.get(f"{name}.bias")
    if b is not None:
        out["bias"] = _tensor(b.as_numpy(), torch.float32, device)
    return out


def load_params(
    path: str | Path, dtype: torch.dtype = torch.bfloat16, device="cpu"
) -> LoadedModel:
    """Load a dense (f16/f32) GGUF checkpoint onto `device`."""
    reader = GGUFReader(path)
    try:
        return _load(reader, dtype, device)
    finally:
        reader.close()


def _load(reader: GGUFReader, dtype: torch.dtype, device) -> LoadedModel:
    kv, tensors = reader.kv, reader.tensors
    config = DinoConfig.from_gguf_kv(kv)
    id2label = id2label_from_kv(kv, config.num_classes)
    quantized = [n for n, t in tensors.items() if t.ggml_type in QUANTIZED_TYPES]
    if GGMLType(config.ftype) in QUANTIZED_TYPES or quantized:
        raise NotImplementedError(f"quantized checkpoints are {_NOT_PORTED}")
    if config.swiglu or "encoder.layer.0.mlp.weights_in.weight" in tensors:
        raise NotImplementedError(f"SwiGLU FFN is {_NOT_PORTED}")

    def f32(name: str) -> torch.Tensor:
        return _tensor(tensors[name].as_numpy().reshape(-1), torch.float32, device)

    d = config.hidden_size
    # patch conv weight (D, C, P, P) -> (P*P*C, D): a patch flattened
    # (py, px, c) meets it as one contraction
    wp = tensors["embeddings.patch_embeddings.projection.weight"].as_numpy()
    d_model, c_in, ph, pw = wp.shape
    p: dict[str, Any] = {
        "patch_embed": {
            "kernel": _tensor(
                wp.transpose(2, 3, 1, 0).reshape(ph * pw * c_in, d_model), dtype, device
            ),
            "bias": f32("embeddings.patch_embeddings.projection.bias"),
        },
        "cls_token": f32("embeddings.cls_token"),
        "pos_embed": f32("embeddings.position_embeddings").reshape(-1, d),
    }
    if config.num_register_tokens > 0:
        p["register_tokens"] = f32("embeddings.register_tokens").reshape(-1, d)

    layers = []
    for i in range(config.num_hidden_layers):
        base = f"encoder.layer.{i}"
        layers.append({
            "norm1": {"scale": f32(f"{base}.norm1.weight"), "bias": f32(f"{base}.norm1.bias")},
            "qkv": _linear(tensors, f"{base}.attention.attention.qkv", dtype, device),
            "proj": _linear(tensors, f"{base}.attention.output.dense", dtype, device),
            "ls1": f32(f"{base}.layer_scale1.lambda1"),
            "norm2": {"scale": f32(f"{base}.norm2.weight"), "bias": f32(f"{base}.norm2.bias")},
            "mlp": {
                "fc1": _linear(tensors, f"{base}.mlp.fc1", dtype, device),
                "fc2": _linear(tensors, f"{base}.mlp.fc2", dtype, device),
            },
            "ls2": f32(f"{base}.layer_scale2.lambda1"),
        })
    p["layers"] = _stack(layers)
    p["final_norm"] = {"scale": f32("layernorm.weight"), "bias": f32("layernorm.bias")}
    has_classifier = "classifier.weight" in tensors
    if has_classifier:
        p["classifier"] = _linear(tensors, "classifier", dtype, device)
    return LoadedModel(
        config=config, params=p, id2label=id2label, has_classifier=has_classifier
    )
