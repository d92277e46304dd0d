"""Export a parameter tree back to GGUF (inverse of models/params.py; port of
dinov2_tpu/io/export.py).

Makes training round-trip: load GGUF -> fine-tune -> export a GGUF that the
reference C++ loader, the JAX package and `DinoEngine` can read. Tensor
naming and dtype policy match the converter: fused qkv, fp16 2D weights,
fp32 1D + cls/pos/register tensors, patch-embed bias as (1, C, 1, 1). On the
same parameters the file is the JAX package's byte for byte.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from dinov2_tpu_torch.io.gguf import GGMLType, GGUFWriter
from dinov2_tpu_torch.models.config import DinoConfig
from dinov2_tpu_torch.models.params import PACKED_WEIGHTS, tree_leaves, tree_map


def _np(x) -> np.ndarray:
    """A leaf on the host: f32 for a bf16 tensor (exact; numpy has no bf16),
    its own dtype otherwise. Arrays pass through."""
    if not torch.is_tensor(x):
        return np.asarray(x)
    x = x.detach().cpu()
    return (x.float() if x.dtype == torch.bfloat16 else x).numpy()


def export_gguf(
    path: str | Path,
    params: dict,
    config: DinoConfig,
    id2label: dict[int, str] | None = None,
) -> Path:
    if any(isinstance(leaf, PACKED_WEIGHTS) for leaf in tree_leaves(params)):
        raise ValueError(
            "cannot export fused-quantized or int8 params; reload with "
            "quant_mode='dequant' or quantize the exported fp16 file with "
            "quant/quantize.py"
        )

    w = GGUFWriter(path, arch="dinov2")
    for key, value in (id2label or {}).items():
        w.add_string(str(key), value)

    def t16(name, arr):
        w.add_tensor(name, _np(arr).astype(np.float16))

    def t32(name, arr):
        w.add_tensor(name, _np(arr).astype(np.float32))

    d = config.hidden_size
    p = config.patch_size
    t32("embeddings.cls_token", _np(params["cls_token"]).reshape(1, 1, d))
    t32("embeddings.position_embeddings", _np(params["pos_embed"])[None])
    if "register_tokens" in params:
        t32("embeddings.register_tokens", _np(params["register_tokens"])[None])

    # patch embed kernel (P*P*C, D) -> conv layout (D, C, P, P)
    k = _np(params["patch_embed"]["kernel"]).reshape(p, p, 3, d)
    t16("embeddings.patch_embeddings.projection.weight", k.transpose(3, 2, 0, 1))
    t32(
        "embeddings.patch_embeddings.projection.bias",
        _np(params["patch_embed"]["bias"]).reshape(1, d, 1, 1),
    )

    # fetch each stacked layer tensor to the host once: _np inside the
    # per-layer loop would copy the full stack (e.g. ViT-g qkv: ~566 MB) once
    # per layer index
    layers = tree_map(_np, params["layers"])
    n_layers = config.num_hidden_layers

    def layer_leaf(keys, i):
        node = layers
        for kk in keys:
            node = node[kk]
        return node[i]

    for i in range(n_layers):
        base = f"encoder.layer.{i}"
        t32(f"{base}.norm1.weight", layer_leaf(("norm1", "scale"), i))
        t32(f"{base}.norm1.bias", layer_leaf(("norm1", "bias"), i))
        # kernels stored (in, out) -> GGUF/torch layout (out, in)
        t16(f"{base}.attention.attention.qkv.weight", layer_leaf(("qkv", "kernel"), i).T)
        t32(f"{base}.attention.attention.qkv.bias", layer_leaf(("qkv", "bias"), i))
        t16(f"{base}.attention.output.dense.weight", layer_leaf(("proj", "kernel"), i).T)
        t32(f"{base}.attention.output.dense.bias", layer_leaf(("proj", "bias"), i))
        t32(f"{base}.layer_scale1.lambda1", layer_leaf(("ls1",), i))
        t32(f"{base}.norm2.weight", layer_leaf(("norm2", "scale"), i))
        t32(f"{base}.norm2.bias", layer_leaf(("norm2", "bias"), i))
        if config.swiglu:
            t16(f"{base}.mlp.weights_in.weight", layer_leaf(("mlp", "win", "kernel"), i).T)
            t32(f"{base}.mlp.weights_in.bias", layer_leaf(("mlp", "win", "bias"), i))
            t16(f"{base}.mlp.weights_out.weight", layer_leaf(("mlp", "wout", "kernel"), i).T)
            t32(f"{base}.mlp.weights_out.bias", layer_leaf(("mlp", "wout", "bias"), i))
        else:
            t16(f"{base}.mlp.fc1.weight", layer_leaf(("mlp", "fc1", "kernel"), i).T)
            t32(f"{base}.mlp.fc1.bias", layer_leaf(("mlp", "fc1", "bias"), i))
            t16(f"{base}.mlp.fc2.weight", layer_leaf(("mlp", "fc2", "kernel"), i).T)
            t32(f"{base}.mlp.fc2.bias", layer_leaf(("mlp", "fc2", "bias"), i))
        t32(f"{base}.layer_scale2.lambda1", layer_leaf(("ls2",), i))

    t32("layernorm.weight", _np(params["final_norm"]["scale"]))
    t32("layernorm.bias", _np(params["final_norm"]["bias"]))
    if "classifier" in params:
        t16("classifier.weight", _np(params["classifier"]["kernel"]).T)
        t32("classifier.bias", _np(params["classifier"]["bias"]))

    kv = config.to_gguf_kv()
    # header must agree with the tensor list: num_classes > 0 with no
    # classifier tensors makes the reference C++ loader fail on a missing
    # classifier.weight and id2label_from_kv fabricate bogus labels
    if "classifier" in params:
        kv["num_classes"] = len(id2label) if id2label else config.num_classes
    else:
        kv["num_classes"] = 0
    kv["ftype"] = int(GGMLType.F16)
    for key, value in kv.items():
        w.add_uint32(key, value)
    w.write()
    return Path(path)
