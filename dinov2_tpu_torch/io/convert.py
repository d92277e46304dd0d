"""HuggingFace -> GGUF converter (port of dinov2_tpu/io/convert.py; the
reference's scripts/dinov2-to-gguf.py). It writes the JAX converter's file
byte for byte, the layout the reference C++ loader expects:
  - arch "dinov2"; id2label as per-index string KVs; flat u32 hparams KVs
  - tensor names = HF state-dict names with the leading "dinov2" /
    "dinov2_with_registers" component stripped
  - skips embeddings.mask_token, norm_pre* and the separate q/k/v tensors;
    fuses q, k, v into `...attention.attention.qkv.{weight,bias}`
  - dtype policy: F16 except 1D tensors and position_embeddings / cls_token
    / register_tokens, which stay F32
  - patch-embed bias reshaped to (1, C, 1, 1) for conv broadcast

Extension beyond the reference: a `use_swiglu_ffn` bool KV so SwiGLU
selection does not depend on the layers==40 quirk (Q6) for non-giant models;
reference-made files without it still load through the quirk rule.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Mapping

import numpy as np

from dinov2_tpu_torch.io.gguf import GGMLType, GGUFWriter

ARCH = "dinov2"

_F32_KEEP = {
    "embeddings.position_embeddings",
    "embeddings.cls_token",
    "embeddings.register_tokens",
}


def _strip_arch_prefix(name: str) -> str:
    if name.startswith(ARCH):  # matches both "dinov2." and "dinov2_with_registers."
        name = ".".join(name.split(".")[1:])
    return name


def _should_skip(name: str) -> bool:
    return (
        name in {"embeddings.mask_token"}
        or name.startswith("norm_pre")
        or "attention.attention" in name  # separate q/k/v; re-added fused below
    )


def _save(writer: GGUFWriter, name: str, data: np.ndarray) -> None:
    dtype = (
        np.float32 if (data.ndim == 1 or name in _F32_KEEP) else np.float16
    )
    data = data.astype(dtype)
    if name == "embeddings.patch_embeddings.projection.bias":
        data = data.reshape(1, data.shape[0], 1, 1)
    writer.add_tensor(name, data)


def convert_state_dict(
    state_dict: Mapping[str, np.ndarray],
    config: Mapping[str, Any],
    output_path: str | Path,
    id2label: Mapping[int, str] | None = None,
) -> Path:
    """Convert an HF-style DINOv2 state dict (numpy arrays) to GGUF.

    `config` needs: hidden_size, num_hidden_layers, num_attention_heads,
    patch_size, image_size, and optionally use_swiglu_ffn.
    """
    output_path = Path(output_path)
    id2label = id2label or {}
    writer = GGUFWriter(output_path, arch=ARCH)

    for key, value in id2label.items():
        writer.add_string(str(key), value)

    num_register_tokens = 0
    stripped = {_strip_arch_prefix(k): np.asarray(v) for k, v in state_dict.items()}

    for name, value in stripped.items():
        if _should_skip(name):
            continue
        if name == "embeddings.register_tokens":
            num_register_tokens = value.shape[1]
        _save(writer, name, value)

    # fuse q, k, v per layer
    n_layers = int(config["num_hidden_layers"])
    for i in range(n_layers):
        base = f"encoder.layer.{i}.attention.attention"
        for suffix in ("weight", "bias"):
            parts = [stripped[f"{base}.{p}.{suffix}"] for p in ("query", "key", "value")]
            fused = np.concatenate(parts, axis=0)
            _save(writer, f"{base}.qkv.{suffix}", fused)

    hparams = {
        "hidden_size": int(config["hidden_size"]),
        "num_hidden_layers": n_layers,
        "num_attention_heads": int(config["num_attention_heads"]),
        "num_classes": len(id2label),
        "patch_size": int(config["patch_size"]),
        "img_size": int(config["image_size"]),
        "ftype": int(GGMLType.F16),
        "num_register_tokens": num_register_tokens,
    }
    for k, v in hparams.items():
        writer.add_uint32(k, v)
    if "use_swiglu_ffn" in config and config["use_swiglu_ffn"] is not None:
        writer.add_uint32("use_swiglu_ffn", int(bool(config["use_swiglu_ffn"])))

    writer.write()
    return output_path


def convert_hf_model(model, output_path: str | Path) -> Path:
    """Convert an in-memory HF transformers model (Dinov2Model /
    Dinov2ForImageClassification / ...WithRegisters variants)."""
    import torch

    with torch.no_grad():
        state = {k: v.cpu().numpy() for k, v in model.state_dict().items()}
    cfg = model.config
    id2label = getattr(cfg, "id2label", None)
    # mirror the reference: id2label only for classifier checkpoints
    is_classifier = any(k.startswith("classifier") for k in state)
    config = {
        "hidden_size": cfg.hidden_size,
        "num_hidden_layers": cfg.num_hidden_layers,
        "num_attention_heads": cfg.num_attention_heads,
        "patch_size": cfg.patch_size,
        "image_size": cfg.image_size,
        "use_swiglu_ffn": getattr(cfg, "use_swiglu_ffn", None),
    }
    return convert_state_dict(
        state, config, output_path, id2label=id2label if is_classifier else None
    )


def convert_hf_name(model_name: str, output_path: str | Path) -> Path:
    """Load by HF model name or local checkpoint directory and convert (the
    reference CLI's rule: AutoModelForImageClassification iff the name
    contains "imagenet"). A directory loads from disk; a hub name
    downloads."""
    from transformers import AutoModel, AutoModelForImageClassification

    if "imagenet" in model_name:
        model = AutoModelForImageClassification.from_pretrained(model_name)
    else:
        model = AutoModel.from_pretrained(model_name)
    return convert_hf_model(model, output_path)
