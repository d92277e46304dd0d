"""Synthetic GGUF checkpoints: random weights with the exact reference tensor
inventory/naming/dtype policy. Used by the benchmark (per-op perf does not depend
on weight values) and by tests that exercise the load/predict path without
downloading real HF checkpoints.

Tensor set mirrors the converter output (the reference converter dinov2-to-gguf.py):
embeddings.{cls_token,position_embeddings,register_tokens,patch_embeddings.projection.*},
encoder.layer.N.{norm1,norm2}.{weight,bias}, .attention.attention.qkv.{weight,bias},
.attention.output.dense.{weight,bias}, .layer_scale{1,2}.lambda1,
.mlp.{fc1,fc2}.{weight,bias} or .mlp.weights_{in,out}.{weight,bias},
layernorm.{weight,bias}, classifier.{weight,bias}.

The port's own copy of dinov2_tpu/io/synthetic.py (numpy only).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from dinov2_tpu_torch.io.gguf import GGUFWriter
from dinov2_tpu_torch.models.config import DinoConfig


def write_synthetic_gguf(
    path: str | Path,
    config: DinoConfig,
    seed: int = 0,
    with_classifier: bool | None = None,
    scale: float = 0.02,
) -> Path:
    """Write a random-weight GGUF for `config`. Weights ~N(0, scale²) keep
    activations in a numerically sane range through 40 layers."""
    rng = np.random.default_rng(seed)
    d = config.hidden_size
    n_pos = config.num_model_patches + 1
    inter = int(config.hidden_size * config.mlp_ratio)
    if with_classifier is None:
        with_classifier = config.num_classes > 0

    w = GGUFWriter(path, arch="dinov2")

    def t16(name, *shape):
        w.add_tensor(name, (rng.standard_normal(shape) * scale).astype(np.float16))

    def t32(name, *shape, value=None):
        data = (
            np.full(shape, value, dtype=np.float32)
            if value is not None
            else (rng.standard_normal(shape) * scale).astype(np.float32)
        )
        w.add_tensor(name, data)

    if with_classifier:
        for i in range(config.num_classes):
            w.add_string(str(i), f"class_{i}")

    t32("embeddings.cls_token", 1, 1, d)
    t32("embeddings.position_embeddings", 1, n_pos, d)
    if config.num_register_tokens > 0:
        t32("embeddings.register_tokens", 1, config.num_register_tokens, d)
    t16("embeddings.patch_embeddings.projection.weight", d, 3, config.patch_size, config.patch_size)
    t32("embeddings.patch_embeddings.projection.bias", 1, d, 1, 1)

    for i in range(config.num_hidden_layers):
        base = f"encoder.layer.{i}"
        t32(f"{base}.norm1.weight", d, value=1.0)
        t32(f"{base}.norm1.bias", d, value=0.0)
        t16(f"{base}.attention.attention.qkv.weight", 3 * d, d)
        t32(f"{base}.attention.attention.qkv.bias", 3 * d)
        t16(f"{base}.attention.output.dense.weight", d, d)
        t32(f"{base}.attention.output.dense.bias", d)
        t32(f"{base}.layer_scale1.lambda1", d, value=1.0)
        t32(f"{base}.norm2.weight", d, value=1.0)
        t32(f"{base}.norm2.bias", d, value=0.0)
        if config.swiglu:
            sh = config.swiglu_hidden_dim
            t16(f"{base}.mlp.weights_in.weight", 2 * sh, d)
            t32(f"{base}.mlp.weights_in.bias", 2 * sh)
            t16(f"{base}.mlp.weights_out.weight", d, sh)
            t32(f"{base}.mlp.weights_out.bias", d)
        else:
            t16(f"{base}.mlp.fc1.weight", inter, d)
            t32(f"{base}.mlp.fc1.bias", inter)
            t16(f"{base}.mlp.fc2.weight", d, inter)
            t32(f"{base}.mlp.fc2.bias", d)
        t32(f"{base}.layer_scale2.lambda1", d, value=1.0)

    t32("layernorm.weight", d, value=1.0)
    t32("layernorm.bias", d, value=0.0)
    if with_classifier:
        t16("classifier.weight", config.num_classes, 2 * d)
        t32("classifier.bias", config.num_classes)

    for k, v in config.to_gguf_kv().items():
        if k == "num_classes" and not with_classifier:
            # keep the header honest: num_classes > 0 with no classifier
            # tensors is a self-contradictory GGUF (the reference loader
            # would fail to resolve classifier.weight)
            v = 0
        w.add_uint32(k, v)
    w.write()
    return Path(path)
