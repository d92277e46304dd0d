"""Seeded random weights of a configuration, and the GGUF the program loads.

The tensors carry the names, shapes and types the reference converter
(dinov2-to-gguf.py) writes: matrices f16, vectors f32. They are drawn on the
device from the seed, in two calls of one generator (one for the matrices,
one for the vectors), so that set-up stays short and the reference, run
after the window, draws the same values again. The statistics are the
configuration file's "weights": matrices N(0, matrix_std), biases
N(0, bias_std), embeddings N(0, embedding_std), LayerNorm scales and
LayerScale N(mean, std).

With the configuration's use_swiglu_ffn a layer's MLP is the converter's
SwiGLU pair, mlp.weights_in (2h, D) and mlp.weights_out (D, h), in place
of fc1 and fc2.

For a q4_0 mix every 2-D tensor named *weight (the reference quantizer's
rule: qkv, proj, fc1, fc2 and the classifier) is written as the blocks of
reference/q4_0.py, which the reference decodes again.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from portbench import gguf, seeds
from portbench.reference import q4_0

# GGUF ftype values of the reference converter and quantizer
FTYPES = {"f16": 1, "q4_0": 2}


def swiglu_hidden(config: dict) -> int:
    """The SwiGLU FFN's hidden size h (weights_in is (2h, D), weights_out
    (D, h)), 0 without use_swiglu_ffn: Hugging Face's Dinov2SwiGLUFFN rule,
    int(D * mlp_ratio * 2 / 3) rounded up to a multiple of 8 (4096 at
    ViT-g's 1536)."""
    if not config.get("use_swiglu_ffn"):
        return 0
    return (int(int(config["hidden_size"] * config["mlp_ratio"]) * 2 / 3) + 7) // 8 * 8


def tensor_specs(config: dict) -> list[tuple[str, tuple[int, ...], str]]:
    """(name, shape, kind) of every tensor, in the converter's order."""
    d = config["hidden_size"]
    p = config["patch_size"]
    inter = d * config["mlp_ratio"]
    swiglu = swiglu_hidden(config)
    grid = config["image_size"] // p
    regs = config["assumed"].get("num_register_tokens", 0)
    specs = [
        ("embeddings.cls_token", (1, 1, d), "embedding"),
        ("embeddings.position_embeddings", (1, grid * grid + 1, d), "embedding"),
    ]
    if regs:
        specs.append(("embeddings.register_tokens", (1, regs, d), "embedding"))
    specs += [
        ("embeddings.patch_embeddings.projection.weight", (d, 3, p, p), "matrix"),
        ("embeddings.patch_embeddings.projection.bias", (1, d, 1, 1), "bias"),
    ]
    for i in range(config["num_hidden_layers"]):
        base = f"encoder.layer.{i}"
        specs += [
            (f"{base}.norm1.weight", (d,), "norm_scale"),
            (f"{base}.norm1.bias", (d,), "bias"),
            (f"{base}.attention.attention.qkv.weight", (3 * d, d), "matrix"),
            (f"{base}.attention.attention.qkv.bias", (3 * d,), "bias"),
            (f"{base}.attention.output.dense.weight", (d, d), "matrix"),
            (f"{base}.attention.output.dense.bias", (d,), "bias"),
            (f"{base}.layer_scale1.lambda1", (d,), "layer_scale"),
            (f"{base}.norm2.weight", (d,), "norm_scale"),
            (f"{base}.norm2.bias", (d,), "bias"),
        ]
        if swiglu:
            specs += [
                (f"{base}.mlp.weights_in.weight", (2 * swiglu, d), "matrix"),
                (f"{base}.mlp.weights_in.bias", (2 * swiglu,), "bias"),
                (f"{base}.mlp.weights_out.weight", (d, swiglu), "matrix"),
                (f"{base}.mlp.weights_out.bias", (d,), "bias"),
            ]
        else:
            specs += [
                (f"{base}.mlp.fc1.weight", (inter, d), "matrix"),
                (f"{base}.mlp.fc1.bias", (inter,), "bias"),
                (f"{base}.mlp.fc2.weight", (d, inter), "matrix"),
                (f"{base}.mlp.fc2.bias", (d,), "bias"),
            ]
        specs.append((f"{base}.layer_scale2.lambda1", (d,), "layer_scale"))
    specs += [("layernorm.weight", (d,), "norm_scale"), ("layernorm.bias", (d,), "bias")]
    if config["num_labels"]:
        specs += [
            ("classifier.weight", (config["num_labels"], 2 * d), "matrix"),
            ("classifier.bias", (config["num_labels"],), "bias"),
        ]
    return specs


def model_arrays(config: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """Every tensor of the configuration, by name, on `device`: matrices
    f16, vectors f32."""
    stats = config["weights"]
    specs = tensor_specs(config)
    gen = torch.Generator(device=device).manual_seed(seeds.derive(seed, "weights"))
    sizes = {kind: 0 for kind in ("matrix", "vector")}
    for _, shape, kind in specs:
        sizes["matrix" if kind == "matrix" else "vector"] += int(np.prod(shape))
    matrices = torch.randn(sizes["matrix"], generator=gen, device=device)
    matrices = (matrices * stats["matrix_std"]).to(torch.float16)
    vectors = torch.randn(sizes["vector"], generator=gen, device=device)
    affine = {
        "bias": (0.0, stats["bias_std"]),
        "embedding": (0.0, stats["embedding_std"]),
        "norm_scale": (stats["norm_scale_mean"], stats["norm_scale_std"]),
        "layer_scale": (stats["layer_scale_mean"], stats["layer_scale_std"]),
    }
    out, at = {}, {"matrix": 0, "vector": 0}
    for name, shape, kind in specs:
        n = int(np.prod(shape))
        if kind == "matrix":
            out[name] = matrices[at["matrix"]: at["matrix"] + n].view(shape)
            at["matrix"] += n
        else:
            mean, std = affine[kind]
            out[name] = vectors[at["vector"]: at["vector"] + n].view(shape) * std + mean
            at["vector"] += n
    return out


def quantized(name: str, shape: tuple[int, ...], fmt: str) -> bool:
    """Whether the file of format `fmt` holds `name` in blocks: the reference
    quantizer's rule, a 2-D tensor whose name ends in "weight"."""
    return fmt != "f16" and name.endswith("weight") and len(shape) == 2


def gguf_kv(config: dict, fmt: str) -> dict:
    """The header the reference converter writes (flat u32 keys)."""
    return {
        "hidden_size": config["hidden_size"],
        "num_hidden_layers": config["num_hidden_layers"],
        "num_attention_heads": config["num_attention_heads"],
        "num_classes": config["num_labels"],
        "patch_size": config["patch_size"],
        "img_size": config["image_size"],
        "ftype": FTYPES[fmt],
        "num_register_tokens": config["assumed"].get("num_register_tokens", 0),
    }


def write_model(path: Path, config: dict, arrays: dict[str, torch.Tensor], fmt: str) -> Path:
    """The GGUF of `arrays` in format `fmt` ("f16" or "q4_0")."""
    tensors = {}
    for name, t in arrays.items():
        if quantized(name, tuple(t.shape), fmt):
            tensors[name] = gguf.Blocks(q4_0.to_bytes(*q4_0.encode(t.float())), tuple(t.shape),
                                        gguf.Q4_0)
        else:
            tensors[name] = t.cpu().numpy()
    gguf.write(path, gguf_kv(config, fmt), tensors)
    return Path(path)
