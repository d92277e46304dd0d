"""DINOv2 ViT forward pass on torch tensors (port of dinov2_tpu/models/vit.py).

Functional and batch-first, with the JAX signatures: `forward(params, x,
config, opts, classify)` on a parameter tree whose encoder layers are
stacked on axis 0. The attention half-layer of every layer takes the route
`resolve_attention_path(opts.flash_attention, T)` picks (ops/attention.py):
"slab" is the K1 kernel (ops/fused_attention.py::slab_layer_block), "flash"
is LN1 then the unfused half-layer around the K4 kernel
(ops/flash_attention.py), "vanilla" the same around plain PyTorch. Each
kernel runs as CUDA on a card and as its plain version on the CPU. The MLP
half-layer is plain PyTorch, as the JAX package leaves it to XLA.
`DinoViT` is a thin nn.Module that owns the weight tensors.

Numerics as in the JAX package: LN statistics in f32; matmuls accumulate in
f32 and round to the compute dtype before the bias add; tokens are embedded
in f32 and cast once; the final LN and the head run in f32. Quirks kept:
registers spliced after the pos-embed add (C8), classify pooling
sum(patches)/n_img_embd² with registers included in reference mode (Q3, Q5).

Left out: the JAX CLS-shift overflow rescue (the port's softmax takes the
exact row max), batch chunking (TPU scheduling), remat, sequence
parallelism and SwiGLU.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch
from torch import nn

from dinov2_tpu_torch.models.config import DinoConfig
from dinov2_tpu_torch.image.posembed import interpolate_pos_embed
from dinov2_tpu_torch.ops.attention import resolve_attention_path, self_attention_block
from dinov2_tpu_torch.ops.fused_attention import slab_layer_block
from dinov2_tpu_torch.ops.qmatmul import apply_linear


@dataclass(frozen=True)
class ModelOptions:
    parity: str = "reference"  # "reference" replicates ggml quirks; "hf" matches HF
    flash_attention: Any = "auto"  # True | False | "auto" | "slab" | "flash" | "vanilla"
    compute_dtype: torch.dtype = torch.bfloat16

    @property
    def gelu_activation(self) -> str:
        """ggml's fp16-LUT tanh-GELU in reference mode; exact erf GELU in hf."""
        return "gelu_tanh_f16" if self.parity == "reference" else "gelu_erf"


def layer_norm(x: torch.Tensor, p: dict, eps: float) -> torch.Tensor:
    """LayerNorm with f32 statistics and affine, cast back to x's dtype."""
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"] + p["bias"]).to(x.dtype)


def mlp_block(x: torch.Tensor, p: dict, activation: str) -> torch.Tensor:
    """fc1 -> GELU -> fc2."""
    return apply_linear(apply_linear(x, p["fc1"], activation=activation), p["fc2"])


def _attention_half_layer(
    x: torch.Tensor, layer: dict, config: DinoConfig, opts: ModelOptions
) -> torch.Tensor:
    """LN1 -> QKV -> attention -> proj -> LayerScale -> residual: K1 as one
    kernel on the slab route; LN1 and self_attention_block (the K4 kernel on
    the flash route) otherwise, in the JAX ordering."""
    heads = config.num_attention_heads
    path = resolve_attention_path(opts.flash_attention, x.shape[1])
    if path == "slab":
        return slab_layer_block(
            x, layer["norm1"]["scale"], layer["norm1"]["bias"],
            layer["qkv"]["kernel"], layer["qkv"]["bias"],
            layer["proj"]["kernel"], layer["proj"]["bias"],
            layer["ls1"], heads, 1.0 / (config.hidden_size // heads) ** 0.5, config.eps,
        )
    h = layer_norm(x, layer["norm1"], config.eps)
    return self_attention_block(
        x, h, layer["qkv"], layer["proj"], layer["ls1"], heads, flash=path
    )


def _mlp_half_layer(
    x: torch.Tensor, layer: dict, config: DinoConfig, opts: ModelOptions
) -> torch.Tensor:
    """LN2 -> MLP -> LayerScale -> residual, in the compute dtype."""
    if config.swiglu:
        raise NotImplementedError(
            "SwiGLU FFN is not ported to dinov2_tpu_torch yet (see ROADMAP.md)"
        )
    h = mlp_block(layer_norm(x, layer["norm2"], config.eps), layer["mlp"], opts.gelu_activation)
    return x + h * layer["ls2"].to(x.dtype)


def encoder_layer(
    x: torch.Tensor, layer: dict, config: DinoConfig, opts: ModelOptions
) -> torch.Tensor:
    return _mlp_half_layer(_attention_half_layer(x, layer, config, opts), layer, config, opts)


def _layer(layers: Any, i: int) -> Any:
    """Layer i of the stacked layer tree."""
    if isinstance(layers, dict):
        return {k: _layer(v, i) for k, v in layers.items()}
    return layers[i]


def embed_tokens(
    params: dict, x: torch.Tensor, config: DinoConfig, opts: ModelOptions
) -> torch.Tensor:
    """Preprocessed images (B, H, W, 3) -> tokens (B, 1+R+N, D) in the compute
    dtype: the stride-p patch conv as a matmul over (py, px, c)-ordered
    patches, f32 tokens + bias + pos-embed, one cast; registers get no
    pos-embed."""
    b, h, w, c = x.shape
    p = config.patch_size
    gh, gw = h // p, w // p
    dtype = opts.compute_dtype
    patches = x.reshape(b, gh, p, gw, p, c).permute(0, 1, 3, 2, 4, 5)
    patches = patches.reshape(b, gh * gw, p * p * c).to(dtype)
    # f32 accumulation and an f32 result, like preferred_element_type=f32
    tokens = torch.matmul(patches.float(), params["patch_embed"]["kernel"].float())
    tokens = tokens + params["patch_embed"]["bias"]

    pos = interpolate_pos_embed(params["pos_embed"], config.n_img_embd, (gh, gw))
    cls = (params["cls_token"][None, None, :] + pos[None, :1]).expand(b, 1, -1)
    tokens = tokens + pos[None, 1:]
    parts = [cls.to(dtype), tokens.to(dtype)]
    if config.num_register_tokens > 0:
        reg = params["register_tokens"][None].expand(b, -1, -1)
        parts.insert(1, reg.to(dtype))  # after the pos add: no pos-embed
    return torch.cat(parts, dim=1)


def forward_features(
    params: dict, x: torch.Tensor, config: DinoConfig, opts: ModelOptions
) -> torch.Tensor:
    """(B, H, W, 3) preprocessed -> final-normed tokens (B, 1+R+N, D) in f32."""
    tokens = embed_tokens(params, x, config, opts)
    for i in range(config.num_hidden_layers):
        tokens = encoder_layer(tokens, _layer(params["layers"], i), config, opts)
    return layer_norm(tokens.float(), params["final_norm"], config.eps)


def head_logits(
    params: dict, tokens: torch.Tensor, config: DinoConfig, opts: ModelOptions
) -> torch.Tensor:
    """Final tokens -> classifier logits (B, num_classes), f32.

    "reference": registers included in the pooled patches and the divisor is
    the MODEL-grid count n_img_embd² (quirks Q5, Q3). "hf": registers
    excluded and a true mean."""
    cls = tokens[:, 0]
    if opts.parity == "reference":
        pooled = tokens[:, 1:].sum(dim=1) / float(config.n_img_embd**2)
    else:
        pooled = tokens[:, 1 + config.num_register_tokens :].mean(dim=1)
    feats = torch.cat([cls, pooled], dim=-1)
    return apply_linear(feats, params["classifier"]).float()


def forward_head(
    params: dict, tokens: torch.Tensor, config: DinoConfig, opts: ModelOptions
) -> torch.Tensor:
    """Final tokens -> class probabilities (softmax over head_logits)."""
    return torch.softmax(head_logits(params, tokens, config, opts), dim=-1)


def forward(
    params: dict,
    x: torch.Tensor,
    config: DinoConfig,
    opts: ModelOptions,
    classify: bool = False,
) -> dict[str, torch.Tensor]:
    """f32 outputs: cls_token (B, D); patch_tokens (B, N, D) with CLS and
    registers dropped; probs (B, classes) when classify."""
    tokens = forward_features(params, x, config, opts)
    out = {
        "cls_token": tokens[:, 0],
        "patch_tokens": tokens[:, 1 + config.num_register_tokens :],
    }
    if classify:
        out["probs"] = forward_head(params, tokens, config, opts)
    return out


def _flatten(tree: dict, prefix: str = "") -> dict[str, torch.Tensor]:
    flat = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            flat.update(_flatten(v, f"{name}/"))
        else:
            flat[name] = v
    return flat


class DinoViT(nn.Module):
    """Owns the weight tensors (as buffers named by their tree path, e.g.
    "layers/qkv/kernel") and runs the functional forward on them."""

    def __init__(self, params: dict, config: DinoConfig, opts: ModelOptions):
        super().__init__()
        self.config = config
        self.opts = opts
        for name, tensor in _flatten(params).items():
            self.register_buffer(name, tensor)

    @property
    def params(self) -> dict[str, Any]:
        tree: dict[str, Any] = {}
        for name, tensor in self.named_buffers():
            *path, leaf = name.split("/")
            node = tree
            for key in path:
                node = node.setdefault(key, {})
            node[leaf] = tensor
        return tree

    def forward(self, x: torch.Tensor, classify: bool = False) -> dict[str, torch.Tensor]:
        return forward(self.params, x, self.config, self.opts, classify=classify)
