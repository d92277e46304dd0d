"""DINOv2 ViT forward pass on torch tensors (port of dinov2_tpu/models/vit.py).

Functional and batch-first, with the JAX signatures: `forward(params, x,
config, opts, classify)` on a parameter tree whose encoder layers are
stacked on axis 0. The attention half-layer of every layer takes the route
`resolve_attention_path` picks from opts.flash_attention, T, the activations'
dtype and device and the head_dim (ops/attention.py):
"slab" is one of the slab kernels of ops/fused_attention.py (below), "flash"
is LN1 then the unfused half-layer around the K4 kernel
(ops/flash_attention.py), "vanilla" the same around plain PyTorch. Each
kernel runs as CUDA on a card and as its plain version on the CPU.
`DinoViT` is a thin nn.Module that owns the weight tensors.

The slab route has three levels, `slab_fusion` (the JAX package walks them
by its VMEM gates fits_slab_layer, fits_slab_proj, fits_slab, which describe
a TPU; the port carries no such gate and takes an option in their place):
  - "layer": the whole half-layer in one call, K1 (slab_layer_block), or K8
    on quantized weights; "auto" is "layer";
  - "proj": LN1 and the QKV GEMM in PyTorch, then attention core + proj +
    bias + LayerScale + residual in one call, K2 (slab_attention_block);
  - "core": LN1, QKV GEMM, the attention core K3 (slab_attention), then proj,
    LayerScale and residual in PyTorch: the JAX package's route for ViT-g/14.
What a level cannot take (a proj without bias, mixed dense and quantized
weights) falls to the next one, as in the JAX package.

The MLP half-layer is plain PyTorch (fc1, GELU, fc2, or SwiGLU: weights_in,
SiLU(x1) * x2, weights_out), as the JAX package leaves it to XLA. With
`fuse_mlp` (off by default, as there) a GELU MLP on the slab route with both
biases runs as one call of the K5 kernel (slab_mlp_block); SwiGLU and a
mixed dense/quantized pair take no fused route.

Quantized weights (QuantLinear, quant_mode="fused") route as follows, with
two options in place of the JAX package's environment knobs:
  - slab route, qkv and proj quantized, `quant_slab` (DINOV2_TPU_QUANT_SLAB):
    "auto" and "kernel" run the K8 kernel
    (ops/fused_quant_attention.py::slab_layer_block_quant); "dequant"
    dequantizes the layer's weights into K1 (the JAX package's TPU
    default); "off" takes the truly unfused route: the K3 core between
    quant_matmul calls for qkv and proj. At the "proj" level a quantized
    proj is dequantized into K2 unless "off"; with `fuse_mlp` a quantized
    fc1/fc2 pair is dequantized into K5 unless "off";
  - every other quantized linear (fc1 with its GELU, fc2, the classifier on
    f32 features, qkv and proj on the flash and vanilla routes) goes through
    ops/qmatmul.py::quant_matmul with `quant_backend`
    (DINOV2_TPU_QUANT_BACKEND): "auto" and "kernel" run the K7 kernel
    (ops/qmatmul_kernel.py), "dequant" dequantizes and runs a plain matmul.
On a card "auto" therefore always reaches a kernel; the JAX package's
"auto" picks the dequant routes, a choice measured on a TPU.

Numerics as in the JAX package: LN statistics in f32; matmuls accumulate in
f32 and round to the compute dtype before the bias add; tokens are embedded
in f32 and cast once; the final LN and the head run in f32. Quirks kept:
registers spliced after the pos-embed add (C8), classify pooling
sum(patches)/n_img_embd² with registers included in reference mode (Q3, Q5).

Training: the forward is differentiable on the tree's dense leaves, on a
card through the kernels' autograd Functions (ops/fused_attention.py,
ops/flash_attention.py); a QuantLinear path raises where an input requires
grad. `remat` (off by default) runs each encoder layer under
`torch.utils.checkpoint` (non-reentrant): only the layer's input is kept
and the layer runs again in the backward, so its forward kernels launch
twice a step; it does nothing where grad is disabled.

Left out: the JAX CLS-shift overflow rescue (the port's softmax takes the
exact row max), batch chunking (TPU scheduling), sequence parallelism and
the W8A8 Int8Linear.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from dinov2_tpu_torch.models.config import DinoConfig
from dinov2_tpu_torch.models.params import QUANT_FIELDS, QuantLinear, tree_leaves
from dinov2_tpu_torch.image.posembed import interpolate_pos_embed
from dinov2_tpu_torch.ops.attention import resolve_attention_path, self_attention_block
from dinov2_tpu_torch.ops.fused_attention import slab_layer_block, slab_mlp_block
from dinov2_tpu_torch.ops.fused_quant_attention import slab_layer_block_quant
from dinov2_tpu_torch.ops.qmatmul import (
    QUANT_BACKENDS,
    apply_linear,
    dequant_weight,
    refuse_quant_grad,
)

QUANT_SLAB_MODES = ("auto", "kernel", "dequant", "off")
SLAB_FUSION_LEVELS = ("auto", "layer", "proj", "core")


@dataclass(frozen=True)
class ModelOptions:
    parity: str = "reference"  # "reference" replicates ggml quirks; "hf" matches HF
    flash_attention: Any = "auto"  # True | False | "auto" | "slab" | "flash" | "vanilla"
    compute_dtype: torch.dtype = torch.bfloat16
    quant_slab: str = "auto"  # "auto" | "kernel" | "dequant" | "off" (module docstring)
    quant_backend: str = "auto"  # "auto" | "kernel" | "dequant"
    slab_fusion: str = "auto"  # "auto" | "layer" | "proj" | "core" (module docstring)
    fuse_mlp: bool = False  # the MLP half-layer as the K5 kernel, where it applies
    remat: bool = False  # rematerialize encoder layers in the backward (training memory/FLOPs trade)

    def __post_init__(self):
        if self.slab_fusion not in SLAB_FUSION_LEVELS:
            raise ValueError(
                f"slab_fusion must be one of {SLAB_FUSION_LEVELS}, got {self.slab_fusion!r}"
            )
        if self.quant_slab not in QUANT_SLAB_MODES:
            raise ValueError(f"quant_slab must be one of {QUANT_SLAB_MODES}, got {self.quant_slab!r}")
        if self.quant_backend not in QUANT_BACKENDS:
            raise ValueError(
                f"quant_backend must be one of {QUANT_BACKENDS}, got {self.quant_backend!r}"
            )

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


def mlp_block(x: torch.Tensor, p: dict, activation: str, backend: str = "auto") -> torch.Tensor:
    """fc1 -> GELU -> fc2."""
    h = apply_linear(x, p["fc1"], activation=activation, backend=backend)
    return apply_linear(h, p["fc2"], backend=backend)


def swiglu_block(x: torch.Tensor, p: dict, backend: str = "auto") -> torch.Tensor:
    """weights_in -> split halves -> SiLU(x1) * x2 in the compute dtype ->
    weights_out."""
    x1, x2 = apply_linear(x, p["win"], backend=backend).chunk(2, dim=-1)
    return apply_linear(F.silu(x1) * x2, p["wout"], backend=backend)


def _attention_path(x: torch.Tensor, config: DinoConfig, opts: ModelOptions) -> str:
    """The route of (B, T, D) activations x: by the option, T, x's dtype and
    device and the model's head_dim (ops/attention.py)."""
    return resolve_attention_path(
        opts.flash_attention, x.shape[1], x.dtype,
        config.hidden_size // config.num_attention_heads, x.device.type,
    )


def _attention_half_layer(
    x: torch.Tensor, layer: dict, config: DinoConfig, opts: ModelOptions
) -> torch.Tensor:
    """LN1 -> QKV -> attention -> proj -> LayerScale -> residual. On the slab
    route at the "layer" level: K1 (or K8 with quantized weights) as one
    kernel. Otherwise LN1 and self_attention_block: K2 or K3 on the slab
    route below that level, the K4 kernel on the flash route, in the JAX
    ordering."""
    heads = config.num_attention_heads
    scale = 1.0 / (config.hidden_size // heads) ** 0.5
    path = _attention_path(x, config, opts)
    w_qkv, w_proj = layer["qkv"]["kernel"], layer["proj"]["kernel"]
    quantized = isinstance(w_qkv, QuantLinear), isinstance(w_proj, QuantLinear)
    whole = (
        path == "slab" and opts.slab_fusion in ("auto", "layer")
        and "bias" in layer["qkv"] and "bias" in layer["proj"]
    )
    if whole and all(quantized) and opts.quant_slab in ("auto", "kernel"):
        return slab_layer_block_quant(
            x, layer["norm1"]["scale"], layer["norm1"]["bias"], w_qkv, layer["qkv"]["bias"],
            w_proj, layer["proj"]["bias"], layer["ls1"], heads, scale, config.eps,
        )
    if whole and all(quantized) and opts.quant_slab == "dequant":
        refuse_quant_grad("the quantized attention half-layer", x, *_tensor_leaves(layer))
        # the layer's weights dequantized into K1's dense (in, out) layout
        w_qkv = dequant_weight(w_qkv, x.dtype).T.contiguous()
        w_proj = dequant_weight(w_proj, x.dtype).T.contiguous()
        quantized = False, False
    if whole and not any(quantized):
        return slab_layer_block(
            x, layer["norm1"]["scale"], layer["norm1"]["bias"], w_qkv, layer["qkv"]["bias"],
            w_proj, layer["proj"]["bias"], layer["ls1"], heads, scale, config.eps,
        )
    h = layer_norm(x, layer["norm1"], config.eps)
    return self_attention_block(
        x, h, layer["qkv"], layer["proj"], layer["ls1"], heads, flash=path,
        backend=opts.quant_backend, fuse_proj=opts.slab_fusion != "core",
        dequant_proj=opts.quant_slab != "off",
    )


def _mlp_half_layer(
    x: torch.Tensor, layer: dict, config: DinoConfig, opts: ModelOptions
) -> torch.Tensor:
    """LN2 -> MLP -> LayerScale -> residual, in the compute dtype. With
    `fuse_mlp`, on the slab route, a GELU MLP with both biases is one call of
    the K5 kernel; a quantized fc1/fc2 pair is dequantized into it unless
    quant_slab is "off"; a mixed dense/quantized pair takes no fused route."""
    mlp = layer["mlp"]
    if (
        opts.fuse_mlp and not config.swiglu
        and _attention_path(x, config, opts) == "slab"
        and "bias" in mlp["fc1"] and "bias" in mlp["fc2"]
    ):
        w1, w2 = mlp["fc1"]["kernel"], mlp["fc2"]["kernel"]
        quantized = isinstance(w1, QuantLinear), isinstance(w2, QuantLinear)
        if all(quantized) and opts.quant_slab != "off":
            refuse_quant_grad("the quantized MLP half-layer", x, *_tensor_leaves(layer))
            w1 = dequant_weight(w1, x.dtype).T.contiguous()
            w2 = dequant_weight(w2, x.dtype).T.contiguous()
            quantized = False, False
        if not any(quantized):
            return slab_mlp_block(
                x, layer["norm2"]["scale"], layer["norm2"]["bias"], w1, mlp["fc1"]["bias"],
                w2, mlp["fc2"]["bias"], layer["ls2"], opts.gelu_activation, config.eps,
            )
    h = layer_norm(x, layer["norm2"], config.eps)
    if config.swiglu:
        h = swiglu_block(h, mlp, opts.quant_backend)
    else:
        h = mlp_block(h, mlp, opts.gelu_activation, opts.quant_backend)
    return x + h * layer["ls2"].to(x.dtype)


def encoder_layer(
    x: torch.Tensor, layer: dict, config: DinoConfig, opts: ModelOptions
) -> torch.Tensor:
    return _mlp_half_layer(_attention_half_layer(x, layer, config, opts), layer, config, opts)


def _tensor_leaves(tree: Any) -> list[torch.Tensor]:
    """The dense tensors of a parameter (sub)tree; QuantLinears are skipped."""
    return [leaf for leaf in tree_leaves(tree) if torch.is_tensor(leaf)]


def _layer(layers: Any, i: int) -> Any:
    """Layer i of the stacked layer tree."""
    if isinstance(layers, dict):
        return {k: _layer(v, i) for k, v in layers.items()}
    if isinstance(layers, QuantLinear):
        return layers.map(lambda t: t[i])
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
    remat = opts.remat and torch.is_grad_enabled()
    for i in range(config.num_hidden_layers):
        # the slices of the stacked leaves are views taken outside the
        # checkpoint, so gradients land in the stacked leaf either way
        layer = _layer(params["layers"], i)
        if remat:
            tokens = checkpoint(
                encoder_layer, tokens, layer, config, opts,
                use_reentrant=False, preserve_rng_state=False,
            )
        else:
            tokens = encoder_layer(tokens, layer, config, opts)
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
    return apply_linear(feats, params["classifier"], backend=opts.quant_backend).float()


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


def _flatten(tree: dict, prefix: str = "") -> dict[str, Any]:
    """Tree path -> leaf; a QuantLinear is one leaf."""
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
    "layers/qkv/kernel", or "layers/qkv/kernel/codes" for a QuantLinear's
    fields) and runs the functional forward on them. A QuantLinear's static
    fields (ggml_type, shape, packed) are kept beside the buffers."""

    def __init__(self, params: dict, config: DinoConfig, opts: ModelOptions):
        super().__init__()
        self.config = config
        self.opts = opts
        self._quant_static: dict[str, tuple] = {}
        for name, leaf in _flatten(params).items():
            if isinstance(leaf, QuantLinear):
                self._quant_static[name] = (leaf.ggml_type, leaf.shape, leaf.packed)
                for field, tensor in leaf.tensors().items():
                    self.register_buffer(f"{name}/{field}", tensor)
            else:
                self.register_buffer(name, leaf)

    @property
    def params(self) -> dict[str, Any]:
        tree: dict[str, Any] = {}
        for name, tensor in self.named_buffers():
            *path, leaf = name.split("/")
            node = tree
            for key in path:
                node = node.setdefault(key, {})
            node[leaf] = tensor
        for name, (ggml_type, shape, packed) in self._quant_static.items():
            *path, leaf = name.split("/")
            node = tree
            for key in path:
                node = node[key]
            fields = node[leaf]
            node[leaf] = QuantLinear(
                **{f: fields.get(f) for f in QUANT_FIELDS},
                ggml_type=ggml_type, shape=shape, packed=packed,
            )
        return tree

    def forward(self, x: torch.Tensor, classify: bool = False) -> dict[str, torch.Tensor]:
        return forward(self.params, x, self.config, self.opts, classify=classify)
