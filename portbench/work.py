"""The work of a ViT forward and of each function a kernel computes,
counted from the shapes, and the published peaks they are held against.

Operations are the multiply-adds of matrix products and attention products,
two a multiply-add: the work the tensor cores can do. LayerNorm, softmax,
GELU and the adds are left out, so a share of a peak is never counted high.
Bytes count each input once and each output once.
"""

from __future__ import annotations

from portbench.weights import swiglu_hidden

# NVIDIA H100 SXM data sheet, dense: bf16 989 TFLOP/s, TF32 (the tensor
# cores' float32 products) 495 TFLOP/s, INT8 1979 TOP/s; HBM3 3.35 TB/s
PEAK_FLOPS = {"bf16": 989e12, "f32": 495e12, "int8": 1979e12}
PEAK_BYTES = 3.35e12
BYTES = {"bf16": 2, "f32": 4, "q4_0": 18 / 32, "int8": 1}  # a value; q4_0: 18-byte blocks of 32


def tokens_of(config: dict, traffic: dict) -> int:
    """Tokens a forward runs on: CLS (+ registers) + the patch grid of the
    preprocessed image (224 px for classify and training; features: each
    side the next multiple of the patch above it)."""
    p = config["patch_size"]
    regs = config["assumed"].get("num_register_tokens", 0)
    if traffic["entry"] == "extract_features":
        size = traffic["images"][0]
        grid = (size["height"] // p + 1) * (size["width"] // p + 1)
    else:
        grid = (224 // p) ** 2
    return 1 + regs + grid


def linear_flops(config: dict, tokens: int, classify: bool) -> dict[str, int]:
    """Operations of one image's linears by GGUF name without the layer
    (each counts for every layer): QKV, proj, the MLP's pair (fc1 and fc2,
    or SwiGLU's weights_in and weights_out) and the head on [CLS, pooled]."""
    d = config["hidden_size"]
    h = swiglu_hidden(config)
    out = {"attention.attention.qkv": 2 * tokens * d * 3 * d,
           "attention.output.dense": 2 * tokens * d * d}
    if h:
        out.update({"mlp.weights_in": 2 * tokens * d * 2 * h,
                    "mlp.weights_out": 2 * tokens * h * d})
    else:
        inter = d * config["mlp_ratio"]
        out.update({"mlp.fc1": 2 * tokens * d * inter, "mlp.fc2": 2 * tokens * inter * d})
    if classify:
        out["classifier"] = 2 * 2 * d * config["num_labels"]
    return out


def forward_flops(config: dict, tokens: int, classify: bool) -> int:
    """Operations of one image's forward: the patch embedding, per layer
    QKV, QK^T, PV, proj and the MLP's pair, and the head on [CLS, pooled]."""
    d = config["hidden_size"]
    p = config["patch_size"]
    patches = tokens - 1 - config["assumed"].get("num_register_tokens", 0)
    linears = linear_flops(config, tokens, classify)
    head = linears.pop("classifier", 0)
    per_layer = sum(linears.values()) + 4 * tokens * tokens * d
    return 2 * patches * 3 * p * p * d + config["num_hidden_layers"] * per_layer + head


def int8_flops(config: dict, tokens: int, classify: bool, linears) -> int:
    """Operations of one image's forward in the W8A8 linears `linears`
    (names as a traffic's int8 scheme gives them: the tensor cores' int8
    products); the rest of forward_flops runs in the activations' type."""
    layers = config["num_hidden_layers"]
    return sum(n if name == "classifier" else layers * n
               for name, n in linear_flops(config, tokens, classify).items()
               if name in linears)


def attention_half_layer(batch: int, tokens: int, config: dict, act: str, weights: str):
    """LN1, QKV with bias, softmax(q k^T / sqrt(hd)) v per head, proj with
    bias, LayerScale and the residual, on (batch, tokens, D): [(ops, bytes)]."""
    d = config["hidden_size"]
    m = batch * tokens
    ops = 2 * m * d * 4 * d + 4 * batch * tokens * tokens * d
    nbytes = 2 * m * d * BYTES[act] + 4 * d * d * BYTES[weights] + 4 * 7 * d
    return [(ops, nbytes)]


def attention_core(batch: int, tokens: int, config: dict, act: str, weights: str):
    """softmax(q k^T / sqrt(hd)) v per head: q, k, v in, o out."""
    d = config["hidden_size"]
    return [(4 * batch * tokens * tokens * d, 4 * batch * tokens * d * BYTES[act])]


def mlp_linears(batch: int, tokens: int, config: dict, act: str, weights: str):
    """fc1 with its bias and GELU, then fc2 with its bias, as two products
    (the hidden activation crosses memory between them)."""
    d = config["hidden_size"]
    inter = d * config["mlp_ratio"]
    m = batch * tokens
    out = []
    for k, n in ((d, inter), (inter, d)):
        out.append((2 * m * k * n, (m * k + m * n) * BYTES[act] + k * n * BYTES[weights] + 4 * n))
    return out


def swiglu_linears(batch: int, tokens: int, config: dict, act: str, weights: str):
    """SwiGLU's weights_in with its bias, then weights_out with its bias, as
    two products: the (m, 2h) output of the first and the (m, h) gated
    input of the second cross memory. The gate's elementwise work is not
    counted."""
    d = config["hidden_size"]
    h = swiglu_hidden(config)
    m = batch * tokens
    out = []
    for k, n in ((d, 2 * h), (h, d)):
        out.append((2 * m * k * n, (m * k + m * n) * BYTES[act] + k * n * BYTES[weights] + 4 * n))
    return out


FUNCTIONS = {
    "attention_half_layer": attention_half_layer,
    "attention_core": attention_core,
    "mlp_linears": mlp_linears,
    "swiglu_linears": swiglu_linears,
}


def bound_seconds(parts: list[tuple[int, float]], act: str) -> float:
    """The least time of a function's products: each the larger of its
    operations over the peak and its bytes over the memory's rate."""
    return sum(max(ops / PEAK_FLOPS[act], nbytes / PEAK_BYTES) for ops, nbytes in parts)
