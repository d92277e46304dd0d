"""DINOv2 ViT in plain float32 PyTorch: preprocessing, the forward, the
classifier, and a training step with AdamW.

It follows dinov2.cpp (parity "reference") and Hugging Face's Dinov2 with
the -imagenet1k-1-layer head (parity "hf"):
  - preprocessing as dinov2.cpp's: uint8 / 255, OpenCV's INTER_CUBIC
    resize (A = -0.75, sample centres at (i + 0.5) * scale - 0.5, edges
    replicated, no antialiasing), ImageNet mean and std. Classify: resize to
    256 x 256, centre crop 224. Features: resize each side to
    (side // patch + 1) * patch (dinov2.cpp adds a patch even to a multiple);
  - the patch embedding, then the position embedding, its patch grid
    resized bicubically to the image's grid unless the patch counts agree
    (dinov2.cpp compares counts), the CLS row kept;
  - pre-LN blocks: x + ls1 * proj(attention(LN1(x))), then
    x + ls2 * fc2(GELU(fc1(LN2(x)))); LayerNorm eps from the configuration;
    with the configuration's use_swiglu_ffn the second is Hugging Face's
    Dinov2SwiGLUFFN: x + ls2 * weights_out(SiLU(x1) * x2), x1 and x2 the
    halves of weights_in(LN2(x)) in that order;
  - GELU: in "reference" ggml's, read from a table of f16 values:
    f16(gelu_tanh(f16(x))); in "hf" the exact erf GELU;
  - the final LayerNorm; the head on [CLS, pooled patches]: in "reference"
    the patches' sum over the model's grid count (image_size / patch)^2,
    dinov2.cpp's divisor; in "hf" their mean.

Precision: "f32" runs every product in full float32 (TF32 off), "tf32"
lets cuBLAS and cuDNN run float32 products in TF32, and "fp8" rounds both
operands of every linear layer to float8 e4m3 (activations scaled per row,
weights per output row; 4-bit weights are kept) before an f32 product.
The last two are the controls of the comparison, never the reference.

W8A8 int8 (a traffic's "int8" scheme): the weights come already rounded to
their codes (reference/int8.py), and `act_rows` names the linears whose
input rows are rounded to codes of at most `act_max` before the product.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

from . import int8

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
CLASSIFY_RESIZE, CLASSIFY_CROP = 256, 224
FP8_MAX = 448.0  # the largest finite float8 e4m3 value


@contextlib.contextmanager
def precision(name: str):
    """Float32 products in full precision, or in TF32 for "tf32"; the
    switches are put back afterwards."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    tf32 = name == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


# -- preprocessing -------------------------------------------------------------

def cubic_matrix(src: int, dst: int) -> np.ndarray:
    """(dst, src) float32 M with out = M @ in: OpenCV's INTER_CUBIC."""
    a = -0.75
    x = (np.arange(dst, dtype=np.float64) + 0.5) * (src / dst) - 0.5
    left = np.floor(x).astype(np.int64)
    t = x - left

    def kernel(s):  # the cubic convolution kernel at distance s
        s = np.abs(s)
        return np.where(
            s <= 1, ((a + 2) * s - (a + 3)) * s * s + 1,
            np.where(s < 2, ((a * s - 5 * a) * s + 8 * a) * s - 4 * a, 0.0),
        )

    m = np.zeros((dst, src), dtype=np.float64)
    rows = np.arange(dst)
    for k in range(-1, 3):
        np.add.at(m, (rows, np.clip(left + k, 0, src - 1)), kernel(t - k))
    return m.astype(np.float32)


def resize(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """(N, H, W, C) float32 -> (N, out_h, out_w, C), bicubic."""
    mh = torch.from_numpy(cubic_matrix(x.shape[1], out_h)).to(x.device)
    mw = torch.from_numpy(cubic_matrix(x.shape[2], out_w)).to(x.device)
    x = torch.einsum("oh,nhwc->nowc", mh, x)
    return torch.einsum("ow,nhwc->nhoc", mw, x)


def _normalize(x: torch.Tensor) -> torch.Tensor:
    mean = torch.tensor(MEAN, device=x.device)
    std = torch.tensor(STD, device=x.device)
    return (x - mean) / std


def classify_input(images: np.ndarray, device) -> torch.Tensor:
    """(N, H, W, 3) uint8 -> (N, 224, 224, 3) normalized float32."""
    x = torch.from_numpy(np.ascontiguousarray(images)).to(device).float() / 255.0
    x = resize(x, CLASSIFY_RESIZE, CLASSIFY_RESIZE)
    o = (CLASSIFY_RESIZE - CLASSIFY_CROP) // 2
    return _normalize(x[:, o: o + CLASSIFY_CROP, o: o + CLASSIFY_CROP])


def feature_input(images: np.ndarray, patch: int, device) -> torch.Tensor:
    """(N, H, W, 3) uint8 -> (N, H', W', 3), each side the next multiple of
    the patch above it."""
    x = torch.from_numpy(np.ascontiguousarray(images)).to(device).float() / 255.0
    h, w = images.shape[1], images.shape[2]
    return _normalize(resize(x, (h // patch + 1) * patch, (w // patch + 1) * patch))


# -- the model -----------------------------------------------------------------

def _fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale per row (last axis)."""
    scale = x.abs().amax(dim=-1, keepdim=True).clamp_min(1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None, prec: str,
           four_bit: bool = False) -> torch.Tensor:
    """x @ w.T + b, w (out, in)."""
    if prec == "fp8":
        x = _fp8(x)
        w = w if four_bit else _fp8(w)
    y = x @ w.T
    return y if b is None else y + b


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, eps: float) -> torch.Tensor:
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * w + b


def gelu(x: torch.Tensor, parity: str) -> torch.Tensor:
    if parity == "reference":
        return F.gelu(x.to(torch.float16).float(), approximate="tanh").to(torch.float16).float()
    return F.gelu(x)


class Model:
    """The forward of one configuration on a dict of float32 tensors named
    as the GGUF names them. `four_bit` names the weights already rounded to
    a quantized format (decoded from q4_0, or int8 codes); `act_rows` names
    the linears whose input rows become codes of at most `act_max`
    (int8.covers)."""

    def __init__(self, config: dict, tensors: dict, parity: str, prec: str = "f32",
                 four_bit: frozenset = frozenset(), act_rows: tuple = (),
                 act_max: int = int8.INT8_MAX):
        self.c = config
        self.t = tensors
        self.parity = parity
        self.prec = prec
        self.four_bit = four_bit
        self.act_rows = tuple(act_rows)
        self.act_max = act_max
        self.heads = config["num_attention_heads"]
        self.patch = config["patch_size"]
        self.grid = config["image_size"] // config["patch_size"]
        self.regs = config["assumed"].get("num_register_tokens", 0)
        self.eps = config["layer_norm_eps"]

    def _linear(self, x, name, bias=True):
        if self.act_rows and int8.covers(name, self.act_rows):
            x = int8.activation_rows(x, self.act_max)
        return linear(x, self.t[f"{name}.weight"], self.t[f"{name}.bias"] if bias else None,
                      self.prec, f"{name}.weight" in self.four_bit)

    def _pos_embed(self, gh: int, gw: int) -> torch.Tensor:
        pos = self.t["embeddings.position_embeddings"].reshape(-1, self.c["hidden_size"])
        if gh * gw == self.grid * self.grid:
            return pos
        grid = pos[1:].reshape(1, self.grid, self.grid, -1)
        grid = resize(grid, gh, gw).reshape(gh * gw, -1)
        return torch.cat([pos[:1], grid])

    def embed(self, x: torch.Tensor) -> torch.Tensor:
        """(N, H, W, 3) preprocessed -> tokens (N, 1 + R + n, D)."""
        n, h, w, _ = x.shape
        p = self.patch
        gh, gw = h // p, w // p
        # patches flattened (channel, row, column), as the conv weight is
        patches = x.reshape(n, gh, p, gw, p, 3).permute(0, 1, 3, 5, 2, 4).reshape(n, gh * gw, -1)
        wp = self.t["embeddings.patch_embeddings.projection.weight"]
        tokens = linear(patches, wp.reshape(wp.shape[0], -1),
                        self.t["embeddings.patch_embeddings.projection.bias"].reshape(-1),
                        self.prec)
        pos = self._pos_embed(gh, gw)
        cls = (self.t["embeddings.cls_token"].reshape(1, 1, -1) + pos[:1]).expand(n, 1, -1)
        parts = [cls, tokens + pos[1:]]
        if self.regs:
            parts.insert(1, self.t["embeddings.register_tokens"].reshape(1, self.regs, -1)
                         .expand(n, -1, -1))
        return torch.cat(parts, dim=1)

    def block(self, x: torch.Tensor, i: int) -> torch.Tensor:
        base = f"encoder.layer.{i}"
        t = self.t
        n, tokens, d = x.shape
        hd = d // self.heads
        h = layer_norm(x, t[f"{base}.norm1.weight"], t[f"{base}.norm1.bias"], self.eps)
        qkv = self._linear(h, f"{base}.attention.attention.qkv")
        q, k, v = qkv.reshape(n, tokens, 3, self.heads, hd).permute(2, 0, 3, 1, 4)
        att = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(hd), dim=-1) @ v
        att = att.transpose(1, 2).reshape(n, tokens, d)
        x = x + t[f"{base}.layer_scale1.lambda1"] * self._linear(att, f"{base}.attention.output.dense")
        h = layer_norm(x, t[f"{base}.norm2.weight"], t[f"{base}.norm2.bias"], self.eps)
        if self.c.get("use_swiglu_ffn"):
            x1, x2 = self._linear(h, f"{base}.mlp.weights_in").chunk(2, dim=-1)
            h = self._linear(F.silu(x1) * x2, f"{base}.mlp.weights_out")
        else:
            h = self._linear(gelu(self._linear(h, f"{base}.mlp.fc1"), self.parity),
                             f"{base}.mlp.fc2")
        return x + t[f"{base}.layer_scale2.lambda1"] * h

    def tokens(self, x: torch.Tensor) -> torch.Tensor:
        """Preprocessed images -> the final-normed tokens."""
        x = self.embed(x)
        for i in range(self.c["num_hidden_layers"]):
            x = self.block(x, i)
        return layer_norm(x, self.t["layernorm.weight"], self.t["layernorm.bias"], self.eps)

    def logits(self, tokens: torch.Tensor) -> torch.Tensor:
        cls = tokens[:, 0]
        if self.parity == "reference":
            pooled = tokens[:, 1:].sum(dim=1) / float(self.grid * self.grid)
        else:
            pooled = tokens[:, 1 + self.regs:].mean(dim=1)
        return self._linear(torch.cat([cls, pooled], dim=-1), "classifier")


def _by_shape(images: list[np.ndarray]):
    """(indices, stacked images) of each image size, in first-seen order."""
    groups: dict[tuple, list[int]] = {}
    for i, img in enumerate(images):
        groups.setdefault(img.shape, []).append(i)
    return [(idx, np.stack([images[i] for i in idx])) for idx in groups.values()]


@torch.no_grad()
def classify_log_probs(model: Model, images: list[np.ndarray], device) -> torch.Tensor:
    """RGB uint8 images of any sizes -> (N, classes) float64 log-probabilities."""
    out = [None] * len(images)
    for idx, batch in _by_shape(images):
        logits = model.logits(model.tokens(classify_input(batch, device)))
        for row, i in enumerate(idx):
            out[i] = torch.log_softmax(logits[row].double(), dim=-1)
    return torch.stack(out)


@torch.no_grad()
def features(model: Model, images: list[np.ndarray], device) -> tuple[torch.Tensor, torch.Tensor]:
    """Same-size images -> CLS (N, D) and patch tokens (N, n, D)."""
    tokens = model.tokens(feature_input(np.stack(images), model.patch, device))
    return tokens[:, 0], tokens[:, 1 + model.regs:]


def train_steps(config: dict, tensors: dict, batches: list, opt: dict, parity: str, prec: str,
                device, fault: str | None = None) -> dict:
    """AdamW steps (optax.adamw: b1, b2, eps, weight decay on every tensor,
    update -lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)) of the cross-entropy
    of the classifier, one a batch of (uint8 images, labels), from `tensors`.
    Returns the losses, each tensor's first gradient and its change over all
    steps, by name. `fault` plants one of the faults the comparison must
    catch: "half_batch" (the mean over half the batch), "token" (one
    image's CLS token altered), "unchanged" (no update)."""
    params = {k: v.detach().float().clone().requires_grad_(True) for k, v in tensors.items()}
    start = {k: v.detach().clone() for k, v in params.items()}
    mu = {k: torch.zeros_like(v) for k, v in params.items()}
    nu = {k: torch.zeros_like(v) for k, v in params.items()}
    lr, wd = opt["learning_rate"], opt["weight_decay"]
    b1, b2, eps = opt["b1"], opt["b2"], opt["eps"]
    losses, first_grads = [], None
    for step, (images, labels) in enumerate(batches, start=1):
        model = Model(config, params, parity, prec)
        x = classify_input(images, device)
        y = torch.from_numpy(np.asarray(labels)).to(device=device, dtype=torch.int64)
        if fault == "half_batch":
            x, y = x[: len(y) // 2], y[: len(y) // 2]
        tokens = model.tokens(x)
        if fault == "token":
            bump = torch.zeros_like(tokens)
            bump[0, 0] = 1.0
            tokens = tokens + bump
        loss = F.cross_entropy(model.logits(tokens), y)
        grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True,
                                    materialize_grads=True)
        losses.append(float(loss.detach()))
        if first_grads is None:
            first_grads = {k: g.detach().clone() for k, g in zip(params, grads)}
        if fault == "unchanged":
            continue
        with torch.no_grad():
            for (k, p), g in zip(params.items(), grads):
                mu[k].mul_(b1).add_(g, alpha=1 - b1)
                nu[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                m_hat = mu[k] / (1 - b1**step)
                v_hat = nu[k] / (1 - b2**step)
                p.sub_(lr * (m_hat / (v_hat.sqrt() + eps) + wd * p))
    return {
        "losses": losses,
        "first_grads": first_grads,
        "changes": {k: (p.detach() - start[k]) for k, p in params.items()},
    }
