"""GGUF -> parameter tree of torch tensors (port of dinov2_tpu/models/params.py).

The tree has the JAX pytree's layout, so the two packages can be compared
leaf by leaf:
  - encoder layers stacked on axis 0 (`params["layers"]["qkv"]["kernel"]` is
    (L, D, 3D));
  - dense kernels stored (in, out) in the compute dtype (the GGUF/torch
    layout is (out, in); it is transposed once at load);
  - norms, biases, LayerScale, cls_token, pos_embed and register tokens in f32.

Quantized checkpoints (ggml q4_0/q4_1/q5_0/q5_1/q8_0) load in one of two
modes, as in the JAX package:
  - "dequant": the blocks are decoded on the host at load, and the weights
    live on the device as dense kernels in the compute dtype;
  - "fused": each quantized linear stays in ggml's blocks on the device as a
    `QuantLinear`, kept (out, in), and every matmul dequantizes it on the fly
    (the K7 and K8 kernels, ops/qmatmul_kernel.py and
    ops/fused_quant_attention.py).
The W8A8 mode "int8" is a runtime mode for a file of any ftype: every linear
weight is requantized on the host at load to per-row symmetric int8, an
`Int8Linear` kept (out, in), and every matmul quantizes its activations per
row and runs an s8 x s8 -> s32 product (the K9 kernel,
ops/int8_matmul_kernel.py). The SwiGLU FFN (ViT-g) loads as `mlp.win`
(D, 2*hidden) and `mlp.wout` (hidden, D) in place of fc1/fc2, dense,
QuantLinear or Int8Linear alike.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from pathlib import Path
from typing import Any

import numpy as np
import torch

from dinov2_tpu_torch.io.gguf import GGMLType, GGUFReader, GGUFTensor, QUANTIZED_TYPES
from dinov2_tpu_torch.models.config import DinoConfig, id2label_from_kv
from dinov2_tpu_torch.quant import QUANT_TYPE_NAMES, block_dtype, quantize, unpack_codes

QUANT_FIELDS = ("codes", "d", "m", "qh_lo", "qh_hi")  # QuantLinear's tensor fields


@dataclass
class QuantLinear:
    """A ggml-quantized linear weight (out, in), in one of two layouts
    (port of the JAX package's QuantLinear; the K7 and K8 kernels read both):

    packed=False ("int8 SoA", any of the five formats):
      codes: (out, in) int8 with the zero point subtracted, so the weight is
             codes*d (+ m for q4_1/q5_1).
    packed=True (q4_0/q4_1/q5_0/q5_1, the load path's layout):
      codes: (out, in/2) uint8 natural-order nibble planes: byte j holds
             element j in its low nibble and element j + in/2 in its high one;
      qh_lo, qh_hi: (out, in/16) uint8 5th bits of the q5 formats, bit i of
             word g the bit of plane lane 8g + i (None for q4).
    In both, d and m (None for the symmetric formats) are (out, in/32) f32
    per-32-block scales and mins. `ggml_type`, `shape` and `packed` are
    static; the stacked layer tree holds one QuantLinear per weight name with
    a leading layer axis on every tensor field."""

    codes: torch.Tensor
    d: torch.Tensor
    m: torch.Tensor | None
    ggml_type: int
    shape: tuple[int, int]
    packed: bool = False
    qh_lo: torch.Tensor | None = None
    qh_hi: torch.Tensor | None = None

    @property
    def zero_point(self) -> int:
        """What a packed code carries above its value: 8 for q4_0, 16 for
        q5_0, 0 for the affine formats; SoA codes have it subtracted."""
        if not self.packed or self.m is not None:
            return 0
        return 16 if self.qh_lo is not None else 8

    def tensors(self) -> dict[str, torch.Tensor]:
        """The tensor fields that are set, by name."""
        return {f: getattr(self, f) for f in QUANT_FIELDS if getattr(self, f) is not None}

    def map(self, fn) -> QuantLinear:
        """The same weight with fn applied to every tensor field."""
        return replace(self, **{k: fn(v) for k, v in self.tensors().items()})


INT8_FIELDS = ("codes", "s")  # Int8Linear's tensor fields


@dataclass
class Int8Linear:
    """A W8A8 serving-mode linear weight (out, in): per-output-row symmetric
    int8 (port of the JAX package's Int8Linear).

      codes: (out, in) int8, no zero point;
      s:     (out,) f32 per-row scale, so the weight is codes * s[:, None].

    `shape` is static. `int8_per_row` is the dispatch marker, deliberately
    not `ggml_type`: an Int8Linear is not a QuantLinear, so nothing routes
    it into the ggml-block kernels (K7, K8). The stacked layer tree holds
    one Int8Linear per weight name with a leading layer axis on both
    fields."""

    codes: torch.Tensor
    s: torch.Tensor
    shape: tuple[int, int]

    int8_per_row = True

    def tensors(self) -> dict[str, torch.Tensor]:
        """The tensor fields, by name."""
        return {"codes": self.codes, "s": self.s}

    def map(self, fn) -> Int8Linear:
        """The same weight with fn applied to both tensor fields."""
        return replace(self, codes=fn(self.codes), s=fn(self.s))


PACKED_WEIGHTS = (QuantLinear, Int8Linear)  # the weights kept (out, in) in their own form


@dataclass
class LoadedModel:
    config: DinoConfig
    params: dict[str, Any]
    id2label: dict[int, str]
    has_classifier: bool
    quantized: bool = False  # weights kept as QuantLinear (quant_mode="fused")


def _stack(dicts: list[Any]) -> Any:
    """Stack identically-structured trees of tensors (and QuantLinears and
    Int8Linears, field by field) along a new axis 0."""
    first = dicts[0]
    if isinstance(first, dict):
        return {k: _stack([d[k] for d in dicts]) for k in first}
    if isinstance(first, PACKED_WEIGHTS):
        return replace(first, **{
            k: torch.stack([q.tensors()[k] for q in dicts], dim=0) for k in first.tensors()
        })
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
    rng = np.random.default_rng(seed)
    d = config.hidden_size
    p = config.patch_size
    inter = int(d * config.mlp_ratio)
    sh = config.swiglu_hidden_dim
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
        mlp = (  # drawn before qkv/proj, as in the JAX init
            {"win": {"kernel": w(d, 2 * sh), "bias": zeros(2 * sh)},
             "wout": {"kernel": w(sh, d), "bias": zeros(d)}}
            if config.swiglu
            else {"fc1": {"kernel": w(d, inter), "bias": zeros(inter)},
                  "fc2": {"kernel": w(inter, d), "bias": zeros(d)}}
        )
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
    ml_dtypes extension type) are moved bit for bit. A QuantLinear or an
    Int8Linear of either package becomes the port's, its layout kept."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if getattr(tree, "int8_per_row", False):
        return Int8Linear(
            codes=params_from_numpy(tree.codes, device), s=params_from_numpy(tree.s, device),
            shape=tuple(int(v) for v in tree.shape),
        )
    if hasattr(tree, "ggml_type"):
        return QuantLinear(
            **{f: None if getattr(tree, f) is None else params_from_numpy(getattr(tree, f), device)
               for f in QUANT_FIELDS},
            ggml_type=int(tree.ggml_type),
            shape=tuple(int(s) for s in tree.shape),
            packed=bool(tree.packed),
        )
    arr = np.asarray(tree)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr.copy()).to(device)


def params_to_numpy(tree: Any) -> Any:
    """The inverse of `params_from_numpy`: a tree of torch tensors -> the same
    tree of numpy arrays on the host, dtypes kept (detached from any graph).
    bfloat16 goes bit for bit into numpy's `ml_dtypes.bfloat16` where that
    package is installed, else to float32 (exact). A QuantLinear or an
    Int8Linear keeps its class, its tensor fields as arrays."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, PACKED_WEIGHTS):
        return tree.map(params_to_numpy)
    tensor = tree.detach().cpu()
    if tensor.dtype != torch.bfloat16:
        return tensor.numpy()
    try:
        import ml_dtypes
    except ImportError:
        return tensor.float().numpy()
    return tensor.view(torch.int16).numpy().view(ml_dtypes.bfloat16)


def tree_leaves(tree: Any) -> list[Any]:
    """The leaves of a parameter tree in its (insertion) order; a QuantLinear
    or an Int8Linear is one leaf."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree: Any, *rest: Any) -> Any:
    """fn over the leaves of one or more identically-structured trees."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def trainable_params(tree: Any, device="cpu") -> Any:
    """The tree as training holds it: every leaf an f32 master tensor on
    `device` that requires grad (its own storage, never a view of the
    input), the stacked-layer layout kept. Quantized leaves are refused:
    fused-quant and int8 weights aren't trainable."""
    def leaf(t):
        if isinstance(t, PACKED_WEIGHTS):
            raise ValueError(
                "fused-quant and int8 weights aren't trainable: load the checkpoint with "
                "quant_mode='dequant'"
            )
        return t.detach().to(device=device, dtype=torch.float32, copy=True).requires_grad_(True)

    return tree_map(leaf, tree)


# the formats that load packed; q8_0 loads as int8 SoA (its codes are bytes)
_PACKED_TYPES = (GGMLType.Q4_0, GGMLType.Q4_1, GGMLType.Q5_0, GGMLType.Q5_1)


def decode_packed_planes(
    codes: torch.Tensor, qh_lo: torch.Tensor | None, qh_hi: torch.Tensor | None, zero: int
) -> torch.Tensor:
    """Natural-order nibble planes (+ the q5 5th-bit words) back to integer
    codes: (..., out, k/2) uint8 -> (..., out, k) int32, `zero` subtracted.

    The single source of truth for the packed layout: byte j = element j
    (low nibble) | element j + k/2 (high nibble); word g of qh_lo/qh_hi holds
    the 5th bits of plane lanes 8g..8g+7, lane 8g+i in bit i."""
    lo = (codes & 0xF).to(torch.int32)
    hi = (codes >> 4).to(torch.int32)
    if qh_lo is not None:
        shifts = torch.arange(8, dtype=torch.int32, device=codes.device)

        def bits(words: torch.Tensor) -> torch.Tensor:
            b = (words.to(torch.int32).unsqueeze(-1) >> shifts) & 1
            return b.reshape(*words.shape[:-1], words.shape[-1] * 8)

        lo = lo | (bits(qh_lo) << 4)
        hi = hi | (bits(qh_hi) << 4)
    q = torch.cat([lo, hi], dim=-1)
    return q - zero if zero else q


def _natural_plane_words(bits: np.ndarray) -> np.ndarray:
    """(out, half_k) 0/1 bits -> (out, half_k//8) uint8, one byte per 8
    consecutive lanes, bit i of word g = bits[:, 8g+i]."""
    o, hk = bits.shape
    w = bits.astype(np.uint32).reshape(o, hk // 8, 8)
    return (w << np.arange(8, dtype=np.uint32)).sum(axis=2).astype(np.uint8)


def _int8_soa(t: GGUFTensor, device) -> QuantLinear:
    """A ggml-quantized (out, in) tensor in the int8 SoA layout."""
    gt = GGMLType(t.ggml_type)
    codes, d, m = unpack_codes(t.data, gt, t.shape)
    return QuantLinear(
        codes=_tensor(codes, torch.int8, device),
        d=_tensor(d, torch.float32, device),
        m=None if m is None else _tensor(m, torch.float32, device),
        ggml_type=int(gt),
        shape=tuple(t.shape),
    )


def _soa_from_blocks(t: GGUFTensor, device="cpu") -> QuantLinear:
    """A ggml-quantized (out, in) tensor -> QuantLinear on `device`: packed
    planes for q4_0/q4_1/q5_0/q5_1 (ggml's block-local nibbles, elements
    32b+j and 32b+16+j in byte j of block b, repacked once on the host),
    int8 SoA for q8_0. Scales and mins lift out as f32."""
    out_dim, in_dim = t.shape
    gt = GGMLType(t.ggml_type)
    if gt not in _PACKED_TYPES:
        return _int8_soa(t, device)
    nb = in_dim // 32
    blocks = t.data.view(np.uint8).view(block_dtype(gt)).reshape(out_dim, nb)
    qs = blocks["qs"]  # (out, nb, 16)
    elems = np.empty((out_dim, nb, 32), dtype=np.uint8)
    elems[..., :16] = qs & 0xF
    elems[..., 16:] = qs >> 4
    elems = elems.reshape(out_dim, in_dim)
    half = in_dim // 2
    qh_lo = qh_hi = None
    if "qh" in blocks.dtype.names:
        qh = blocks["qh"].astype(np.uint32)  # bit r = 5th bit of element 32b+r
        bits = ((qh[..., None] >> np.arange(32, dtype=np.uint32)) & 1).reshape(out_dim, in_dim)
        qh_lo = _tensor(_natural_plane_words(bits[:, :half]), torch.uint8, device)
        qh_hi = _tensor(_natural_plane_words(bits[:, half:]), torch.uint8, device)
    return QuantLinear(
        codes=_tensor(elems[:, :half] | (elems[:, half:] << 4), torch.uint8, device),
        d=_tensor(blocks["d"].astype(np.float32), torch.float32, device),
        m=_tensor(blocks["m"].astype(np.float32), torch.float32, device)
        if "m" in blocks.dtype.names else None,
        ggml_type=int(gt),
        shape=(out_dim, in_dim),
        packed=True,
        qh_lo=qh_lo,
        qh_hi=qh_hi,
    )


def quantize_linear(w: np.ndarray, quant_type: str, packed: bool = True, device="cpu") -> QuantLinear:
    """A float (out, in) weight -> QuantLinear through ggml's codec
    ("q4_0" ... "q8_0"): the load path's layout (packed planes for q4/q5,
    int8 SoA for q8_0), or int8 SoA for any format with packed=False."""
    gt = QUANT_TYPE_NAMES[quant_type]
    raw = quantize(np.asarray(w, dtype=np.float32), gt)
    t = GGUFTensor(name="w", shape=tuple(w.shape), ggml_type=gt, data=raw)
    return _soa_from_blocks(t, device) if packed else _int8_soa(t, device)


def _int8_from_tensor(t: GGUFTensor, device="cpu") -> Int8Linear:
    """Per-row symmetric int8 requantization of a 2-D weight on the host,
    once at load (the JAX package's numpy code): f16/f32 directly, ggml
    blocks through their exact dequantization, so an int8 model made from a
    q8_0 file sees the values the dequant path would."""
    arr = np.asarray(t.as_numpy(), dtype=np.float32)
    if arr.ndim != 2:
        raise ValueError(f"int8 mode needs a 2D weight, got {arr.shape}")
    if not np.isfinite(arr).all():
        raise ValueError("int8 requantization refuses non-finite weights")
    s = np.abs(arr).max(axis=1) / 127.0
    s = np.maximum(s, 1e-12)
    codes = np.clip(np.rint(arr / s[:, None]), -127, 127).astype(np.int8)
    return Int8Linear(
        codes=_tensor(codes, torch.int8, device),
        s=_tensor(s, torch.float32, device),
        shape=(int(arr.shape[0]), int(arr.shape[1])),
    )


def _linear(
    tensors: dict[str, GGUFTensor], name: str, dtype: torch.dtype, device, quant_mode: str
) -> dict[str, Any]:
    """`{name}.weight` (out, in) as an (in, out) kernel; or kept (out, in) as
    an Int8Linear in quant_mode "int8", or as a QuantLinear when it is
    quantized and quant_mode is "fused"; plus its f32 bias."""
    w = tensors[f"{name}.weight"]
    if quant_mode == "int8":
        out: dict[str, Any] = {"kernel": _int8_from_tensor(w, device)}
    elif quant_mode == "fused" and w.ggml_type in QUANTIZED_TYPES:
        out = {"kernel": _soa_from_blocks(w, device)}
    else:  # as_numpy decodes ggml blocks to f32
        out = {"kernel": _tensor(w.as_numpy().T, dtype, device)}
    b = tensors.get(f"{name}.bias")
    if b is not None:
        out["bias"] = _tensor(b.as_numpy(), torch.float32, device)
    return out


QUANT_MODES = ("dequant", "fused", "int8")


def load_params(
    path: str | Path,
    dtype: torch.dtype = torch.bfloat16,
    device="cpu",
    quant_mode: str = "dequant",
) -> LoadedModel:
    """Load a GGUF checkpoint onto `device`: dense f16/f32, or ggml-quantized
    in `quant_mode` "dequant" (decoded at load) or "fused" (QuantLinear
    weights). A dense file ignores "fused", as in the JAX package. "int8"
    takes a file of any ftype and holds every linear weight as an
    Int8Linear; `quantized` stays False (no weight is a QuantLinear)."""
    if quant_mode not in QUANT_MODES:
        raise ValueError(f"quant_mode must be one of {QUANT_MODES}, got {quant_mode!r}")
    reader = GGUFReader(path)
    try:
        return _load(reader, dtype, device, quant_mode)
    finally:
        reader.close()


def _load(reader: GGUFReader, dtype: torch.dtype, device, quant_mode: str) -> LoadedModel:
    kv, tensors = reader.kv, reader.tensors
    config = DinoConfig.from_gguf_kv(kv)
    id2label = id2label_from_kv(kv, config.num_classes)
    quantized = GGMLType(config.ftype) in QUANTIZED_TYPES
    if not quantized and quant_mode == "fused":
        quant_mode = "dequant"  # "fused" needs ggml blocks to keep; "int8" takes any ftype
    # SwiGLU is detected from the tensors too, and written back into the config
    swiglu = config.swiglu or "encoder.layer.0.mlp.weights_in.weight" in tensors
    mlp_names = (
        {"win": "weights_in", "wout": "weights_out"} if swiglu else {"fc1": "fc1", "fc2": "fc2"}
    )

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
            "qkv": _linear(tensors, f"{base}.attention.attention.qkv", dtype, device, quant_mode),
            "proj": _linear(tensors, f"{base}.attention.output.dense", dtype, device, quant_mode),
            "ls1": f32(f"{base}.layer_scale1.lambda1"),
            "norm2": {"scale": f32(f"{base}.norm2.weight"), "bias": f32(f"{base}.norm2.bias")},
            "mlp": {
                key: _linear(tensors, f"{base}.mlp.{name}", dtype, device, quant_mode)
                for key, name in mlp_names.items()
            },
            "ls2": f32(f"{base}.layer_scale2.lambda1"),
        })
    p["layers"] = _stack(layers)
    p["final_norm"] = {"scale": f32("layernorm.weight"), "bias": f32("layernorm.bias")}
    has_classifier = "classifier.weight" in tensors
    if has_classifier:
        p["classifier"] = _linear(tensors, "classifier", dtype, device, quant_mode)
    if swiglu:
        # the real FFN hidden size comes from the weights, so a checkpoint off
        # the HF sizing rule (swiglu_hidden_dim) keeps its true GEMM shapes
        updates: dict[str, Any] = {}
        if config.use_swiglu_ffn is None:
            updates["use_swiglu_ffn"] = True
        if config.swiglu_hidden is None:
            updates["swiglu_hidden"] = (
                tensors["encoder.layer.0.mlp.weights_in.weight"].shape[0] // 2
            )
        if updates:
            config = DinoConfig(**{**config.__dict__, **updates})
    return LoadedModel(
        config=config, params=p, id2label=id2label, has_classifier=has_classifier,
        quantized=quantized and quant_mode == "fused",
    )
