"""Model configuration, mirroring the reference's `dino_hparams`.

Reference: dinov2.h:25-45 (fields + derived dims) and
dinov2.cpp:274-307 (GGUF KV names and load-time overrides).
KV schema is flat u32 keys: hidden_size, num_hidden_layers, num_attention_heads,
num_classes, patch_size, img_size, ftype, num_register_tokens; id2label entries are
string KVs keyed "0".."N-1" (written by the reference converter dinov2-to-gguf.py:130-132).

Quirk Q6 (SURVEY.md): the reference selects the SwiGLU FFN iff num_hidden_layers==40
(the reference dinov2.cpp:740-743). We honor that rule when loading reference-made
GGUFs and additionally read/write an explicit `use_swiglu_ffn` bool KV so that
non-giant SwiGLU configs (e.g. tiny test models) round-trip correctly.

The port's own copy of dinov2_tpu/models/config.py (standard library only).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

IMAGENET_DEFAULT_MEAN = (0.485, 0.456, 0.406)
IMAGENET_DEFAULT_STD = (0.229, 0.224, 0.225)


@dataclasses.dataclass(frozen=True)
class DinoConfig:
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    num_classes: int = 1000
    num_register_tokens: int = 0
    patch_size: int = 14
    img_size: int = 518
    ftype: int = 1
    eps: float = 1e-6
    use_swiglu_ffn: bool | None = None  # None = reference rule (layers == 40)
    mlp_ratio: float = 4.0
    swiglu_hidden: int | None = None  # inferred from weights at load if present

    @property
    def head_dim(self) -> int:
        # dino_hparams::n_enc_head_dim, the reference dinov2.cpp:39-41
        return self.hidden_size // self.num_attention_heads

    @property
    def swiglu_hidden_dim(self) -> int:
        """SwiGLU FFN hidden size: the explicit KV/weight-inferred value if
        present, else the HF Dinov2SwiGLUFFN sizing rule (2/3 * 4 * hidden,
        rounded up to a multiple of 8) — the ONE home of that formula."""
        if self.swiglu_hidden:
            return self.swiglu_hidden
        return -(-int(self.hidden_size * 4 * 2 / 3) // 8) * 8

    @property
    def n_img_embd(self) -> int:
        # dino_hparams::n_img_embd, the reference dinov2.cpp:51-53
        return self.img_size // self.patch_size

    @property
    def num_model_patches(self) -> int:
        return self.n_img_embd * self.n_img_embd

    @property
    def swiglu(self) -> bool:
        if self.use_swiglu_ffn is not None:
            return self.use_swiglu_ffn
        return self.num_hidden_layers == 40  # quirk Q6

    def grid_for(self, height: int, width: int) -> tuple[int, int]:
        """Patch grid for a preprocessed image size."""
        return height // self.patch_size, width // self.patch_size

    # ------------------------------------------------------------------
    @classmethod
    def from_gguf_kv(cls, kv: Mapping[str, Any]) -> "DinoConfig":
        use_swiglu = kv.get("use_swiglu_ffn")
        return cls(
            hidden_size=int(kv["hidden_size"]),
            num_hidden_layers=int(kv["num_hidden_layers"]),
            num_attention_heads=int(kv["num_attention_heads"]),
            num_classes=int(kv.get("num_classes", 0)),
            num_register_tokens=int(kv.get("num_register_tokens", 0)),
            patch_size=int(kv["patch_size"]),
            img_size=int(kv["img_size"]),
            # the reference strips the quantization version before use:
            # hparams.ftype %= GGML_QNT_VERSION_FACTOR (1000), dinov2.cpp:307
            ftype=int(kv["ftype"]) % 1000,
            use_swiglu_ffn=bool(use_swiglu) if use_swiglu is not None else None,
        )

    def to_gguf_kv(self) -> dict[str, int]:
        kv = {
            "hidden_size": self.hidden_size,
            "num_hidden_layers": self.num_hidden_layers,
            "num_attention_heads": self.num_attention_heads,
            "num_classes": self.num_classes,
            "patch_size": self.patch_size,
            "img_size": self.img_size,
            "ftype": self.ftype,
            "num_register_tokens": self.num_register_tokens,
        }
        if self.use_swiglu_ffn is not None:
            kv["use_swiglu_ffn"] = int(self.use_swiglu_ffn)
        return kv


def id2label_from_kv(kv: Mapping[str, Any], num_classes: int) -> dict[int, str]:
    """id2label travels as per-index string KVs ("0".."N-1"), reference
    the reference dinov2.cpp:297-305."""
    return {i: kv.get(str(i), str(i)) for i in range(num_classes)}


# Published model presets (HF checkpoint names used by the reference README/bench).
PRESETS: dict[str, DinoConfig] = {
    "small": DinoConfig(hidden_size=384, num_hidden_layers=12, num_attention_heads=6),
    "base": DinoConfig(hidden_size=768, num_hidden_layers=12, num_attention_heads=12),
    "large": DinoConfig(hidden_size=1024, num_hidden_layers=24, num_attention_heads=16),
    "giant": DinoConfig(
        hidden_size=1536,
        num_hidden_layers=40,
        num_attention_heads=24,
        use_swiglu_ffn=True,
        swiglu_hidden=4096,
    ),
}
