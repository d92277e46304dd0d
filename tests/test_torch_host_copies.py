"""The port's own copies of the host modules (models/config.py, io/gguf.py,
io/synthetic.py, quant/blocks.py, quant/quantize.py, utils/native.py) against
the JAX package's originals: the same seed gives the same bytes, and each
package reads the other's files."""

import dataclasses

import numpy as np
import pytest
import torch_threads  # noqa: F401  (caps torch's threads under xdist)

from dinov2_tpu.io import gguf as jgguf
from dinov2_tpu.io.synthetic import write_synthetic_gguf as jwrite_synthetic_gguf
from dinov2_tpu.models import config as jconfig
from dinov2_tpu.quant import blocks as jblocks
from dinov2_tpu.quant.quantize import quantize_gguf as jquantize_gguf
from dinov2_tpu.utils import native as jnative
from dinov2_tpu_torch.io import gguf
from dinov2_tpu_torch.io.synthetic import write_synthetic_gguf
from dinov2_tpu_torch.models import config
from dinov2_tpu_torch.quant import blocks, quantize_gguf
from dinov2_tpu_torch.utils import native

FORMATS = ["q4_0", "q4_1", "q5_0", "q5_1", "q8_0"]


def _tiny(cls, **over):
    return cls(**{"hidden_size": 64, "num_hidden_layers": 2, "num_attention_heads": 2,
                  "num_classes": 4, "num_register_tokens": 4, "patch_size": 14, "img_size": 70,
                  **over})


def test_config_and_presets_agree_field_for_field():
    assert [f.name for f in dataclasses.fields(config.DinoConfig)] == [
        f.name for f in dataclasses.fields(jconfig.DinoConfig)
    ]
    assert set(config.PRESETS) == set(jconfig.PRESETS) and "giant" in config.PRESETS
    for name, preset in config.PRESETS.items():
        want = jconfig.PRESETS[name]
        assert preset.__dict__ == want.__dict__, name
        for prop in ("head_dim", "n_img_embd", "num_model_patches", "swiglu", "swiglu_hidden_dim"):
            assert getattr(preset, prop) == getattr(want, prop), (name, prop)
        assert preset.to_gguf_kv() == want.to_gguf_kv()
    assert config.IMAGENET_DEFAULT_MEAN == jconfig.IMAGENET_DEFAULT_MEAN
    assert config.IMAGENET_DEFAULT_STD == jconfig.IMAGENET_DEFAULT_STD
    kv = {"3": "c", "0": "a"}
    assert config.id2label_from_kv(kv, 4) == jconfig.id2label_from_kv(kv, 4)


@pytest.mark.parametrize("swiglu", [False, True])
def test_synthetic_gguf_same_bytes(tmp_path, swiglu):
    """write_synthetic_gguf of both packages, same seed: byte-identical
    files, GELU and SwiGLU (a hidden size off the default rule)."""
    over = {"use_swiglu_ffn": True, "swiglu_hidden": 96} if swiglu else {}
    ours = write_synthetic_gguf(tmp_path / "a.gguf", _tiny(config.DinoConfig, **over), seed=5)
    theirs = jwrite_synthetic_gguf(tmp_path / "b.gguf", _tiny(jconfig.DinoConfig, **over), seed=5)
    assert ours.read_bytes() == theirs.read_bytes()


@pytest.mark.parametrize("fmt", FORMATS)
def test_quantize_gguf_same_bytes_and_cross_read(tmp_path, fmt):
    """quantize_gguf of both packages on the same dense file: byte-identical
    outputs; each package's GGUFReader reads the other's file to the same
    KVs and the same (dequantized) tensors."""
    dense = write_synthetic_gguf(tmp_path / "m.gguf", _tiny(config.DinoConfig), seed=9)
    ours = quantize_gguf(dense, tmp_path / "a.gguf", fmt)
    theirs = jquantize_gguf(dense, tmp_path / "b.gguf", fmt)
    assert ours.read_bytes() == theirs.read_bytes()
    mine, other = gguf.GGUFReader(theirs), jgguf.GGUFReader(ours)
    try:
        assert mine.kv == other.kv
        assert config.DinoConfig.from_gguf_kv(mine.kv).__dict__ == \
            jconfig.DinoConfig.from_gguf_kv(other.kv).__dict__
        assert list(mine.tensors) == list(other.tensors)
        for name, t in mine.tensors.items():
            o = other.tensors[name]
            assert (t.shape, int(t.ggml_type)) == (o.shape, int(o.ggml_type)), name
            np.testing.assert_array_equal(t.as_numpy(), o.as_numpy(), err_msg=name)
    finally:
        mine.close()
        other.close()


@pytest.mark.parametrize("use_native", [False, True])
@pytest.mark.parametrize("fmt", FORMATS)
def test_block_codecs_same_bytes(monkeypatch, fmt, use_native):
    """quantize, dequantize and unpack_codes of the copy against the
    original, through the numpy codecs and (where csrc/libdinogguf.so is
    built) through the native library the two bindings share."""
    if use_native and not (native.available() and jnative.available()):
        pytest.skip("csrc/libdinogguf.so is not built")
    if not use_native:
        monkeypatch.setenv("DINOV2_TPU_NO_NATIVE", "1")
        monkeypatch.setattr(native, "_lib", None)
        monkeypatch.setattr(jnative, "_lib", None)
    gt, jgt = gguf.GGMLType[fmt.upper()], jgguf.GGMLType[fmt.upper()]
    w = (np.random.default_rng(3).standard_normal((24, 128)) * 0.7).astype(np.float32)
    raw, jraw = blocks.quantize(w, gt), jblocks.quantize(w, jgt)
    assert raw.tobytes() == jraw.tobytes()
    np.testing.assert_array_equal(blocks.dequantize(raw, gt, w.shape),
                                  jblocks.dequantize(jraw, jgt, w.shape))
    for got, want in zip(blocks.unpack_codes(raw, gt, w.shape),
                         jblocks.unpack_codes(jraw, jgt, w.shape)):
        assert (got is None) == (want is None)
        if got is not None:
            np.testing.assert_array_equal(got, want)
    assert blocks.block_dtype(gt) == jblocks.block_dtype(jgt)
