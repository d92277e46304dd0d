"""The port's parameter loading against the JAX package's, leaf by leaf."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (caps torch's threads under xdist)

from dinov2_tpu.io.synthetic import write_synthetic_gguf
from dinov2_tpu.models import params as jparams
from dinov2_tpu.models.config import DinoConfig
from dinov2_tpu.quant.quantize import quantize_gguf
from dinov2_tpu_torch.models import params

TINY = DinoConfig(hidden_size=64, num_hidden_layers=2, num_attention_heads=2,
                  num_classes=4, patch_size=14, img_size=70)
DTYPES = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)]


def _leaves(jax_tree):
    """(key path, numpy leaf) pairs of a JAX params tree."""
    return [
        (tuple(k.key for k in path), np.asarray(leaf))
        for path, leaf in jax.tree_util.tree_flatten_with_path(jax_tree)[0]
    ]


def _at(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def _assert_same_tree(torch_tree, jax_tree):
    """Same structure, shapes, dtypes and bits."""
    leaves = _leaves(jax_tree)
    n_torch = len(jax.tree_util.tree_leaves(torch_tree))
    assert n_torch == len(leaves)
    for path, want in leaves:
        got = _at(torch_tree, path)
        assert tuple(got.shape) == want.shape, path
        assert str(got.dtype).removeprefix("torch.") == want.dtype.name, path
        np.testing.assert_array_equal(got.float().numpy(), want.astype(np.float32), err_msg=str(path))


@pytest.mark.parametrize("jdt, tdt", DTYPES)
@pytest.mark.parametrize("registers", [0, 4])
def test_init_params_bitwise_equal_to_jax(jdt, tdt, registers):
    config = DinoConfig(**{**TINY.__dict__, "num_register_tokens": registers})
    want = jparams.init_params(config, seed=7, dtype=jdt)
    got = params.init_params(config, seed=7, dtype=tdt)
    _assert_same_tree(got, want)


@pytest.mark.parametrize("jdt, tdt", DTYPES)
def test_load_params_equals_jax(tmp_path, jdt, tdt):
    config = DinoConfig(**{**TINY.__dict__, "num_register_tokens": 4})
    path = write_synthetic_gguf(tmp_path / "m.gguf", config, seed=3)
    want = jparams.load_params(path, dtype=jdt)
    got = params.load_params(path, dtype=tdt)
    assert got.config.__dict__ == want.config.__dict__  # the port's own DinoConfig class
    assert got.id2label == want.id2label
    assert got.has_classifier == want.has_classifier
    _assert_same_tree(got.params, want.params)


def test_load_params_without_classifier(tmp_path):
    path = write_synthetic_gguf(tmp_path / "m.gguf", TINY, seed=3, with_classifier=False)
    loaded = params.load_params(path, dtype=torch.float32)
    assert not loaded.has_classifier and "classifier" not in loaded.params


def test_load_params_refuses_quantized_and_swiglu(tmp_path):
    """Quantized files load in "dequant" and "fused" mode
    (tests/test_torch_quant.py), the W8A8 "int8" mode from any ftype
    (tests/test_torch_int8.py) and SwiGLU loads (tests/test_torch_giant.py);
    an unknown mode is refused."""
    dense = write_synthetic_gguf(tmp_path / "m.gguf", TINY, seed=3)
    q8 = tmp_path / "q8.gguf"
    quantize_gguf(dense, q8, "q8_0")
    with pytest.raises(ValueError, match="quant_mode"):
        params.load_params(q8, quant_mode="pallas")
    swiglu = DinoConfig(**{**TINY.__dict__, "use_swiglu_ffn": True})
    path = write_synthetic_gguf(tmp_path / "sw.gguf", swiglu, seed=3)
    loaded = params.load_params(path, dtype=torch.float32)
    assert loaded.config.swiglu and set(loaded.params["layers"]["mlp"]) == {"win", "wout"}
    assert set(params.init_params(swiglu)["layers"]["mlp"]) == {"win", "wout"}


@pytest.mark.parametrize("jdt", [jnp.float32, jnp.bfloat16])
def test_params_from_numpy_round_trips(jdt):
    """JAX params -> numpy -> port tensors keeps every bit and dtype; the
    port's tensors -> numpy -> port tensors is the identity."""
    jax_tree = jparams.init_params(TINY, seed=1, dtype=jdt)
    got = params.params_from_numpy(jax.tree_util.tree_map(np.asarray, jax_tree))
    _assert_same_tree(got, jax_tree)
    again = params.params_from_numpy(
        jax.tree_util.tree_map(lambda t: t.float().numpy(), got)
    )
    for a, b in zip(jax.tree_util.tree_leaves(again), jax.tree_util.tree_leaves(got)):
        assert torch.equal(a, b.float())
