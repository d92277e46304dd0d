"""SwiGLU (ViT-g/14), the slab attention cores K3 and K2, the MLP half-layer
K5 and the slab route's levels, against the JAX package on the CPU.

Inputs come from numpy seeds and go through both packages, f32. The JAX
Pallas kernels run as the JAX package's own tests run them here
(`interpret=True`); whole JAX forwards take `flash_attention="slab"`, since
its "auto" is the vanilla route off a TPU. At these tiny widths the JAX VMEM
gates pick K1 for a whole forward (same ordering as K2 and K3, which the
function-level tests hold against JAX themselves)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (caps torch's threads under xdist)

from dinov2_tpu.io.synthetic import write_synthetic_gguf
from dinov2_tpu.models import params as jparams
from dinov2_tpu.models import vit as jvit
from dinov2_tpu.models.config import DinoConfig
from dinov2_tpu.ops import fused_attention as jfused
from dinov2_tpu.quant.quantize import quantize_gguf
from dinov2_tpu_torch.models import params, vit
from dinov2_tpu_torch.models.params import params_from_numpy
from dinov2_tpu_torch.ops import attention, fused_attention
from dinov2_tpu_torch.runtime.engine import DinoEngine

# two heads of 64 so that the same files could run on a card; a SwiGLU hidden
# size (160) off the default rule (344 at D=128) and a multiple of 32 (ggml)
SWIGLU = DinoConfig(hidden_size=128, num_hidden_layers=2, num_attention_heads=2, num_classes=4,
                    num_register_tokens=4, patch_size=14, img_size=70, use_swiglu_ffn=True,
                    swiglu_hidden=160)
GELU = DinoConfig(hidden_size=128, num_hidden_layers=3, num_attention_heads=2, num_classes=4,
                  patch_size=14, img_size=70)
# tests/test_torch_slice.py's f32 bounds against the JAX forward: 6e-6 is
# docs/PARITY.md's f32 envelope (hf mode); reference mode adds the f16 GELU
# rounding flips that file explains (5e-5). SwiGLU has no f16 GELU, so both
# of its modes sit within the hf bound times a small margin.
TOKEN_ATOL = {"hf": 6e-6, "reference": 5e-5}
PROB_ATOL = 1e-6


def _t(tree):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, tree))


def _images(seed, n=2, px=70):
    return np.random.default_rng(seed).standard_normal((n, px, px, 3)).astype(np.float32)


def _slab_inputs(seed, b, t, d):
    rng = np.random.default_rng(seed)
    return {
        "x": rng.standard_normal((b, t, d)),
        "qkv": rng.standard_normal((b, t, 3 * d)) * 1.5,
        "w_proj": rng.standard_normal((d, d)) * 0.05,
        "b_proj": rng.standard_normal(d) * 0.1,
        "ls1": rng.uniform(0.1, 1.0, d),
    }


@pytest.mark.parametrize("b, t, heads", [(2, 37, 2), (1, 5, 1), (3, 64, 3)])
def test_slab_attention_matches_jax(b, t, heads):
    """K3's plain version against the JAX kernel (interpret mode) and the JAX
    unfused reference, at test_pallas_kernels.py's tolerance for the slab
    kernel (1e-5: its exp2 softmax with a shifted max reassociates); T not a
    multiple of 8 included."""
    a = _slab_inputs(t, b, t, 64 * heads)
    qkv = a["qkv"].astype(np.float32)
    kernel = np.asarray(jfused.slab_attention(jnp.asarray(qkv), heads, 0.125, True))
    unfused = np.asarray(jfused._slab_reference(jnp.asarray(qkv), heads, 0.125))
    got = fused_attention.slab_attention(torch.from_numpy(qkv), heads, 0.125).numpy()
    assert got.shape == (b, t, 64 * heads)
    np.testing.assert_allclose(got, kernel, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, unfused, rtol=2e-6, atol=2e-6)


@pytest.mark.parametrize("b, t, heads", [(2, 37, 2), (1, 5, 1)])
def test_slab_attention_block_matches_jax(b, t, heads):
    """K2's plain version against the JAX kernel (interpret mode) and the JAX
    unfused reference."""
    a = {k: v.astype(np.float32) for k, v in _slab_inputs(t + 1, b, t, 64 * heads).items()}
    order = ("x", "qkv", "w_proj", "b_proj", "ls1")
    j_args = [jnp.asarray(a[k]) for k in order]
    kernel = np.asarray(jfused.slab_attention_block(*j_args, heads, 0.125, True))
    unfused = np.asarray(jfused._slab_block_reference(*j_args, heads, 0.125))
    got = fused_attention.slab_attention_block(
        *[torch.from_numpy(a[k]) for k in order], heads, 0.125
    ).numpy()
    np.testing.assert_allclose(got, kernel, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, unfused, rtol=2e-6, atol=2e-6)


def _mlp_inputs(seed, b, t, d):
    rng = np.random.default_rng(seed)
    return [a.astype(np.float32) for a in (
        rng.standard_normal((b, t, d)), rng.uniform(0.5, 1.5, d), rng.standard_normal(d) * 0.1,
        rng.standard_normal((d, 4 * d)) * 0.05, rng.standard_normal(4 * d) * 0.1,
        rng.standard_normal((4 * d, d)) * 0.05, rng.standard_normal(d) * 0.1,
        rng.uniform(0.1, 1.0, d),
    )]


@pytest.mark.parametrize("activation", ["gelu_tanh_f16", "gelu_erf", "gelu_tanh"])
@pytest.mark.parametrize("flat", ["auto", "off"])
def test_slab_mlp_block_matches_jax(monkeypatch, flat, activation):
    """K5's plain version against both JAX Pallas variants in interpret mode
    (the flattened-rows one, and the per-image one forced with
    DINOV2_TPU_MLP_FLAT=off) and the JAX unfused reference, T=5 (not a
    multiple of 8). gelu_tanh_f16 rounds g to f16, so where the two
    packages' f32 fc1 outputs straddle an f16 boundary g moves by one f16
    ulp (2^-11 of |g| <= ~3) and fc2 (|w2| ~ 0.05, times ls2 <= 1) carries
    ~1e-4 of it into the output: its bound is 2e-4, the others' 5e-6."""
    b, t, d = 8, 5, 64
    arrays = _mlp_inputs(7, b, t, d)
    j_args = [jnp.asarray(a) for a in arrays]
    monkeypatch.setenv("DINOV2_TPU_MLP_FLAT", flat)
    flat_calls = []
    real_flat = jfused._slab_mlp_flat
    monkeypatch.setattr(jfused, "_slab_mlp_flat",
                        lambda *a, **k: flat_calls.append(1) or real_flat(*a, **k))
    kernel = np.asarray(jfused.slab_mlp_block(*j_args, activation, 1e-6, True))
    assert bool(flat_calls) == (flat == "auto")  # the variant the case names ran
    unfused = np.asarray(jfused._slab_mlp_reference(*j_args, activation, 1e-6))
    got = fused_attention.slab_mlp_block(
        *[torch.from_numpy(a) for a in arrays], activation, 1e-6
    ).numpy()
    tol = 2e-4 if activation == "gelu_tanh_f16" else 5e-6
    np.testing.assert_allclose(got, kernel, rtol=0, atol=tol)
    np.testing.assert_allclose(got, unfused, rtol=0, atol=tol)


def test_slab_wrappers_refuse_other_devices_and_activations():
    meta = torch.zeros((1, 3, 192), device="meta")
    with pytest.raises(ValueError, match="no slab_attention for device"):
        fused_attention.slab_attention(meta, 1, 0.125)
    with pytest.raises(ValueError, match="no slab_attention_block for device"):
        fused_attention.slab_attention_block(meta[..., :64], meta, *([None] * 3), 1, 0.125)
    with pytest.raises(ValueError, match="no slab_mlp_block for device"):
        fused_attention.slab_mlp_block(meta, *([None] * 7), "gelu_erf", 1e-6)
    with pytest.raises(ValueError, match="unknown activation"):
        fused_attention.slab_mlp_block(torch.zeros((1, 3, 64)), *([None] * 7), "relu", 1e-6)


def _k2_args(d=128, dtype=torch.bfloat16):
    bf = torch.bfloat16
    return {"qkv": torch.zeros((2, 5, 3 * d), dtype=dtype), "num_heads": d // 64,
            "x": torch.zeros((2, 5, d), dtype=dtype), "w_proj": torch.zeros((d, d), dtype=bf),
            "b_proj": torch.zeros(d), "ls1": torch.ones(d)}


@pytest.mark.parametrize("case, error", [
    ("f16 slab", NotImplementedError),
    ("head_dim 32", NotImplementedError),
    ("slab not (B, T, 3D)", ValueError),
    ("w_proj in f32", ValueError),
    ("x of another batch", ValueError),
    ("slab not contiguous", ValueError),
])
def test_slab_attention_argument_checks(case, error):
    """What K3 and K2 refuse on a card, checked before any launch (the
    checks read metadata only, so CPU tensors do)."""
    args = _k2_args()
    if case == "f16 slab":  # the kernels take bf16 and f32
        args = _k2_args(dtype=torch.float16)
    elif case == "head_dim 32":
        args["num_heads"] = 4
    elif case == "slab not (B, T, 3D)":
        args["qkv"] = torch.zeros((2, 5, 128), dtype=torch.bfloat16)
    elif case == "w_proj in f32":
        args["w_proj"] = args["w_proj"].float()
    elif case == "x of another batch":
        args["x"] = torch.zeros((3, 5, 128), dtype=torch.bfloat16)
    elif case == "slab not contiguous":
        args["qkv"] = torch.zeros((2, 384, 5), dtype=torch.bfloat16).transpose(1, 2)
    fused_attention.check_slab_attention_args(**_k2_args())  # the valid sets pass
    fused_attention.check_slab_attention_args(_k2_args()["qkv"], 2)
    with pytest.raises(error):
        fused_attention.check_slab_attention_args(**args)


def _k5_args(d=384, dh=None, dtype=torch.bfloat16, wdtype=None):
    dh = 4 * d if dh is None else dh
    w = dtype if wdtype is None else wdtype
    return [torch.zeros((2, 5, d), dtype=dtype), torch.ones(d), torch.zeros(d),
            torch.zeros((d, dh), dtype=w), torch.zeros(dh), torch.zeros((dh, d), dtype=w),
            torch.zeros(d), torch.ones(d)]


@pytest.mark.parametrize("case, error", [
    ("f16 activations", NotImplementedError),  # bf16 and f32 only
    ("D=128", NotImplementedError),  # bf16 at a width its kernel is not built for
    ("f32 D=120", NotImplementedError),  # f32 takes D % 16 == 0
    ("f32 x, bf16 weights", ValueError),
    ("DH = 2 D", NotImplementedError),
    ("w2 transposed", ValueError),
    ("b1 in bf16", ValueError),
])
def test_slab_mlp_argument_checks(case, error):
    """What K5 refuses on a card, checked before any launch."""
    args = _k5_args()
    if case == "f16 activations":
        args = _k5_args(dtype=torch.float16)
    elif case == "D=128":
        args = _k5_args(d=128)
    elif case == "f32 D=120":
        args = _k5_args(d=120, dtype=torch.float32)
    elif case == "f32 x, bf16 weights":
        args = _k5_args(dtype=torch.float32, wdtype=torch.bfloat16)
    elif case == "DH = 2 D":
        args = _k5_args(dh=768)
    elif case == "w2 transposed":
        args[5] = args[5].T.contiguous()
    elif case == "b1 in bf16":
        args[4] = args[4].to(torch.bfloat16)
    for d in fused_attention.MLP_KERNEL_WIDTHS:
        fused_attention.check_slab_mlp_args(*_k5_args(d=d))  # the valid sets pass
    for d in (64, 128, 768):  # f32: any D % 16 == 0
        fused_attention.check_slab_mlp_args(*_k5_args(d=d, dtype=torch.float32))
    with pytest.raises(error):
        fused_attention.check_slab_mlp_args(*args)


def test_swiglu_block_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 9, 32)).astype(np.float32)
    p = {"win": {"kernel": rng.standard_normal((32, 2 * 24)).astype(np.float32) * 0.3,
                 "bias": rng.standard_normal(2 * 24).astype(np.float32)},
         "wout": {"kernel": rng.standard_normal((24, 32)).astype(np.float32) * 0.3,
                  "bias": rng.standard_normal(32).astype(np.float32)}}
    want = np.asarray(jvit.swiglu_block(jnp.asarray(x), jax.tree_util.tree_map(jnp.asarray, p)))
    got = vit.swiglu_block(torch.from_numpy(x), _t(p)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("jdt, tdt", [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)])
def test_swiglu_init_params_bitwise_equal_to_jax(jdt, tdt):
    """One seed, the same SwiGLU weights in both packages, bit for bit, at
    the inferred default hidden size and at an explicit one."""
    for config in (SWIGLU, DinoConfig(**{**SWIGLU.__dict__, "swiglu_hidden": None})):
        want = jparams.init_params(config, seed=7, dtype=jdt)
        got = params.init_params(config, seed=7, dtype=tdt)
        leaves, tree_def = jax.tree_util.tree_flatten(want)
        got_leaves, got_def = jax.tree_util.tree_flatten(got)
        assert tree_def == got_def
        assert got["layers"]["mlp"]["win"]["kernel"].shape == (
            2, 128, 2 * config.swiglu_hidden_dim)
        for g, w in zip(got_leaves, leaves):
            w = np.asarray(w)
            assert tuple(g.shape) == w.shape and str(g.dtype).removeprefix("torch.") == w.dtype.name
            np.testing.assert_array_equal(g.float().numpy(), w.astype(np.float32))


@pytest.mark.parametrize("explicit_kv", [True, False])
def test_swiglu_load_params_equals_jax(tmp_path, explicit_kv):
    """A SwiGLU GGUF loads to the JAX tree leaf for leaf, and SwiGLU and the
    real hidden size are written back into the config: from the
    `use_swiglu_ffn` KV, or detected from the tensors alone when the file
    carries no such KV (as a 40-layer reference checkpoint does not)."""
    path = write_synthetic_gguf(tmp_path / "g.gguf", SWIGLU, seed=3)
    if not explicit_kv:  # the same tensors under a config that does not say SwiGLU
        from dinov2_tpu.io.gguf import GGUFReader, GGUFWriter

        reader = GGUFReader(path)
        writer = GGUFWriter(tmp_path / "g2.gguf", arch="")
        for key, value in reader.kv.items():
            if key != "use_swiglu_ffn":
                writer.add_kv(key, value, reader.kv_types[key], reader.kv_array_types.get(key))
        for t in reader.tensors.values():
            writer.add_tensor(t.name, t.data, t.ggml_type, t.shape)
        writer.write()
        reader.close()
        path = tmp_path / "g2.gguf"
    want = jparams.load_params(path, dtype=jnp.float32)
    got = params.load_params(path, dtype=torch.float32)
    assert got.config.__dict__ == want.config.__dict__
    assert got.config.swiglu and got.config.swiglu_hidden == 160
    leaves, tree_def = jax.tree_util.tree_flatten(want.params)
    got_leaves, got_def = jax.tree_util.tree_flatten(got.params)
    assert tree_def == got_def and set(got.params["layers"]["mlp"]) == {"win", "wout"}
    for g, w in zip(got_leaves, leaves):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_swiglu_params_from_numpy_round_trips():
    tree = jparams.init_params(SWIGLU, seed=1, dtype=jnp.bfloat16)
    got = _t(tree)
    assert got["layers"]["mlp"]["wout"]["kernel"].dtype == torch.bfloat16
    for g, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(g.float().numpy(), np.asarray(w).astype(np.float32))


def _jax_forward(loaded, parity, x, env=(), **opts):
    """The JAX forward on its slab route; environment knobs are read at trace
    time, so the jit cache is cleared around the call."""
    jopts = jvit.ModelOptions(parity=parity, compute_dtype=jnp.float32, flash_attention="slab",
                              **opts)
    with pytest.MonkeyPatch.context() as mp:
        for key, value in env:
            mp.setenv(key, value)
        jax.clear_caches()
        out = jvit.forward(loaded.params, jnp.asarray(x), loaded.config, jopts, classify=True)
        out = {k: np.asarray(v) for k, v in out.items()}
    jax.clear_caches()
    return out


def _port_forward(loaded, parity, x, **opts):
    popts = vit.ModelOptions(parity=parity, compute_dtype=torch.float32, **opts)
    out = vit.forward(loaded.params, torch.from_numpy(x), loaded.config, popts, classify=True)
    return {k: v.numpy() for k, v in out.items()}


def _assert_close(got, want, token_atol, prob_atol=PROB_ATOL):
    for key in ("cls_token", "patch_tokens"):
        np.testing.assert_allclose(got[key], want[key], atol=token_atol, rtol=0, err_msg=key)
    np.testing.assert_allclose(got["probs"], want["probs"], atol=prob_atol, rtol=0)


@pytest.fixture(scope="module")
def swiglu_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("giant")
    dense = write_synthetic_gguf(root / "g.gguf", SWIGLU, seed=11)
    return {"f16": dense, **{fmt: quantize_gguf(dense, root / f"g.{fmt}.gguf", fmt)
                             for fmt in ("q4_0", "q8_0")}}


@pytest.mark.parametrize("parity", ["hf", "reference"])
def test_swiglu_forward_matches_jax(swiglu_files, parity):
    """A tiny dense SwiGLU model (registers, a hidden size off the default
    rule) through both forwards. Measured 2.6e-6 on tokens in both
    modes; bound 1e-5: the f32 envelope with room for the
    other summation orders, no f16 GELU on this path."""
    x = _images(21)
    want = _jax_forward(jparams.load_params(swiglu_files["f16"], dtype=jnp.float32), parity, x)
    got = _port_forward(params.load_params(swiglu_files["f16"], dtype=torch.float32), parity, x)
    _assert_close(got, want, 1e-5)


@pytest.mark.parametrize("fmt", ["q4_0", "q8_0"])
@pytest.mark.parametrize("parity", ["hf", "reference"])
def test_swiglu_fused_quant_forward_matches_jax(swiglu_files, parity, fmt):
    """The same model quantized, quant_mode="fused": K8's plain version for
    the attention half, K7's for win, wout and the head, against the JAX
    fused forward with its K8 in interpret mode and the dequant-weight
    matmul backend (tests/test_torch_quant.py's pairing). Bound: that file's
    5e-5 on tokens."""
    x = _images(22)
    env = (("DINOV2_TPU_QUANT_SLAB", "kernel"), ("DINOV2_TPU_QUANT_BACKEND", "xla"))
    jl = jparams.load_params(swiglu_files[fmt], dtype=jnp.float32, quant_mode="fused")
    pl = params.load_params(swiglu_files[fmt], dtype=torch.float32, quant_mode="fused")
    assert pl.quantized and pl.config.swiglu
    assert isinstance(pl.params["layers"]["mlp"]["win"]["kernel"], params.QuantLinear)
    _assert_close(_port_forward(pl, parity, x), _jax_forward(jl, parity, x, env), 5e-5)


@pytest.fixture(scope="module")
def gelu_model():
    tree = jparams.init_params(GELU, seed=4, dtype=jnp.float32)
    # biases, LayerScale and norms off their init values, so every term counts
    rng = np.random.default_rng(4)
    tree = jax.tree_util.tree_map(
        lambda a: a if a.ndim > 2 else jnp.asarray(
            np.asarray(a) + rng.standard_normal(a.shape).astype(np.float32) * 0.05), tree)
    jl = jparams.LoadedModel(config=GELU, params=tree, id2label={}, has_classifier=True,
                             quantized=False)
    pl = params.LoadedModel(config=GELU, params=_t(tree), id2label={}, has_classifier=True)
    return jl, pl


@pytest.mark.parametrize("parity", ["hf", "reference"])
def test_fuse_mlp_forward_matches_jax_and_unfused(gelu_model, parity):
    """fuse_mlp=True (K5's plain version in every layer) against the JAX
    forward with fuse_mlp=True (its Pallas MLP kernel, interpreted) and
    against the port's own fuse_mlp=False: <= 6e-6 on tokens in hf mode, the
    logged f16-GELU gap <= 5e-5 in reference mode."""
    jl, pl = gelu_model
    x = _images(23)
    got = _port_forward(pl, parity, x, fuse_mlp=True)
    _assert_close(got, _jax_forward(jl, parity, x, fuse_mlp=True), TOKEN_ATOL[parity])
    _assert_close(got, _port_forward(pl, parity, x), TOKEN_ATOL[parity])


def _count(monkeypatch, module, name, calls):
    real = getattr(module, name)

    def counted(*args, **kwargs):
        calls[name] = calls.get(name, 0) + 1
        return real(*args, **kwargs)

    monkeypatch.setattr(module, name, counted)


WRAPPERS = ("slab_layer_block", "slab_attention_block", "slab_attention", "slab_mlp_block",
            "slab_layer_block_quant")


def _counted_forward(monkeypatch, loaded, x, **opts):
    """The port's forward with every slab wrapper counted."""
    from dinov2_tpu_torch.ops import fused_quant_attention

    calls: dict = {}
    with monkeypatch.context() as mp:
        # the wrappers are looked up in fused_attention at call time by
        # ops/attention.py and through vit's own names by models/vit.py
        _count(mp, fused_attention, "slab_attention", calls)
        _count(mp, fused_attention, "slab_attention_block", calls)
        _count(mp, vit, "slab_layer_block", calls)
        _count(mp, vit, "slab_mlp_block", calls)
        _count(mp, vit, "slab_layer_block_quant", calls)
        assert fused_quant_attention.slab_layer_block_quant is not vit.slab_layer_block_quant
        out = _port_forward(loaded, "hf", x, **opts)
    return out, {name: calls.get(name, 0) for name in WRAPPERS}


@pytest.mark.parametrize("level, wrapper", [
    ("auto", "slab_layer_block"), ("layer", "slab_layer_block"),
    ("proj", "slab_attention_block"), ("core", "slab_attention"),
])
def test_slab_fusion_levels_agree_and_reach_their_wrapper(monkeypatch, gelu_model, level, wrapper):
    """Each level of the slab route reaches the wrapper it names, once a
    layer, and no other attention wrapper; all give the same tokens on the
    CPU within 1e-6 (the plain versions share their ordering)."""
    _, pl = gelu_model
    x = _images(24, n=1)
    want = _port_forward(pl, "hf", x)
    got, calls = _counted_forward(monkeypatch, pl, x, slab_fusion=level, fuse_mlp=True)
    attention_calls = {k: v for k, v in calls.items() if k != "slab_mlp_block"}
    assert attention_calls == {k: GELU.num_hidden_layers * (k == wrapper) for k in attention_calls}
    assert calls["slab_mlp_block"] == GELU.num_hidden_layers
    _assert_close(got, want, 6e-6)
    _assert_close(_port_forward(pl, "hf", x, slab_fusion=level), want, 1e-6)


def test_fuse_mlp_and_slab_fusion_are_slab_route_options(monkeypatch, gelu_model):
    """Off the slab route no slab wrapper runs, whatever the options say, and
    SwiGLU takes no fused MLP route; bad option values raise."""
    _, pl = gelu_model
    x = _images(25, n=1)
    for route in ("flash", "vanilla"):
        _, calls = _counted_forward(monkeypatch, pl, x, flash_attention=route, fuse_mlp=True,
                                    slab_fusion="core")
        assert not any(calls.values()), (route, calls)
    sw = params.LoadedModel(config=SWIGLU, params=params.init_params(SWIGLU, 1, torch.float32),
                            id2label={}, has_classifier=True)
    _, calls = _counted_forward(monkeypatch, sw, x, fuse_mlp=True)
    assert calls["slab_mlp_block"] == 0 and calls["slab_layer_block"] == 2
    with pytest.raises(ValueError, match="slab_fusion"):
        vit.ModelOptions(slab_fusion="slab")


@pytest.mark.parametrize("quant", [
    {"slab_fusion": "layer"}, {"slab_fusion": "proj"}, {"slab_fusion": "core"},
    {"quant_slab": "off"}, {"quant_slab": "off", "slab_fusion": "proj"},
    {"quant_slab": "dequant", "slab_fusion": "proj"},
])
def test_quantized_slab_levels_reach_their_wrappers(monkeypatch, swiglu_files, quant):
    """Quantized weights at each level: "layer" is K8; "proj" dequantizes
    proj into K2 (the JAX package's rule) unless quant_slab is "off";
    "core" and quant_slab="off" run K3 between quant_matmul calls. All agree
    with the default route within f32 reassociation."""
    pl = params.load_params(swiglu_files["q8_0"], dtype=torch.float32, quant_mode="fused")
    x = _images(26, n=1)
    want = _port_forward(pl, "hf", x)
    got, calls = _counted_forward(monkeypatch, pl, x, **quant)
    level = quant.get("slab_fusion", "layer")
    if quant.get("quant_slab") == "off" or level == "core":
        expected = "slab_attention"
    elif level == "proj":
        expected = "slab_attention_block"
    else:
        expected = "slab_layer_block_quant"
    assert calls == {k: 2 * (k == expected) for k in WRAPPERS}
    _assert_close(got, want, 2e-6)


def test_fuse_mlp_dequantizes_a_quantized_pair(monkeypatch, tmp_path):
    """With fuse_mlp a quantized fc1/fc2 pair is dequantized into K5 unless
    quant_slab is "off"; both agree with the unfused quantized forward."""
    dense = write_synthetic_gguf(tmp_path / "m.gguf", GELU, seed=6)
    pl = params.load_params(quantize_gguf(dense, tmp_path / "q.gguf", "q4_0"),
                            dtype=torch.float32, quant_mode="fused")
    x = _images(27, n=1)
    want = _port_forward(pl, "hf", x)
    got, calls = _counted_forward(monkeypatch, pl, x, fuse_mlp=True)
    assert calls["slab_mlp_block"] == 3 and calls["slab_layer_block_quant"] == 3
    _assert_close(got, want, 6e-6)
    got, calls = _counted_forward(monkeypatch, pl, x, fuse_mlp=True, quant_slab="off")
    assert calls["slab_mlp_block"] == 0 and calls["slab_attention"] == 3
    _assert_close(got, want, 6e-6)


def test_engine_takes_slab_fusion_and_fuse_mlp(tmp_path):
    """DinoEngine's keywords reach ModelOptions; a tiny ViT-g-like file
    classifies through every level on the CPU to the same probabilities."""
    path = write_synthetic_gguf(tmp_path / "g.gguf", SWIGLU, seed=8)
    imgs = np.random.default_rng(8).integers(0, 256, (3, 80, 90, 3), dtype=np.uint8)
    base = DinoEngine(path, dtype=torch.float32, device="cpu")
    assert base.config.swiglu and base.opts.slab_fusion == "auto" and not base.opts.fuse_mlp
    want = base.classify_probs(imgs)
    for level in ("layer", "proj", "core"):
        engine = DinoEngine(path, dtype=torch.float32, device="cpu", slab_fusion=level,
                            fuse_mlp=True)
        assert engine.opts.slab_fusion == level and engine.opts.fuse_mlp
        np.testing.assert_allclose(engine.classify_probs(imgs), want, atol=1e-6, rtol=0)


def test_self_attention_slab_route_is_the_k3_core(monkeypatch):
    """ops/attention.py::self_attention on the slab route calls
    slab_attention and agrees with the vanilla route."""
    calls: dict = {}
    _count(monkeypatch, fused_attention, "slab_attention", calls)
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.standard_normal((1, 5, 64)).astype(np.float32))
    qkv = {"kernel": torch.from_numpy(rng.standard_normal((64, 192)).astype(np.float32) * 0.1)}
    proj = {"kernel": torch.from_numpy(rng.standard_normal((64, 64)).astype(np.float32) * 0.1)}
    got = attention.self_attention(x, qkv, proj, 1, flash="slab")
    want = attention.self_attention(x, qkv, proj, 1, flash="vanilla")
    assert calls == {"slab_attention": 1}
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6, rtol=0)
