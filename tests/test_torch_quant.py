"""The port's quantized path (QuantLinear, dequant_weight, K7's and K8's
plain versions, the quantized routes of the forward) against the JAX package
on the CPU.

Inputs come from numpy seeds and go through both packages. The JAX kernels
run as its own tests run them: Pallas in interpret mode. Everything is f32
unless a test says otherwise."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (caps torch's threads under xdist)

from dinov2_tpu.io.gguf import GGUFTensor
from dinov2_tpu.io.synthetic import write_synthetic_gguf
from dinov2_tpu.models import params as jparams
from dinov2_tpu.models import vit as jvit
from dinov2_tpu.models.config import DinoConfig
from dinov2_tpu.ops import fused_quant_attention as jfqa
from dinov2_tpu.ops import qmatmul as jqmatmul
from dinov2_tpu.ops.pallas_qmatmul import quant_matmul_pallas
from dinov2_tpu.quant.blocks import dequantize, quantize, unpack_codes
from dinov2_tpu.quant.quantize import QUANT_TYPE_NAMES, quantize_gguf
from dinov2_tpu_torch.models import params, vit
from dinov2_tpu_torch.models.params import QuantLinear, params_from_numpy, quantize_linear
from dinov2_tpu_torch.ops import qmatmul
from dinov2_tpu_torch.ops.fused_quant_attention import quant_layer_reference, slab_layer_block_quant
from dinov2_tpu_torch.ops.qmatmul_kernel import (
    check_quant_weight,
    quant_matmul_kernel,
    quant_matmul_reference,
)
from dinov2_tpu_torch.runtime.engine import DinoEngine

FORMATS = ["q4_0", "q4_1", "q5_0", "q5_1", "q8_0"]
# the load path's layout (packed planes for q4/q5, SoA for q8_0) and int8 SoA
LAYOUTS = [True, False]
TINY = DinoConfig(hidden_size=64, num_hidden_layers=2, num_attention_heads=2,
                  num_classes=4, patch_size=14, img_size=70)
# tests/test_torch_slice.py's f32 bounds against the JAX forward: hf 5e-5 is
# also tests/test_pallas_kernels.py's bound for the JAX quantized slab route;
# reference mode adds the f16 GELU rounding flips that file explains
TOKEN_ATOL = {"hf": 5e-5, "reference": 5e-5}
PROB_ATOL = 1e-6


def _weight(seed: int, n: int, k: int) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal((n, k)) * 0.5).astype(np.float32)


def _jax_ql(w: np.ndarray, fmt: str, packed: bool):
    """The JAX package's QuantLinear of w, as its own tests build one."""
    gt = QUANT_TYPE_NAMES[fmt]
    raw = quantize(w, gt)
    if packed:
        return jparams._soa_from_blocks(GGUFTensor("w", w.shape, gt, raw))
    codes, d, m = unpack_codes(raw, gt, w.shape)
    return jparams.QuantLinear(
        codes=jnp.asarray(codes), d=jnp.asarray(d), m=None if m is None else jnp.asarray(m),
        ggml_type=int(gt), shape=w.shape,
    )


def _to_port(jql) -> QuantLinear:
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, jql))


def _assert_same_ql(got: QuantLinear, want):
    assert (got.ggml_type, tuple(got.shape), got.packed) == (want.ggml_type, tuple(want.shape), want.packed)
    for field in params.QUANT_FIELDS:
        w = getattr(want, field)
        g = getattr(got, field)
        assert (g is None) == (w is None), field
        if w is not None:
            w = np.asarray(w)
            assert str(g.dtype).removeprefix("torch.") == w.dtype.name, field
            np.testing.assert_array_equal(g.numpy(), w, err_msg=field)


@pytest.mark.parametrize("packed", LAYOUTS)
@pytest.mark.parametrize("fmt", FORMATS)
def test_quantize_linear_same_bytes_as_jax(fmt, packed):
    """The port's _soa_from_blocks (through quantize_linear) and
    params_from_numpy of the JAX QuantLinear give the JAX package's bytes."""
    w = _weight(1, 96, 256)
    want = _jax_ql(w, fmt, packed)
    _assert_same_ql(quantize_linear(w, fmt, packed), want)
    _assert_same_ql(_to_port(want), want)


@pytest.mark.parametrize("packed", LAYOUTS)
@pytest.mark.parametrize("fmt", FORMATS)
def test_dequant_weight_matches_jax(fmt, packed):
    """Exact in f32 against the JAX dequant_weight; within 1e-6 of the block
    decoder (quant.blocks.dequantize, the checkpoint's own meaning)."""
    w = _weight(2, 64, 256)
    jql = _jax_ql(w, fmt, packed)
    got = qmatmul.dequant_weight(_to_port(jql), torch.float32).numpy()
    np.testing.assert_array_equal(got, np.asarray(jqmatmul.dequant_weight(jql, jnp.float32)))
    raw = quantize(w, QUANT_TYPE_NAMES[fmt])
    np.testing.assert_allclose(got, dequantize(raw, QUANT_TYPE_NAMES[fmt], w.shape),
                               rtol=1e-6, atol=1e-6)
    bf = qmatmul.dequant_weight(_to_port(jql), torch.bfloat16)
    assert bf.dtype == torch.bfloat16 and torch.equal(bf, torch.from_numpy(got).to(torch.bfloat16))


def test_decode_packed_planes_matches_jax():
    for fmt, zero in (("q4_0", 8), ("q5_0", 16), ("q5_1", 0)):
        jql = _jax_ql(_weight(3, 32, 256), fmt, True)
        want = jparams.decode_packed_planes(
            np.asarray(jql.codes), None if jql.qh_lo is None else np.asarray(jql.qh_lo),
            None if jql.qh_hi is None else np.asarray(jql.qh_hi), zero, np)
        ql = _to_port(jql)
        assert ql.zero_point == zero
        got = params.decode_packed_planes(ql.codes, ql.qh_lo, ql.qh_hi, zero)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("activation", [None, "gelu_erf", "gelu_tanh"])
@pytest.mark.parametrize("packed", LAYOUTS)
@pytest.mark.parametrize("fmt", FORMATS)
def test_quant_matmul_reference_matches_jax_xla(fmt, packed, activation):
    """K7's plain version against JAX quant_matmul(backend="xla") in f32:
    the same dequantized weight and one f32 matmul, so only summation order
    differs. N=160 is no multiple of 64 (the head's edge)."""
    jql = _jax_ql(_weight(4, 160, 256), fmt, packed)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 7, 256)).astype(np.float32)
    bias = (rng.standard_normal(160) * 0.1).astype(np.float32)
    want = np.asarray(jqmatmul.quant_matmul(jnp.asarray(x), jql, backend="xla",
                                            bias=jnp.asarray(bias), activation=activation))
    ql = _to_port(jql)
    got = quant_matmul_reference(torch.from_numpy(x), ql, torch.from_numpy(bias), activation)
    assert tuple(got.shape) == (3, 7, 160)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # on the CPU the K7 wrapper and both quant_matmul backends are the plain version
    for out in (quant_matmul_kernel(torch.from_numpy(x), ql, torch.from_numpy(bias), activation),
                *(qmatmul.quant_matmul(torch.from_numpy(x), ql, b, torch.from_numpy(bias), activation)
                  for b in ("auto", "kernel", "dequant"))):
        assert torch.equal(out, got)


@pytest.mark.parametrize("packed", LAYOUTS)
@pytest.mark.parametrize("fmt", FORMATS)
def test_quant_matmul_reference_matches_jax_pallas(fmt, packed):
    """K7's plain version against the TPU kernel quant_matmul_pallas in
    interpret mode. The TPU kernel rounds each scale d to bf16 and then each
    product q·d to bf16 before the MXU (and adds blocksums(x)·mᵀ in f32 for
    the affine formats), which K7 does not copy: each weight's q·d part moves
    by at most 2^-8 of itself, so |Δy| <= 2^-8·(|x| @ |q·d|ᵀ), plus f32
    noise. The symmetric formats also hold the kernel's own test tolerance
    (tests/test_pallas_kernels.py, rtol 2e-2, atol 0.15); the affine ones,
    whose q·d runs up to twice the weight's range, exceed it on about half
    of the seeds tried."""
    jql = _jax_ql(_weight(6, 160, 256), fmt, packed)
    x = np.random.default_rng(7).standard_normal((24, 256)).astype(np.float32)
    want = np.asarray(quant_matmul_pallas(jnp.asarray(x), jql, block_m=8, block_n=128,
                                          interpret=True))
    ql = _to_port(jql)
    got = quant_matmul_reference(torch.from_numpy(x), ql).numpy()
    qd = qmatmul.dequant_weight(ql, torch.float32).numpy()
    if ql.m is not None:
        qd = qd - np.repeat(ql.m.numpy(), 32, axis=1)
    bound = 2.0**-8 * (np.abs(x) @ np.abs(qd).T) + 1e-5 * (1 + np.abs(want))
    assert (np.abs(got - want) <= bound).all()
    if ql.m is None:
        np.testing.assert_allclose(got, want, rtol=2e-2, atol=0.15)


@pytest.mark.parametrize("fmt, packed", [(f, True) for f in FORMATS] + [("q5_1", False)])
def test_quant_layer_matches_jax_kernel(fmt, packed):
    """K8's plain version (what slab_layer_block_quant runs on the CPU)
    against the TPU kernel slab_layer_block_quant in interpret mode, with
    that kernel's own bound (tests/test_pallas_kernels.py): the same math
    with other f32 reduction orders."""
    b, t, heads, d = 2, 37, 4, 64
    rng = np.random.default_rng(8)
    jq = _jax_ql(_weight(9, 3 * d, d), fmt, packed)
    jp = _jax_ql(_weight(10, d, d), fmt, packed)
    x = rng.standard_normal((b, t, d)).astype(np.float32)
    rows = [rng.uniform(0.5, 1.5, d), rng.standard_normal(d) * 0.1, rng.standard_normal(3 * d) * 0.1,
            rng.standard_normal(d) * 0.1, rng.uniform(0.1, 1.0, d)]
    lns, lnb, bq, bp, ls = (r.astype(np.float32) for r in rows)
    want = np.asarray(jfqa.slab_layer_block_quant(
        *map(jnp.asarray, (x, lns, lnb)), jq, jnp.asarray(bq), jp, *map(jnp.asarray, (bp, ls)),
        heads, 0.125, 1e-6, True))
    t_args = [torch.from_numpy(a) for a in (x, lns, lnb, bq, bp, ls)]
    got = slab_layer_block_quant(*t_args[:3], _to_port(jq), t_args[3], _to_port(jp), *t_args[4:],
                                 heads, 0.125, 1e-6)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    assert torch.equal(got, quant_layer_reference(*t_args[:3], _to_port(jq), t_args[3],
                                                  _to_port(jp), *t_args[4:], heads, 0.125, 1e-6))


@pytest.fixture(scope="module")
def quant_files(tmp_path_factory):
    """The tiny model, dense and in each format."""
    root = tmp_path_factory.mktemp("quant")
    dense = write_synthetic_gguf(root / "m.gguf", TINY, seed=7)
    files = {"f16": dense}
    for fmt in FORMATS:
        files[fmt] = quantize_gguf(dense, root / f"m.{fmt}.gguf", fmt)
    return files


@pytest.mark.parametrize("fmt", FORMATS)
def test_load_params_fused_equals_jax(quant_files, fmt):
    """Every leaf of the fused tree, QuantLinear fields included, equals the
    JAX package's; dense files ignore "fused"."""
    want = jparams.load_params(quant_files[fmt], dtype=jnp.float32, quant_mode="fused")
    got = params.load_params(quant_files[fmt], dtype=torch.float32, quant_mode="fused")
    assert got.quantized and want.quantized and got.config.__dict__ == want.config.__dict__
    for key in ("qkv", "proj"):
        _assert_same_ql(got.params["layers"][key]["kernel"], want.params["layers"][key]["kernel"])
    for key in ("fc1", "fc2"):
        _assert_same_ql(got.params["layers"]["mlp"][key]["kernel"],
                        want.params["layers"]["mlp"][key]["kernel"])
    _assert_same_ql(got.params["classifier"]["kernel"], want.params["classifier"]["kernel"])
    np.testing.assert_array_equal(got.params["layers"]["qkv"]["bias"].numpy(),
                                  np.asarray(want.params["layers"]["qkv"]["bias"]))
    assert not params.load_params(quant_files["f16"], dtype=torch.float32,
                                  quant_mode="fused").quantized


@pytest.mark.parametrize("fmt", ["q4_0", "q8_0"])
def test_load_params_dequant_equals_jax(quant_files, fmt):
    want = jparams.load_params(quant_files[fmt], dtype=jnp.float32, quant_mode="dequant")
    got = params.load_params(quant_files[fmt], dtype=torch.float32, quant_mode="dequant")
    assert not got.quantized
    np.testing.assert_array_equal(got.params["layers"]["mlp"]["fc1"]["kernel"].numpy(),
                                  np.asarray(want.params["layers"]["mlp"]["fc1"]["kernel"]))


def _jax_forward(path, parity, route, x, backend="xla", quant_slab="kernel"):
    """The JAX fused forward with its quantized slab kernel forced; the
    environment knobs are read at trace time, so the jit cache is cleared
    around the call."""
    loaded = jparams.load_params(path, dtype=jnp.float32, quant_mode="fused")
    opts = jvit.ModelOptions(parity=parity, compute_dtype=jnp.float32, flash_attention=route)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DINOV2_TPU_QUANT_SLAB", quant_slab)
        mp.setenv("DINOV2_TPU_QUANT_BACKEND", backend)
        jax.clear_caches()
        out = jvit.forward(loaded.params, jnp.asarray(x), loaded.config, opts, classify=True)
        out = {k: np.asarray(v) for k, v in out.items()}
    jax.clear_caches()
    return out


def _port_forward(path, parity, route, x, quant_mode="fused", **quant):
    loaded = params.load_params(path, dtype=torch.float32, quant_mode=quant_mode)
    opts = vit.ModelOptions(parity=parity, flash_attention=route, compute_dtype=torch.float32,
                            **quant)
    return vit.forward(loaded.params, torch.from_numpy(x), loaded.config, opts, classify=True)


@pytest.mark.parametrize("route", ["slab", "flash"])
@pytest.mark.parametrize("parity", ["hf", "reference"])
def test_fused_forward_matches_jax(quant_files, parity, route):
    """The whole tiny q4_0 forward in quant_mode="fused": the slab route
    (K8, then K7 in the MLP and the head) and the flash route (K7 for qkv
    and proj around K4) against the JAX fused forward with
    DINOV2_TPU_QUANT_SLAB=kernel (its K8 in interpret mode) and the
    dequant-weight matmul backend ("xla"), K7's numerics."""
    x = np.random.default_rng(11).standard_normal((2, 70, 70, 3)).astype(np.float32)
    want = _jax_forward(quant_files["q4_0"], parity, route, x)
    got = _port_forward(quant_files["q4_0"], parity, route, x)
    for key in ("cls_token", "patch_tokens"):
        np.testing.assert_allclose(got[key].numpy(), want[key], atol=TOKEN_ATOL[parity], rtol=0)
    np.testing.assert_allclose(got["probs"].numpy(), want["probs"], atol=PROB_ATOL, rtol=0)


def test_fused_forward_against_jax_pallas_matmuls(quant_files):
    """Against the JAX fused forward with its TPU dequant-matmul kernels too
    (DINOV2_TPU_QUANT_BACKEND=pallas, interpret mode): those round every
    scale and weight to bf16 (test_quant_matmul_reference_matches_jax_pallas),
    so the tokens sit within the bf16 bound of tests/test_torch_slice.py,
    5e-2 of max|token|, and not within the f32 one."""
    x = np.random.default_rng(12).standard_normal((2, 70, 70, 3)).astype(np.float32)
    want = _jax_forward(quant_files["q4_1"], "hf", "slab", x, backend="pallas")
    got = _port_forward(quant_files["q4_1"], "hf", "slab", x)
    tokens = np.concatenate([got["cls_token"][:, None].numpy(), got["patch_tokens"].numpy()], 1)
    ref = np.concatenate([want["cls_token"][:, None], want["patch_tokens"]], 1)
    assert np.abs(tokens - ref).max() <= 5e-2 * np.abs(ref).max()
    np.testing.assert_allclose(got["probs"].numpy(), want["probs"], rtol=1e-2, atol=0)


@pytest.mark.parametrize("fmt", FORMATS)
def test_fused_matches_dequant_at_load(quant_files, fmt):
    """quant_mode="fused" (QuantLinear through K8's and K7's plain versions)
    against "dequant" (dense weights decoded at load, K1's plain version and
    dense matmuls): the same weights, so only f32 reassociation differs."""
    x = np.random.default_rng(13).standard_normal((2, 70, 70, 3)).astype(np.float32)
    got = _port_forward(quant_files[fmt], "hf", "slab", x)
    want = _port_forward(quant_files[fmt], "hf", "slab", x, quant_mode="dequant")
    for key in got:
        np.testing.assert_allclose(got[key].numpy(), want[key].numpy(), atol=2e-6, rtol=0)


@pytest.mark.parametrize("quant", [{"quant_slab": "dequant"}, {"quant_backend": "dequant"},
                                   {"quant_slab": "kernel", "quant_backend": "kernel"}])
def test_quant_routes_agree_on_the_cpu(quant_files, quant):
    """On the CPU every quantized route computes the same plain versions."""
    x = np.random.default_rng(14).standard_normal((1, 70, 70, 3)).astype(np.float32)
    want = _port_forward(quant_files["q5_1"], "reference", "slab", x)
    got = _port_forward(quant_files["q5_1"], "reference", "slab", x, **quant)
    for key in got:
        np.testing.assert_allclose(got[key].numpy(), want[key].numpy(), atol=2e-6, rtol=0)


def test_quant_slab_off_needs_the_unported_slab_core(quant_files):
    """quant_slab="off" once raised for want of the slab core; with K3 ported
    it is the truly unfused quantized route (K3 between quant_matmul calls)
    and agrees with the JAX forward under DINOV2_TPU_QUANT_SLAB=off within
    the f32 bound of the other routes."""
    x = np.random.default_rng(15).standard_normal((2, 70, 70, 3)).astype(np.float32)
    got = _port_forward(quant_files["q4_0"], "hf", "slab", x, quant_slab="off")
    want = _jax_forward(quant_files["q4_0"], "hf", "slab", x, quant_slab="off")
    for key in ("cls_token", "patch_tokens"):
        np.testing.assert_allclose(got[key].numpy(), want[key], atol=TOKEN_ATOL["hf"], rtol=0)
    np.testing.assert_allclose(got["probs"].numpy(), want["probs"], atol=PROB_ATOL, rtol=0)
    for bad in ({"quant_slab": "pallas"}, {"quant_backend": "xla"}):
        with pytest.raises(ValueError):
            vit.ModelOptions(**bad)


def test_dino_vit_keeps_quant_linear_static_fields(quant_files):
    """DinoViT holds a QuantLinear's tensors as buffers and rebuilds it, its
    static fields included, for the forward."""
    loaded = params.load_params(quant_files["q5_0"], dtype=torch.float32, quant_mode="fused")
    model = vit.DinoViT(loaded.params, loaded.config,
                        vit.ModelOptions(compute_dtype=torch.float32))
    names = dict(model.named_buffers())
    assert names["layers/qkv/kernel/codes"].shape == (2, 192, 32)
    assert "layers/qkv/kernel/m" not in names and "layers/qkv/kernel/qh_lo" in names
    rebuilt = model.params["layers"]["qkv"]["kernel"]
    original = loaded.params["layers"]["qkv"]["kernel"]
    assert isinstance(rebuilt, QuantLinear)
    assert (rebuilt.ggml_type, rebuilt.shape, rebuilt.packed) == (
        original.ggml_type, original.shape, original.packed)
    layer0 = vit._layer(model.params["layers"], 0)["qkv"]["kernel"]
    assert layer0.codes.shape == (192, 32) and layer0.ggml_type == original.ggml_type
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((1, 70, 70, 3)).astype(np.float32))
    out = model(x, classify=True)
    want = vit.forward(loaded.params, x, loaded.config, model.opts, classify=True)
    for key in want:
        assert torch.equal(out[key], want[key])


@pytest.mark.parametrize("n", [1, 3])
def test_engine_fused_classify_matches_jax(quant_files, n):
    """DinoEngine(quant_mode="fused") on the CPU against the JAX engine in
    its fused mode (JAX's "auto" routes: the dequantized weights into its
    dense kernels), f32."""
    from dinov2_tpu.runtime.engine import DinoEngine as JaxEngine

    imgs = np.random.default_rng(n).integers(0, 256, (n, 90, 100, 3), dtype=np.uint8)
    want = JaxEngine(quant_files["q8_0"], dtype=jnp.float32, quant_mode="fused").classify_probs(imgs)
    engine = DinoEngine(quant_files["q8_0"], dtype=torch.float32, device="cpu", quant_mode="fused")
    assert engine.loaded.quantized
    np.testing.assert_allclose(engine.classify_probs(imgs), want, atol=PROB_ATOL, rtol=0)


@pytest.mark.parametrize(
    "case, error",
    [
        ("packed K/2 % 64", NotImplementedError),
        ("SoA K % 64", NotImplementedError),
        ("d in bf16", ValueError),
        ("codes not contiguous", ValueError),
        ("qh without its pair", ValueError),
        ("wrong shape", ValueError),
    ],
)
def test_quant_weight_checks(case, error):
    """What the CUDA kernels refuse of a QuantLinear, checked before any
    launch (the checks read metadata only, so they run here)."""
    device = torch.device("cpu")
    ql = quantize_linear(_weight(15, 64, 256), "q5_1")
    assert check_quant_weight(ql, "w", device, 64, 256) == (64, 256)
    n, k = 64, 256
    if case == "packed K/2 % 64":
        ql, k = quantize_linear(_weight(15, 64, 64), "q5_1"), 64
    elif case == "SoA K % 64":
        ql, k = quantize_linear(_weight(15, 64, 96), "q8_0", packed=False), 96
    elif case == "d in bf16":
        ql.d = ql.d.to(torch.bfloat16)
    elif case == "codes not contiguous":
        ql.codes = ql.codes.T.contiguous().T
    elif case == "qh without its pair":
        ql.qh_hi = None
    elif case == "wrong shape":
        n = 32
    with pytest.raises(error):
        check_quant_weight(ql, "w", device, n, k)


def test_kernel_wrappers_refuse_other_devices():
    ql = quantize_linear(_weight(16, 64, 128), "q4_0")
    x = torch.zeros((2, 128), device="meta")
    with pytest.raises(ValueError, match="no quant_matmul_kernel for device"):
        quant_matmul_kernel(x, ql)
    with pytest.raises(ValueError, match="no slab_layer_block_quant for device"):
        slab_layer_block_quant(torch.zeros((1, 3, 64), device="meta"), *([None] * 7), 1, 0.125, 1e-6)
