"""The port's W8A8 int8 mode (Int8Linear, the per-row activation quantize,
the int8 matmul and its routes through the forward) against the JAX
package's on the CPU.

Inputs come from numpy seeds and go through both packages; everything is
f32 unless a test says otherwise. On the CPU the K9 wrappers run their plain
versions (ops/qmatmul.py), so these tests hold the arithmetic the kernel
must reproduce bit for bit on a card (tests/test_torch_cuda.py,
chip_smoke.py). The JAX slab kernels run as its own tests run them: Pallas
in interpret mode.

Where two forwards meet, the int8 codes of an activation come from values
that the two packages compute in f32 in different orders (layer norm,
attention), a few ulps apart: a value that sits within those ulps of a
half step x / sx = j + 1/2 rounds to j in one and j + 1 in the other. Each
such flip moves one term of a product by one quantization step,
sx * |w| <= max|x| / 127 * max|w|, and the later layers carry it on. So
the forwards agree within 1e-6 where no code flips and within a flip's
reach where one does: over image seeds 8-13 on the tiny model, up to
1.1e-3 of max|token| and 1.2e-3 in a probability. TOKEN_REL_BOUND and
PROB_ABS_BOUND are 4x those. The weights' codes, the quantize of one input
and every product of identical codes agree exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (caps torch's threads under xdist)

from dinov2_tpu.io.gguf import GGUFTensor as JaxGGUFTensor
from dinov2_tpu.io.synthetic import write_synthetic_gguf
from dinov2_tpu.models import params as jparams
from dinov2_tpu.models import vit as jvit
from dinov2_tpu.models.config import DinoConfig
from dinov2_tpu.ops import qmatmul as jqmatmul
from dinov2_tpu.quant.blocks import quantize
from dinov2_tpu.quant.quantize import QUANT_TYPE_NAMES, quantize_gguf
from dinov2_tpu.runtime.engine import DinoEngine as JaxEngine
from dinov2_tpu_torch.io.gguf import GGMLType, GGUFTensor
from dinov2_tpu_torch.models import params, vit
from dinov2_tpu_torch.models.params import Int8Linear, params_from_numpy
from dinov2_tpu_torch.ops import qmatmul
from dinov2_tpu_torch.ops.int8_matmul_kernel import (
    int8_gemm_kernel,
    int8_matmul_kernel,
    quantize_rows_int8_kernel,
)
from dinov2_tpu_torch.runtime.engine import DinoEngine

TINY = DinoConfig(hidden_size=128, num_hidden_layers=2, num_attention_heads=2,
                  num_classes=4, patch_size=14, img_size=70)
ACTIVATIONS = [None, "gelu_tanh_f16", "gelu_erf", "gelu_tanh"]
# the forwards against JAX's (module docstring): max|dtokens| / max|tokens|
# and max|dprobs|
TOKEN_REL_BOUND = 5e-3
PROB_ABS_BOUND = 5e-3
# the activations of the two packages on the same f32 value: XLA's and
# PyTorch's tanh and erf differ in the last bits, which can round
# gelu_tanh_f16's f16 result the other way near zero (f16's subnormal steps)
ACT_RTOL = 1e-6
ACT_ATOL = 1e-6


@pytest.fixture(scope="module")
def tiny_gguf(tmp_path_factory):
    return write_synthetic_gguf(tmp_path_factory.mktemp("int8") / "tiny.gguf", TINY, seed=3)


def _weight(seed: int, n: int, k: int) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal((n, k)) * 0.5).astype(np.float32)


def _tensors(w: np.ndarray, ftype: str):
    """The same 2-D weight as a GGUF tensor of each package, stored as
    `ftype`."""
    if ftype in ("f32", "f16"):
        gt = GGMLType.F32 if ftype == "f32" else GGMLType.F16
        raw = w.astype(np.float32 if ftype == "f32" else np.float16).view(np.uint8).ravel()
    else:
        gt = QUANT_TYPE_NAMES[ftype]
        raw = quantize(w, gt)
    return JaxGGUFTensor("w", w.shape, int(gt), raw), GGUFTensor("w", w.shape, int(gt), raw)


def _bits(a) -> np.ndarray:
    return np.asarray(a).view(np.uint32)


@pytest.mark.parametrize("ftype", ["f16", "f32", "q8_0", "q4_0"])
def test_int8_from_tensor_equals_jax(ftype):
    """Codes and scales bit for bit the JAX package's, from each source
    format (the ggml ones through their exact dequantization)."""
    jt, pt = _tensors(_weight(1, 96, 256), ftype)
    want = jparams._int8_from_tensor(jt)
    got = params._int8_from_tensor(pt)
    assert isinstance(got, Int8Linear) and got.shape == want.shape == (96, 256)
    assert got.codes.dtype == torch.int8 and got.s.dtype == torch.float32
    np.testing.assert_array_equal(got.codes.numpy(), np.asarray(want.codes))
    np.testing.assert_array_equal(_bits(got.s.numpy()), _bits(want.s))


def test_int8_from_tensor_refuses_what_jax_refuses():
    w = np.full((4, 32), np.nan, dtype=np.float32)
    _, pt = _tensors(w, "f32")
    with pytest.raises(ValueError, match="non-finite"):
        params._int8_from_tensor(pt)
    with pytest.raises(ValueError, match="2D weight"):
        params._int8_from_tensor(GGUFTensor("b", (32,), int(GGMLType.F32),
                                            np.zeros(32, np.float32).view(np.uint8)))


def _activations(seed: int, shape, dtype: torch.dtype) -> np.ndarray:
    """f32 values exactly representable in `dtype`, with a zero row and a
    row of one nonzero value (the absmax floor and the +-127 extremes)."""
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * 3.0
    x[..., 0, :] = 0.0
    x[..., 1, :] = 0.0
    x[..., 1, 5] = -2.5
    return torch.from_numpy(x).to(dtype).float().numpy()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(7, 64), (2, 5, 300)])
def test_quantize_rows_int8_equals_jax(shape, dtype):
    """Scales bit for bit and codes equal, with no tie allowance: both take
    sx = max(absmax, f32(1e-12)) * f32(1/127) and round x / sx half to even
    with an IEEE division."""
    x = _activations(2, shape, dtype)
    jx = jnp.asarray(x).astype(jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    want8, want_sx = jqmatmul.quantize_rows_int8(jx)
    got8, got_sx = qmatmul.quantize_rows_int8(torch.from_numpy(x).to(dtype))
    assert got8.dtype == torch.int8 and got_sx.shape == (*shape[:-1], 1)
    np.testing.assert_array_equal(got8.numpy(), np.asarray(want8))
    np.testing.assert_array_equal(_bits(got_sx.numpy()), _bits(want_sx))
    assert got8.abs().max() == 127 and (got8.reshape(-1, shape[-1])[0] == 0).all()
    # the CPU wrapper is the plain version
    k8, ksx = quantize_rows_int8_kernel(torch.from_numpy(x).to(dtype))
    assert torch.equal(k8, got8) and torch.equal(ksx, got_sx)


def test_int8_constants_are_jax_constants():
    """The Python constants and the kernel's hex floats carry the bits of
    JAX's f32(1/127) and f32(1e-12)."""
    import re
    from pathlib import Path

    step, floor = np.float32(1.0 / 127.0), np.float32(1e-12)
    assert np.float32(qmatmul.INT8_SCALE_STEP) == step
    assert np.float32(qmatmul.INT8_SCALE_FLOOR) == floor
    src = (Path(qmatmul.__file__).parents[1] / "csrc" / "int8_matmul.cu").read_text()
    hexes = dict(re.findall(r"constexpr float (kScale\w+) = (0x[0-9a-fp.\-]+)f;", src))
    assert np.float32(float.fromhex(hexes["kScaleStep"])) == step
    assert np.float32(float.fromhex(hexes["kScaleFloor"])) == floor


def _il_pair(seed: int, n: int, k: int):
    """The same Int8Linear in both packages, from one f32 weight."""
    jt, pt = _tensors(_weight(seed, n, k) * 0.1, "f32")
    return jparams._int8_from_tensor(jt), params._int8_from_tensor(pt)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("activation", ACTIVATIONS)
def test_int8_matmul_equals_jax(activation, dtype):
    """int8_matmul (the CPU path of K9's wrapper) against JAX's int8_matmul:
    bit for bit without an activation (the s32 product is exact on both
    sides, the rescale and the bias add the same f32 operations); with one,
    within ACT_RTOL in f32."""
    jil, il = _il_pair(3, 40, 256)
    x = _activations(4, (3, 5, 256), dtype)
    bias = np.random.default_rng(5).standard_normal(40).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = jqmatmul.int8_matmul(jnp.asarray(x).astype(jdt), jil, bias=jnp.asarray(bias),
                                activation=activation)
    xt = torch.from_numpy(x).to(dtype)
    got = qmatmul.apply_linear(xt, {"kernel": il, "bias": torch.from_numpy(bias)}, activation)
    assert got.dtype == dtype and got.shape == (3, 5, 40)
    want = np.asarray(want.astype(jnp.float32))
    if activation is None:
        np.testing.assert_array_equal(got.float().numpy(), want)
    elif dtype == torch.float32:
        np.testing.assert_allclose(got.float().numpy(), want, rtol=ACT_RTOL, atol=ACT_ATOL)
    else:
        # jax.nn.gelu on bf16 rounds its intermediate steps to bf16, PyTorch's
        # computes in f32 and rounds once (its dense path does the same): the
        # activation is applied, bit for bit, to JAX's bf16 value before it
        before = jqmatmul.int8_matmul(jnp.asarray(x).astype(jdt), jil, bias=jnp.asarray(bias))
        before = torch.from_numpy(np.array(before.astype(jnp.float32))).to(dtype)
        assert torch.equal(got, qmatmul.apply_activation(before, activation))
    assert torch.equal(got, int8_matmul_kernel(xt, il, torch.from_numpy(bias), activation))
    assert torch.equal(got, qmatmul.int8_matmul_reference(xt, il, torch.from_numpy(bias),
                                                          activation))


def test_int8_product_is_exact():
    """The plain version's f64 product equals an int64 one at the worst
    case of K9's widths: every code +-127 over K = 4096."""
    k = 4096
    rng = np.random.default_rng(6)
    x8 = torch.from_numpy(rng.choice([-127, 127], (9, k)).astype(np.int8))
    codes = torch.from_numpy(rng.choice([-127, 127], (5, k)).astype(np.int8))
    codes[0] = x8[0]  # one sum of 127 * 127 * K
    want = x8.long() @ codes.long().T
    got = qmatmul.int8_product(x8, codes)
    assert got.dtype == torch.int32 and torch.equal(got.long(), want)
    assert want[0, 0] == 127 * 127 * k


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dequant_weight_int8_equals_jax(dtype):
    jil, il = _il_pair(7, 48, 128)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = np.asarray(jqmatmul.dequant_weight(jil, jdt).astype(jnp.float32))
    got = qmatmul.dequant_weight(il, dtype)
    assert got.dtype == dtype and got.shape == (48, 128)
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_load_params_int8_stacks_leaves(tiny_gguf):
    """Every linear weight an Int8Linear stacked on the layer axis, codes
    and scales bit for bit JAX's; the patch embedding stays dense;
    `quantized` stays False; params_from_numpy takes JAX's Int8Linear."""
    want = jparams.load_params(tiny_gguf, dtype=jnp.float32, quant_mode="int8")
    got = params.load_params(tiny_gguf, dtype=torch.float32, quant_mode="int8")
    assert not got.quantized and not want.quantized
    d, layers = TINY.hidden_size, TINY.num_hidden_layers
    qkv = got.params["layers"]["qkv"]["kernel"]
    assert isinstance(qkv, Int8Linear) and qkv.shape == (3 * d, d)
    assert qkv.codes.shape == (layers, 3 * d, d) and qkv.s.shape == (layers, 3 * d)
    assert isinstance(got.params["classifier"]["kernel"], Int8Linear)
    assert torch.is_tensor(got.params["patch_embed"]["kernel"])
    for name in ("qkv", "proj"):
        for field in ("codes", "s"):
            np.testing.assert_array_equal(
                getattr(got.params["layers"][name]["kernel"], field).numpy(),
                np.asarray(getattr(want.params["layers"][name]["kernel"], field)))
    for key in ("fc1", "fc2"):
        np.testing.assert_array_equal(got.params["layers"]["mlp"][key]["kernel"].codes.numpy(),
                                      np.asarray(want.params["layers"]["mlp"][key]["kernel"].codes))
    moved = params_from_numpy(jax.tree_util.tree_map(np.asarray, want.params))
    assert isinstance(moved["classifier"]["kernel"], Int8Linear)
    assert torch.equal(moved["classifier"]["kernel"].codes, got.params["classifier"]["kernel"].codes)
    assert moved["classifier"]["kernel"].shape == (TINY.num_classes, 2 * d)
    with pytest.raises(ValueError, match="trainable"):
        params.trainable_params(got.params)


def test_dino_vit_keeps_int8_linear(tiny_gguf):
    """DinoViT holds an Int8Linear's codes and scales as buffers and rebuilds
    it with its shape for the forward."""
    loaded = params.load_params(tiny_gguf, dtype=torch.float32, quant_mode="int8")
    model = vit.DinoViT(loaded.params, loaded.config,
                        vit.ModelOptions(compute_dtype=torch.float32))
    names = dict(model.named_buffers())
    assert names["layers/mlp/fc1/kernel/codes"].dtype == torch.int8
    assert names["layers/mlp/fc1/kernel/s"].shape == (2, 4 * 128)
    rebuilt = model.params["layers"]["mlp"]["fc1"]["kernel"]
    assert isinstance(rebuilt, Int8Linear) and rebuilt.shape == (4 * 128, 128)
    assert vit._layer(model.params["layers"], 1)["qkv"]["kernel"].codes.shape == (384, 128)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((1, 70, 70, 3)).astype(np.float32))
    out = model(x, classify=True)
    want = vit.forward(loaded.params, x, loaded.config, model.opts, classify=True)
    for key in want:
        assert torch.equal(out[key], want[key])


def _images(seed: int, n: int = 2, hw=(70, 84)) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (n, *hw, 3), dtype=np.uint8)


def _close_tokens(got: np.ndarray, want: np.ndarray) -> None:
    rel = np.abs(got - want).max() / np.abs(want).max()
    assert rel <= TOKEN_REL_BOUND, rel


def _jax_engine(path, quant_slab: str, monkeypatch, **kw):
    """The JAX engine in int8 mode on its slab route (its "auto" takes the
    plain attention off a TPU), DINOV2_TPU_QUANT_SLAB set before it traces."""
    monkeypatch.setenv("DINOV2_TPU_QUANT_SLAB", quant_slab)
    jax.clear_caches()
    return JaxEngine(path, dtype=jnp.float32, quant_mode="int8", flash_attention="slab", **kw)


@pytest.mark.parametrize("quant_slab", ["auto", "off"])
def test_engine_int8_classify_matches_jax(tiny_gguf, quant_slab, monkeypatch):
    """DinoEngine(quant_mode="int8").classify_probs on the CPU against the
    JAX engine's on the same route: "auto" dequantizes qkv/proj into K1
    (int8 GEMMs in the MLP and the head), "off" runs every linear as an
    int8 GEMM around the K3 core."""
    imgs = _images(8)
    want = _jax_engine(tiny_gguf, quant_slab, monkeypatch).classify_probs(imgs)
    engine = DinoEngine(tiny_gguf, dtype=torch.float32, device="cpu", quant_mode="int8",
                        quant_slab=quant_slab)
    got = engine.classify_probs(imgs)
    np.testing.assert_allclose(got, want, atol=PROB_ABS_BOUND, rtol=0)
    np.testing.assert_allclose(got.sum(-1), 1.0, rtol=1e-5)
    jax.clear_caches()


@pytest.mark.parametrize("quant_slab", ["auto", "off"])
def test_engine_int8_features_match_jax(tiny_gguf, quant_slab, monkeypatch):
    imgs = _images(9, n=1, hw=(70, 98))
    want = _jax_engine(tiny_gguf, quant_slab, monkeypatch).extract_features(imgs)
    got = DinoEngine(tiny_gguf, dtype=torch.float32, device="cpu", quant_mode="int8",
                     quant_slab=quant_slab).extract_features(imgs)
    assert got["grid"] == tuple(want["grid"])
    for key in ("cls_token", "patch_tokens"):
        _close_tokens(np.asarray(got[key]), np.asarray(want[key]))
    jax.clear_caches()


def test_engine_int8_routes_disagree_by_the_activation_quantize(tiny_gguf):
    """"auto" and "off" differ by the quantize of qkv's and proj's inputs:
    within JAX's own 8-bit envelope of each other
    (tests/test_int8_mode.py::test_int8_unfused_path_matches_slab_route),
    not equal."""
    imgs = _images(10, n=1)
    probs = [DinoEngine(tiny_gguf, dtype=torch.float32, device="cpu", quant_mode="int8",
                        quant_slab=mode).classify_probs(imgs) for mode in ("auto", "off")]
    assert 0 < np.abs(probs[0] - probs[1]).max() < 0.1


def test_engine_int8_flash_route_matches_jax(tiny_gguf):
    """The flash route (K4 between int8 GEMMs for qkv and proj) against
    JAX's flash route (its flash kernel in interpret mode)."""
    imgs = _images(11, n=1)
    want = JaxEngine(tiny_gguf, dtype=jnp.float32, quant_mode="int8",
                     flash_attention=True).extract_features(imgs)
    got = DinoEngine(tiny_gguf, dtype=torch.float32, device="cpu", quant_mode="int8",
                     flash_attention=True).extract_features(imgs)
    _close_tokens(np.asarray(got["patch_tokens"]), np.asarray(want["patch_tokens"]))
    jax.clear_caches()


def test_engine_int8_swiglu_matches_jax(tmp_path, monkeypatch):
    """SwiGLU's win and wout as int8 GEMMs (the route where the JAX package
    says its int8 GEMMs run in production), qkv/proj dequantized into K1."""
    cfg = DinoConfig(**{**TINY.__dict__, "use_swiglu_ffn": True})
    path = write_synthetic_gguf(tmp_path / "swiglu.gguf", cfg, seed=5)
    imgs = _images(12)
    want = _jax_engine(path, "auto", monkeypatch).classify_probs(imgs)
    engine = DinoEngine(path, dtype=torch.float32, device="cpu", quant_mode="int8")
    assert isinstance(engine.loaded.params["layers"]["mlp"]["win"]["kernel"], Int8Linear)
    np.testing.assert_allclose(engine.classify_probs(imgs), want, atol=PROB_ABS_BOUND, rtol=0)
    jax.clear_caches()


def test_int8_fuse_mlp_matches_jax(tiny_gguf, monkeypatch):
    """fuse_mlp: fc1/fc2 dequantized into K5 (plain version here, the JAX
    slab_mlp_block in interpret mode), both half-layers on dequantized
    weights; the head is the one int8 GEMM."""
    x = np.random.default_rng(13).standard_normal((2, 70, 70, 3)).astype(np.float32)
    jl = jparams.load_params(tiny_gguf, dtype=jnp.float32, quant_mode="int8")
    monkeypatch.setenv("DINOV2_TPU_QUANT_SLAB", "auto")
    jax.clear_caches()
    want = jvit.forward(jl.params, jnp.asarray(x), jl.config,
                        jvit.ModelOptions(parity="reference", compute_dtype=jnp.float32,
                                          flash_attention="slab", fuse_mlp=True), classify=True)
    pl = params.load_params(tiny_gguf, dtype=torch.float32, quant_mode="int8")
    opts = vit.ModelOptions(compute_dtype=torch.float32, fuse_mlp=True)
    got = vit.forward(pl.params, torch.from_numpy(x), pl.config, opts, classify=True)
    for key in ("cls_token", "patch_tokens"):
        _close_tokens(got[key].numpy(), np.asarray(want[key]))
    np.testing.assert_allclose(got["probs"].numpy(), np.asarray(want["probs"]),
                               atol=PROB_ABS_BOUND, rtol=0)
    jax.clear_caches()


def test_engine_int8_from_q8_file_matches_jax(tiny_gguf, tmp_path, monkeypatch):
    qpath = tmp_path / "tiny-q8.gguf"
    quantize_gguf(tiny_gguf, qpath, "q8_0")
    imgs = _images(14, n=1)
    want = _jax_engine(qpath, "auto", monkeypatch).classify_probs(imgs)
    got = DinoEngine(qpath, dtype=torch.float32, device="cpu", quant_mode="int8").classify_probs(imgs)
    np.testing.assert_allclose(got, want, atol=PROB_ABS_BOUND, rtol=0)
    jax.clear_caches()


def test_int8_refuses_grad(tiny_gguf):
    loaded = params.load_params(tiny_gguf, dtype=torch.float32, quant_mode="int8")
    il = loaded.params["classifier"]["kernel"]
    x = torch.zeros((2, 2 * TINY.hidden_size), requires_grad=True)
    with pytest.raises(RuntimeError, match="aren't trainable"):
        qmatmul.apply_linear(x, loaded.params["classifier"])
    with pytest.raises(RuntimeError, match="aren't trainable"):
        int8_matmul_kernel(x, il)
    with torch.no_grad():
        assert qmatmul.apply_linear(x, loaded.params["classifier"]).shape == (2, 4)


def test_export_refuses_int8_params(tiny_gguf, tmp_path):
    from dinov2_tpu_torch.io.export import export_gguf

    loaded = params.load_params(tiny_gguf, dtype=torch.float32, quant_mode="int8")
    with pytest.raises(ValueError, match="int8"):
        export_gguf(tmp_path / "out.gguf", loaded.params, loaded.config)


class _CudaStub:
    """Metadata of a CUDA tensor, for the wrappers' checks that run before
    any launch (no card here)."""

    def __init__(self, shape, dtype):
        self.shape, self.dtype = torch.Size(shape), dtype
        self.device = torch.device("cuda")
        self.requires_grad = False

    def is_contiguous(self):
        return True

    def data_ptr(self):
        return 0


@pytest.mark.parametrize("k", [96, 200, 1000])
def test_k9_refuses_k_it_does_not_take(k):
    """On a CUDA tensor a K that is no multiple of 128 raises, in the
    one-call wrapper before its first launch and in the GEMM's; the
    quantize alone takes K % 16 == 0."""
    il = Int8Linear(codes=torch.zeros((64, k), dtype=torch.int8),
                    s=torch.ones(64), shape=(64, k))
    with pytest.raises(NotImplementedError, match="K % 128"):
        int8_matmul_kernel(_CudaStub((4, k), torch.bfloat16), il)
    with pytest.raises(NotImplementedError, match="K % 128"):
        int8_gemm_kernel(_CudaStub((4, k), torch.int8), _CudaStub((4, 1), torch.float32), il)
    if k % 16:
        with pytest.raises(NotImplementedError, match="K % 16"):
            quantize_rows_int8_kernel(_CudaStub((4, k), torch.float32))
    with pytest.raises(NotImplementedError, match="bf16 or f32"):
        quantize_rows_int8_kernel(_CudaStub((4, 128), torch.float16))
    with pytest.raises(ValueError, match="no K9 kernel for device"):
        quantize_rows_int8_kernel(torch.zeros((4, 128), device="meta"))
