"""The port's ops and image modules against their JAX counterparts on the CPU.

Inputs come from numpy seeds and go through both packages; everything is f32
unless a test says otherwise. The K1 plain version is held against the JAX
kernel run in interpret mode and against the JAX unfused reference.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dinov2_tpu.image import posembed as jposembed
from dinov2_tpu.image import preprocess as jpre
from dinov2_tpu.image import resize as jresize
from dinov2_tpu.models import vit as jvit
from dinov2_tpu.ops import attention as jattn
from dinov2_tpu.ops import fused_attention as jfused
from dinov2_tpu.ops import qmatmul as jqm
from dinov2_tpu_torch.image import posembed, preprocess, resize
from dinov2_tpu_torch.models import vit
from dinov2_tpu_torch.ops import attention, fused_attention, qmatmul


def _half_layer_inputs(rng, b, t, d):
    return [
        rng.standard_normal((b, t, d)),
        rng.uniform(0.5, 1.5, d),
        rng.standard_normal(d) * 0.1,
        rng.standard_normal((d, 3 * d)) * 0.05,
        rng.standard_normal(3 * d) * 0.1,
        rng.standard_normal((d, d)) * 0.05,
        rng.standard_normal(d) * 0.1,
        rng.uniform(0.1, 1.0, d),
    ]


@pytest.mark.parametrize("t", [37, 5])
def test_slab_layer_reference_matches_jax(t):
    """K1's plain version against the JAX kernel (interpret mode) and the JAX
    unfused reference, f32, at the tolerance of
    test_pallas_kernels.py::test_slab_layer_block_matches_unfused."""
    b, heads, d = 2, 4, 64
    scale, eps = 0.25, 1e-6
    arrays = [a.astype(np.float32) for a in _half_layer_inputs(np.random.default_rng(t), b, t, d)]
    j_args = [jnp.asarray(a) for a in arrays]
    kernel = np.asarray(jfused.slab_layer_block(*j_args, heads, scale, eps, True))
    unfused = np.asarray(jfused._slab_layer_reference(*j_args, heads, scale, eps))
    got = fused_attention.slab_layer_block(
        *[torch.from_numpy(a) for a in arrays], heads, scale, eps
    ).numpy()
    np.testing.assert_allclose(got, kernel, rtol=2e-6, atol=2e-6)
    np.testing.assert_allclose(got, unfused, rtol=2e-6, atol=2e-6)


def test_vanilla_attention_matches_jax():
    rng = np.random.default_rng(1)
    qkv = rng.standard_normal((2, 9, 3 * 64)).astype(np.float32)
    want = np.asarray(
        jattn.vanilla_attention(*jattn.split_heads(jnp.asarray(qkv), 4), 0.25)
    )
    got = attention.vanilla_attention(
        *attention.split_heads(torch.from_numpy(qkv), 4), 0.25
    ).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_slab_layer_block_refuses_other_devices():
    x = torch.zeros((1, 3, 64), device="meta")
    with pytest.raises(ValueError, match="no slab_layer_block for device"):
        fused_attention.slab_layer_block(x, *([None] * 7), 1, 0.125, 1e-6)


def _cuda_args(d=128, heads=2, dtype=torch.bfloat16):
    """Valid K1 argument set, built on the CPU (the checks read metadata only)."""
    bf = torch.bfloat16
    return [
        torch.zeros((2, 5, d), dtype=dtype), torch.ones(d), torch.zeros(d),
        torch.zeros((d, 3 * d), dtype=bf), torch.zeros(3 * d),
        torch.zeros((d, d), dtype=bf), torch.zeros(d), torch.ones(d), heads,
    ]


@pytest.mark.parametrize(
    "case, error",
    [
        ("f32 activations", NotImplementedError),
        ("head_dim 32", NotImplementedError),
        ("w_qkv transposed", ValueError),
        ("ls1 in bf16", ValueError),
        ("x not contiguous", ValueError),
    ],
)
def test_cuda_argument_checks(case, error):
    """What the CUDA path refuses, checked before any launch."""
    args = _cuda_args()
    if case == "f32 activations":
        args = _cuda_args(dtype=torch.float32)
    elif case == "head_dim 32":
        args[-1] = 4
    elif case == "w_qkv transposed":
        args[3] = args[3].T.contiguous()
    elif case == "ls1 in bf16":
        args[7] = args[7].to(torch.bfloat16)
    elif case == "x not contiguous":
        args[0] = torch.zeros((2, 128, 5), dtype=torch.bfloat16).transpose(1, 2)
    fused_attention._check_cuda_args(*_cuda_args())  # the valid set passes
    with pytest.raises(error):
        fused_attention._check_cuda_args(*args)


def _f16_ordinal(a: np.ndarray) -> np.ndarray:
    """f16 values as integers in value order (+0 and -0 both map to 0), so
    a difference of ordinals counts f16 ulps, subnormals included."""
    bits = a.astype(np.float16).view(np.int16).astype(np.int32)
    return np.where(bits < 0, -(bits & 0x7FFF), bits)


def test_gelu_tanh_f16_within_one_f16_ulp():
    """Real f16 casts against the JAX version, on a grid that spans the f16
    subnormal band (|x| < 6.1e-5), normal values and the negative tail.

    Within 1 f16 ulp for x > -3. Below, 0.5*x*(1 + tanh(u)) cancels: tanh
    is within a few f32 ulps (2^-24 each) of -1, and XLA's and torch's tanh
    differ there by that much (XLA's even saturates to -1 below x ~ -4.9
    and returns -0). So for x <= -3 the bound is 1 f16 ulp plus
    0.5*|x|*2^-21, four f32 ulps of tanh near -1 for each side."""
    grid = np.concatenate([
        np.linspace(-8.0, 8.0, 4001),
        np.linspace(-1e-4, 1e-4, 2001),
        np.geomspace(1e-8, 6.1e-5, 500),
        -np.geomspace(1e-8, 6.1e-5, 500),
    ]).astype(np.float32)
    want = np.asarray(jqm.gelu_tanh_f16(jnp.asarray(grid)))
    got = qmatmul.gelu_tanh_f16(torch.from_numpy(grid)).numpy()
    tail = grid <= -3.0
    ulps = np.abs(_f16_ordinal(got) - _f16_ordinal(want))
    assert (ulps[~tail] <= 1).all()
    f16_ulp = np.spacing(np.abs(want[tail]).astype(np.float16)).astype(np.float64)
    bound = f16_ulp + 0.5 * np.abs(grid[tail]) * 2.0**-21
    assert (np.abs(got[tail].astype(np.float64) - want[tail]) <= bound).all()


@pytest.mark.parametrize("activation", [None, "gelu_tanh", "gelu_erf", "gelu_tanh_f16"])
def test_apply_linear_matches_jax(activation):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 7, 16)).astype(np.float32)
    layer = {"kernel": rng.standard_normal((16, 24)).astype(np.float32) * 0.3,
             "bias": rng.standard_normal(24).astype(np.float32)}
    want = np.asarray(jqm.apply_linear(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in layer.items()}, activation=activation
    ))
    got = qmatmul.apply_linear(
        torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in layer.items()},
        activation=activation,
    ).numpy()
    # f16-rounded GELU outputs may differ by one f16 ulp (2^-11 relative)
    tol = 1e-3 if activation == "gelu_tanh_f16" else 1e-5
    np.testing.assert_allclose(got, want, rtol=tol, atol=1e-5)
    with pytest.raises(ValueError, match="unknown activation"):
        qmatmul.apply_activation(torch.zeros(1), "relu")


def test_layer_norm_matches_jax():
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((2, 11, 48)) * 3 + 1).astype(np.float32)
    p = {"scale": rng.uniform(0.5, 1.5, 48).astype(np.float32),
         "bias": rng.standard_normal(48).astype(np.float32)}
    want = np.asarray(jvit.layer_norm(jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()}, 1e-6))
    got = vit.layer_norm(torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in p.items()}, 1e-6)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("src, dst", [(37, 16), (5, 4), (256, 256), (100, 256), (3, 9)])
def test_cubic_resize_matrix_exact(src, dst):
    np.testing.assert_array_equal(
        resize.cubic_resize_matrix(src, dst), jresize.cubic_resize_matrix(src, dst)
    )


def test_resize_bicubic_matches_jax():
    img = np.random.default_rng(4).uniform(0, 1, (2, 30, 41, 3)).astype(np.float32)
    want = np.asarray(jresize.resize_bicubic(jnp.asarray(img), 17, 56))
    got = resize.resize_bicubic(torch.from_numpy(img), 17, 56).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_classify_preprocess_matches_jax():
    img = np.random.default_rng(5).integers(0, 256, (2, 100, 120, 3), dtype=np.uint8)
    want = np.asarray(jpre.classify_preprocess(jnp.asarray(img)))
    got = preprocess.classify_preprocess(torch.from_numpy(img)).numpy()
    assert got.shape == (2, 224, 224, 3)
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("new_hw", [(4, 4), (5, 5), (1, 25)])
def test_interpolate_pos_embed_matches_jax(new_hw):
    """5x5 -> 4x4 resizes; an equal patch count (5x5, or 1x25) returns the
    embedding untouched (the reference compares counts, not shapes)."""
    pos = np.random.default_rng(6).standard_normal((26, 8)).astype(np.float32)
    want = np.asarray(jposembed.interpolate_pos_embed(jnp.asarray(pos), 5, new_hw))
    got = posembed.interpolate_pos_embed(torch.from_numpy(pos), 5, new_hw).numpy()
    assert got.shape == (new_hw[0] * new_hw[1] + 1, 8)
    np.testing.assert_allclose(got, want, atol=1e-6)
    if new_hw[0] * new_hw[1] == 25:
        np.testing.assert_array_equal(got, pos)
