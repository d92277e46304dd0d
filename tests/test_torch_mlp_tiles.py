"""The tile walks of K5 and K7 on Hopper, on the CPU.

csrc/slab_mlp.cu (K5) and csrc/quant_matmul.cu (K7) run on the GEMM core of
csrc/wgmma_gemm.cuh and cannot run here. This file emulates their walks in
plain PyTorch, step for step, with test_torch_gemm_tiles.py's emulation of
that core (128-row tiles with the rows past M zero-filled and never written,
256-column tiles of 64-column atoms, 64-deep k-steps accumulated in f32 in
order):
  - K5: the layer norm of each row once, fc1 with the activation epilogue
    (bf16(acc) + bf16(b1), then the activation on that value) into the
    hidden buffer, fc2 over the whole hidden axis with the residual
    epilogue; held against `slab_mlp_reference` and the JAX
    `slab_mlp_block` in interpret mode, for the three activations, at
    D = 384 and row counts around the 128-row tile;
  - K7: the weight dequantized once to (N, K) in the compute dtype, then the
    walk with that weight as the k-major operand, its rows past N
    zero-filled and the columns past N computed and dropped, and the
    activation epilogue; held against `quant_matmul_reference` and the JAX
    `quant_matmul(backend="xla")` for the five formats, packed and int8
    SoA, at N = 33 and N = 1000.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (caps torch's threads under xdist)
from test_torch_gemm_tiles import (
    ATOM,
    COLS,
    DEPTH,
    EPS,
    F32_ATOL,
    ROWS,
    _held,
    emulate_gemm,
    emulate_layer_norm_rows,
    residual_epilogue,
)
from test_torch_quant import _jax_ql, _to_port

from dinov2_tpu.ops import fused_attention as jfused
from dinov2_tpu.ops import qmatmul as jqmatmul
from dinov2_tpu_torch.ops.fused_attention import slab_mlp_reference
from dinov2_tpu_torch.ops.qmatmul import apply_activation, dequant_weight
from dinov2_tpu_torch.ops.qmatmul_kernel import quant_matmul_reference

ACTIVATIONS = ["gelu_tanh_f16", "gelu_erf", "gelu_tanh"]
D = 384  # the narrowest width K5 is built for; DH = 4 D
MLP_ROWS = [(1, 1), (2, 37), (1, 129), (3, 100)]  # (B, T): M = 1, 74, 129, 300
# gelu_tanh_f16 rounds g to f16: where two f32 sums of fc1 straddle an f16
# boundary g moves by one f16 ulp (2^-9 for |g| in [2, 4)), and fc2 carries
# it into the output times one w2 element (max |w2| ~0.25 here) and ls2 <= 1
# (tests/test_torch_giant.py::test_slab_mlp_block_matches_jax, at D = 64)
F32_ATOL_F16_GELU = 5e-4
# K7's f32 comparisons: O(10) outputs, sums over K = 256 in another order
QUANT_F32_RTOL = 2e-6  # of max|output|
FORMATS = ["q4_0", "q4_1", "q5_0", "q5_1", "q8_0"]


def act_epilogue(bias, activation):
    """ActEpilogue (csrc/gemm_core.cuh): bf16(acc), + bf16(bias) where there
    is one, then the activation on that value, rounded."""
    def ep(acc, rows, cols, dtype):
        y = acc.to(dtype)
        if bias is not None:
            y = y + bias[cols].to(dtype)
        return apply_activation(y, activation)
    return ep


def emulate_gemm_k_major(a, w, ep):
    """wgmma_gemm_kernel's walk on an (N, K) weight, any N: a block's 256
    weight rows with those past N zero-filled, ep on the columns < N only."""
    (m, k), n = a.shape, w.shape[0]
    assert k % DEPTH == 0
    out = torch.full((m, n), float("nan"), dtype=a.dtype)
    for row0 in range(0, m, ROWS):
        rows = slice(row0, min(row0 + ROWS, m))
        a_rows = torch.nn.functional.pad(a[rows], (0, 0, 0, ROWS - (rows.stop - rows.start)))
        for col0 in range(0, n, COLS):
            width = min(COLS, n - col0)
            w_rows = torch.zeros((COLS, k), dtype=a.dtype)
            w_rows[:width] = w[col0 : col0 + width]
            acc = torch.zeros((ROWS, COLS))
            for k0 in range(0, k, DEPTH):
                acc += a_rows[:, k0 : k0 + DEPTH].float() @ w_rows[:, k0 : k0 + DEPTH].float().T
            cols = slice(col0, col0 + width)
            out[rows, cols] = ep(acc[: rows.stop - rows.start, :width], rows, cols, a.dtype)
    return out


def emulate_slab_mlp(x, ln_scale, ln_bias, w1, b1, w2, b2, ls2, activation):
    """K5's three launches: layer norm, fc1 with the activation, fc2 with the
    residual; the hidden buffer is (M, 4D) in x's dtype."""
    b, t, d = x.shape
    x2 = x.reshape(b * t, d)
    h = emulate_layer_norm_rows(x2, ln_scale, ln_bias, EPS)
    hidden = emulate_gemm(h, w1.to(x.dtype), act_epilogue(b1, activation))
    assert hidden.shape == (b * t, 4 * d)
    out = emulate_gemm(hidden, w2.to(x.dtype), residual_epilogue(b2, ls2, x2))
    return out.reshape(b, t, d)


def emulate_quant_matmul(x, ql, bias, activation):
    """K7's two bf16 launches: dequant_weight_kernel (bit for bit
    dequant_weight in the compute dtype, (N, K)), then the walk."""
    return emulate_gemm_k_major(x, dequant_weight(ql, x.dtype), act_epilogue(bias, activation))


def _mlp_inputs(b, t, dtype, seed):
    rng = np.random.default_rng(seed)
    arrays = [
        (rng.standard_normal((b, t, D)), dtype),
        (rng.uniform(0.5, 1.5, D), torch.float32),
        (rng.standard_normal(D) * 0.1, torch.float32),
        (rng.standard_normal((D, 4 * D)) * 0.05, dtype),
        (rng.standard_normal(4 * D) * 0.1, torch.float32),
        (rng.standard_normal((4 * D, D)) * 0.05, dtype),
        (rng.standard_normal(D) * 0.1, torch.float32),
        (rng.uniform(0.1, 1.0, D), torch.float32),
    ]
    return [torch.from_numpy(a).to(dt) for a, dt in arrays]


def _f32_atol(activation):
    return F32_ATOL_F16_GELU if activation == "gelu_tanh_f16" else F32_ATOL


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("b, t", MLP_ROWS)
@pytest.mark.parametrize("activation", ACTIVATIONS)
def test_mlp_walk_matches_plain_version(activation, b, t, dtype):
    """K5's walk against slab_mlp_reference: in f32 to summation order, in
    bf16 within K1's bound on the card (cast points)."""
    args = _mlp_inputs(b, t, dtype, seed=b * t)
    got = emulate_slab_mlp(*args, activation)
    assert got.dtype == dtype and got.shape == args[0].shape
    want = slab_mlp_reference(*[a.float() for a in args], activation, EPS)
    if dtype == torch.float32:
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=_f32_atol(activation), rtol=0)
    else:
        _held(got, slab_mlp_reference(*args, activation, EPS), want, f"K5 {activation}")


@pytest.mark.parametrize("activation", ACTIVATIONS)
def test_mlp_walk_matches_jax_kernel(activation):
    """K5's walk in f32 against the JAX slab_mlp_block (the flattened-rows
    Pallas kernel) in interpret mode, M = 74."""
    args = _mlp_inputs(2, 37, torch.float32, seed=5)
    kernel = np.asarray(
        jfused.slab_mlp_block(*[jnp.asarray(a.numpy()) for a in args], activation, EPS, True))
    got = emulate_slab_mlp(*args, activation)
    np.testing.assert_allclose(got.numpy(), kernel, atol=_f32_atol(activation), rtol=0)


@pytest.mark.parametrize("n, activation, with_bias", [(33, "gelu_tanh", False),
                                                      (1000, "gelu_erf", True)])
@pytest.mark.parametrize("packed", [True, False], ids=["packed", "soa"])
@pytest.mark.parametrize("fmt", FORMATS)
def test_quant_walk_matches_plain_version_and_jax(fmt, packed, n, activation, with_bias):
    """K7's dequantize-once walk at a ragged N (33: one 64-column atom,
    scalar stores; 1000: four column tiles, the last one ragged) and M = 130
    (a ragged second row tile): in f32 against quant_matmul_reference and
    the JAX quant_matmul(backend="xla"), in bf16 within K1's bound."""
    k, m = 256, 130
    w = (np.random.default_rng(n).standard_normal((n, k)) * 0.5).astype(np.float32)
    jql = _jax_ql(w, fmt, packed)
    ql = _to_port(jql)
    rng = np.random.default_rng(k + n)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    bias = torch.from_numpy(rng.standard_normal(n).astype(np.float32) * 0.1) if with_bias else None

    got = emulate_quant_matmul(x, ql, bias, activation)
    assert got.shape == (m, n) and torch.isfinite(got).all()
    want = quant_matmul_reference(x, ql, bias, activation)
    atol = QUANT_F32_RTOL * want.abs().max().item()
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=atol, rtol=0)
    jax_out = np.asarray(jqmatmul.quant_matmul(
        jnp.asarray(x.numpy()), jql, backend="xla",
        bias=None if bias is None else jnp.asarray(bias.numpy()), activation=activation))
    np.testing.assert_allclose(got.numpy(), jax_out, atol=atol, rtol=0)

    xb = x.to(torch.bfloat16)
    _held(emulate_quant_matmul(xb, ql, bias, activation),
          quant_matmul_reference(xb, ql, bias, activation),
          quant_matmul_reference(xb.float(), ql, bias, activation), f"K7 {fmt} N={n}")


def test_k_major_walk_equals_the_mn_major_walk():
    """The two weight layouts of the GEMM core are one walk: on a weight of
    N = 64 * odd both give equal bits (ATOM-wide columns, the same k order)."""
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.standard_normal((200, 192))).to(torch.bfloat16)
    w = torch.from_numpy(rng.standard_normal((3 * ATOM, 192)) * 0.1).to(torch.bfloat16)
    bias = torch.from_numpy(rng.standard_normal(3 * ATOM)).float()
    ep = act_epilogue(bias, "gelu_erf")
    assert torch.equal(emulate_gemm_k_major(a, w, ep), emulate_gemm(a, w.T.contiguous(), ep))
