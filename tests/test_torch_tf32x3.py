"""3xTF32, the f32 products of K7's f32 route and of K6 f32, on the CPU.

csrc/tf32x3.cuh splits every f32 operand once, where it is staged, into two
TF32 values, hi = tf32(a) (cvt.rna.tf32.f32: to nearest, ties away) and
lo = tf32(a - hi), and takes a . b as a_lo.b_hi + a_hi.b_lo + a_hi.b_hi on
the tensor cores, a long sum in chunks added with rounded f32 adds. The
kernels cannot run here. This file holds:
  - the split itself, with the kernel's rounding (+0x1000 on the bits, then
    the low 13 bits cleared);
  - K7's f32 route (csrc/quant_matmul.cu): the dequantize launch's two
    planes, whose sum is `dequant_weight(W, f32)` bit for bit in the
    symmetric formats; the GEMM's walk (128 x 128 tiles, rows past M and N
    landing as zeros, 32-deep k-steps each a chunk, the act(acc + bias)
    epilogue on the columns < N), held against `quant_matmul_reference`,
    the JAX `quant_matmul(backend="xla")` and `quant_matmul_pallas` in
    interpret mode;
  - K6 f32's walk (csrc/f32_backward.cuh): test_torch_flash_tiles.py's
    `emulate_backward` with 32-row streamed tiles and the 3xTF32 product,
    held against `flash_backward_reference` and the JAX `_flash_backward`
    in interpret mode.
The emulation sums each product's terms to nearest in f32; the card's
tensor cores truncate inside a chunk, which only the card's checks
(chip_smoke.py, F32_TOL and F32_GRAD_TOL) can show.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (caps torch's threads under xdist)
from test_torch_flash_backward import _force_multi_block, _qkvg
from test_torch_flash_tiles import emulate_backward
from test_torch_quant import _jax_ql, _to_port

from dinov2_tpu.ops import flash_attention as jfa
from dinov2_tpu.ops import qmatmul as jqmatmul
from dinov2_tpu.ops.pallas_qmatmul import quant_matmul_pallas
from dinov2_tpu_torch.ops.flash_attention import flash_backward_reference
from dinov2_tpu_torch.ops.qmatmul import apply_activation, dequant_weight
from dinov2_tpu_torch.ops.qmatmul_kernel import quant_matmul_reference

FORMATS = ["q4_0", "q4_1", "q5_0", "q5_1", "q8_0"]
SYMMETRIC = {"q4_0", "q5_0", "q8_0"}
ACTIVATIONS = [None, "gelu_tanh_f16", "gelu_erf", "gelu_tanh"]
ROWS, COLS, DEPTH = 128, 128, 32  # K7's f32 GEMM: output tile, k-step
# chip_smoke.py's bounds, of max(1, max|plain|): F32_TOL, F32_GRAD_TOL
F32_TOL = 1e-5
F32_GRAD_TOL = 2e-5
SCALE = 0.125


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32 on f32 x: +0x1000 on the bits, the low 13 cleared
    (to nearest, ties away from zero), as f32 values."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """tf32x3.cuh::split_tf32: hi = tf32(x), lo = tf32(x - hi)."""
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)


def tf32x3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the kernels take it: both split, the two small products
    first, the f32 sum of the three a chunk."""
    ah, al = tf32_split(a)
    bh, bl = tf32_split(b)
    return al @ bh + ah @ bl + ah @ bh


def _bound(want: torch.Tensor, tol: float) -> float:
    return tol * max(1.0, want.abs().max().item())


def f16_step(y: torch.Tensor) -> torch.Tensor:
    """One f16 step at each value of y."""
    _, exponent = torch.frexp(y.abs())
    return torch.exp2((exponent - 11).float()).clamp_min(2.0**-24)


GELU_SLOPE = 1.13  # the largest |d gelu_tanh / dy|


def assert_activation_close(got, want, activation, pre):
    """Within F32_TOL of max(1, max|want|). gelu_tanh_f16 rounds its input
    y and its output g to f16: where the kernel's and the plain version's
    f32 sums straddle an f16 boundary of y, g moves by up to GELU_SLOPE f16
    steps of y, and by one f16 step of g where g's straddle one; `pre` is y."""
    slack = 0.0
    if activation == "gelu_tanh_f16":
        slack = GELU_SLOPE * f16_step(pre) + f16_step(want)
    assert ((got - want).abs() <= _bound(want, F32_TOL) + slack).all()


# ----------------------------------------------------------------- the split

def test_tf32_round_ties_away_from_zero():
    """cvt.rna: a value halfway between two TF32 neighbours goes to the one
    away from zero, whatever the last kept bit; just below half goes down."""
    one, ulp = 1.0, 2.0**-10
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp + ulp / 2,
                      one + ulp / 2 - 2.0**-23, 3.0, -0.0], dtype=torch.float32)
    want = torch.tensor([one + ulp, -(one + ulp), one + 2 * ulp, one, 3.0, -0.0])
    assert torch.equal(tf32_round(x), want)


@pytest.mark.parametrize("scale", [1e-30, 1e-3, 1.0, 7.5, 1e30])
def test_split_is_whole_tf32_values_within_2_to_minus_22(scale):
    """Both planes are TF32 values (low 13 bits zero); hi is within half a
    TF32 step (2^-11) of x, hi + lo within 2^-22 of x, and hi + lo is exact
    in f32 (the two cover at most 22 significant bits)."""
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(4096) * scale).float()
    hi, lo = tf32_split(x)
    for plane in (hi, lo):
        assert not (plane.view(torch.int32) & 0x1FFF).any()
    x64 = x.double()
    assert ((hi.double() - x64).abs() <= 2.0**-11 * x64.abs()).all()
    assert ((hi.double() + lo.double() - x64).abs() <= 2.0**-22 * x64.abs()).all()
    assert torch.equal((hi + lo).double(), hi.double() + lo.double())


def test_one_pass_tf32_misses_the_f32_bound_and_3xtf32_meets_it():
    """Why three products: one pass of TF32 operands is ~1e-4 off an f32
    product at K = 768, 3xTF32 within F32_TOL."""
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.standard_normal((64, 768))).float()
    b = torch.from_numpy(rng.standard_normal((768, 96)) * 0.05).float()
    want = (a.double() @ b.double()).float()
    one_pass = tf32_round(a) @ tf32_round(b)
    assert (one_pass - want).abs().max().item() > 10 * _bound(want, F32_TOL)
    assert (tf32x3(a, b) - want).abs().max().item() <= _bound(want, F32_TOL)


# --------------------------------------------------------------- K7's f32 route

def dequant_planes(ql) -> tuple[torch.Tensor, torch.Tensor]:
    """The dequantize launch, dequant_weight_kernel<Tf32SplitRows>: the TF32
    hi and lo planes of dequant_weight(W, f32), (N, K) each."""
    return tf32_split(dequant_weight(ql, torch.float32))


def emulate_quant_matmul_f32(x, ql, bias, activation):
    """quant_matmul_tf32x3_kernel's walk: 128 x 128 output tiles, rows past M
    and weight rows past N zero (the TMA's fill), 32-deep k-steps each a
    fresh chunk of three products added to the f32 sum, then act(acc +
    bias) on the rows < M and columns < N."""
    hi, lo = dequant_planes(ql)
    (m, k), n = x.shape, hi.shape[0]
    assert k % DEPTH == 0
    out = torch.full((m, n), float("nan"))
    for row0 in range(0, m, ROWS):
        rows = min(ROWS, m - row0)
        xr = torch.zeros((ROWS, k))
        xr[:rows] = x[row0 : row0 + rows]
        for col0 in range(0, n, COLS):
            width = min(COLS, n - col0)
            wh, wl = torch.zeros((COLS, k)), torch.zeros((COLS, k))
            wh[:width], wl[:width] = hi[col0 : col0 + width], lo[col0 : col0 + width]
            acc = torch.zeros((ROWS, COLS))
            for k0 in range(0, k, DEPTH):
                xh, xl = tf32_split(xr[:, k0 : k0 + DEPTH])
                step = slice(k0, k0 + DEPTH)
                acc = acc + (xl @ wh[:, step].T + xh @ wl[:, step].T + xh @ wh[:, step].T)
            y = acc[:rows, :width]
            if bias is not None:
                y = y + bias[col0 : col0 + width]
            out[row0 : row0 + rows, col0 : col0 + width] = apply_activation(y, activation)
    return out


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "soa"])
@pytest.mark.parametrize("fmt", FORMATS)
def test_dequant_planes_sum_to_the_f32_weight(fmt, packed):
    """hi + lo == dequant_weight(W, f32) bit for bit where a value has at
    most 19 significant bits (a 4-8-bit code times an f16 scale: q4_0, q5_0,
    q8_0); within 2^-22 of it for q4_1 and q5_1, whose + m adds bits."""
    ql = _to_port(_jax_ql((np.random.default_rng(1).standard_normal((200, 256)) * 0.5)
                          .astype(np.float32), fmt, packed))
    w = dequant_weight(ql, torch.float32)
    hi, lo = dequant_planes(ql)
    for plane in (hi, lo):
        assert not (plane.view(torch.int32) & 0x1FFF).any()
    if fmt in SYMMETRIC:
        assert torch.equal(hi + lo, w)
    else:
        assert ((hi + lo).double() - w.double()).abs().le(2.0**-22 * w.double().abs()).all()


def _quant_inputs(fmt, packed, n, k, m, seed):
    w = (np.random.default_rng(seed).standard_normal((n, k)) * 0.5).astype(np.float32)
    jql = _jax_ql(w, fmt, packed)
    rng = np.random.default_rng(seed + 1)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    bias = torch.from_numpy(rng.standard_normal(n).astype(np.float32) * 0.1)
    return jql, _to_port(jql), x, bias


@pytest.mark.parametrize("activation", ACTIVATIONS)
@pytest.mark.parametrize("packed", [True, False], ids=["packed", "soa"])
@pytest.mark.parametrize("fmt", FORMATS)
def test_quant_f32_walk_matches_plain_version_and_jax(fmt, packed, activation):
    """K7's f32 walk at a ragged M = 130 (a second row tile of two rows) and
    N = 200 (a second column tile of 72 columns) against
    quant_matmul_reference and the JAX quant_matmul(backend="xla"), within
    chip_smoke.py's F32_TOL (gelu_tanh_f16: its two f16 roundings more).
    Without a bias the epilogue adds nothing."""
    jql, ql, x, bias = _quant_inputs(fmt, packed, 200, 256, 130, seed=len(fmt) + packed)
    if activation == "gelu_erf":
        bias = None
    got = emulate_quant_matmul_f32(x, ql, bias, activation)
    assert got.shape == (130, 200) and torch.isfinite(got).all()
    want = quant_matmul_reference(x, ql, bias, activation)
    pre = quant_matmul_reference(x, ql, bias, None)
    assert_activation_close(got, want, activation, pre)
    jax_out = np.asarray(jqmatmul.quant_matmul(
        jnp.asarray(x.numpy()), jql, backend="xla",
        bias=None if bias is None else jnp.asarray(bias.numpy()), activation=activation))
    assert_activation_close(got, torch.from_numpy(jax_out.copy()), activation, pre)


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "soa"])
@pytest.mark.parametrize("fmt", FORMATS)
def test_quant_f32_walk_against_jax_pallas(fmt, packed):
    """K7's f32 walk against the TPU kernel quant_matmul_pallas in interpret
    mode, with test_torch_quant.py's bound for the plain version: the TPU
    kernel rounds each q·d to bf16 before the MXU, 2^-8 of itself, which
    K7 does not copy."""
    jql, ql, x, _ = _quant_inputs(fmt, packed, 160, 256, 24, seed=6)
    want = np.asarray(quant_matmul_pallas(jnp.asarray(x.numpy()), jql, block_m=8, block_n=128,
                                          interpret=True))
    got = emulate_quant_matmul_f32(x, ql, None, None).numpy()
    qd = dequant_weight(ql, torch.float32).numpy()
    if ql.m is not None:
        qd = qd - np.repeat(ql.m.numpy(), 32, axis=1)
    bound = 2.0**-8 * (np.abs(x.numpy()) @ np.abs(qd).T) + 1e-5 * (1 + np.abs(want))
    assert (np.abs(got - want) <= bound).all()


# ------------------------------------------------------------------- K6 f32

BLOCK_ROWS, STREAM_ROWS = 128, 32  # f32_backward.cuh's blocks and streamed tiles


@pytest.mark.parametrize("slab", [False, True], ids=["contiguous", "slab"])
@pytest.mark.parametrize("t", [65, 300])
def test_k6_f32_walk_matches_plain_version_and_jax(monkeypatch, t, slab):
    """K6 f32's walk (blocks of 128 keys and 128 queries, 64 a warpgroup,
    32-row streamed tiles, every product 3xTF32, each tile's dV, dK and dQ
    products a chunk)
    against flash_backward_reference and the JAX FA-2 backward kernels in
    interpret mode on the JAX forward's o and lse, within F32_GRAD_TOL of
    max(1, max|g|). At T = 300 the JAX kernels take several KV blocks; with
    `slab` q, k and v are strided head views, as the slab route hands
    them."""
    if t == 300:
        _force_multi_block(monkeypatch, t)
    b, heads = 2, 2
    q, k, v, g = _qkvg(t + 7, b, t, heads)
    qs, ks, vs, gs = (torch.from_numpy(a) for a in (q, k, v, g))
    if slab:
        qkv = torch.cat([a.reshape(b, t, heads * 64) for a in (qs, ks, vs)], dim=-1)
        qs, ks, vs = (qkv[..., i * heads * 64 : (i + 1) * heads * 64].unflatten(-1, (heads, 64))
                      for i in range(3))
    jq, jk, jv, jg = map(jnp.asarray, (q, k, v, g))
    o, lse = jfa._flash_forward(jq, jk, jv, SCALE, interpret=True, with_lse=True)
    want_jax = jfa._flash_backward(jq, jk, jv, o, lse, jg, SCALE, interpret=True)
    o_port = torch.from_numpy(np.asarray(o).copy())
    lse_port = torch.from_numpy(np.asarray(lse)[:, :t, 0].reshape(b, heads, t).copy())
    got = emulate_backward(qs, ks, vs, o_port, lse_port, gs, SCALE, BLOCK_ROWS, STREAM_ROWS,
                           tf32x3)
    plain = flash_backward_reference(qs, ks, vs, o_port, lse_port, gs, SCALE)
    for name, a, p, w in zip(("dq", "dk", "dv"), got, plain, want_jax):
        assert a.shape == (b, t, heads, 64) and torch.isfinite(a).all(), name
        assert (a - p).abs().max().item() <= _bound(p, F32_GRAD_TOL), name
        assert np.abs(a.numpy() - np.asarray(w)).max() <= _bound(p, F32_GRAD_TOL), name
