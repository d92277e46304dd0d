"""The tile algebra of K1's Hopper GEMMs, on the CPU.

csrc/wgmma_gemm.cuh (K1's layer-norm, QKV and proj launches, K2's proj)
cannot run here. This file emulates its walk in plain PyTorch, step for step:
the layer norm of each row once (two-pass f32 statistics,
(x - mu) * rstd * scale + bias, one cast to the operand dtype), then 128-row
output tiles with the rows past M zero-filled and never written, 256-column
tiles made of four 64-column atoms with the atoms past N (N = 64 * odd)
zero-filled and not written, 64-deep k-steps accumulated in f32 in order,
and both epilogues' rounding order. With
test_torch_flash_tiles.py's emulation of the attention tile loop between the
two GEMMs it is the whole of K1, held against the plain version
`slab_layer_reference` and, through it, against the JAX `slab_layer_block`
run in interpret mode, so that a wrong mask, a wrong cast point or a wrong
column tile shows before any time on a card is spent.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (caps torch's threads under xdist)
from test_torch_flash_tiles import emulate_forward

from dinov2_tpu.ops import fused_attention as jfused
from dinov2_tpu_torch.ops.attention import split_heads
from dinov2_tpu_torch.ops.fused_attention import (
    _slab_block_reference,
    slab_layer_reference,
)

ROWS, COLS, ATOM, DEPTH = 128, 256, 64, 64  # a block's tile, a swizzle atom, a k-step
SCALE, EPS = 0.125, 1e-6
SHAPES = [(1, 1, 2), (2, 37, 3), (3, 65, 4), (2, 257, 12)]  # (B, T, heads), D = 64 * heads
# f32: the emulation and the plain version differ by summation order only
F32_ATOL = 1e-5


def emulate_layer_norm_rows(x, ln_scale, ln_bias, eps):
    """layer_norm_rows_kernel: each row of (M, K) x normalized with its own
    f32 two-pass statistics, cast once to x's dtype."""
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(dim=-1, keepdim=True)
    rstd = 1.0 / torch.sqrt(var + eps)
    return ((x32 - mu) * rstd * ln_scale + ln_bias).to(x.dtype)


def bias_epilogue(bias):
    def ep(acc, rows, cols, dtype):
        return acc.to(dtype) + bias[cols].to(dtype)
    return ep


def residual_epilogue(bias, ls, resid):
    def ep(acc, rows, cols, dtype):
        y = acc.to(dtype) + bias[cols].to(dtype)
        return resid[rows, cols] + y * ls[cols].to(dtype)
    return ep


def emulate_gemm(a, w, ep):
    """wgmma_gemm_kernel's walk: ep(A @ W) for (M, K) a and (K, N) w in a's
    dtype."""
    (m, k), n = a.shape, w.shape[1]
    assert k % DEPTH == 0 and n % ATOM == 0
    out = torch.full((m, n), float("nan"), dtype=a.dtype)
    for row0 in range(0, m, ROWS):
        rows = slice(row0, min(row0 + ROWS, m))
        pad = ROWS - (rows.stop - rows.start)
        a_rows = torch.nn.functional.pad(a[rows], (0, 0, 0, pad))  # rows past M: zeros
        for col0 in range(0, n, COLS):
            width = min(COLS, n - col0)  # the 64-column atoms that N has
            acc = torch.zeros((ROWS, COLS))
            for k0 in range(0, k, DEPTH):
                a_tile = a_rows[:, k0 : k0 + DEPTH]
                w_tile = torch.zeros((DEPTH, COLS), dtype=a.dtype)
                w_tile[:, :width] = w[k0 : k0 + DEPTH, col0 : col0 + width]
                acc += a_tile.float() @ w_tile.float()
            cols = slice(col0, col0 + width)
            n_rows = rows.stop - rows.start
            out[rows, cols] = ep(acc[:n_rows, : cols.stop - cols.start], rows, cols, a.dtype)
    return out


def emulate_slab_layer(x, ln_scale, ln_bias, w_qkv, b_qkv, w_proj, b_proj, ls1, heads, block_rows):
    """K1's four launches: layer norm, QKV, attention, proj."""
    b, t, d = x.shape
    x2 = x.reshape(b * t, d)
    h = emulate_layer_norm_rows(x2, ln_scale, ln_bias, EPS)
    qkv = emulate_gemm(h, w_qkv.to(x.dtype), bias_epilogue(b_qkv))
    attn, _ = emulate_forward(*split_heads(qkv.reshape(b, t, 3 * d), heads), SCALE, block_rows)
    out = emulate_gemm(attn.reshape(b * t, d), w_proj.to(x.dtype),
                       residual_epilogue(b_proj, ls1, x2))
    return out.reshape(b, t, d), qkv.reshape(b, t, 3 * d)


def _inputs(b, t, d, dtype, seed):
    rng = np.random.default_rng(seed)
    arrays = [
        (rng.standard_normal((b, t, d)), dtype),
        (rng.uniform(0.5, 1.5, d), torch.float32),
        (rng.standard_normal(d) * 0.1, torch.float32),
        (rng.standard_normal((d, 3 * d)) * 0.05, dtype),
        (rng.standard_normal(3 * d) * 0.1, torch.float32),
        (rng.standard_normal((d, d)) * 0.05, dtype),
        (rng.standard_normal(d) * 0.1, torch.float32),
        (rng.uniform(0.1, 1.0, d), torch.float32),
    ]
    return [torch.from_numpy(a).to(dt) for a, dt in arrays]


def _held(got, plain, want, what):
    """K1's bound on the card (chip_smoke.py::check_kernel): in bf16 the
    kernel's walk may be twice as far from f32 as the plain version, plus
    1e-3 of the output's scale."""
    assert torch.isfinite(got).all(), what  # every element was written
    err = (got.float() - want).abs().max().item()
    err_plain = (plain.float() - want).abs().max().item()
    bound = 2 * err_plain + 1e-3 * want.abs().max().item()
    assert err <= bound, (what, err, err_plain, bound)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("b, t, heads", SHAPES)
def test_half_layer_walk_matches_plain_version(b, t, heads, dtype):
    """The whole of K1's walk against slab_layer_reference; M = B T covers one
    row, a ragged first tile, a ragged second tile and five tiles, D an even
    and an odd count of 64-column atoms (one to three column tiles)."""
    args = _inputs(b, t, 64 * heads, dtype, seed=t + heads)
    want = slab_layer_reference(*[a.float() for a in args], heads, SCALE, EPS)
    plain = slab_layer_reference(*args, heads, SCALE, EPS)
    for block_rows in (64, 128):
        out, _ = emulate_slab_layer(*args, heads, block_rows)
        assert out.dtype == dtype and out.shape == args[0].shape
        if dtype == torch.float32:
            np.testing.assert_allclose(out.numpy(), want.numpy(), atol=F32_ATOL, rtol=0)
        else:
            _held(out, plain, want, f"out, {block_rows}-row attention blocks")


@pytest.mark.parametrize("b, t, heads", SHAPES)
def test_half_layer_walk_matches_jax_kernel(b, t, heads):
    """The walk in f32 against the JAX slab_layer_block in interpret mode, at
    tests/test_torch_ops.py's tolerance scaled to this depth of sums."""
    args = _inputs(b, t, 64 * heads, torch.float32, seed=t + heads)
    kernel = np.asarray(
        jfused.slab_layer_block(*[jnp.asarray(a.numpy()) for a in args], heads, SCALE, EPS, True))
    out, _ = emulate_slab_layer(*args, heads, 128)
    np.testing.assert_allclose(out.numpy(), kernel, atol=F32_ATOL, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("m, k, n", [(1, 64, 64), (127, 128, 192), (128, 192, 576), (300, 64, 320), (129, 128, 256)])
def test_gemm_walk_bias_epilogue_and_layer_norm_cast_point(m, k, n, dtype):
    """The layer-norm and QKV launches alone: the qkv slab is bf16(acc) + bf16(bias) of
    bf16(LN(x)) @ W, the plain version's cast points, at N = 64 * odd and
    rows around the 128-row tile."""
    rng = np.random.default_rng(m + n)
    x = torch.from_numpy(rng.standard_normal((m, k)) * 2 + 0.5).to(dtype)
    w = torch.from_numpy(rng.standard_normal((k, n)) * 0.05).to(dtype)
    ln_scale = torch.from_numpy(rng.uniform(0.5, 1.5, k)).float()
    ln_bias = torch.from_numpy(rng.standard_normal(k) * 0.1).float()
    bias = torch.from_numpy(rng.standard_normal(n) * 0.1).float()

    def plain_version(x, w):
        x32 = x.float()
        mu = x32.mean(dim=-1, keepdim=True)
        var = ((x32 - mu) ** 2).mean(dim=-1, keepdim=True)
        h = ((x32 - mu) * torch.rsqrt(var + EPS) * ln_scale + ln_bias).to(x.dtype)
        return torch.matmul(h, w).to(x.dtype) + bias.to(x.dtype)

    got = emulate_gemm(emulate_layer_norm_rows(x, ln_scale, ln_bias, EPS), w, bias_epilogue(bias))
    want = plain_version(x.float(), w.float())
    if dtype == torch.float32:
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=F32_ATOL, rtol=0)
    else:
        _held(got, plain_version(x, w), want, "qkv slab")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("b, t, heads", SHAPES)
def test_gemm_walk_residual_epilogue_matches_block_reference(b, t, heads, dtype):
    """The proj launch alone on a given attention output, which is K2 after
    its attention launch: bf16(acc) + bf16(b_proj), * bf16(ls1), + x, each
    rounded, against _slab_block_reference's tail."""
    d = 64 * heads
    x, _, _, _, _, w_proj, b_proj, ls1 = _inputs(b, t, d, dtype, seed=b + t)
    rng = np.random.default_rng(t)
    qkv = torch.from_numpy(rng.standard_normal((b, t, 3 * d)) * 1.5).to(dtype)
    attn, _ = emulate_forward(*split_heads(qkv, heads), SCALE, 64)
    got = emulate_gemm(attn.reshape(b * t, d), w_proj, residual_epilogue(b_proj, ls1, x.reshape(-1, d)))
    got = got.reshape(b, t, d)
    block = (x, qkv, w_proj, b_proj, ls1)
    want = _slab_block_reference(*[a.float() for a in block], heads, SCALE)
    if dtype == torch.float32:
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=F32_ATOL, rtol=0)
    else:
        _held(got, _slab_block_reference(*block, heads, SCALE), want, "K2's output")
