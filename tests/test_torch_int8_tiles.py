"""The tile algebra of K9, the int8 matmul, on the CPU.

csrc/int8_matmul.cu cannot run here. This file emulates its two launches in
plain PyTorch, step for step, and holds them bit for bit against the plain
version `int8_matmul_reference` (which tests/test_torch_int8.py holds
against the JAX package's int8_matmul):
  - the quantize: a warp a row, each lane's 16-byte pieces (8 bf16 or 4
    f32 values, lane j taking pieces j, j + 32, ...), its own absmax, a
    butterfly max over the warp, then each piece divided and rounded;
  - the GEMM: 128-row output tiles with the rows past M zero-filled and
    never written, 256-column tiles of the (N, K) codes with the rows past
    N zero-filled, 128-deep k-steps of four k32 products each, summed in
    order into s32 accumulators, the epilogue's rescale in the kernel's
    order, and the 16-byte stores, whole where N allows and value by value
    where it does not.
So a wrong mask, a wrong k-step or a wrong rounding point shows here before
any time on a card is spent. Shapes: M ragged at 257 * b, N = 1000 (the
head), N = 33 (unaligned rows), K = 128 * odd.
"""

import numpy as np
import pytest
import torch

from dinov2_tpu_torch.models.params import Int8Linear
from dinov2_tpu_torch.ops.qmatmul import (
    INT8_SCALE_FLOOR,
    INT8_SCALE_STEP,
    apply_activation,
    int8_matmul_reference,
    quantize_rows_int8,
)

ROWS, COLS, DEPTH, K32 = 128, 256, 128, 32  # a block's tile, a k-step, a wgmma's k
LANES, PIECE = 32, 16  # a warp, the bytes a lane loads or stores at once


def emulate_quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """int8_quantize_rows_kernel on (M, K) x."""
    m, k = x.shape
    vec = PIECE // x.element_size()
    pieces = x.float().reshape(m, k // vec, vec)
    lane_max = torch.zeros((m, LANES))
    for p in range(k // vec):  # lane p % 32 takes piece p
        lane_max[:, p % LANES] = torch.maximum(lane_max[:, p % LANES],
                                               pieces[:, p].abs().amax(dim=1))
    for off in (16, 8, 4, 2, 1):  # the butterfly
        lane_max = torch.maximum(lane_max, lane_max[:, torch.arange(LANES) ^ off])
    assert (lane_max == lane_max[:, :1]).all()  # every lane holds the row's max
    sx = torch.clamp_min(lane_max[:, :1], INT8_SCALE_FLOOR) * INT8_SCALE_STEP
    codes = torch.round(pieces / sx[:, :, None]).reshape(m, k)
    assert codes.abs().max() <= 127
    return codes.to(torch.int8), sx


def emulate_epilogue(acc, sx, s, bias, dtype):
    """Int8RescaleEpilogue<act, Out>::value on one tile's s32 sums, up to
    the activation."""
    y = (acc.float() * sx) * s  # two rounded f32 multiplies, in that order
    y = y.to(dtype)
    if bias is not None:
        y = y + bias.to(dtype)  # f32 add of two values of the output type, rounded once
    return y


def emulate_gemm(x8, sx, il, bias, activation, dtype):
    """int8_gemm_kernel's walk over (M, K) x8 and the (N, K) codes."""
    (m, k), n = x8.shape, il.codes.shape[0]
    assert k % DEPTH == 0
    out = torch.full((m, n), float("nan"), dtype=dtype)
    vec = PIECE // out.element_size()
    for row0 in range(0, m, ROWS):
        a = torch.zeros((ROWS, k), dtype=torch.int64)
        rows = min(ROWS, m - row0)
        a[:rows] = x8[row0 : row0 + rows].long()  # rows past M: zeros
        for col0 in range(0, n, COLS):
            w = torch.zeros((COLS, k), dtype=torch.int64)
            cols = min(COLS, n - col0)
            w[:cols] = il.codes[col0 : col0 + cols].long()  # rows past N: zeros
            acc = torch.zeros((ROWS, COLS), dtype=torch.int64)
            for k0 in range(0, k, DEPTH):
                for kc in range(k0, k0 + DEPTH, K32):  # four wgmma k32 products a step
                    acc += a[:, kc : kc + K32] @ w[:, kc : kc + K32].T
            assert acc.abs().max() < 2**31  # the s32 accumulators hold the sums
            col_idx = torch.arange(col0, col0 + COLS)
            inside, clamped = col_idx < n, col_idx.clamp(max=n - 1)  # columns past N: 0
            s = torch.where(inside, il.s[clamped], 0.0)
            b = None if bias is None else torch.where(inside, bias[clamped], 0.0)
            row_sx = torch.zeros((ROWS, 1))
            row_sx[:rows] = sx[row0 : row0 + rows]
            tile = emulate_epilogue(acc.to(torch.int32), row_sx, s, b, dtype)
            # the stores: 16-byte pieces, whole where N % vec == 0, else by value
            for c in range(0, COLS, vec):
                c_glob = col0 + c
                if c_glob >= n:
                    continue
                width = vec if n % vec == 0 else min(vec, n - c_glob)
                out[row0 : row0 + rows, c_glob : c_glob + width] = tile[:rows, c : c + width]
    # the activation, elementwise, last: on the whole output, so that PyTorch's
    # CPU vector and scalar paths (a last-bit apart in tanh) meet the same
    # elements as in the plain version
    return apply_activation(out, activation)


def _case(m, k, n, dtype, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32) * 2).to(dtype)
    x[min(3, m - 1)] = 0  # a zero row: the absmax floor
    w = rng.standard_normal((n, k)).astype(np.float32) * 0.05
    s = np.maximum(np.abs(w).max(axis=1) / 127.0, 1e-12)
    codes = np.clip(np.rint(w / s[:, None]), -127, 127).astype(np.int8)
    il = Int8Linear(codes=torch.from_numpy(codes), s=torch.from_numpy(s.astype(np.float32)),
                    shape=(n, k))
    bias = torch.from_numpy(rng.standard_normal(n).astype(np.float32) * 0.1)
    return x, il, bias


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m", [257, 514])
def test_quantize_walk_equals_plain(m, dtype):
    x, _, _ = _case(m, 640, 8, dtype, seed=m)
    got8, got_sx = emulate_quantize(x)
    want8, want_sx = quantize_rows_int8(x)
    assert torch.equal(got8, want8)
    assert torch.equal(got_sx.view(torch.int32), want_sx.view(torch.int32))


@pytest.mark.parametrize(
    "m, k, n, dtype, activation",
    [
        (257, 384, 1000, torch.float32, None),  # the head: N = 1000 masked, f32
        (514, 128, 256, torch.bfloat16, "gelu_tanh_f16"),  # fc1's epilogue, ragged M
        (257, 640, 384, torch.bfloat16, None),  # fc2's: K = 128 * 5
        (514, 384, 1000, torch.bfloat16, "gelu_erf"),
        (100, 128, 33, torch.bfloat16, None),  # rows of 66 bytes: stored value by value
        (100, 384, 33, torch.float32, "gelu_tanh"),
        (1, 128, 40, torch.float32, None),  # one row
    ],
)
def test_gemm_walk_equals_plain(m, k, n, dtype, activation):
    """The emulated launches bit for bit the plain version, every element
    in range written."""
    x, il, bias = _case(m, k, n, dtype, seed=k + n)
    x8, sx = emulate_quantize(x)
    for b in (bias, None):
        got = emulate_gemm(x8, sx, il, b, activation, dtype)
        want = int8_matmul_reference(x, il, b, activation)
        assert not got.isnan().any()
        assert got.dtype == want.dtype == dtype
        assert torch.equal(got.view(torch.int16 if dtype == torch.bfloat16 else torch.int32),
                           want.view(torch.int16 if dtype == torch.bfloat16 else torch.int32))


def test_s32_accumulators_hold_every_published_width():
    """127 * 127 * K stays below 2^31 for every K the port's models give
    K9: D in {384, 768, 1024, 1536}, 4D, the head's 2D, SwiGLU's 4096."""
    widths = {384, 768, 1024, 1536} | {4 * d for d in (384, 768, 1024, 1536)} | {4096}
    widths |= {2 * d for d in (384, 768, 1024, 1536)}
    for k in sorted(widths):
        assert k % DEPTH == 0 and 127 * 127 * k < 2**31, k
