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

The kernels' Hopper walks are emulated too: the quantize with the row held
whole in registers (a lane's pieces l, l + 32, ... up to the instance's
count, zeros past the row); the persistent GEMM's static tile schedule
(ops/int8_matmul_kernel.py::int8_schedule, beside the kernel's constants),
its two consumers sharing each tile, the mbarrier ring they wait on, and
their 64 x 256 pieces stored 64 bytes of columns at a time; and the bf16 gelu_tanh_f16 epilogue's table, looked up as
csrc/activation.cuh does, on all 65,536 bf16 inputs.
"""

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (caps torch's threads under xdist)

from dinov2_tpu_torch.models.params import Int8Linear
from dinov2_tpu_torch.ops.int8_matmul_kernel import (
    F16_OVERFLOW,
    GELU_TABLE_HI,
    GELU_TABLE_LO,
    GELU_TABLE_SPAN,
    INT8_CONSUMERS,
    INT8_STAGES,
    INT8_TILE_COLS,
    INT8_TILE_ROWS,
    K_DEPTH,
    QUANTIZE_PIECES_PER_LANE,
    gelu_table_reference,
    int8_schedule,
    quantize_pieces_per_lane,
)
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


# ---- the Hopper walks ------------------------------------------------------

SMS = 132  # an H100's SMs: the persistent GEMM's most blocks
CONSUMER_ROWS = 64  # a consumer warpgroup's rows of output (wgmma m64n256k32)


def emulate_quantize_held(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """int8_quantize_rows_kernel<T, kPieces> on (M, K) x: lane l holds the
    pieces l + 32 p for p < kPieces, zeros past the row, all loaded before
    the lane's max; the butterfly; then the codes from the held pieces."""
    m, k = x.shape
    vec = PIECE // x.element_size()
    held_pieces = quantize_pieces_per_lane(k, x.element_size())
    assert k * x.element_size() <= held_pieces * LANES * PIECE
    pieces = x.float().reshape(m, k // vec, vec)
    held = torch.zeros((m, LANES, held_pieces, vec))
    for p in range(held_pieces):
        for lane in range(LANES):
            c = lane + LANES * p
            if c < k // vec:
                held[:, lane, p] = pieces[:, c]
    lane_max = held.abs().amax(dim=(2, 3))
    for off in (16, 8, 4, 2, 1):
        lane_max = torch.maximum(lane_max, lane_max[:, torch.arange(LANES) ^ off])
    sx = torch.clamp_min(lane_max[:, :1], INT8_SCALE_FLOOR) * INT8_SCALE_STEP
    codes = torch.zeros((m, k // vec, vec))
    for p in range(held_pieces):
        for lane in range(LANES):
            c = lane + LANES * p
            if c < k // vec:
                codes[:, c] = torch.round(held[:, lane, p] / sx)
    assert codes.abs().max() <= 127
    return codes.reshape(m, k).to(torch.int8), sx


@pytest.mark.parametrize(
    "m, k, dtype, pieces",
    [
        (5, 16, torch.bfloat16, 4),  # one piece, one lane
        (9, 768, torch.bfloat16, 4),  # fc1's input: 3 pieces a lane
        (9, 3072, torch.bfloat16, 12),  # fc2's
        (9, 4096, torch.bfloat16, 16),  # SwiGLU's wout
        (7, 6144, torch.bfloat16, 24),  # 4 * 1536
        (7, 1536, torch.float32, 12),  # the head's f32 features
        (5, 3072, torch.float32, 24),  # ViT-g's head
        (5, 4096, torch.float32, 32),  # SwiGLU's wout in f32
    ],
)
def test_quantize_held_row_walk_equals_plain(m, k, dtype, pieces):
    """The quantize with the row held whole in registers, bit for bit the
    plain quantize, at each kernel instance's piece count."""
    assert quantize_pieces_per_lane(k, torch.empty((), dtype=dtype).element_size()) == pieces
    x, _, _ = _case(m, k, 8, dtype, seed=k + m)
    got8, got_sx = emulate_quantize_held(x)
    want8, want_sx = quantize_rows_int8(x)
    assert torch.equal(got8, want8)
    assert torch.equal(got_sx.view(torch.int32), want_sx.view(torch.int32))


def test_quantize_piece_counts_cover_every_published_row():
    """Every published width's row fits an instance, bf16 and f32, and a
    row past the largest is refused, not cut."""
    widths = {384, 768, 1024, 1536} | {4 * d for d in (384, 768, 1024, 1536)} | {4096, 3072}
    for k in sorted(widths):
        for size in (2, 4):
            if k * size <= 16384:
                assert quantize_pieces_per_lane(k, size) in QUANTIZE_PIECES_PER_LANE
    with pytest.raises(NotImplementedError):
        quantize_pieces_per_lane(6144, 4)


class _CudaRows:
    """The metadata of a CUDA tensor, for the wrapper's checks that run
    before any launch (no card here)."""

    def __init__(self, shape, dtype):
        self.shape, self.dtype, self.device = torch.Size(shape), dtype, torch.device("cuda")
        self.requires_grad = False

    def is_contiguous(self):
        return True

    def data_ptr(self):
        return 0


@pytest.mark.parametrize("k, dtype", [(6144, torch.float32), (16384, torch.bfloat16)])
def test_quantize_refuses_a_row_past_what_it_holds(k, dtype):
    """A CUDA row of more than 16 KB raises before any launch (nothing
    falls back to the plain version)."""
    from dinov2_tpu_torch.ops.int8_matmul_kernel import quantize_rows_int8_kernel

    with pytest.raises(NotImplementedError, match="at most 16384 bytes"):
        quantize_rows_int8_kernel(_CudaRows((4, k), dtype))


SCHEDULE_SHAPES = {  # name -> (M, N, K)
    "fc1": (64 * 257, 3072, 768),
    "fc2": (64 * 257, 768, 3072),
    "head": (64, 1000, 1536),
    "qkv_t1370": (8 * 1370, 2304, 768),
    "ragged_m": (257 * 3, 512, 384),
    "n33": (100, 33, 128),
    "n1000": (514, 1000, 384),
}


@pytest.mark.parametrize("sms", [SMS, 5])
@pytest.mark.parametrize("name", list(SCHEDULE_SHAPES))
def test_schedule_makes_every_tile_once(name, sms):
    """Every 64 x 256 piece of the output is made exactly once, by one
    consumer of one block; the grid is at most one block an SM; a block's
    tiles go N-fastest in their bands."""
    m, n, k = SCHEDULE_SHAPES[name]
    blocks, walk = int8_schedule(m, n, k, sms)
    tiles = -(-m // INT8_TILE_ROWS) * -(-n // INT8_TILE_COLS)
    assert blocks == min(tiles, sms) <= sms
    pieces = [(row0, col0) for _, _, _, row0, col0, _ in walk]
    want = {(r, c) for r in range(0, -(-m // INT8_TILE_ROWS) * INT8_TILE_ROWS, CONSUMER_ROWS)
            for c in range(0, n, INT8_TILE_COLS)}
    assert len(pieces) == len(set(pieces)) == len(want)
    assert set(pieces) == want
    for block, consumer, tile, row0, col0, _ in walk:
        assert tile % blocks == block and consumer in range(INT8_CONSUMERS)
        assert col0 == tile % -(-n // INT8_TILE_COLS) * INT8_TILE_COLS


@pytest.mark.parametrize("name", list(SCHEDULE_SHAPES))
def test_consumers_share_each_tile(name):
    """Both consumers make every tile of their block, each its own 64 rows,
    at the same ring positions; a block's i-th tile starts at ring position
    i * steps, after the block's earlier tiles."""
    m, n, k = SCHEDULE_SHAPES[name]
    steps = k // K_DEPTH
    _, walk = int8_schedule(m, n, k, 7)
    for block in range(7):
        mine = [w for w in walk if w[0] == block]
        for i in range(0, len(mine), 2):
            a, b = mine[i], mine[i + 1]
            assert (a[1], b[1]) == (0, 1) and a[2] == b[2] and a[5] == b[5] == i // 2 * steps
            assert b[3] == a[3] + CONSUMER_ROWS


class Barrier:
    """An mbarrier as the kernel uses it: `count` arrivals complete a phase;
    a wait with parity p passes once the phase of that parity has completed,
    i.e. while the completed phases' parity differs from p (so a wait can
    pass on a phase two behind the one meant)."""

    def __init__(self, count: int):
        self.count, self.pending, self.completed = count, 0, 0

    def arrive(self, n: int = 1) -> None:
        self.pending += n
        assert self.pending <= self.count
        if self.pending == self.count:
            self.pending, self.completed = 0, self.completed + 1

    def passes(self, parity: int) -> bool:
        return (self.completed & 1) != parity


def simulate_ring(walk, steps: int, stages: int) -> int:
    """One block's producer and consumers on the kernel's barriers, stepped
    in turns (consumers first, so they run as far ahead as the waits let
    them) until nothing moves. Full barriers complete when the producer
    fills a stage (one arrival; the bytes land at once); empty barriers take
    kEmptyArrivals, a warp of each consumer. A consumer gives a stage back
    after its next step's products are issued, and its last at its tile's
    end. Asserts that every passed wait finds the stage holding the position
    meant; returns the positions filled."""
    full = [Barrier(1) for _ in range(stages)]
    empty = [Barrier(4 * INT8_CONSUMERS) for _ in range(stages)]
    total = max((w[5] + steps for w in walk), default=0)
    ring = [None] * stages  # the position a stage holds
    firsts = {c: [w[5] for w in walk if w[1] == c] for c in range(INT8_CONSUMERS)}
    state = {c: [0, 0, None] for c in firsts}  # tile index, next step, stage to give back
    filled = 0
    moved = True
    while moved:
        moved = False
        for c, mine in firsts.items():
            t, j, held = state[c]
            if t == len(mine):
                continue
            pos = mine[t] + j
            stage = pos % stages
            if not full[stage].passes((pos // stages) & 1):
                continue
            assert ring[stage] == pos, f"consumer {c} read stage {stage} for {pos}: {ring[stage]}"
            if held is not None:
                empty[held].arrive(4)
            held = stage
            j += 1
            if j == steps:
                empty[held].arrive(4)
                t, j, held = t + 1, 0, None
            state[c] = [t, j, held]
            moved = True
        if filled < total:
            stage = filled % stages
            if empty[stage].passes(((filled // stages) & 1) ^ 1):
                ring[stage] = filled
                full[stage].arrive()
                filled += 1
                moved = True
    assert all(state[c][0] == len(firsts[c]) for c in firsts), "a consumer waits forever"
    return filled


@pytest.mark.parametrize("sms", [SMS, 5])
@pytest.mark.parametrize("name", ["fc1", "fc2", "head", "n33"])
def test_ring_runs_every_block_to_its_end(name, sms):
    """The producer and the consumers of each block run through the ring
    on parity waits without a deadlock and without reading a stage early,
    and every position is filled once."""
    m, n, k = SCHEDULE_SHAPES[name]
    steps = k // K_DEPTH
    blocks, walk = int8_schedule(m, n, k, sms)
    for block in range(min(blocks, 4)):
        mine = [w for w in walk if w[0] == block]
        tiles = len({w[2] for w in mine})
        assert simulate_ring(mine, steps, INT8_STAGES) == tiles * steps


def test_parity_wait_cannot_tell_phases_two_apart():
    """Why the consumers wait on the ring in order: a wait for a stage's
    next fill passes at once while the fill before it has not landed (its
    phase two back has the same parity), so a consumer that skipped ahead,
    as a ping-pong build's second consumer would, reads the stage early."""
    full = Barrier(1)
    assert full.passes(1)  # round 1's wait, before round 0 has landed
    assert not full.passes(0)
    full.arrive()  # round 0 lands
    assert full.passes(0) and not full.passes(1)


def emulate_persistent_gemm(x8, sx, il, bias, activation, dtype, sms, table=None):
    """int8_gemm_kernel's persistent walk: each consumer piece of the
    schedule summed over 128-deep k-steps of four k32 products (rows past
    M and N zero, as TMA fills them), the epilogue, then stored 64 bytes of
    columns at a time, rows past M and columns past N dropped. With `table`
    the bf16 gelu_tanh_f16 is looked up in it per element, as the kernel
    does; else the activation runs on the whole output at the end."""
    (m, k), n = x8.shape, il.codes.shape[0]
    out = torch.full((m, n), float("nan"), dtype=dtype)
    written = torch.zeros((m, n), dtype=torch.int32)
    chunk = 64 // out.element_size()
    vec = PIECE // out.element_size()
    _, walk = int8_schedule(m, n, k, sms)
    for _, _, _, row0, col0, _ in walk:
        a = torch.zeros((CONSUMER_ROWS, k), dtype=torch.int64)
        rows = max(0, min(CONSUMER_ROWS, m - row0))
        a[:rows] = x8[row0 : row0 + rows].long()
        w = torch.zeros((INT8_TILE_COLS, k), dtype=torch.int64)
        cols = min(INT8_TILE_COLS, n - col0)
        w[:cols] = il.codes[col0 : col0 + cols].long()
        acc = torch.zeros((CONSUMER_ROWS, INT8_TILE_COLS), dtype=torch.int64)
        for k0 in range(0, k, K_DEPTH):
            for kc in range(k0, k0 + K_DEPTH, K32):
                acc += a[:, kc : kc + K32] @ w[:, kc : kc + K32].T
        col_idx = torch.arange(col0, col0 + INT8_TILE_COLS)
        inside, clamped = col_idx < n, col_idx.clamp(max=n - 1)
        s = torch.where(inside, il.s[clamped], 0.0)
        # the stash: without a bias the kernel adds -0, which leaves y as it is
        b = torch.full((INT8_TILE_COLS,), -0.0) if bias is None else torch.where(
            inside, bias[clamped], 0.0)
        row_sx = torch.zeros((CONSUMER_ROWS, 1))
        row_sx[:rows] = sx[row0 : row0 + rows]
        tile = emulate_epilogue(acc.to(torch.int32), row_sx, s, b, dtype)
        if table is not None:
            tile = lookup_gelu(tile, table)
        for c0 in range(0, INT8_TILE_COLS, chunk):  # a strip of 64 bytes a row
            if col0 + c0 >= n:
                continue
            for c in range(c0, c0 + chunk, vec):
                g = col0 + c
                if g >= n:
                    continue
                width = vec if n % vec == 0 else min(vec, n - g)
                out[row0 : row0 + rows, g : g + width] = tile[:rows, c : c + width]
                written[row0 : row0 + rows, g : g + width] += 1
    assert (written == 1).all()
    return out if table is not None else apply_activation(out, activation)


@pytest.mark.parametrize("sms", [3, SMS])
@pytest.mark.parametrize(
    "m, k, n, dtype, activation",
    [
        (257, 384, 1000, torch.float32, None),  # the head: N = 1000, f32 strips of 16 columns
        (514, 256, 512, torch.bfloat16, "gelu_tanh_f16"),
        (257, 640, 384, torch.bfloat16, None),
        (100, 128, 33, torch.bfloat16, None),  # rows stored value by value
        (100, 384, 33, torch.float32, "gelu_tanh"),
        (1, 128, 40, torch.float32, None),
    ],
)
def test_persistent_walk_equals_plain(m, k, n, dtype, activation, sms):
    """The persistent walk on a card of 3 SMs (many tiles a block) and on
    an H100's 132, bit for bit the plain version."""
    x, il, bias = _case(m, k, n, dtype, seed=k + n + 1)
    x8, sx = emulate_quantize_held(x)
    for b in (bias, None):
        got = emulate_persistent_gemm(x8, sx, il, b, activation, dtype, sms)
        want = int8_matmul_reference(x, il, b, activation)
        view = torch.int16 if dtype == torch.bfloat16 else torch.int32
        assert not got.isnan().any()
        assert torch.equal(got.view(view), want.view(view))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_adding_negative_zero_leaves_every_value(dtype):
    """The epilogue adds -0 where there is no bias, with no branch: y + -0
    is y bit for bit for every bf16 (all 65,536) and for f32 signed zeros,
    subnormals, extremes, inf and a spread of normals (+0 would turn -0
    into +0)."""
    if dtype == torch.bfloat16:
        y = torch.arange(65536, dtype=torch.int32).to(torch.int16).view(torch.bfloat16)
    else:
        special = torch.tensor([0.0, -0.0, 1e-45, -1e-45, 3.4e38, -3.4e38, float("inf"),
                                -float("inf")])
        y = torch.cat([special, torch.from_numpy(
            np.random.default_rng(0).standard_normal(4096).astype(np.float32) * 100)])
    got = (y.float() + torch.tensor(-0.0)).to(dtype)
    nan = y.isnan()
    view = torch.int16 if dtype == torch.bfloat16 else torch.int32
    assert torch.equal(got.isnan(), nan)
    assert torch.equal(got.view(view)[~nan], y.view(view)[~nan])


def lookup_gelu(y: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """csrc/activation.cuh::gelu_tanh_f16_lookup on bf16 y: the entry at the
    clamped index, y's signed zero below the table, above it f16(y) for
    y > 0 (y itself, inf from 65536 on, NaN kept) and -0 (NaN once f16(y)
    is -inf) for y < 0, all by integer selects."""
    assert y.dtype == torch.bfloat16
    bits = y.view(torch.int16).to(torch.int32) & 0xFFFF
    sign, mag = bits & 0x8000, bits & 0x7FFF
    at = mag.clamp(GELU_TABLE_LO, GELU_TABLE_HI - 1) - GELU_TABLE_LO
    at = at + torch.where(sign != 0, GELU_TABLE_SPAN, 0)
    entry = table.to(torch.int32)[at] & 0xFFFF
    nan, inf = 0x7FC0, 0x7F80
    above = torch.where(sign != 0, torch.where(mag >= F16_OVERFLOW, nan, 0x8000),
                        torch.where(mag > inf, nan, torch.where(mag >= F16_OVERFLOW, inf, bits)))
    out = torch.where(mag < GELU_TABLE_LO, sign,
                      torch.where(mag < GELU_TABLE_HI, entry, above))
    return out.to(torch.int16).view(torch.bfloat16)


def test_table_gelu_equals_plain_on_every_bf16():
    """The table built with the plain formula on the CPU, looked up as the
    kernel does, is apply_activation(., "gelu_tanh_f16") bit for bit on all
    65,536 bf16 inputs: both signed zeros, subnormals, the table's edges,
    the closed forms above it, +-inf and the NaNs (NaN exactly where the
    plain version gives NaN)."""
    y = torch.arange(65536, dtype=torch.int32).to(torch.int16).view(torch.bfloat16)
    want = apply_activation(y, "gelu_tanh_f16")
    got = lookup_gelu(y, gelu_table_reference())
    nan = want.isnan()
    assert torch.equal(got.isnan(), nan)
    assert torch.equal(torch.where(nan, 0, got.view(torch.int16)),
                       torch.where(nan, 0, want.view(torch.int16)))
    # the closed forms are needed: the table holds 7168 of the 65536 inputs
    assert 2 * GELU_TABLE_SPAN == gelu_table_reference().numel() < 65536 // 8
    assert torch.equal(got[0], torch.zeros((), dtype=torch.bfloat16))
    assert got[0x8000].view(torch.int16).item() == -0x8000  # gelu(-0) = -0


def test_table_edges_hold_the_closed_forms():
    """Just past the table the formula already is its closed form (so the
    table cannot be cut shorter without a check failing): y itself from 8
    up, -0 from -8 down, +-0 below 2^-25."""
    edges = torch.tensor([GELU_TABLE_HI, 0x8000 | GELU_TABLE_HI, GELU_TABLE_LO - 1,
                          0x8000 | (GELU_TABLE_LO - 1)], dtype=torch.int32)
    y = edges.to(torch.int16).view(torch.bfloat16)
    g = apply_activation(y, "gelu_tanh_f16")
    assert g[0] == y[0] and g[1].view(torch.int16) == -0x8000
    assert g[2].view(torch.int16) == 0 and g[3].view(torch.int16) == -0x8000


@pytest.mark.parametrize("sms", [3, SMS])
def test_persistent_walk_with_table_gelu_equals_plain(sms):
    """fc1's epilogue with the table lookup per element (bf16 out, the bias
    added first), bit for bit the plain version; M * N a multiple of 64, so
    PyTorch's CPU GELU meets every element on its vector path."""
    x, il, bias = _case(514, 256, 256, torch.bfloat16, seed=11)
    x8, sx = emulate_quantize_held(x)
    table = gelu_table_reference()
    for b in (bias, None):
        got = emulate_persistent_gemm(x8, sx, il, b, "gelu_tanh_f16", torch.bfloat16, sms,
                                      table)
        want = int8_matmul_reference(x, il, b, "gelu_tanh_f16")
        assert torch.equal(got.view(torch.int16), want.view(torch.int16))
