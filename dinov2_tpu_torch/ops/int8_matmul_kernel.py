"""The W8A8 int8 matmul, K9 (port of dinov2_tpu/ops/qmatmul.py::int8_matmul).

    int8_matmul_kernel(x, il, bias, activation)
        = act(f32(q(x) @ il.codes^T) * sx * il.s + bias)

for x (..., K) bf16 or f32 and an (N, K) Int8Linear `il` (models/params.py),
in x's dtype. The JAX function is no Pallas kernel: it leaves its
s8 x s8 -> s32 dot_general to XLA. On a CUDA tensor it is two launches of
the hand-written kernels in csrc/int8_matmul.cu:
  - `quantize_rows_int8_kernel`: x -> (x8 (..., K) int8, sx (..., 1) f32),
    the row's absmax in f32, sx = max(absmax, 1e-12) * f32(1/127), codes
    rounded half to even (ops/qmatmul.py::quantize_rows_int8);
  - `int8_gemm_kernel`: the s8 x s8 -> s32 product on wgmma with the
    rescale, the bias and the activation in its epilogue
    (ops/qmatmul.py::int8_epilogue).
Each adds one to its own `launches` where it launches. On a CPU tensor each
runs its plain version (ops/qmatmul.py), bit for bit what the kernels give.
A CUDA tensor the kernels do not take raises; nothing falls back.

The GEMM is persistent and warp-specialised (csrc/int8_matmul.cu): a
producer warp keeps TMA loads in an mbarrier ring, two consumer warpgroups
run wgmma m64n256k32 and the epilogue on a shared 128 x 256 tile.
`int8_schedule` mirrors its static tile walk for the CPU tests, next to the
constants it shares with the kernel; `gelu_table_reference` and the
GELU_TABLE_* constants mirror the table its bf16 gelu_tanh_f16 epilogue
reads, which `int8_gelu_table` makes once a device on the card.
"""

from __future__ import annotations

import torch

from dinov2_tpu_torch.ops.qmatmul import (
    apply_activation,
    int8_epilogue,
    int8_matmul_reference,
    int8_product,
    quantize_rows_int8,
    refuse_quant_grad,
)
from dinov2_tpu_torch.ops.qmatmul_kernel import ACTIVATIONS

K_DEPTH = 128  # the GEMM's k-step: one 128-byte swizzle row of codes
QUANTIZE_PIECE = 16  # the quantize reads 16-byte pieces of a row
# the quantize holds a row in registers: up to this many 16-byte pieces a
# lane (the kernel's template instances), so a row of at most 16 KB
QUANTIZE_PIECES_PER_LANE = (4, 12, 16, 24, 32)
QUANTIZE_ROW_BYTES = 32 * QUANTIZE_PIECE * QUANTIZE_PIECES_PER_LANE[-1]
# the persistent GEMM (csrc/int8_matmul.cu): two consumer warpgroups share
# each 128 x 256 output tile, 64 rows each
INT8_CONSUMERS = 2
INT8_TILE_ROWS = 64 * INT8_CONSUMERS
INT8_TILE_COLS = 256
INT8_STAGES = 4
# gelu_tanh_f16 by table for bf16 y (csrc/activation.cuh): entries for the
# bf16 magnitudes [LO, HI), positive then negative; below LO the result is
# y's signed zero, from HI on a closed form
GELU_TABLE_LO = 0x3300  # 2^-25
GELU_TABLE_HI = 0x4100  # 8.0
GELU_TABLE_SPAN = GELU_TABLE_HI - GELU_TABLE_LO
GELU_TABLE_ENTRIES = 2 * GELU_TABLE_SPAN
F16_OVERFLOW = 0x4780  # bf16 65536 and up: f16(y) is inf, the negative side's result NaN


def quantize_pieces_per_lane(k: int, element_size: int) -> int:
    """The 16-byte pieces a lane of the quantize holds for a row of K
    elements of `element_size` bytes: the kernel instance the entry picks
    (the smallest of QUANTIZE_PIECES_PER_LANE that holds the row)."""
    need = -(-k * element_size // (32 * QUANTIZE_PIECE))
    for pieces in QUANTIZE_PIECES_PER_LANE:
        if need <= pieces:
            return pieces
    raise NotImplementedError(f"a row of {k * element_size} bytes is more than the quantize holds")


def int8_schedule(m: int, n: int, k: int, blocks_max: int):
    """The persistent GEMM's static walk, as int8_gemm_kernel runs it, for
    (M, K) x8 and (N, K) codes on a card of `blocks_max` SMs: blocks =
    min(tiles, blocks_max); block b takes tiles b, b + blocks, ... (N
    fastest within a band of rows), each `k // K_DEPTH` ring positions in
    that order, and both its consumers make every one of its tiles,
    consumer c the rows 64c..64c+63. Returns (blocks, [(block, consumer,
    tile, row0, col0, first ring position)]), one entry for each 64 x 256
    piece of output a consumer makes."""
    tiles_n = -(-n // INT8_TILE_COLS)
    tiles = -(-m // INT8_TILE_ROWS) * tiles_n
    blocks = min(tiles, blocks_max)
    steps = k // K_DEPTH
    walk = []
    for block in range(blocks):
        for i, tile in enumerate(range(block, tiles, blocks)):
            row0, col0 = tile // tiles_n * INT8_TILE_ROWS, tile % tiles_n * INT8_TILE_COLS
            walk += [(block, c, tile, row0 + 64 * c, col0, i * steps)
                     for c in range(INT8_CONSUMERS)]
    return blocks, walk


def gelu_table_reference() -> torch.Tensor:
    """The table of the bf16 gelu_tanh_f16 epilogue, made on the CPU with
    the plain formula: entry i is the bf16 bits (int16) of
    gelu_tanh_f16(y) for the bf16 y of bits (0x8000 if i >= SPAN) | (LO +
    i % SPAN), as csrc/activation.cuh::gelu_tanh_f16_entry makes it."""
    i = torch.arange(GELU_TABLE_ENTRIES, dtype=torch.int32)
    bits = torch.where(i >= GELU_TABLE_SPAN, 0x8000, 0) | (GELU_TABLE_LO + i % GELU_TABLE_SPAN)
    y = bits.to(torch.int16).view(torch.bfloat16)
    return apply_activation(y, "gelu_tanh_f16").view(torch.int16)


def _check_input(x: torch.Tensor, name: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no K9 kernel for device {x.device}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _check_quantize_input(x: torch.Tensor) -> int:
    """What the quantize takes of a checked x (_check_input): (..., K) bf16
    or f32, K % 16 == 0, a row of at most 16 KB; returns K."""
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise NotImplementedError(f"the CUDA int8 quantize takes bf16 or f32 x, got {x.dtype}")
    k = x.shape[-1]
    if k % QUANTIZE_PIECE:
        raise NotImplementedError(
            f"the CUDA int8 quantize needs K % {QUANTIZE_PIECE} == 0, got {k}")
    if k * x.dtype.itemsize > QUANTIZE_ROW_BYTES:
        raise NotImplementedError(
            f"the CUDA int8 quantize holds a row of at most {QUANTIZE_ROW_BYTES} bytes in "
            f"registers, got K={k} {x.dtype}")
    return k


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _launch_quantize(x, x8, sx, m: int, k: int) -> None:
    """K9's quantize launch on checked operands, inside torch.cuda.device."""
    from dinov2_tpu_torch.ops._kernels import check_status, int8_matmul_lib

    lib = int8_matmul_lib()
    code = lib.dinov2_int8_quantize_rows(
        x.data_ptr(), int(x.dtype == torch.float32), x8.data_ptr(), sx.data_ptr(), m, k,
        _stream(x.device))
    check_status(lib, code, "quantize_rows_int8_kernel")
    quantize_rows_int8_kernel.launches += 1


def quantize_rows_int8_kernel(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(x8, sx) = quantize_rows_int8(x) for x (..., K) bf16 or f32: codes
    (..., K) int8 and row scales (..., 1) f32. A CPU tensor runs the plain
    version; a CUDA tensor launches K9's quantize kernel and adds one to
    `quantize_rows_int8_kernel.launches` (K % 16 == 0, a row of at most
    16 KB)."""
    if x.device.type == "cpu":
        return quantize_rows_int8(x)
    _check_input(x, "x")
    k = _check_quantize_input(x)
    x8 = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    sx = torch.empty((*x.shape[:-1], 1), dtype=torch.float32, device=x.device)
    m = x.numel() // k if k else 0
    if m:
        with torch.cuda.device(x.device):  # the launch goes to the current device
            _launch_quantize(x, x8, sx, m, k)
    return x8, sx


quantize_rows_int8_kernel.launches = 0  # kernel launches on CUDA tensors


def check_int8_weight(il, device: torch.device, k: int) -> int:
    """What the GEMM takes of an Int8Linear: codes (N, K) int8 and s (N,)
    f32, contiguous and 16-byte aligned on `device`, K % 128 == 0; returns
    N."""
    codes, s = il.codes, il.s
    if codes.dim() != 2 or codes.shape[1] != k or codes.dtype != torch.int8:
        raise ValueError(f"weight codes: expected (N, {k}) int8, got "
                         f"{tuple(codes.shape)} {codes.dtype}")
    n = codes.shape[0]
    if tuple(s.shape) != (n,) or s.dtype != torch.float32:
        raise ValueError(f"weight s: expected ({n},) f32, got {tuple(s.shape)} {s.dtype}")
    if k % K_DEPTH:
        raise NotImplementedError(
            f"the CUDA int8 GEMM needs K % {K_DEPTH} == 0 (a k-step is one 128-byte row "
            f"of codes), got K={k}"
        )
    for name, t in (("codes", codes), ("s", s)):
        if t.device != device:
            raise ValueError(f"weight {name} is on {t.device}, the input on {device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"weight {name} must be contiguous and 16-byte aligned")
    return n


def _check_epilogue(bias, activation, dtype, n: int, device: torch.device) -> None:
    if dtype not in (torch.bfloat16, torch.float32):
        raise NotImplementedError(f"the CUDA int8 GEMM writes bf16 or f32, got {dtype}")
    if activation not in ACTIVATIONS:
        raise ValueError(f"unknown activation {activation!r}")
    if bias is not None and (
        tuple(bias.shape) != (n,) or bias.dtype != torch.float32 or bias.device != device
        or not bias.is_contiguous()
    ):
        raise ValueError(f"bias: expected ({n},) f32 on {device}, got "
                         f"{tuple(bias.shape)} {bias.dtype} on {bias.device}")


_GELU_TABLES: dict[int, torch.Tensor] = {}  # device index -> the GEMM's gelu_tanh_f16 table


def int8_gelu_table(device: torch.device) -> torch.Tensor:
    """The table the GEMM's bf16 gelu_tanh_f16 epilogue reads, on a CUDA
    `device`: (GELU_TABLE_ENTRIES,) int16 bf16 bits, made there once by
    csrc/int8_matmul.cu's one-off kernel with the epilogue's own formula,
    and kept for the process."""
    device = torch.device(device)
    index = torch.cuda.current_device() if device.index is None else device.index
    table = _GELU_TABLES.get(index)
    if table is None:
        from dinov2_tpu_torch.ops._kernels import (
            check_status,
            int8_gelu_table_entry,
            int8_matmul_lib,
        )

        table = torch.empty(GELU_TABLE_ENTRIES, dtype=torch.int16, device=f"cuda:{index}")
        with torch.cuda.device(index):
            code = int8_gelu_table_entry()(table.data_ptr(), _stream(table.device))
            check_status(int8_matmul_lib(), code, "int8_gelu_table")
            torch.cuda.current_stream(table.device).synchronize()  # every stream may read it
        _GELU_TABLES[index] = table
    return table


def _launch_gemm(x8, sx, il, bias, activation, out, m: int, n: int, k: int) -> None:
    """K9's GEMM launch on checked operands, inside torch.cuda.device."""
    from dinov2_tpu_torch.ops._kernels import check_status, int8_matmul_lib

    table = int8_gelu_table(x8.device) if activation == "gelu_tanh_f16" else None
    lib = int8_matmul_lib()
    code = lib.dinov2_int8_gemm(
        x8.data_ptr(), sx.data_ptr(), il.codes.data_ptr(), il.s.data_ptr(),
        None if bias is None else bias.data_ptr(), ACTIVATIONS[activation],
        out.data_ptr(), int(out.dtype == torch.float32), m, n, k, _stream(x8.device),
        None if table is None else table.data_ptr(),
    )
    check_status(lib, code, "int8_gemm_kernel")
    int8_gemm_kernel.launches += 1


def int8_gemm_kernel(
    x8: torch.Tensor, sx: torch.Tensor, il, bias: torch.Tensor | None = None,
    activation: str | None = None, dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """act(f32(x8 @ il.codes^T) * sx * il.s + bias) in `dtype` (bf16 or
    f32): x8 (..., K) int8 and sx (..., 1) f32 from the quantize, bias (N,)
    f32 or None -> (..., N). A CPU tensor runs the plain version (an exact
    s32 product, then int8_epilogue); a CUDA tensor launches K9's GEMM and
    adds one to `int8_gemm_kernel.launches`."""
    if x8.device.type == "cpu":
        return int8_epilogue(int8_product(x8, il.codes), sx, il.s, dtype, bias, activation)
    _check_input(x8, "x8")
    if x8.dtype != torch.int8:
        raise ValueError(f"x8 must be int8, got {x8.dtype}")
    k = x8.shape[-1]
    n = check_int8_weight(il, x8.device, k)
    _check_epilogue(bias, activation, dtype, n, x8.device)
    lead = x8.shape[:-1]
    if tuple(sx.shape) != (*lead, 1) or sx.dtype != torch.float32 or sx.device != x8.device \
            or not sx.is_contiguous():
        raise ValueError(f"sx: expected {(*lead, 1)} f32 on {x8.device}, got "
                         f"{tuple(sx.shape)} {sx.dtype} on {sx.device}")
    out = torch.empty((*lead, n), dtype=dtype, device=x8.device)
    m = x8.numel() // k
    if m and n:
        with torch.cuda.device(x8.device):  # the launch goes to the current device
            _launch_gemm(x8, sx, il, bias, activation, out, m, n, k)
    return out


int8_gemm_kernel.launches = 0  # kernel launches on CUDA tensors


def int8_matmul_kernel(
    x: torch.Tensor, il, bias: torch.Tensor | None = None, activation: str | None = None
) -> torch.Tensor:
    """act(x @ W^T + bias) for x (..., K) bf16 or f32 and an (N, K)
    Int8Linear W, in x's dtype: on a card K9's two launches (every operand
    checked once, before the first), on the CPU the plain version. An input
    that requires grad raises: int8 weights are not trainable and K9 has no
    backward."""
    refuse_quant_grad("int8_matmul_kernel", x, bias)
    if x.device.type == "cpu":
        return int8_matmul_reference(x, il, bias, activation)
    _check_input(x, "x")
    n = check_int8_weight(il, x.device, x.shape[-1])
    k = _check_quantize_input(x)
    _check_epilogue(bias, activation, x.dtype, n, x.device)
    x8 = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    sx = torch.empty((*x.shape[:-1], 1), dtype=torch.float32, device=x.device)
    out = torch.empty((*x.shape[:-1], n), dtype=x.dtype, device=x.device)
    m = x.numel() // k
    if m and n:
        with torch.cuda.device(x.device):  # the launches go to the current device
            _launch_quantize(x, x8, sx, m, k)
            _launch_gemm(x8, sx, il, bias, activation, out, m, n, k)
    return out


def int8_gemm_variant() -> dict:
    """The GEMM's build as the loaded library reports it (its C constants):
    consumers sharing a tile, tile rows and columns, ring stages, dynamic
    shared bytes, registers a thread of the producer and of the consumers
    after setmaxnreg. Needs nvcc; no card."""
    import ctypes

    from dinov2_tpu_torch.ops._kernels import int8_probe_entries

    values = (ctypes.c_int * 7)()
    int8_probe_entries()["variant"](values)
    consumers, rows, cols, stages, shared, producer, consumer = list(values)
    return {"variant": f"cooperative, {consumers} consumers a tile", "tile": (rows, cols),
            "stages": stages, "shared_bytes": shared, "producer_registers": producer,
            "consumer_registers": consumer}


def x8_tensor_map_us(x8: torch.Tensor, reps: int = 1000) -> float:
    """Host microseconds to encode the tensor map of x8 (M, K) int8 on the
    card as each GEMM call does, averaged over `reps` encodes."""
    from dinov2_tpu_torch.ops._kernels import int8_probe_entries

    k = x8.shape[-1]
    us = int8_probe_entries()["tensor_map_us"](x8.data_ptr(), x8.numel() // k, k, reps)
    if us < 0:
        raise RuntimeError("cuTensorMapEncodeTiled refused x8's map")
    return us


def int8_gelu_lookup_kernel(y: torch.Tensor) -> torch.Tensor:
    """gelu_tanh_f16(y) for bf16 y on a card through the GEMM epilogue's
    table lookup alone (csrc/activation.cuh::gelu_tanh_f16_lookup): what
    chip_smoke.py holds against the plain gelu_tanh_f16 on every bf16 bit
    pattern. Not on any path of the port."""
    from dinov2_tpu_torch.ops._kernels import check_status, int8_matmul_lib, int8_probe_entries

    _check_input(y, "y")
    if y.dtype != torch.bfloat16:
        raise ValueError(f"y must be bf16, got {y.dtype}")
    out = torch.empty_like(y)
    if y.numel():
        with torch.cuda.device(y.device):
            table = int8_gelu_table(y.device)
            code = int8_probe_entries()["lookup"](
                y.data_ptr(), out.data_ptr(), y.numel(), table.data_ptr(), _stream(y.device))
        check_status(int8_matmul_lib(), code, "int8_gelu_lookup_kernel")
    return out
