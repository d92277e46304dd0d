"""ggml block-quantization codecs (q4_0 / q4_1 / q5_0 / q5_1 / q8_0) in numpy.

Semantics match ggml's reference quantizers bit-for-bit (the C++ reference calls
`ggml_quantize_chunk` / dequant kernels from the vendored ggml submodule; see
the reference dinov2.cpp:414-427 for the quantize path and SURVEY.md §2 C17/C23):

  q4_0: d=fp16(signed_absmax/-8),           x = d*(q-8),   q in [0,15]
  q4_1: d=fp16((max-min)/15), m=fp16(min),  x = d*q + m
  q5_0: d=fp16(signed_absmax/-16), qh u32,  x = d*(q-16),  q in [0,31]
  q5_1: d=fp16((max-min)/31), m, qh u32,    x = d*q + m
  q8_0: d=fp16(absmax/127),                 x = d*q,       q int8

Block size is 32 elements; blocks run along the contiguous (last) axis.
C truncation/rounding quirks are reproduced exactly:
  q4_0/q5_0 use trunc(x*id + {8.5,16.5}) with a high clamp,
  q4_1/q5_1 use trunc((x-min)*id + 0.5),
  q8_0 uses roundf (half away from zero).

These codecs are the numpy fallback; `dinov2_tpu_torch.utils.native` exposes the same
entry points backed by the C++ codec in csrc/ when built.

The port's own copy of dinov2_tpu/quant/blocks.py (numpy only).
"""

from __future__ import annotations

import numpy as np

from dinov2_tpu_torch.io.gguf import GGMLType

QK = 32  # ggml block size for all the formats we support

_BLOCK_DTYPES: dict[GGMLType, np.dtype] = {
    GGMLType.Q4_0: np.dtype([("d", "<f2"), ("qs", "u1", (16,))]),
    GGMLType.Q4_1: np.dtype([("d", "<f2"), ("m", "<f2"), ("qs", "u1", (16,))]),
    GGMLType.Q5_0: np.dtype([("d", "<f2"), ("qh", "<u4"), ("qs", "u1", (16,))]),
    GGMLType.Q5_1: np.dtype([("d", "<f2"), ("m", "<f2"), ("qh", "<u4"), ("qs", "u1", (16,))]),
    GGMLType.Q8_0: np.dtype([("d", "<f2"), ("qs", "i1", (32,))]),
}


def block_dtype(ggml_type: GGMLType) -> np.dtype:
    return _BLOCK_DTYPES[ggml_type]


def _to_blocks(x: np.ndarray) -> np.ndarray:
    x = np.ascontiguousarray(x, dtype=np.float32)
    if x.shape[-1] % QK != 0:
        raise ValueError(f"last dim {x.shape[-1]} not a multiple of {QK}")
    return x.reshape(-1, QK)


def _signed_absmax(blocks: np.ndarray) -> np.ndarray:
    """The element with the largest magnitude, sign preserved (ggml's `max`)."""
    idx = np.argmax(np.abs(blocks), axis=1)
    return blocks[np.arange(blocks.shape[0]), idx]


def _safe_inv(d: np.ndarray) -> np.ndarray:
    with np.errstate(divide="ignore"):
        inv = np.where(d != 0.0, 1.0 / d, 0.0)
    return inv.astype(np.float32)


def _pack_nibbles(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    return ((lo & 0xF) | ((hi & 0xF) << 4)).astype(np.uint8)


def _affine_quant(blocks: np.ndarray, levels: int):
    """Shared q4_1/q5_1 affine rounding: q = trunc((x - min) / d + 0.5),
    clamped to `levels` (ggml's quantize_row_q{4,5}_1_ref semantics)."""
    mn = blocks.min(axis=1)
    mx = blocks.max(axis=1)
    d = (mx - mn) / float(levels)
    q = np.minimum(
        levels,
        np.trunc((blocks - mn[:, None]) * _safe_inv(d)[:, None] + 0.5).astype(np.int32),
    )
    return d, mn, q


def _pack_qh(q: np.ndarray) -> np.ndarray:
    """Shared q5_0/q5_1 5th-bit plane: element j's bit 4 lands at qh bit j."""
    bits = (q >> 4) & 1  # (n, 32)
    shifts = np.arange(QK, dtype=np.uint32)
    return (bits.astype(np.uint64) << shifts).sum(axis=1).astype(np.uint32)


def quantize(x: np.ndarray, ggml_type: GGMLType) -> np.ndarray:
    """Quantize a float array to raw block bytes (uint8, flat).

    Non-finite input is rejected up front: ggml's absmax loop (`fabs(x) >
    amax`) SKIPS NaN, so the native codec would compute a finite scale,
    sail through row validation, and silently write garbage codes for the
    NaN element — while the numpy path's argmax would pick the NaN and fail
    validation. Refusing keeps the two paths bit-identical and surfaces the
    corrupted checkpoint at the source."""
    x = np.ascontiguousarray(x, dtype=np.float32)
    if not np.isfinite(x).all():
        raise ValueError(
            f"non-finite values in tensor being quantized to {ggml_type.name}"
        )
    from dinov2_tpu_torch.utils import native

    if native.available():
        out = native.quantize(x, int(ggml_type))
        if out is not None:
            return out
    blocks = _to_blocks(x)
    n = blocks.shape[0]
    out = np.zeros(n, dtype=_BLOCK_DTYPES[ggml_type])

    if ggml_type == GGMLType.Q4_0:
        maxv = _signed_absmax(blocks)
        d = maxv / -8.0
        q = np.minimum(15, np.trunc(blocks * _safe_inv(d)[:, None] + 8.5).astype(np.int32))
        out["d"] = d.astype(np.float16)
        out["qs"] = _pack_nibbles(q[:, :16], q[:, 16:])
    elif ggml_type == GGMLType.Q4_1:
        d, mn, q = _affine_quant(blocks, 15)
        out["d"] = d.astype(np.float16)
        out["m"] = mn.astype(np.float16)
        out["qs"] = _pack_nibbles(q[:, :16], q[:, 16:])
    elif ggml_type == GGMLType.Q5_0:
        maxv = _signed_absmax(blocks)
        d = maxv / -16.0
        q = np.minimum(31, np.trunc(blocks * _safe_inv(d)[:, None] + 16.5).astype(np.int32))
        out["d"] = d.astype(np.float16)
        out["qs"] = _pack_nibbles(q[:, :16], q[:, 16:])
        out["qh"] = _pack_qh(q)
    elif ggml_type == GGMLType.Q5_1:
        d, mn, q = _affine_quant(blocks, 31)
        out["d"] = d.astype(np.float16)
        out["m"] = mn.astype(np.float16)
        out["qs"] = _pack_nibbles(q[:, :16], q[:, 16:])
        out["qh"] = _pack_qh(q)
    elif ggml_type == GGMLType.Q8_0:
        amax = np.abs(blocks).max(axis=1)
        d = amax / 127.0
        scaled = blocks * _safe_inv(d)[:, None]
        # roundf: half away from zero
        q = np.sign(scaled) * np.floor(np.abs(scaled) + 0.5)
        out["d"] = d.astype(np.float16)
        out["qs"] = q.astype(np.int8)
    else:
        raise ValueError(f"unsupported quant type {ggml_type}")

    return out.view(np.uint8).ravel()


def _unpack_nibbles(qs: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    return (qs & 0xF).astype(np.int32), (qs >> 4).astype(np.int32)


def _qh_bits(qh: np.ndarray) -> np.ndarray:
    """(n,) uint32 -> (n, 32) the per-element 5th bits."""
    shifts = np.arange(QK, dtype=np.uint32)
    return ((qh[:, None].astype(np.uint64) >> shifts) & 1).astype(np.int32)


def dequantize(
    raw: np.ndarray, ggml_type: GGMLType, shape: tuple[int, ...]
) -> np.ndarray:
    """Decode raw block bytes back to float32 with the given logical shape."""
    from dinov2_tpu_torch.utils import native

    if ggml_type == GGMLType.F32:
        return raw.view("<f4").reshape(shape).astype(np.float32)
    if ggml_type == GGMLType.F16:
        if native.available():
            return native.fp16_to_fp32(raw.view("<f2")).reshape(shape)
        return raw.view("<f2").reshape(shape).astype(np.float32)
    if ggml_type == GGMLType.BF16:
        u32 = raw.view("<u2").astype(np.uint32) << 16
        return u32.view(np.float32).reshape(shape)

    if native.available():
        out = native.dequantize(raw, int(ggml_type), tuple(shape))
        if out is not None:
            return out

    blocks = raw.view(np.uint8).view(_BLOCK_DTYPES[ggml_type])
    d = blocks["d"].astype(np.float32)[:, None]

    if ggml_type == GGMLType.Q4_0:
        lo, hi = _unpack_nibbles(blocks["qs"])
        q = np.concatenate([lo, hi], axis=1)
        x = d * (q - 8)
    elif ggml_type == GGMLType.Q4_1:
        lo, hi = _unpack_nibbles(blocks["qs"])
        q = np.concatenate([lo, hi], axis=1)
        x = d * q + blocks["m"].astype(np.float32)[:, None]
    elif ggml_type == GGMLType.Q5_0:
        lo, hi = _unpack_nibbles(blocks["qs"])
        bits = _qh_bits(blocks["qh"])
        q = np.concatenate([lo | (bits[:, :16] << 4), hi | (bits[:, 16:] << 4)], axis=1)
        x = d * (q - 16)
    elif ggml_type == GGMLType.Q5_1:
        lo, hi = _unpack_nibbles(blocks["qs"])
        bits = _qh_bits(blocks["qh"])
        q = np.concatenate([lo | (bits[:, :16] << 4), hi | (bits[:, 16:] << 4)], axis=1)
        x = d * q + blocks["m"].astype(np.float32)[:, None]
    elif ggml_type == GGMLType.Q8_0:
        x = d * blocks["qs"].astype(np.float32)
    else:
        raise ValueError(f"unsupported quant type {ggml_type}")

    return x.astype(np.float32).reshape(shape)


def unpack_codes(
    raw: np.ndarray, ggml_type: GGMLType, shape: tuple[int, ...]
) -> tuple[np.ndarray, np.ndarray, np.ndarray | None]:
    """Decode raw blocks into a kernel-friendly structure-of-arrays:

      codes: int8 (rows, cols) — zero-point already subtracted for q4_0/q5_0
             (so dequant is `codes * d` or `codes * d + m`)
      d:     float32 (rows, cols//32) per-block scales
      m:     float32 per-block mins for q4_1/q5_1, else None

    Rationale: unpacking 4/5-bit nibbles once on the host lets a dequant-matmul
    read int8 tiles directly and fuse only the multiply-by-scale into its
    weight load (see ops/qmatmul_kernel.py; models/params.py keeps this
    layout for q8_0 and repacks the 4/5-bit formats into nibble planes).
    """
    from dinov2_tpu_torch.utils import native

    if native.available():
        out = native.unpack_codes(raw, int(ggml_type), tuple(shape))
        if out is not None:
            return out

    rows, cols = int(np.prod(shape[:-1], dtype=np.int64)), shape[-1]
    nb = cols // QK
    blocks = raw.view(np.uint8).view(_BLOCK_DTYPES[ggml_type]).reshape(rows, nb)
    d = blocks["d"].astype(np.float32)
    m = blocks["m"].astype(np.float32) if "m" in blocks.dtype.names else None

    if ggml_type == GGMLType.Q8_0:
        codes = blocks["qs"].view(np.int8).reshape(rows, cols)
        return codes, d, None

    qs = blocks["qs"]  # (rows, nb, 16)
    lo = (qs & 0xF).astype(np.int16)
    hi = (qs >> 4).astype(np.int16)
    q = np.concatenate([lo, hi], axis=-1)  # (rows, nb, 32)
    if ggml_type in (GGMLType.Q5_0, GGMLType.Q5_1):
        shifts = np.arange(QK, dtype=np.uint32)
        bits = ((blocks["qh"][..., None].astype(np.uint64) >> shifts) & 1).astype(np.int16)
        q = q | (bits << 4)
    zero = {GGMLType.Q4_0: 8, GGMLType.Q4_1: 0, GGMLType.Q5_0: 16, GGMLType.Q5_1: 0}[
        GGMLType(ggml_type)
    ]
    codes = (q - zero).astype(np.int8).reshape(rows, cols)
    return codes, d, m


def validate_quantized(raw: np.ndarray, ggml_type: GGMLType) -> bool:
    """Equivalent of ggml_validate_row_data: scales/mins must be finite fp16."""
    from dinov2_tpu_torch.utils import native

    if native.available():
        out = native.validate(raw, int(ggml_type))
        if out is not None:
            return out
    blocks = raw.view(np.uint8).view(_BLOCK_DTYPES[ggml_type])
    ok = np.isfinite(blocks["d"].astype(np.float32)).all()
    if "m" in blocks.dtype.names:
        ok &= np.isfinite(blocks["m"].astype(np.float32)).all()
    return bool(ok)
