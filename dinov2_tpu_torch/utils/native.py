"""ctypes bindings for the native host codec (csrc/libdinogguf.so).

The numpy implementations in quant/blocks.py are the reference semantics; the
C++ library is a bit-identical OpenMP-parallel fast path for the multi-GB host
work (fp16 expansion, quantize/dequantize/unpack of giant checkpoints). The
library is built with `make -C csrc` (or build_native()); everything degrades
gracefully to numpy when it is absent.

The port's own copy of dinov2_tpu/utils/native.py; it binds the same library,
built from the csrc/ directory at the root of the checkout.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path

import numpy as np

_CSRC = Path(__file__).resolve().parent.parent.parent / "csrc"
_LIB_PATH = _CSRC / "libdinogguf.so"
_lib: ctypes.CDLL | None = None


def build_native(quiet: bool = True) -> bool:
    """Compile the library in-tree. Returns True on success."""
    try:
        subprocess.run(
            ["make", "-C", str(_CSRC), "libdinogguf.so"],
            check=True,
            capture_output=quiet,
        )
        return _LIB_PATH.exists()
    except (subprocess.CalledProcessError, FileNotFoundError):
        return False


def _load() -> ctypes.CDLL | None:
    global _lib
    if _lib is not None:
        return _lib
    if os.environ.get("DINOV2_TPU_NO_NATIVE"):
        return None
    if not _LIB_PATH.exists():
        return None
    lib = ctypes.CDLL(str(_LIB_PATH))
    i64, u8p, i8p, f32p, u16p, i32 = (
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_int8),
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_uint16),
        ctypes.c_int,
    )
    lib.dg_fp16_to_fp32.argtypes = [u16p, f32p, i64]
    lib.dg_fp32_to_fp16.argtypes = [f32p, u16p, i64]
    lib.dg_quantize.argtypes = [i32, f32p, u8p, i64, i64]
    lib.dg_quantize.restype = i64
    lib.dg_dequantize.argtypes = [i32, u8p, f32p, i64, i64]
    lib.dg_dequantize.restype = i32
    lib.dg_unpack_codes.argtypes = [i32, u8p, i8p, f32p, f32p, i64, i64]
    lib.dg_unpack_codes.restype = i32
    lib.dg_validate.argtypes = [i32, u8p, i64]
    lib.dg_validate.restype = i32
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def fp16_to_fp32(src: np.ndarray) -> np.ndarray:
    lib = _load()
    src = np.ascontiguousarray(src)
    if lib is None:
        return src.astype(np.float32)
    out = np.empty(src.shape, dtype=np.float32)
    lib.dg_fp16_to_fp32(
        _ptr(src.view(np.uint16), ctypes.c_uint16), _ptr(out, ctypes.c_float), src.size
    )
    return out


def quantize(x: np.ndarray, ggml_type: int) -> np.ndarray | None:
    """Native quantize; returns None if the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    x2 = np.ascontiguousarray(x, dtype=np.float32).reshape(-1, x.shape[-1])
    rows, cols = x2.shape
    from dinov2_tpu_torch.io.gguf import GGML_TYPE_TRAITS, GGMLType

    block, bb = GGML_TYPE_TRAITS[GGMLType(ggml_type)]
    out = np.empty(rows * (cols // block) * bb, dtype=np.uint8)
    n = lib.dg_quantize(
        int(ggml_type),
        _ptr(x2, ctypes.c_float),
        _ptr(out, ctypes.c_uint8),
        rows,
        cols,
    )
    if n < 0:
        return None
    return out


def dequantize(raw: np.ndarray, ggml_type: int, shape) -> np.ndarray | None:
    lib = _load()
    if lib is None:
        return None
    rows = int(np.prod(shape[:-1], dtype=np.int64)) if len(shape) > 1 else 1
    cols = shape[-1]
    out = np.empty((rows, cols), dtype=np.float32)
    raw = np.ascontiguousarray(raw.view(np.uint8).ravel())
    rc = lib.dg_dequantize(
        int(ggml_type), _ptr(raw, ctypes.c_uint8), _ptr(out, ctypes.c_float), rows, cols
    )
    if rc != 0:
        return None
    return out.reshape(shape)


def unpack_codes(raw: np.ndarray, ggml_type: int, shape):
    lib = _load()
    if lib is None:
        return None
    rows = int(np.prod(shape[:-1], dtype=np.int64)) if len(shape) > 1 else 1
    cols = shape[-1]
    nb = cols // 32
    codes = np.empty((rows, cols), dtype=np.int8)
    d = np.empty((rows, nb), dtype=np.float32)
    needs_m = int(ggml_type) in (3, 7)  # Q4_1, Q5_1
    m = np.empty((rows, nb), dtype=np.float32) if needs_m else None
    raw = np.ascontiguousarray(raw.view(np.uint8).ravel())
    rc = lib.dg_unpack_codes(
        int(ggml_type),
        _ptr(raw, ctypes.c_uint8),
        _ptr(codes, ctypes.c_int8),
        _ptr(d, ctypes.c_float),
        _ptr(m, ctypes.c_float) if m is not None else None,
        rows,
        cols,
    )
    if rc != 0:
        return None
    return codes, d, m


def validate(raw: np.ndarray, ggml_type: int) -> bool | None:
    lib = _load()
    if lib is None:
        return None
    raw = np.ascontiguousarray(raw.view(np.uint8).ravel())
    return bool(lib.dg_validate(int(ggml_type), _ptr(raw, ctypes.c_uint8), raw.nbytes))
