"""A GGUF v3 writer, as much of the format as the benchmark's files need:
u32 and string header values, f32, f16 and q4_0 tensors."""

from __future__ import annotations

import struct
from dataclasses import dataclass
from pathlib import Path

import numpy as np

ALIGNMENT = 32
F32, F16, Q4_0 = 0, 1, 2  # ggml type ids
UINT32, STRING = 4, 8  # GGUF value types


@dataclass(frozen=True)
class Blocks:
    """A tensor in ggml blocks: the raw bytes, the logical (numpy) shape and
    the ggml type."""

    raw: np.ndarray
    shape: tuple[int, ...]
    ggml_type: int


def _string(s: str) -> bytes:
    b = s.encode()
    return struct.pack("<Q", len(b)) + b


def _align(n: int) -> int:
    return -(-n // ALIGNMENT) * ALIGNMENT


def write(path: Path, kv: dict, tensors: dict) -> None:
    """`kv`: name -> int (u32) or str; `tensors`: name -> float32 or
    float16 array, or Blocks."""
    kv = {"general.architecture": "dinov2", **kv}
    head = struct.pack("<4sIQQ", b"GGUF", 3, len(tensors), len(kv))
    for key, value in kv.items():
        if isinstance(value, str):
            head += _string(key) + struct.pack("<I", STRING) + _string(value)
        else:
            head += _string(key) + struct.pack("<II", UINT32, int(value))
    payloads, offset = [], 0
    for name, t in tensors.items():
        if isinstance(t, Blocks):
            raw, shape, kind = t.raw, t.shape, t.ggml_type
        else:
            kind = {np.dtype(np.float32): F32, np.dtype(np.float16): F16}[t.dtype]
            raw, shape = np.ascontiguousarray(t).view(np.uint8).ravel(), t.shape
        dims = tuple(reversed(shape))  # ggml's ne[]: innermost first
        head += _string(name) + struct.pack("<I", len(dims))
        head += b"".join(struct.pack("<Q", n) for n in dims)
        head += struct.pack("<IQ", kind, offset)
        payloads.append(raw)
        offset = _align(offset + raw.nbytes)
    with open(path, "wb") as f:
        f.write(head)
        f.write(b"\0" * (_align(len(head)) - len(head)))
        for raw in payloads:
            f.write(memoryview(raw))
            f.write(b"\0" * (_align(raw.nbytes) - raw.nbytes))
