"""GGUF v3 reader/writer, implemented from scratch on numpy + mmap.

File-format interop target: files produced/consumed by the reference project
lavaman131/dinov2.cpp (its converter `scripts/dinov2-to-gguf.py` uses the upstream
`gguf` Python package; its C++ side uses ggml's `gguf_init_from_file`,
see the reference dinov2.cpp:263-272). This module implements the public GGUF v3
on-disk layout directly so checkpoints are interchangeable in both directions.

Layout (little-endian):
  header:  magic "GGUF" | version u32 (=3) | n_tensors u64 | n_kv u64
  kv:      key string (u64 len + utf8) | value_type u32 | value
  tensors: name string | n_dims u32 | ne[u64]*n_dims | ggml_type u32 | data offset u64
  padding to `general.alignment` (default 32), then tensor data (each offset aligned).

Note on shapes: GGUF stores `ne` with ne[0] the *fastest-moving* (contiguous)
dimension, i.e. the reverse of a C-order numpy shape. Quantized blocks run along
ne[0]. We expose numpy-convention shapes and handle the reversal internally.

The port's own copy of dinov2_tpu/io/gguf.py (numpy and the standard library only).
"""

from __future__ import annotations

import enum
import mmap
import struct
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Iterable, Mapping

import numpy as np

GGUF_MAGIC = b"GGUF"
GGUF_VERSION = 3
GGUF_DEFAULT_ALIGNMENT = 32


class GGUFValueType(enum.IntEnum):
    UINT8 = 0
    INT8 = 1
    UINT16 = 2
    INT16 = 3
    UINT32 = 4
    INT32 = 5
    FLOAT32 = 6
    BOOL = 7
    STRING = 8
    ARRAY = 9
    UINT64 = 10
    INT64 = 11
    FLOAT64 = 12


class GGMLType(enum.IntEnum):
    """ggml tensor dtypes used by the reference (subset of the full ggml enum)."""

    F32 = 0
    F16 = 1
    Q4_0 = 2
    Q4_1 = 3
    Q5_0 = 6
    Q5_1 = 7
    Q8_0 = 8
    I8 = 24
    I16 = 25
    I32 = 26
    I64 = 27
    F64 = 28
    BF16 = 30


# (block_size_elements, bytes_per_block)
GGML_TYPE_TRAITS: dict[GGMLType, tuple[int, int]] = {
    GGMLType.F32: (1, 4),
    GGMLType.F16: (1, 2),
    GGMLType.BF16: (1, 2),
    GGMLType.F64: (1, 8),
    GGMLType.I8: (1, 1),
    GGMLType.I16: (1, 2),
    GGMLType.I32: (1, 4),
    GGMLType.I64: (1, 8),
    GGMLType.Q4_0: (32, 18),  # fp16 d + 16B nibbles
    GGMLType.Q4_1: (32, 20),  # fp16 d + fp16 m + 16B nibbles
    GGMLType.Q5_0: (32, 22),  # fp16 d + u32 qh + 16B nibbles
    GGMLType.Q5_1: (32, 24),  # fp16 d + fp16 m + u32 qh + 16B nibbles
    GGMLType.Q8_0: (32, 34),  # fp16 d + 32 int8
}

QUANTIZED_TYPES = (
    GGMLType.Q4_0,
    GGMLType.Q4_1,
    GGMLType.Q5_0,
    GGMLType.Q5_1,
    GGMLType.Q8_0,
)

_SIMPLE_NP_DTYPES: dict[GGMLType, np.dtype] = {
    GGMLType.F32: np.dtype("<f4"),
    GGMLType.F16: np.dtype("<f2"),
    GGMLType.F64: np.dtype("<f8"),
    GGMLType.I8: np.dtype("<i1"),
    GGMLType.I16: np.dtype("<i2"),
    GGMLType.I32: np.dtype("<i4"),
    GGMLType.I64: np.dtype("<i8"),
}

_SCALAR_FMT: dict[GGUFValueType, str] = {
    GGUFValueType.UINT8: "<B",
    GGUFValueType.INT8: "<b",
    GGUFValueType.UINT16: "<H",
    GGUFValueType.INT16: "<h",
    GGUFValueType.UINT32: "<I",
    GGUFValueType.INT32: "<i",
    GGUFValueType.FLOAT32: "<f",
    GGUFValueType.BOOL: "<?",
    GGUFValueType.UINT64: "<Q",
    GGUFValueType.INT64: "<q",
    GGUFValueType.FLOAT64: "<d",
}


def ggml_nbytes(ggml_type: GGMLType, shape: tuple[int, ...]) -> int:
    """Byte size of a tensor: blocks run along the contiguous (last numpy) axis."""
    block, block_bytes = GGML_TYPE_TRAITS[ggml_type]
    if not shape:
        shape = (1,)
    inner = shape[-1]
    if inner % block != 0:
        raise ValueError(
            f"inner dim {inner} not a multiple of {ggml_type.name} block size {block}"
        )
    n_rows = int(np.prod(shape[:-1], dtype=np.int64)) if len(shape) > 1 else 1
    return n_rows * (inner // block) * block_bytes


@dataclass
class GGUFTensor:
    """One tensor record. `data` is the raw on-disk bytes (possibly quantized blocks)."""

    name: str
    shape: tuple[int, ...]  # numpy convention (row-major, last axis contiguous)
    ggml_type: GGMLType
    data: np.ndarray  # uint8 view of raw bytes, or typed array for simple dtypes

    @property
    def nbytes(self) -> int:
        return ggml_nbytes(self.ggml_type, self.shape)

    def as_numpy(self) -> np.ndarray:
        """Decode to a float/int numpy array (dequantizes block formats)."""
        if self.ggml_type in _SIMPLE_NP_DTYPES:
            return self.data.view(_SIMPLE_NP_DTYPES[self.ggml_type]).reshape(self.shape)
        # BF16 and the block formats all decode in quant.blocks (one home)
        from dinov2_tpu_torch.quant.blocks import dequantize

        return dequantize(self.data.view(np.uint8).ravel(), self.ggml_type, self.shape)


def _align(offset: int, alignment: int) -> int:
    return (offset + alignment - 1) // alignment * alignment


# ---------------------------------------------------------------------------
# Reader
# ---------------------------------------------------------------------------


class _Cursor:
    def __init__(self, buf: memoryview | mmap.mmap):
        self.buf = buf
        self.pos = 0

    def take(self, n: int) -> memoryview:
        out = memoryview(self.buf)[self.pos : self.pos + n]
        if len(out) != n:
            raise EOFError("truncated GGUF file")
        self.pos += n
        return out

    def unpack(self, fmt: str):
        size = struct.calcsize(fmt)
        return struct.unpack(fmt, self.take(size))[0]

    def read_string(self) -> str:
        n = self.unpack("<Q")
        return bytes(self.take(n)).decode("utf-8")

    def read_value(self, vtype: GGUFValueType):
        if vtype == GGUFValueType.STRING:
            return self.read_string()
        if vtype == GGUFValueType.ARRAY:
            return self.read_array()[1]
        return self.unpack(_SCALAR_FMT[vtype])

    def read_array(self) -> tuple["GGUFValueType", list]:
        """Read an ARRAY payload, returning (element_type, values)."""
        elem_type = GGUFValueType(self.unpack("<I"))
        n = self.unpack("<Q")
        return elem_type, [self.read_value(elem_type) for _ in range(n)]


class GGUFReader:
    """mmap-backed GGUF reader. Tensor payloads are zero-copy views into the map."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self._file = open(self.path, "rb")
        try:
            self._mmap = mmap.mmap(self._file.fileno(), 0, access=mmap.ACCESS_READ)
            self._parse(path)
        except Exception:
            # a parse error (bad magic, duplicated tensor names, truncated
            # header, ...) must not leak the fd/map of the half-built reader —
            # a long-lived process scanning untrusted files would exhaust fds
            self.close() if hasattr(self, "_mmap") else self._file.close()
            raise

    def _parse(self, path):
        cur = _Cursor(self._mmap)

        if bytes(cur.take(4)) != GGUF_MAGIC:
            raise ValueError(f"{path}: not a GGUF file")
        self.version = cur.unpack("<I")
        if self.version not in (2, 3):
            raise ValueError(f"{path}: unsupported GGUF version {self.version}")
        n_tensors = cur.unpack("<Q")
        n_kv = cur.unpack("<Q")

        self.kv: dict[str, Any] = {}
        self.kv_types: dict[str, GGUFValueType] = {}
        # ARRAY KVs also record their on-disk element type so rewrites
        # (e.g. quantize_gguf's KV copy) round-trip byte-identically instead
        # of re-inferring INT32 arrays as UINT32 from the first element.
        self.kv_array_types: dict[str, GGUFValueType] = {}
        for _ in range(n_kv):
            key = cur.read_string()
            if key in self.kv_types:
                # ggml's gguf_init_from_file rejects duplicated keys; silent
                # last-wins here would drop data the reference loader refuses
                raise ValueError(f"{path}: duplicated KV key {key!r}")
            vtype = GGUFValueType(cur.unpack("<I"))
            if vtype == GGUFValueType.ARRAY:
                elem_type, values = cur.read_array()
                self.kv[key] = values
                self.kv_array_types[key] = elem_type
            else:
                self.kv[key] = cur.read_value(vtype)
            self.kv_types[key] = vtype

        self.alignment = int(self.kv.get("general.alignment", GGUF_DEFAULT_ALIGNMENT))

        infos: list[tuple[str, tuple[int, ...], GGMLType, int]] = []
        for _ in range(n_tensors):
            name = cur.read_string()
            n_dims = cur.unpack("<I")
            ne = [cur.unpack("<Q") for _ in range(n_dims)]
            ggml_type = GGMLType(cur.unpack("<I"))
            offset = cur.unpack("<Q")
            shape = tuple(reversed(ne)) if ne else (1,)
            infos.append((name, shape, ggml_type, offset))

        if len({i[0] for i in infos}) != len(infos):
            # ggml's gguf_init_from_file rejects duplicated tensor names;
            # silently last-winning would be silent data loss
            dupes = sorted({n for n in (i[0] for i in infos) if
                            [i[0] for i in infos].count(n) > 1})
            raise ValueError(f"{path}: duplicated tensor names {dupes}")
        data_start = _align(cur.pos, self.alignment)
        self.tensors: dict[str, GGUFTensor] = {}
        for name, shape, ggml_type, offset in infos:
            nbytes = ggml_nbytes(ggml_type, shape)
            raw = np.frombuffer(
                self._mmap, dtype=np.uint8, count=nbytes, offset=data_start + offset
            )
            self.tensors[name] = GGUFTensor(name, shape, ggml_type, raw)

    def close(self) -> None:
        """Best-effort close. Tensor arrays are zero-copy views into the mmap; if
        any are still alive the map stays open until they are garbage-collected
        (the OS page cache backs them either way)."""
        try:
            self._mmap.close()
        except BufferError:
            pass
        self._file.close()

    def __enter__(self) -> "GGUFReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# ---------------------------------------------------------------------------
# Writer
# ---------------------------------------------------------------------------


def _value_type_for(value: Any) -> GGUFValueType:
    if isinstance(value, bool):
        return GGUFValueType.BOOL
    if isinstance(value, str):
        return GGUFValueType.STRING
    if isinstance(value, float):
        return GGUFValueType.FLOAT32
    if isinstance(value, int):
        return GGUFValueType.UINT32 if 0 <= value < 2**32 else GGUFValueType.INT64
    if isinstance(value, (list, tuple)):
        # nested arrays are legal GGUF (elem type ARRAY); inner element types
        # are re-inferred per element when written
        return GGUFValueType.ARRAY
    raise TypeError(f"cannot infer GGUF value type for {type(value)}")


def _array_elem_type(values) -> GGUFValueType:
    """Element type for an ARRAY KV, inferred from ALL elements — inferring
    from values[0] alone mislabels mixed-sign int arrays (e.g. [0, -1] would
    infer UINT32 and die in struct.pack on the -1)."""
    types = {_value_type_for(v) for v in values}
    if types <= {GGUFValueType.UINT32, GGUFValueType.INT64}:
        if any(isinstance(v, int) and v < 0 for v in values):
            return (
                GGUFValueType.INT32
                if all(-(2**31) <= v < 2**31 for v in values)
                else GGUFValueType.INT64
            )
        return (
            GGUFValueType.UINT32 if types == {GGUFValueType.UINT32}
            else GGUFValueType.INT64
        )
    if len(types) != 1:
        raise TypeError(f"cannot infer one GGUF element type for {sorted(types)}")
    return types.pop()


@dataclass
class _KV:
    key: str
    vtype: GGUFValueType
    value: Any
    elem_type: GGUFValueType | None = None  # ARRAY element type (None = infer)


class GGUFWriter:
    """Streaming GGUF v3 writer mirroring the schema the reference emits."""

    def __init__(self, path: str | Path, arch: str = "dinov2"):
        self.path = Path(path)
        self.alignment = GGUF_DEFAULT_ALIGNMENT
        self._kvs: list[_KV] = []
        self._tensors: list[GGUFTensor] = []
        if arch:
            self.add_kv("general.architecture", arch)

    # -- KVs --------------------------------------------------------------
    def add_kv(
        self,
        key: str,
        value: Any,
        vtype: GGUFValueType | None = None,
        elem_type: GGUFValueType | None = None,
    ) -> None:
        if vtype is None:
            vtype = (
                GGUFValueType.ARRAY
                if isinstance(value, (list, tuple))
                else _value_type_for(value)
            )
        if key == "general.alignment":
            # the KV governs the data-section layout we are about to write
            # (readers — ours and ggml's — honor it; writing offsets with a
            # different alignment than the stored KV corrupts the file)
            self.alignment = int(value)
        self._kvs.append(_KV(key, vtype, value, elem_type))

    def add_uint32(self, key: str, value: int) -> None:
        self.add_kv(key, int(value), GGUFValueType.UINT32)

    def add_string(self, key: str, value: str) -> None:
        self.add_kv(key, value, GGUFValueType.STRING)

    # -- tensors -----------------------------------------------------------
    def add_tensor(
        self,
        name: str,
        data: np.ndarray,
        ggml_type: GGMLType | None = None,
        shape: tuple[int, ...] | None = None,
    ) -> None:
        """Add a tensor.

        For plain dtypes pass a float16/float32/... array and the type is inferred.
        For quantized blocks pass raw uint8 `data` plus explicit `ggml_type` and the
        logical element `shape`.
        """
        if any(t.name == name for t in self._tensors):
            # ggml's loader rejects files with duplicated tensor names — fail
            # at write time, not when the reference C++ refuses the artifact
            raise ValueError(f"duplicate tensor name {name!r}")
        if ggml_type is None:
            np_to_ggml = {
                np.dtype(np.float32): GGMLType.F32,
                np.dtype(np.float16): GGMLType.F16,
                np.dtype(np.int8): GGMLType.I8,
                np.dtype(np.int16): GGMLType.I16,
                np.dtype(np.int32): GGMLType.I32,
                np.dtype(np.int64): GGMLType.I64,
                np.dtype(np.float64): GGMLType.F64,
            }
            ggml_type = np_to_ggml[data.dtype]
            shape = data.shape
        if shape is None:
            raise ValueError("shape is required for quantized tensors")
        raw = np.ascontiguousarray(data).view(np.uint8).ravel()
        expect = ggml_nbytes(ggml_type, tuple(shape))
        if raw.nbytes != expect:
            raise ValueError(
                f"tensor {name}: got {raw.nbytes} bytes, expected {expect} "
                f"for {ggml_type.name} {shape}"
            )
        self._tensors.append(GGUFTensor(name, tuple(shape), ggml_type, raw))

    # -- serialize ----------------------------------------------------------
    @staticmethod
    def _pack_string(s: str) -> bytes:
        b = s.encode("utf-8")
        return struct.pack("<Q", len(b)) + b

    def _pack_value(
        self, vtype: GGUFValueType, value: Any, elem_type: GGUFValueType | None = None
    ) -> bytes:
        if vtype == GGUFValueType.STRING:
            return self._pack_string(value)
        if vtype == GGUFValueType.ARRAY:
            if elem_type is None:
                if not value:
                    raise ValueError("cannot write empty untyped array")
                elem_type = _array_elem_type(value)
            out = struct.pack("<I", elem_type) + struct.pack("<Q", len(value))
            return out + b"".join(self._pack_value(elem_type, v) for v in value)
        return struct.pack(_SCALAR_FMT[vtype], value)

    def write(self) -> None:
        header = struct.pack(
            "<4sIQQ", GGUF_MAGIC, GGUF_VERSION, len(self._tensors), len(self._kvs)
        )
        kv_blob = b"".join(
            self._pack_string(kv.key)
            + struct.pack("<I", kv.vtype)
            + self._pack_value(kv.vtype, kv.value, kv.elem_type)
            for kv in self._kvs
        )
        info_blob = b""
        offset = 0
        for t in self._tensors:
            ne = tuple(reversed(t.shape))
            info_blob += self._pack_string(t.name)
            info_blob += struct.pack("<I", len(ne))
            info_blob += b"".join(struct.pack("<Q", d) for d in ne)
            info_blob += struct.pack("<I", t.ggml_type)
            info_blob += struct.pack("<Q", offset)
            offset = _align(offset + t.nbytes, self.alignment)

        head_len = len(header) + len(kv_blob) + len(info_blob)
        data_start = _align(head_len, self.alignment)

        with open(self.path, "wb") as f:
            f.write(header)
            f.write(kv_blob)
            f.write(info_blob)
            f.write(b"\x00" * (data_start - head_len))
            pos = 0
            for t in self._tensors:
                f.write(t.data.tobytes())
                pos += t.nbytes
                pad = _align(pos, self.alignment) - pos
                f.write(b"\x00" * pad)
                pos += pad

    close = write  # parity with the upstream writer's API shape


# ---------------------------------------------------------------------------
# Convenience API
# ---------------------------------------------------------------------------


def read_gguf(path: str | Path) -> tuple[dict[str, Any], dict[str, GGUFTensor]]:
    reader = GGUFReader(path)
    return reader.kv, reader.tensors


def write_gguf(
    path: str | Path,
    kv: Mapping[str, Any],
    tensors: Iterable[GGUFTensor] | Mapping[str, np.ndarray],
    arch: str = "dinov2",
    kv_types: Mapping[str, GGUFValueType] | None = None,
    kv_array_types: Mapping[str, GGUFValueType] | None = None,
) -> None:
    """Convenience writer. `arch` is a default only: a `general.architecture`
    key present in `kv` wins, so read-modify-write round-trips preserve the
    source file's architecture instead of silently relabeling it. Pass the
    reader's `kv_types` / `kv_array_types` to round-trip on-disk value types
    byte-identically instead of re-inferring them (INT32 arrays would
    otherwise come back UINT32)."""
    kv_types = kv_types or {}
    kv_array_types = kv_array_types or {}
    w = GGUFWriter(path, arch=str(kv.get("general.architecture", arch)))
    for k, v in kv.items():
        if k == "general.architecture":
            continue
        w.add_kv(k, v, kv_types.get(k), kv_array_types.get(k))
    if isinstance(tensors, Mapping):
        for name, arr in tensors.items():
            if isinstance(arr, GGUFTensor):  # read_gguf round-trip
                w.add_tensor(name, arr.data, arr.ggml_type, arr.shape)
            else:
                w.add_tensor(name, arr)
    else:
        for t in tensors:
            w.add_tensor(t.name, t.data, t.ggml_type, t.shape)
    w.write()
