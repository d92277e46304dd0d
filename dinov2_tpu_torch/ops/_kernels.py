"""Build and bind the hand-written CUDA kernels of dinov2_tpu_torch/csrc/.

Each source is compiled by `nvcc` into a shared library with a plain C
interface and loaded with ctypes, at the first call that needs it (never at
import, so the CPU-only test suite imports this module freely). Libraries go
to `build/kernels/` at the root of the checkout, named by a hash of the
source, of every header in csrc/ and of the flags, so an edited source or
header is rebuilt and a stale library is never loaded.

The entry points take device pointers and the CUDA stream as `void*` and
return `cudaGetLastError()` after their launches; the Python wrappers
(ops/fused_attention.py, ops/flash_attention.py, ops/qmatmul_kernel.py,
ops/fused_quant_attention.py) check the code and raise.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)


def find_nvcc() -> str:
    """$CUDA_HOME/bin/nvcc, else nvcc on PATH, else /usr/local/cuda/bin/nvcc."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(str(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc"))
    candidates += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for cand in candidates:
        if cand and Path(cand).is_file():
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def library_path(name: str) -> Path:
    """build/kernels/lib<name>-<hash>.so, the hash taken over csrc/<name>.cu,
    every csrc/*.cuh header (any of them may be included) and the flags."""
    digest = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile csrc/<name>.cu into build/kernels/lib<name>-<hash>.so (once)."""
    src = CSRC_DIR / f"{name}.cu"
    lib = library_path(name)
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed on {src.name} (exit {proc.returncode}):\n"
            f"{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, lib)  # atomic: a concurrent process never loads a partial file
    return lib


def _load(name: str) -> ctypes.CDLL:
    """Build and load csrc/<name>.cu; every library exports the error string."""
    lib = ctypes.CDLL(str(build(name)))
    lib.dinov2_cuda_error_string.argtypes = [ctypes.c_int]
    lib.dinov2_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def slab_layer_lib() -> ctypes.CDLL:
    """The K1 library (csrc/slab_layer.cu), built on first use."""
    lib = _load("slab_layer")
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.dinov2_slab_layer_bf16.argtypes = [ptr] * 11 + [i32] * 4 + [f32, f32, ptr]
    lib.dinov2_slab_layer_bf16.restype = i32
    return lib


@functools.cache
def slab_attention_lib() -> ctypes.CDLL:
    """The K3 and K2 library (csrc/slab_attention.cu), built on first use."""
    lib = _load("slab_attention")
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.dinov2_slab_attention_bf16.argtypes = [ptr] * 2 + [i32] * 4 + [f32, ptr]
    lib.dinov2_slab_attention_bf16.restype = i32
    lib.dinov2_slab_attention_block_bf16.argtypes = [ptr] * 7 + [i32] * 4 + [f32, ptr]
    lib.dinov2_slab_attention_block_bf16.restype = i32
    return lib


@functools.cache
def slab_mlp_lib() -> ctypes.CDLL:
    """The K5 library (csrc/slab_mlp.cu), built on first use."""
    lib = _load("slab_mlp")
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.dinov2_slab_mlp_bf16.argtypes = [ptr] * 9 + [i32] * 4 + [f32, ptr]
    lib.dinov2_slab_mlp_bf16.restype = i32
    return lib


@functools.cache
def flash_attention_lib() -> ctypes.CDLL:
    """The K4 library (csrc/flash_attention.cu), built on first use."""
    lib = _load("flash_attention")
    ptr, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    shape_and_strides = [i32] * 3 + [i64] * 3 + [f32]
    lib.dinov2_flash_attention_bf16.argtypes = [ptr] * 4 + shape_and_strides + [ptr]
    lib.dinov2_flash_attention_bf16.restype = i32
    lib.dinov2_flash_attention_lse_bf16.argtypes = [ptr] * 5 + shape_and_strides + [ptr]
    lib.dinov2_flash_attention_lse_bf16.restype = i32
    return lib


@functools.cache
def flash_backward_lib() -> ctypes.CDLL:
    """The K6 library (csrc/flash_backward.cu), built on first use."""
    lib = _load("flash_backward")
    ptr, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.dinov2_flash_backward_bf16.argtypes = [ptr] * 10 + [i32] * 3 + [i64] * 6 + [f32, ptr]
    lib.dinov2_flash_backward_bf16.restype = i32
    return lib


# a QuantLinear as the C entry points take it: codes, d, m, qh_lo, qh_hi,
# packed, zero point
_QUANT_WEIGHT_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2


@functools.cache
def quant_matmul_lib() -> ctypes.CDLL:
    """The K7 library (csrc/quant_matmul.cu), built on first use."""
    lib = _load("quant_matmul")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.dinov2_quant_matmul.argtypes = (
        [ptr, i32] + _QUANT_WEIGHT_ARGS + [ptr, i32, ptr] + [i32] * 3 + [ptr]
    )
    lib.dinov2_quant_matmul.restype = i32
    return lib


@functools.cache
def quant_layer_lib() -> ctypes.CDLL:
    """The K8 library (csrc/quant_layer.cu), built on first use."""
    lib = _load("quant_layer")
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.dinov2_quant_layer_bf16.argtypes = (
        [ptr] * 3 + _QUANT_WEIGHT_ARGS + [ptr] + _QUANT_WEIGHT_ARGS + [ptr] * 5
        + [i32] * 4 + [f32, f32, ptr]
    )
    lib.dinov2_quant_layer_bf16.restype = i32
    return lib


def check_status(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if code != 0:
        msg = lib.dinov2_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
