"""Build and bind the hand-written CUDA kernels of dinov2_tpu_torch/csrc/.

Each source is compiled by `nvcc` into a shared library with a plain C
interface and loaded with ctypes, at the first call that needs it (never at
import, so the CPU-only test suite imports this module freely). Libraries go
to `build/kernels/` at the root of the checkout, named by a hash of the
source and the flags, so an edited source is rebuilt and a stale one is
never loaded.

The entry points take device pointers and the CUDA stream as `void*` and
return `cudaGetLastError()` after their launches; the Python wrappers
(ops/fused_attention.py) check the code and raise.
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


def build(name: str) -> Path:
    """Compile csrc/<name>.cu into build/kernels/lib<name>-<hash>.so (once)."""
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    lib = BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"
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


@functools.cache
def slab_layer_lib() -> ctypes.CDLL:
    """The K1 library (csrc/slab_layer.cu), built on first use."""
    lib = ctypes.CDLL(str(build("slab_layer")))
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.dinov2_slab_layer_bf16.argtypes = (
        [ptr] * 11 + [i32] * 4 + [f32, f32, ptr]
    )
    lib.dinov2_slab_layer_bf16.restype = i32
    lib.dinov2_cuda_error_string.argtypes = [i32]
    lib.dinov2_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check_status(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if code != 0:
        msg = lib.dinov2_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
