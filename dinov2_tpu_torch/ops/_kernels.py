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
ops/fused_quant_attention.py, ops/int8_matmul_kernel.py) check the code and
raise.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
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
    lib.dinov2_slab_mlp_bf16.argtypes = [ptr] * 9 + [i32] * 4 + [f32, ptr, ptr]
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


# bf16 entries whose f32 namesake takes one more pointer at the end: the
# scratch for the TF32 planes of its dense weights (csrc/tf32x3_gemm.cuh)
F32_WEIGHT_SCRATCH = {"dinov2_slab_layer_bf16", "dinov2_slab_attention_block_bf16",
                      "dinov2_slab_mlp_bf16"}


def entry(lib: ctypes.CDLL, bf16_name: str, f32: bool):
    """The C entry `bf16_name` of lib, or with `f32` its f32 namesake (K1,
    K2, K3, K4 with and without lse, K5, K6, K8: the same arguments, f32
    tensors where the bf16 entry takes bf16, and for the entries in
    F32_WEIGHT_SCRATCH a weight scratch last), bound here at first use
    rather than in the library loader, so that a library built from sources
    without the f32 entries still loads (scripts/compare_kernel_builds.py;
    an older f32 entry without the trailing scratch ignores it)."""
    fn = getattr(lib, bf16_name)
    if not f32:
        return fn
    f32_fn = getattr(lib, bf16_name.replace("_bf16", "_f32"))
    if f32_fn.argtypes is None:
        extra = [ctypes.c_void_p] if bf16_name in F32_WEIGHT_SCRATCH else []
        f32_fn.argtypes, f32_fn.restype = fn.argtypes + extra, fn.restype
    return f32_fn


# a QuantLinear as the C entry points take it: codes, d, m, qh_lo, qh_hi,
# packed, zero point
_QUANT_WEIGHT_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2


@functools.cache
def quant_matmul_lib() -> ctypes.CDLL:
    """The K7 library (csrc/quant_matmul.cu), built on first use."""
    lib = _load("quant_matmul")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.dinov2_quant_matmul.argtypes = (
        [ptr, i32] + _QUANT_WEIGHT_ARGS + [ptr, i32, ptr] + [i32] * 3 + [ptr, ptr]
    )
    lib.dinov2_quant_matmul.restype = i32
    return lib


@functools.cache
def dequant_weight_entry():
    """K7's dequantize launch alone (csrc/quant_matmul.cu's
    dinov2_dequant_weight_bf16), bound on first use: tests and timing call
    it, the port's paths reach the kernel through dinov2_quant_matmul."""
    fn = quant_matmul_lib().dinov2_dequant_weight_bf16
    fn.argtypes = _QUANT_WEIGHT_ARGS + [ctypes.c_void_p] + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def quant_layer_lib() -> ctypes.CDLL:
    """The K8 library (csrc/quant_layer.cu), built on first use."""
    lib = _load("quant_layer")
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.dinov2_quant_layer_bf16.argtypes = (
        [ptr] * 3 + _QUANT_WEIGHT_ARGS + [ptr] + _QUANT_WEIGHT_ARGS + [ptr] * 5
        + [i32] * 4 + [f32, f32, ptr, ptr]
    )
    lib.dinov2_quant_layer_bf16.restype = i32
    return lib


@functools.cache
def int8_matmul_lib() -> ctypes.CDLL:
    """The K9 library (csrc/int8_matmul.cu), built on first use."""
    lib = _load("int8_matmul")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.dinov2_int8_quantize_rows.argtypes = [ptr, i32, ptr, ptr, i32, i32, ptr]
    lib.dinov2_int8_quantize_rows.restype = i32
    # the gelu_tanh_f16 table comes last: a library from before it ignores it
    lib.dinov2_int8_gemm.argtypes = [ptr] * 5 + [i32, ptr] + [i32] * 4 + [ptr, ptr]
    lib.dinov2_int8_gemm.restype = i32
    return lib


@functools.cache
def int8_gelu_table_entry():
    """K9's one-off table kernel (csrc/int8_matmul.cu's dinov2_int8_gelu_table),
    bound on first use apart from the library loader, so that a library from
    before the table still loads (scripts/compare_kernel_builds.py)."""
    fn = int8_matmul_lib().dinov2_int8_gelu_table
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def int8_probe_entries() -> dict:
    """K9's entries for checks and reports, not on any path: the epilogue's
    table lookup alone, the GEMM's build constants, the host time of a
    tensor-map encode."""
    lib = int8_matmul_lib()
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.dinov2_int8_gelu_lookup.argtypes = [ptr, ptr, i32, ptr, ptr]
    lib.dinov2_int8_gelu_lookup.restype = i32
    lib.dinov2_int8_gemm_variant.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.dinov2_int8_gemm_variant.restype = None
    lib.dinov2_int8_tensor_map_us.argtypes = [ptr, i32, i32, i32]
    lib.dinov2_int8_tensor_map_us.restype = ctypes.c_double
    return {"lookup": lib.dinov2_int8_gelu_lookup, "variant": lib.dinov2_int8_gemm_variant,
            "tensor_map_us": lib.dinov2_int8_tensor_map_us}


LIBRARIES = {
    "slab_layer": slab_layer_lib, "slab_attention": slab_attention_lib,
    "slab_mlp": slab_mlp_lib, "flash_attention": flash_attention_lib,
    "flash_backward": flash_backward_lib, "quant_matmul": quant_matmul_lib,
    "quant_layer": quant_layer_lib, "int8_matmul": int8_matmul_lib,
}


def build_all() -> list[Path]:
    """Build every kernel library, one nvcc per source, all started
    together, and load each: what a server does at boot so that no request
    waits on the compiler."""
    with ThreadPoolExecutor(len(LIBRARIES)) as pool:
        paths = list(pool.map(build, LIBRARIES))
    for load in LIBRARIES.values():
        load()
    return paths


def check_status(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if code != 0:
        msg = lib.dinov2_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
