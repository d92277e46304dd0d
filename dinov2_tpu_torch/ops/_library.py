"""The forward kernels as PyTorch operators, in the `dinov2_tpu_torch::`
namespace.

Every forward kernel wrapper on an inference path calls its operator:
slab_layer_block (K1), slab_attention_block (K2), slab_attention (K3),
flash_attention and flash_attention_lse (K4), slab_mlp_block (K5),
quant_matmul (K7) and slab_layer_block_quant (K8). Each operator has three
implementations, registered by `define` beside its wrapper:
  - CUDA: the ctypes launch of the kernel, with its argument checks and its
    launch count; it raises on any failure and never runs the plain version;
  - CPU: the plain PyTorch version;
  - fake (FakeTensor and meta tensors): the output's shape and dtype, and on
    a CUDA device the argument checks that need no storage. It builds and
    loads no library and reads no data pointer.
So eager calls and programs traced by `torch.export` (runtime/aot.py) run
the same code: a traced forward holds one node per kernel call, whatever
device it was traced for, and CUDA graphs or torch.compile can see the
kernels. A QuantLinear goes in as its tensor fields, its ggml type and its
layout flag (ops/qmatmul_kernel.py::quant_op_args).

The operators are registered with `torch.library.Library` and `define` /
`impl` rather than `torch.library.custom_op`, whose Python wrapper adds host
time to every call (PERF.md). The autograd Functions of the wrappers, K6
(a backward, on no inference program) and K9 (the int8 mode, which the
artifacts refuse, as the JAX package's do) stay plain Python around ctypes.
"""

from __future__ import annotations

import torch

NAMESPACE = "dinov2_tpu_torch"
LIBRARY = torch.library.Library(NAMESPACE, "DEF")


def define(schema: str, cpu, cuda, fake) -> torch._ops.OpOverload:
    """Define `NAMESPACE::<schema>` with its CPU, CUDA and fake
    implementations; returns the operator's default overload, what the
    wrappers call."""
    name = schema.split("(", 1)[0]
    LIBRARY.define(schema)
    LIBRARY.impl(name, cpu, "CPU")
    LIBRARY.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=LIBRARY)
    return getattr(getattr(torch.ops, NAMESPACE), name).default


def check_device(x: torch.Tensor, what: str) -> None:
    """The operators have CPU and CUDA implementations only: a wrapper
    refuses any other device before its operator is called."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no {what} for device {x.device}")



def count_launch(wrapper, dtype: torch.dtype) -> None:
    """One kernel call more on a wrapper's counter: `wrapper.f32_launches`
    for the f32 kernel, `wrapper.launches` for the bf16 one, so that a run
    can tell which of the two its path went through."""
    if dtype == torch.float32:
        wrapper.f32_launches += 1
    else:
        wrapper.launches += 1
