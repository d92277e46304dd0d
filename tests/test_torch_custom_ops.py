"""The forward kernels as PyTorch operators (dinov2_tpu_torch/ops/_library.py):
torch.library.opcheck of each on CPU tensors (its schema, its fake
implementation's shapes and dtypes against the real output), its CPU
implementation against the plain version bit for bit, and its fake
implementation on fake CUDA tensors: the checks that need no storage, and
no kernel library built or loaded."""

from __future__ import annotations

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (caps torch's threads under xdist)
from torch._subclasses.fake_tensor import FakeTensorMode

from dinov2_tpu_torch.models.params import quantize_linear
from dinov2_tpu_torch.ops import _kernels
from dinov2_tpu_torch.ops.attention import split_heads, vanilla_attention
from dinov2_tpu_torch.ops.flash_attention import flash_forward_reference
from dinov2_tpu_torch.ops.fused_attention import (
    _slab_block_reference,
    _slab_reference,
    slab_layer_reference,
    slab_mlp_reference,
)
from dinov2_tpu_torch.ops.fused_quant_attention import quant_layer_reference
from dinov2_tpu_torch.ops.qmatmul_kernel import quant_matmul_reference, quant_op_args

OPS = torch.ops.dinov2_tpu_torch
B, T, D, HEADS = 2, 5, 128, 2
SCALE, EPS = 0.125, 1e-6


def _t(rng, shape, dtype, scale=1.0, device="cpu"):
    return torch.from_numpy(rng.standard_normal(shape) * scale).to(device, dtype)


def _rows(rng, n, device="cpu"):
    return torch.from_numpy(rng.uniform(0.5, 1.5, n)).to(device, torch.float32)


def _ql(rng, n, k, fmt="q4_0", device="cpu"):
    return quantize_linear(rng.standard_normal((n, k)) * 0.05, fmt, device=device)


def cases(device="cpu"):
    """op name -> (operator arguments, the plain version's output), on
    `device` (the plain version is computed on CPU inputs only)."""
    rng = np.random.default_rng(0)
    bf, f32 = torch.bfloat16, torch.float32
    x = _t(rng, (B, T, D), bf, device=device)
    ln = [_rows(rng, D, device), _t(rng, D, f32, 0.1, device)]
    w_qkv, b_qkv = _t(rng, (D, 3 * D), bf, 0.05, device), _t(rng, 3 * D, f32, 0.1, device)
    w_proj, b_proj = _t(rng, (D, D), bf, 0.05, device), _t(rng, D, f32, 0.1, device)
    ls = _rows(rng, D, device)
    qkv = _t(rng, (B, T, 3 * D), bf, 1.5, device)
    d_mlp = 384
    xm = _t(rng, (B, T, d_mlp), bf, device=device)
    mlp = [xm, _rows(rng, d_mlp, device), _t(rng, d_mlp, f32, 0.1, device),
           _t(rng, (d_mlp, 4 * d_mlp), bf, 0.05, device), _t(rng, 4 * d_mlp, f32, 0.1, device),
           _t(rng, (4 * d_mlp, d_mlp), bf, 0.05, device), _t(rng, d_mlp, f32, 0.1, device),
           _rows(rng, d_mlp, device)]
    q, k, v = split_heads(qkv, HEADS)
    wq4, wp4 = _ql(rng, 3 * D, D, device=device), _ql(rng, D, D, "q5_1", device=device)
    xq, bias = _t(rng, (3, D), bf, device=device), _t(rng, 3 * D, f32, 0.1, device)
    head = _t(rng, (3, D), f32, device=device)
    layer = (x, *ln, w_qkv, b_qkv, w_proj, b_proj, ls)
    # f32 x: K5 f32 at a width the bf16 K5 is not built for, K8 f32
    mlp32 = [_t(rng, (B, T, D), f32, device=device), _rows(rng, D, device),
             _t(rng, D, f32, 0.1, device), _t(rng, (D, 4 * D), f32, 0.05, device),
             _t(rng, 4 * D, f32, 0.1, device), _t(rng, (4 * D, D), f32, 0.05, device),
             _t(rng, D, f32, 0.1, device), _rows(rng, D, device)]
    x32 = x.float()
    on_cpu = device == "cpu"
    return {
        "slab_layer_block": ((*layer, HEADS, SCALE, EPS), on_cpu and (
            lambda: slab_layer_reference(*layer, HEADS, SCALE, EPS))),
        "slab_attention_block": ((x, qkv, w_proj, b_proj, ls, HEADS, SCALE), on_cpu and (
            lambda: _slab_block_reference(x, qkv, w_proj, b_proj, ls, HEADS, SCALE))),
        "slab_attention": ((qkv, HEADS, SCALE), on_cpu and (
            lambda: _slab_reference(qkv, HEADS, SCALE))),
        "slab_mlp_block": ((*mlp, "gelu_tanh_f16", EPS), on_cpu and (
            lambda: slab_mlp_reference(*mlp, "gelu_tanh_f16", EPS))),
        "slab_mlp_block f32": ((*mlp32, "gelu_erf", EPS), on_cpu and (
            lambda: slab_mlp_reference(*mlp32, "gelu_erf", EPS))),
        "flash_attention": ((q, k, v, SCALE), on_cpu and (
            lambda: vanilla_attention(q, k, v, SCALE))),
        "flash_attention_lse": ((q, k, v, SCALE), on_cpu and (
            lambda: flash_forward_reference(q, k, v, SCALE))),
        "quant_matmul": ((xq, *quant_op_args(wq4), bias, "gelu_erf"), on_cpu and (
            lambda: quant_matmul_reference(xq, wq4, bias, "gelu_erf"))),
        "quant_matmul f32 head": ((head, *quant_op_args(wp4), None, None), on_cpu and (
            lambda: quant_matmul_reference(head, wp4))),
        "slab_layer_block_quant": (
            (x, *ln, *quant_op_args(wq4), b_qkv, *quant_op_args(wp4), b_proj, ls, HEADS, SCALE,
             EPS), on_cpu and (
                lambda: quant_layer_reference(x, *ln, wq4, b_qkv, wp4, b_proj, ls, HEADS, SCALE,
                                              EPS))),
        "slab_layer_block_quant f32": (
            (x32, *ln, *quant_op_args(wq4), b_qkv, *quant_op_args(wp4), b_proj, ls, HEADS, SCALE,
             EPS), on_cpu and (
                lambda: quant_layer_reference(x32, *ln, wq4, b_qkv, wp4, b_proj, ls, HEADS,
                                              SCALE, EPS))),
    }


NAMES = list(cases())


def _op(name):
    return getattr(OPS, name.split()[0]).default


@pytest.mark.parametrize("name", NAMES)
def test_opcheck(name):
    args, _ = cases()[name]
    torch.library.opcheck(_op(name), args)


@pytest.mark.parametrize("name", NAMES)
def test_cpu_implementation_is_the_plain_version(name):
    args, plain = cases()[name]
    got, want = _op(name)(*args), plain()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.is_contiguous()
        assert torch.equal(g, w)


def _fake_cuda(args) -> list:
    """The tensors of `args` as fake CUDA tensors of the same shapes, strides
    and dtypes (under the caller's FakeTensorMode)."""
    return [torch.empty_strided(a.shape, a.stride(), dtype=a.dtype, device="cuda")
            if torch.is_tensor(a) else a for a in args]


@pytest.mark.parametrize("name", NAMES)
def test_fake_cuda_builds_nothing(name, monkeypatch):
    """On fake CUDA tensors every operator gives the kernel's output shape
    and dtype and never reaches the library loader."""
    def refuse(*args, **kwargs):
        raise AssertionError("a fake implementation loaded a kernel library")

    monkeypatch.setattr(_kernels, "_load", refuse)
    monkeypatch.setattr(_kernels, "build", refuse)
    args, _ = cases()[name]
    want = _op(name)(*args)
    with FakeTensorMode():
        got = _op(name)(*_fake_cuda(args))
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        assert g.device.type == "cuda" and g.shape == w.shape and g.dtype == w.dtype


@pytest.mark.parametrize("name", ["slab_mlp_block f32", "slab_layer_block_quant f32"])
def test_fake_cuda_gives_f32_for_f32_x(name):
    """K5's and K8's fakes on fake CUDA tensors: f32 x passes their checks
    (the f32 entries) and the output is f32 of x's shape."""
    args, _ = cases()[name]
    assert args[0].dtype == torch.float32
    with FakeTensorMode():
        fake = _fake_cuda(args)
        got = _op(name)(*fake)
    assert got.device.type == "cuda" and got.dtype == torch.float32
    assert tuple(got.shape) == tuple(args[0].shape)


@pytest.mark.parametrize(
    "name, index, value, error",
    [
        ("slab_layer_block", 0, "f16", NotImplementedError),  # bf16 and f32 only
        ("slab_layer_block", 8, 4, NotImplementedError),  # head_dim 32
        ("slab_attention", 0, "f16", NotImplementedError),
        ("slab_attention_block", 4, "bf16", ValueError),  # ls1 in bf16
        ("slab_mlp_block", 8, "relu", ValueError),
        ("flash_attention", 0, "f16", NotImplementedError),
        ("quant_matmul", 0, "f16", NotImplementedError),
        ("slab_layer_block_quant", 0, "f16", NotImplementedError),  # bf16 and f32 only
        ("slab_mlp_block", 0, "f16", NotImplementedError),  # bf16 and f32 only
    ],
)
def test_fake_cuda_refuses_what_the_kernel_refuses(name, index, value, error):
    """A bad argument fails on fake CUDA tensors, at export time, as the
    kernel's wrapper would refuse it on the card."""
    args = list(cases()[name][0])
    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16, "f16": torch.float16}
    if value in dtypes:
        args[index] = args[index].to(dtypes[value])
    else:
        args[index] = value
    with FakeTensorMode():
        fake = _fake_cuda(args)
        with pytest.raises(error):
            _op(name)(*fake)
