"""f32 activations on the card's kernels, on the CPU.

The f32 kernels (csrc/f32_gemm.cuh, csrc/tf32x3_gemm.cuh,
csrc/f32_attention.cuh, csrc/f32_backward.cuh) cannot run here. What can:
the routing that sends f32 to them on a card ("auto" lands where the JAX
resolver's TPU gate lands for f32), the routes models/vit.py takes to K5
and K8 in f32 and around them in f16, the argument checks that refuse what
the kernels refuse, the 3xTF32 GEMM's walk on a dense weight
(tests/test_torch_tf32x3.py's emulation: its masks at ragged M and N, a
partial k-step, and both dense epilogues' order)
against the plain version, and the plain f32 versions the kernels are held
to on the card against the JAX functions they port. The f32 attention
tile loops are tests/test_torch_flash_tiles.py's emulations (the forward's
128-row blocks and 32-key tiles), which tests/test_torch_tf32x3.py runs with
the kernels' 3xTF32 products; K5 f32's and K8 f32's walks are
tests/test_torch_f32_mlp.py's.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (caps torch's threads under xdist)
from test_torch_tf32x3 import emulate_f32_linear

from dinov2_tpu.ops import attention as jax_attention
from dinov2_tpu.ops import flash_attention as jflash
from dinov2_tpu.ops import fused_attention as jfused
from dinov2_tpu_torch.models import vit
from dinov2_tpu_torch.models.params import quantize_linear
from dinov2_tpu_torch.ops import attention, fused_quant_attention
from dinov2_tpu_torch.ops.attention import resolve_attention_path, split_heads
from dinov2_tpu_torch.ops.flash_attention import flash_attention
from dinov2_tpu_torch.ops.fused_attention import (
    _slab_block_reference,
    slab_attention,
    slab_attention_block,
    slab_layer_block,
)

SCALE, EPS = 0.125, 1e-6
F32_ATOL = 1e-5  # forward: summation order only
F32_GRAD_ATOL = 2e-5


def _arrays(rng, *shapes, scale=1.0):
    return [(rng.standard_normal(s) * scale).astype(np.float32) for s in shapes]


# ---------------------------------------------------------------- routing

@pytest.mark.parametrize("d", [384, 768, 1024], ids=["S", "B", "L"])
@pytest.mark.parametrize("t", [257, 1370])
def test_f32_auto_route_on_a_card_is_the_jax_tpu_gate(monkeypatch, t, d):
    """f32 at head_dim 64 on "cuda" takes the kernel route the JAX resolver
    picks on a TPU for f32 (itemsize 4): the slab at 224 px, flash at 518 px."""
    monkeypatch.setattr(jax_attention.jax, "default_backend", lambda: "tpu")
    want = jax_attention.resolve_attention_path("auto", t, d, 4)
    assert want == ("slab" if t < attention.FLASH_MIN_TOKENS else "flash")
    assert resolve_attention_path("auto", t, torch.float32, 64, "cuda") == want


@pytest.mark.parametrize("dtype, head_dim", [(torch.float16, 64), (torch.float32, 32),
                                             (torch.float32, 128)])
def test_other_inputs_stay_on_the_plain_route(dtype, head_dim):
    attention._warn_vanilla_route.cache_clear()
    assert resolve_attention_path("auto", 257, dtype, head_dim, "cuda") == "vanilla"
    assert attention.vanilla_route_warnings() == 1
    attention._warn_vanilla_route.cache_clear()


# ------------------------------------------ models/vit.py around K5 and K8

@pytest.mark.parametrize("dtype, device_type, applies", [
    (torch.bfloat16, "cuda", True),
    (torch.float32, "cuda", True),  # K5 f32
    (torch.float16, "cuda", False),  # no kernel takes f16: the plain MLP
    (torch.float32, "cpu", True),  # the plain version takes any dtype
    (torch.bfloat16, "cpu", True),
])
def test_fused_mlp_takes_k5_only_where_it_applies(dtype, device_type, applies):
    assert vit.fused_mlp_applies(dtype, device_type) is applies


@pytest.mark.parametrize("mode, dtype, device_type, route", [
    ("auto", torch.float32, "cuda", "auto"),  # K8 f32
    ("auto", torch.bfloat16, "cuda", "auto"),
    ("auto", torch.float16, "cuda", "dequant"),  # no kernel takes f16
    ("auto", torch.float32, "cpu", "auto"),
    ("kernel", torch.float32, "cuda", "kernel"),  # K8 f32, no longer refused
    ("dequant", torch.float32, "cuda", "dequant"),
    ("off", torch.float32, "cuda", "off"),
])
def test_quant_slab_route_of_f32(mode, dtype, device_type, route):
    assert vit.resolve_quant_slab(mode, dtype, device_type) == route


def test_routes_around_k5_and_k8_warn_once_per_reason(caplog):
    """bf16 and f32 take K5 and K8 on a card without a word; f16 keeps the
    plain routes with one warning per reason, however many layers ask."""
    vit._warn_plain_route.cache_clear()
    with caplog.at_level(logging.WARNING, logger="dinov2_tpu_torch"):
        for _ in range(3):
            for dtype in (torch.float32, torch.bfloat16, torch.float16):
                vit.fused_mlp_applies(dtype, "cuda")
                vit.resolve_quant_slab("auto", dtype, "cuda")
    messages = [r.getMessage() for r in caplog.records if r.name == "dinov2_tpu_torch"]
    assert len(messages) == 2
    assert "K5" in messages[0] and "K8" in messages[1] and "dequant" in messages[1]
    assert all("float16" in m for m in messages)
    vit._warn_plain_route.cache_clear()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_k8_argument_check_takes_f32_and_refuses_f16(dtype):
    """An explicit quant_slab="kernel" on a card reaches K8's argument
    check: f32 and bf16 pass it (f32 is K8 f32's entry), f16 it refuses
    before anything else (the check reads metadata only, so CPU tensors
    do)."""
    d, heads = 128, 2
    rng = np.random.default_rng(0)
    x = torch.zeros((1, 5, d), dtype=dtype)
    rows = [torch.ones(n) for n in (d, d, 3 * d, d, d)]
    qkv_ql = quantize_linear(rng.standard_normal((3 * d, d)), "q4_0")
    proj_ql = quantize_linear(rng.standard_normal((d, d)), "q4_0")
    args = (x, rows[0], rows[1], qkv_ql, rows[2], proj_ql, rows[3], rows[4], heads)
    if dtype == torch.float16:
        with pytest.raises(NotImplementedError, match="bf16 or f32"):
            fused_quant_attention._check_quant_layer_args(*args, aligned=False)
    else:
        fused_quant_attention._check_quant_layer_args(*args, aligned=False)


# ------------------------------------------------- the 3xTF32 GEMM's walk

@pytest.mark.parametrize("m, k, n", [(1, 16, 4), (130, 32, 132), (257, 64, 384)])
@pytest.mark.parametrize("which", ["bias", "residual"])
def test_tf32x3_gemm_walk_matches_plain_version(m, k, n, which):
    """K1's QKV launch (acc + b_qkv) and proj launch (x + (acc + b) * ls1)
    in f32 on tf32x3_gemm.cuh (the weight split and transposed into its
    planes, then the GEMM's walk), at ragged M, N = 4 * odd and K = 16 (one
    k-step, half of it the TMA's zeros), against the plain version's
    order."""
    rng = np.random.default_rng(m + n)
    a, w, bias, ls, x = (torch.from_numpy(v) for v in _arrays(
        rng, (m, k), (k, n), (n,), (n,), (m, n)))
    if which == "bias":
        got = emulate_f32_linear(a, w, lambda acc, r, c: acc + bias[c])
        want = torch.matmul(a, w) + bias
    else:
        got = emulate_f32_linear(a, w, lambda acc, r, c: x[r, c] + (acc + bias[c]) * ls[c])
        want = x + (torch.matmul(a, w) + bias) * ls
    atol = F32_ATOL * max(1.0, want.abs().max().item())  # the card's bound: of max(1, max|y|)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=atol, rtol=0)


# ------------------------------- the plain f32 versions against JAX

@pytest.mark.parametrize("t", [5, 65])
def test_f32_half_layer_wrappers_match_jax_kernels(t):
    """K1, K2 and K3's wrappers in f32 on the CPU (their plain versions,
    what the f32 kernels are held to on the card) against the JAX
    slab_layer_block, slab_attention_block and slab_attention in f32, in
    interpret mode."""
    b, heads = 2, 2
    d = 64 * heads
    rng = np.random.default_rng(t)
    x, qkv, w_qkv, w_proj = _arrays(rng, (b, t, d), (b, t, 3 * d), (d, 3 * d), (d, d))
    w_qkv, w_proj = w_qkv * 0.05, w_proj * 0.05
    ln_scale = rng.uniform(0.5, 1.5, d).astype(np.float32)
    ln_bias, b_qkv, b_proj = (v * 0.1 for v in _arrays(rng, (d,), (3 * d,), (d,)))
    ls1 = rng.uniform(0.1, 1.0, d).astype(np.float32)
    layer = (x, ln_scale, ln_bias, w_qkv, b_qkv, w_proj, b_proj, ls1)
    block = (x, qkv, w_proj, b_proj, ls1)
    j, p = (lambda arrays: [jnp.asarray(v) for v in arrays]), (
        lambda arrays: [torch.from_numpy(v) for v in arrays])
    cases = [
        (slab_layer_block(*p(layer), heads, SCALE, EPS),
         jfused.slab_layer_block(*j(layer), heads, SCALE, EPS, True)),
        (slab_attention_block(*p(block), heads, SCALE),
         jfused.slab_attention_block(*j(block), heads, SCALE, True)),
        (slab_attention(torch.from_numpy(qkv), heads, SCALE),
         jfused.slab_attention(jnp.asarray(qkv), heads, SCALE, True)),
    ]
    for got, want in cases:
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_ATOL, rtol=0)
    # K2's plain version is the same function as K1's tail
    assert torch.equal(slab_attention_block(*p(block), heads, SCALE),
                       _slab_block_reference(*p(block), heads, SCALE))


@pytest.mark.parametrize("t", [5, 65])
def test_f32_flash_attention_and_gradients_match_jax_kernels(t):
    """K4 (the with_lse forward) and K6 in f32 on the CPU, through
    flash_attention's autograd Function, against the JAX flash_attention
    and its Pallas backward in f32, interpreted."""
    b, heads = 2, 2
    rng = np.random.default_rng(100 + t)
    qkv, g = _arrays(rng, (b, t, 3 * 64 * heads), (b, t, heads, 64))
    q, k, v = (x.contiguous().requires_grad_() for x in split_heads(
        torch.from_numpy(qkv * 1.5), heads))
    out = flash_attention(q, k, v, SCALE)
    grads = torch.autograd.grad(out, (q, k, v), torch.from_numpy(g))

    jq, jk, jv = (jnp.asarray(x.detach().numpy()) for x in (q, k, v))

    def loss(q, k, v):
        o = jflash.flash_attention(q, k, v, SCALE, interpret=True)
        return jnp.sum(o * jnp.asarray(g)), o

    (_, want), jgrads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(jq, jk, jv)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), atol=F32_ATOL, rtol=0)
    for name, got, w in zip(("dq", "dk", "dv"), grads, jgrads):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=F32_GRAD_ATOL, rtol=0,
                                   err_msg=name)
