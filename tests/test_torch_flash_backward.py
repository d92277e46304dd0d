"""The port's flash attention backward (K6's plain version, the `with_lse`
forward's plain version and the autograd Functions of every kernel wrapper)
against the JAX functions on the CPU.

The JAX kernels run as the JAX package's own tests run them: Pallas in
interpret mode. Inputs come from numpy seeds; everything is f32, where the
plain versions' rounding points are no-ops and they meet the JAX kernels'
math. Tolerances: 1e-5 on the logsumexp (f32 sums in another order), 2e-5 on
gradients (two more f32 contractions over T behind the same sums).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (caps torch's threads under xdist)

from dinov2_tpu.ops import attention as jattn
from dinov2_tpu.ops import flash_attention as jfa
from dinov2_tpu.ops import fused_attention as jfused
from dinov2_tpu_torch.ops import flash_attention, fused_attention
from dinov2_tpu_torch.ops.attention import split_heads, vanilla_attention

LSE_TOL = 1e-5
GRAD_TOL = 2e-5
SCALE = 0.125
RAGGED_MULTI_TILE_T = 300  # the JAX kernels run several KV blocks at it (below)


def _qkvg(seed, b, t, heads, hd=64):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, t, heads, hd)).astype(np.float32) for _ in range(4)]


def _tensors(arrays, requires_grad=False):
    return [torch.from_numpy(a).requires_grad_(requires_grad) for a in arrays]


def _force_multi_block(monkeypatch, t):
    """Make the JAX kernels take several KV blocks at T tokens, as
    test_pallas_kernels.py does for the forward."""
    monkeypatch.setattr(jfa, "_VMEM_BUDGET", 300_000)
    _, bk, tp = jfa._pick_blocks(t, 64, 2048)
    assert tp // bk >= 2


@pytest.mark.parametrize("t", [257, RAGGED_MULTI_TILE_T])
def test_forward_reference_lse_matches_jax(monkeypatch, t):
    """`flash_forward_reference` against the JAX `with_lse` forward: out and
    the row logsumexp, which JAX keeps replicated over an 8-wide last axis of
    a (B*H, Tp, 8) array."""
    if t == RAGGED_MULTI_TILE_T:
        _force_multi_block(monkeypatch, t)
    b, heads = 2, 2
    q, k, v, _ = _qkvg(t, b, t, heads)
    want_out, want_lse = jfa._flash_forward(
        *map(jnp.asarray, (q, k, v)), SCALE, interpret=True, with_lse=True
    )
    want_lse = np.asarray(want_lse)[:, :t, 0].reshape(b, heads, t)
    out, lse = flash_attention.flash_forward_reference(*_tensors((q, k, v)), SCALE)
    assert tuple(lse.shape) == (b, heads, t) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), want_lse, rtol=LSE_TOL, atol=LSE_TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), rtol=LSE_TOL, atol=LSE_TOL)
    # out is vanilla_attention's, bit for bit: the CPU forward does not change with grad
    assert torch.equal(out, vanilla_attention(*_tensors((q, k, v)), SCALE))


@pytest.mark.parametrize("t", [257, RAGGED_MULTI_TILE_T])
def test_backward_reference_matches_jax_kernels(monkeypatch, t):
    """`flash_backward_reference` against the JAX FA-2 backward kernels
    (`_dkv_kernel`, `_dq_kernel`) in interpret mode, on the JAX forward's own
    o and lse."""
    if t == RAGGED_MULTI_TILE_T:
        _force_multi_block(monkeypatch, t)
    b, heads = 2, 2
    q, k, v, g = _qkvg(t + 1, b, t, heads)
    jq, jk, jv, jg = map(jnp.asarray, (q, k, v, g))
    o, lse = jfa._flash_forward(jq, jk, jv, SCALE, interpret=True, with_lse=True)
    want = jfa._flash_backward(jq, jk, jv, o, lse, jg, SCALE, interpret=True)
    lse_port = torch.from_numpy(np.asarray(lse)[:, :t, 0].reshape(b, heads, t).copy())
    got = flash_attention.flash_backward_reference(
        *_tensors((q, k, v)), torch.from_numpy(np.asarray(o).copy()), lse_port,
        torch.from_numpy(g), SCALE,
    )
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=name)


@pytest.mark.parametrize("t", [1, 70, 257, RAGGED_MULTI_TILE_T])
def test_backward_reference_matches_autograd_of_vanilla(t):
    """The plain K6 follows the kernels' math from lse and delta; it is not
    autograd of `vanilla_attention`, and must agree with it."""
    q, k, v = _tensors(_qkvg(t + 2, 2, t, 2)[:3], requires_grad=True)
    g = torch.from_numpy(_qkvg(t + 2, 2, t, 2)[3])
    want = torch.autograd.grad(vanilla_attention(q, k, v, SCALE), (q, k, v), g)
    with torch.no_grad():
        out, lse = flash_attention.flash_forward_reference(q, k, v, SCALE)
        got = flash_attention.flash_backward_reference(q, k, v, out, lse, g, SCALE)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), w.numpy(), rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=name)


def test_backward_reference_rounds_p_and_ds_in_bf16():
    """The rounding contract: in bf16, p and dS are rounded before the three
    products. The result stays within bf16 noise of the f32 one."""
    q, k, v, g = [torch.from_numpy(a) for a in _qkvg(5, 1, 70, 2)]
    out, lse = flash_attention.flash_forward_reference(q, k, v, SCALE)
    want = flash_attention.flash_backward_reference(q, k, v, out, lse, g, SCALE)
    bf = [a.bfloat16() for a in (q, k, v)]
    out16, lse16 = flash_attention.flash_forward_reference(*bf, SCALE)
    got = flash_attention.flash_backward_reference(*bf, out16, lse16, g.bfloat16(), SCALE)
    for a, w in zip(got, want):
        assert a.dtype == torch.bfloat16
        assert (a.float() - w).abs().max() <= 0.05 * w.abs().max()


@pytest.mark.parametrize("t", [70, 257])
def test_flash_attention_function_matches_jax_grad(t):
    """`flash_attention`'s Function (on the CPU: the plain `with_lse` forward
    and the plain K6) against jax.grad through the JAX custom_vjp, whose
    backward runs the Pallas kernels in interpret mode."""
    q, k, v, g = _qkvg(t, 2, t, 2)
    want = jax.grad(
        lambda *a: (jfa.flash_attention(*a, SCALE, 2048, True) * jnp.asarray(g)).sum(),
        argnums=(0, 1, 2),
    )(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = _tensors((q, k, v), requires_grad=True)
    out = flash_attention.flash_attention(tq, tk, tv, SCALE)
    assert out.grad_fn is not None and "FlashAttention" in type(out.grad_fn).__name__
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g))
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=name)


@pytest.mark.parametrize("t", [5, 130])
def test_flash_attention_slab_function_matches_jax_grad(t):
    """The slab entry's gradient, one (B, T, 3D) slab, against jax.grad of
    the JAX `flash_attention_slab` (Pallas forward and backward interpreted)."""
    heads = 3
    rng = np.random.default_rng(t)
    qkv = rng.standard_normal((2, t, 3 * 64 * heads)).astype(np.float32)
    g = rng.standard_normal((2, t, 64 * heads)).astype(np.float32)
    want = jax.grad(
        lambda s: (jfa.flash_attention_slab(s, heads, SCALE, 128, True) * jnp.asarray(g)).sum()
    )(jnp.asarray(qkv))
    slab = torch.from_numpy(qkv).requires_grad_()
    out = flash_attention.flash_attention_slab(slab, heads, SCALE)
    assert "FlashAttentionSlab" in type(out.grad_fn).__name__
    (got,) = torch.autograd.grad(out, slab, torch.from_numpy(g))
    assert got.shape == slab.shape and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=GRAD_TOL, atol=GRAD_TOL)


def test_flash_backward_writes_into_given_views():
    """`into` receives dq, dk and dv: the head views of one gradient slab."""
    heads, t = 2, 9
    rng = np.random.default_rng(0)
    qkv = torch.from_numpy(rng.standard_normal((1, t, 3 * 64 * heads)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((1, t, heads, 64)).astype(np.float32))
    q, k, v = split_heads(qkv, heads)
    out, lse = flash_attention.flash_forward_lse(q, k, v, SCALE)
    want = flash_attention.flash_backward(q, k, v, out, lse, g, SCALE)
    slab = torch.full_like(qkv, float("nan"))
    flash_attention.flash_backward(q, k, v, out, lse, g, SCALE, into=split_heads(slab, heads))
    assert torch.equal(slab, torch.cat([w.reshape(1, t, -1) for w in want], dim=-1))


def test_no_grad_path_has_no_graph_and_counts_nothing():
    q, k, v = _tensors(_qkvg(0, 1, 5, 1)[:3], requires_grad=True)
    before = flash_attention.flash_attention.launches, flash_attention.flash_backward.launches
    with torch.no_grad():
        assert flash_attention.flash_attention(q, k, v, SCALE).grad_fn is None
    out = flash_attention.flash_attention(q, k, v, SCALE)
    out.sum().backward()
    assert q.grad is not None
    # on CPU tensors no kernel launches, forward or backward
    assert (flash_attention.flash_attention.launches,
            flash_attention.flash_backward.launches) == before


# ---------------------------------------------------------------------------
# The recompute Functions of K1, K2, K3 and K5 against jax.grad of the JAX
# functions, whose forwards run their Pallas kernels in interpret mode
# ---------------------------------------------------------------------------

B, T, D, HEADS, EPS = 2, 37, 128, 2, 1e-6


def _half_layer_arrays(seed, dh=None):
    """x, LN scale and bias, w (D, 3D or DH), b, w2 (D or DH, D), b2, ls."""
    rng = np.random.default_rng(seed)
    wide = 3 * D if dh is None else dh
    inner = D if dh is None else dh
    return [
        rng.standard_normal((B, T, D)).astype(np.float32),
        rng.uniform(0.5, 1.5, D).astype(np.float32),
        (rng.standard_normal(D) * 0.1).astype(np.float32),
        (rng.standard_normal((D, wide)) * 0.05).astype(np.float32),
        (rng.standard_normal(wide) * 0.1).astype(np.float32),
        (rng.standard_normal((inner, D)) * 0.05).astype(np.float32),
        (rng.standard_normal(D) * 0.1).astype(np.float32),
        rng.uniform(0.1, 1.0, D).astype(np.float32),
    ]


def _compare_grads(jax_fn, torch_fn, arrays, function_name, tol=GRAD_TOL):
    """Gradients of sum(f(*arrays) * g) for every input, JAX against the port;
    the port's output must come from the named autograd Function."""
    g = np.random.default_rng(99).standard_normal((B, T, D)).astype(np.float32)
    want = jax.grad(
        lambda *a: (jax_fn(*a) * jnp.asarray(g)).sum(), argnums=tuple(range(len(arrays)))
    )(*map(jnp.asarray, arrays))
    tensors = _tensors(arrays, requires_grad=True)
    out = torch_fn(*tensors)
    assert function_name in type(out.grad_fn).__name__
    got = torch.autograd.grad(out, tensors, torch.from_numpy(g))
    for i, (a, w) in enumerate(zip(got, want)):
        assert a.dtype == tensors[i].dtype and a.shape == tensors[i].shape
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=tol, atol=tol,
                                   err_msg=f"input {i}")


def test_slab_layer_block_function_matches_jax_grad():
    """K1: every input's gradient (x, LN rows, both weights, biases, ls1)."""
    _compare_grads(
        lambda *a: jfused.slab_layer_block(*a, HEADS, SCALE, EPS, True),
        lambda *a: fused_attention.slab_layer_block(*a, HEADS, SCALE, EPS),
        _half_layer_arrays(1), "_RecomputeFunction",
    )


def test_slab_attention_block_function_matches_jax_grad():
    """K2: x, the qkv slab, w_proj, b_proj and ls1."""
    x, _, _, _, _, wp, bp, ls = _half_layer_arrays(2)
    qkv = np.random.default_rng(3).standard_normal((B, T, 3 * D)).astype(np.float32)
    _compare_grads(
        lambda *a: jfused.slab_attention_block(*a, HEADS, SCALE, True),
        lambda *a: fused_attention.slab_attention_block(*a, HEADS, SCALE),
        [x, qkv, wp, bp, ls], "_RecomputeFunction",
    )


@pytest.mark.parametrize("route", ["plain", "flash"])
def test_slab_attention_function_matches_jax_grad(monkeypatch, route):
    """K3 on both backward routes: the plain recompute, and through the
    flash Function (on the CPU: the plain `with_lse` forward and plain K6).
    JAX takes its vanilla route off the TPU; for the flash case its env knob
    sends it through the Pallas backward kernels, interpreted."""
    threshold = T + 1 if route == "plain" else T
    monkeypatch.setattr(fused_attention, "SLAB_BWD_FLASH_MIN_T", threshold)
    monkeypatch.setenv("DINOV2_TPU_SLAB_BWD", "vanilla" if route == "plain" else "flash")
    qkv = np.random.default_rng(4).standard_normal((B, T, 3 * D)).astype(np.float32)
    _compare_grads(
        lambda s: jfused.slab_attention(s, HEADS, SCALE, True),
        lambda s: fused_attention.slab_attention(s, HEADS, SCALE),
        [qkv], "_SlabAttention",
    )


def test_slab_attention_backward_routes_agree_and_refuse_unknown():
    qkv = torch.from_numpy(np.random.default_rng(5).standard_normal((1, 70, 3 * D))).float()
    g = torch.from_numpy(np.random.default_rng(6).standard_normal((1, 70, D))).float()
    plain = fused_attention.slab_attention_backward(qkv, g, HEADS, SCALE, route="plain")
    flash = fused_attention.slab_attention_backward(qkv, g, HEADS, SCALE, route="flash")
    auto = fused_attention.slab_attention_backward(qkv, g, HEADS, SCALE)
    np.testing.assert_allclose(flash.numpy(), plain.numpy(), rtol=GRAD_TOL, atol=GRAD_TOL)
    assert torch.equal(auto, plain if 70 < fused_attention.SLAB_BWD_FLASH_MIN_T else flash)
    with pytest.raises(ValueError, match="route"):
        fused_attention.slab_attention_backward(qkv, g, HEADS, SCALE, route="fast")


@pytest.mark.parametrize("activation, approximate", [("gelu_erf", False), ("gelu_tanh", True)])
def test_slab_mlp_block_function_matches_jax_grad(activation, approximate):
    """K5: every input's gradient, for the exact and the tanh GELU."""
    _compare_grads(
        lambda *a: jfused.slab_mlp_block(*a, approximate, EPS, True),
        lambda *a: fused_attention.slab_mlp_block(*a, activation, EPS),
        _half_layer_arrays(7, dh=4 * D), "_RecomputeFunction",
    )


def test_recompute_function_casts_f32_masters_like_jax():
    """bf16 activations over f32 master weights: gradients come back in each
    input's own dtype (f32 for the masters), as JAX's `w.astype(h.dtype)`
    inside the differentiated function gives them."""
    arrays = _half_layer_arrays(8)
    tensors = _tensors(arrays, requires_grad=True)
    tensors[0] = tensors[0].detach().bfloat16().requires_grad_()
    out = fused_attention.slab_layer_block(*tensors, HEADS, SCALE, EPS)
    assert out.dtype == torch.bfloat16
    grads = torch.autograd.grad(out.float().sum(), tensors)
    assert [g.dtype for g in grads] == [torch.bfloat16] + [torch.float32] * 7
    assert all(torch.isfinite(g).all() for g in grads)


def test_only_inputs_that_require_grad_get_one():
    x, lns, lnb, wq, bq, wp, bp, ls = _tensors(_half_layer_arrays(9))
    wq.requires_grad_()
    out = fused_attention.slab_layer_block(x, lns, lnb, wq, bq, wp, bp, ls, HEADS, SCALE, EPS)
    out.sum().backward()
    assert wq.grad is not None and x.grad is None and wp.grad is None


@pytest.mark.parametrize("path", ["quant_matmul", "quant_matmul_kernel", "K8", "apply_linear"])
def test_quantized_paths_refuse_inputs_that_require_grad(path):
    """No QuantLinear path may return a tensor cut from the graph: an input
    that requires grad raises (JAX: fused-quant weights aren't trainable);
    under no_grad the same call runs."""
    from dinov2_tpu_torch.models.params import quantize_linear
    from dinov2_tpu_torch.ops import qmatmul, qmatmul_kernel
    from dinov2_tpu_torch.ops.fused_quant_attention import slab_layer_block_quant

    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((1, 3, 128)).astype(np.float32)).requires_grad_()
    ql = quantize_linear(rng.standard_normal((128, 128)) * 0.05, "q4_0")
    bias = torch.zeros(128)
    if path == "quant_matmul":
        call = lambda: qmatmul.quant_matmul(x, ql, "dequant", bias)  # noqa: E731
    elif path == "quant_matmul_kernel":
        call = lambda: qmatmul_kernel.quant_matmul_kernel(x, ql, bias)  # noqa: E731
    elif path == "apply_linear":
        call = lambda: qmatmul.apply_linear(x, {"kernel": ql, "bias": bias})  # noqa: E731
    else:
        wq = quantize_linear(rng.standard_normal((384, 128)) * 0.05, "q4_0")
        rows = [torch.ones(128), torch.zeros(128)]
        call = lambda: slab_layer_block_quant(  # noqa: E731
            x, *rows, wq, torch.zeros(384), ql, bias, torch.ones(128), 2, SCALE, EPS
        )
    with pytest.raises(RuntimeError, match="aren't trainable"):
        call()
    with torch.no_grad():
        assert call().grad_fn is None
