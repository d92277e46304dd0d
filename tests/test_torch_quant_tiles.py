"""The walk of K8 on Hopper, on the CPU.

csrc/quant_layer.cu (K8, the quantized attention half-layer) cannot run
here. This file emulates its six launches in plain PyTorch, step for step,
with the GEMM emulation of tests/test_torch_gemm_tiles.py and
tests/test_torch_mlp_tiles.py:
  - both weights dequantized once into one (4D, D) scratch, qkv's rows
    first and then proj's, in the compute dtype (dequant_weight_kernel, bit
    for bit `dequant_weight`);
  - the layer norm of each row once (two-pass f32 statistics, one cast);
  - the QKV GEMM on the scratch's first 3D rows as the k-major (N, K)
    operand: 128-row tiles with the rows past M zero-filled and never
    written, 256-column tiles whose weight rows past N are zero-filled and
    whose columns past N are dropped, 64-deep k-steps in f32 in order, and
    BiasEpilogue's rounding;
  - the attention on the qkv slab (K3's plain version: the attention kernel
    is K1's and K3's, whose tile loop tests/test_torch_flash_tiles.py
    emulates);
  - the proj GEMM on the scratch's last D rows with ResidualEpilogue.
It is held against `quant_layer_reference` in f32 (summation order only)
and in bf16 (K1's bound on the card), for the five formats in both layouts
at D = 128, where 3D = 384 ends in half a column tile, and in the int8 SoA
layout at D = 192 (3D = 576), where packed planes cannot take a 64-wide
k-step; and against the JAX `slab_layer_block_quant` in interpret mode.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (caps torch's threads under xdist)
from test_torch_gemm_tiles import (
    COLS,
    EPS,
    F32_ATOL,
    SCALE,
    _held,
    bias_epilogue,
    emulate_gemm,
    emulate_layer_norm_rows,
    residual_epilogue,
)
from test_torch_mlp_tiles import FORMATS, emulate_gemm_k_major
from test_torch_quant import _jax_ql, _to_port

from dinov2_tpu.ops import fused_quant_attention as jfqa
from dinov2_tpu_torch.ops.fused_attention import _slab_reference
from dinov2_tpu_torch.ops.fused_quant_attention import quant_layer_reference
from dinov2_tpu_torch.ops.qmatmul import dequant_weight

TOKENS = [1, 37, 65, 257]  # (B = 2) M = 2, 74, 130 (a ragged second row tile), 514
# (D, layout): packed planes need D/2 % 64 == 0, so D = 192 is int8 SoA only
WIDTHS = [(128, True), (128, False), (192, False)]
# the JAX kernel's own bound against the plain version
# (tests/test_torch_quant.py::test_quant_layer_matches_jax_kernel): the same
# math with other f32 reduction orders
JAX_RTOL = JAX_ATOL = 1e-4


def emulate_dequantize_once(qkv_ql, proj_ql, dtype):
    """The two dequantize launches into one (4D, D) scratch: qkv's (3D, D)
    rows, then proj's (D, D)."""
    return torch.cat([dequant_weight(qkv_ql, dtype), dequant_weight(proj_ql, dtype)])


def emulate_quant_layer(x, ln_scale, ln_bias, qkv_ql, b_qkv, proj_ql, b_proj, ls1, heads):
    """K8's six launches; returns the output and the dequantized scratch."""
    b, t, d = x.shape
    scratch = emulate_dequantize_once(qkv_ql, proj_ql, x.dtype)
    assert scratch.shape == (4 * d, d)
    x2 = x.reshape(b * t, d)
    h = emulate_layer_norm_rows(x2, ln_scale, ln_bias, EPS)
    qkv = emulate_gemm_k_major(h, scratch[: 3 * d], bias_epilogue(b_qkv))
    attn = _slab_reference(qkv.reshape(b, t, 3 * d), heads, SCALE)
    out = emulate_gemm_k_major(attn.reshape(b * t, d), scratch[3 * d :],
                               residual_epilogue(b_proj, ls1, x2))
    return out.reshape(b, t, d), scratch


def _layer_inputs(b, t, d, fmt, packed, seed):
    """x and the f32 rows from a numpy seed; the weights through the JAX
    package's QuantLinear, as tests/test_torch_quant.py builds them."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, d)).astype(np.float32)
    rows = [rng.uniform(0.5, 1.5, d), rng.standard_normal(d) * 0.1,
            rng.standard_normal(3 * d) * 0.1, rng.standard_normal(d) * 0.1,
            rng.uniform(0.1, 1.0, d)]
    lns, lnb, bq, bp, ls = (r.astype(np.float32) for r in rows)
    jq = _jax_ql((rng.standard_normal((3 * d, d)) * 0.05).astype(np.float32), fmt, packed)
    jp = _jax_ql((rng.standard_normal((d, d)) * 0.05).astype(np.float32), fmt, packed)
    return (x, lns, lnb, bq, bp, ls), jq, jp


def _port_args(arrays, jq, jp):
    x, lns, lnb, bq, bp, ls = (torch.from_numpy(a) for a in arrays)
    return [x, lns, lnb, _to_port(jq), bq, _to_port(jp), bp, ls]


@pytest.mark.parametrize("t", TOKENS)
@pytest.mark.parametrize("d, packed", WIDTHS, ids=["d128-packed", "d128-soa", "d192-soa"])
@pytest.mark.parametrize("fmt", FORMATS)
def test_quant_layer_walk_matches_plain_version(fmt, d, packed, t):
    """K8's walk against quant_layer_reference: in f32 to summation order
    (F32_ATOL, as K1's walk), in bf16 within K1's bound on the card."""
    heads = d // 64
    arrays, jq, jp = _layer_inputs(2, t, d, fmt, packed, seed=t + d)
    args = _port_args(arrays, jq, jp)
    got, scratch = emulate_quant_layer(*args, heads)
    assert got.shape == (2, t, d) and torch.isfinite(got).all()
    # the scratch holds the dense weights quant_layer_reference computes with
    assert torch.equal(scratch[: 3 * d], dequant_weight(args[3], torch.float32))
    want = quant_layer_reference(*args, heads, SCALE, EPS)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=F32_ATOL, rtol=0)

    xb = args[0].to(torch.bfloat16)
    rest = args[1:]
    out, _ = emulate_quant_layer(xb, *rest, heads)
    assert out.dtype == torch.bfloat16
    _held(out, quant_layer_reference(xb, *rest, heads, SCALE, EPS),
          quant_layer_reference(xb.float(), *rest, heads, SCALE, EPS), f"K8 {fmt} D={d} T={t}")


@pytest.mark.parametrize("fmt", FORMATS)
def test_quant_layer_walk_matches_jax_kernel(fmt):
    """K8's walk in f32 against the TPU kernel slab_layer_block_quant in
    interpret mode at B=1, T=37, D=128 (head_dim 64, which the walk's
    attention takes), packed weights, with that kernel's own bound. One
    interpret-mode call takes ~2 s here, so the file keeps to these five."""
    d, heads = 128, 2
    arrays, jq, jp = _layer_inputs(1, 37, d, fmt, True, seed=8)
    x, lns, lnb, bq, bp, ls = arrays
    want = np.asarray(jfqa.slab_layer_block_quant(
        *map(jnp.asarray, (x, lns, lnb)), jq, jnp.asarray(bq), jp, *map(jnp.asarray, (bp, ls)),
        heads, SCALE, EPS, True))
    got, _ = emulate_quant_layer(*_port_args(arrays, jq, jp), heads)
    np.testing.assert_allclose(got.numpy(), want, rtol=JAX_RTOL, atol=JAX_ATOL)


def test_quant_layer_walk_equals_k1_walk_on_the_dequantized_weights():
    """K8's GEMMs on the k-major scratch and K1's on the same weights
    transposed are one walk: equal bits in bf16 at D = 192, whose QKV GEMM
    ends in one 64-column atom of a 256-column tile."""
    d, heads = 192, 3
    arrays, jq, jp = _layer_inputs(2, 65, d, "q5_1", False, seed=1)
    x, lns, lnb, wq, bq, wp, bp, ls = _port_args(arrays, jq, jp)
    assert (3 * d) % COLS
    xb = x.to(torch.bfloat16)
    got, scratch = emulate_quant_layer(xb, lns, lnb, wq, bq, wp, bp, ls, heads)
    x2 = xb.reshape(-1, d)
    h = emulate_layer_norm_rows(x2, lns, lnb, EPS)
    qkv = emulate_gemm(h, scratch[: 3 * d].T.contiguous(), bias_epilogue(bq))
    attn = _slab_reference(qkv.reshape(2, 65, 3 * d), heads, SCALE)
    k1 = emulate_gemm(attn.reshape(-1, d), scratch[3 * d :].T.contiguous(),
                      residual_epilogue(bp, ls, x2))
    assert torch.equal(got, k1.reshape(got.shape))
