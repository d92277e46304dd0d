"""K5 f32 and K8 f32 on Hopper, on the CPU.

The f32 entries of csrc/slab_mlp.cu (K5) and csrc/quant_layer.cu (K8) run
their GEMMs on csrc/tf32x3_gemm.cuh's 3xTF32 core and cannot run here. This
file emulates their launches step for step in plain PyTorch, with
tests/test_torch_tf32x3.py's emulations of that core (a dense weight split
and transposed into its TF32 planes; the GEMM's 128 x 128 output tiles,
rows past M, weight rows past N and columns past K zero, 32-deep chunks of
three products added to the f32 sum):
  - K5 f32: the layer norm of each row, w1's planes, fc1 with the F32Act
    epilogue (act(acc + b1), the activation on the f32 sum) into the (M,
    4D) f32 hidden buffer, w2's planes, fc2 with F32Residual (x + (acc +
    b2) * ls2); held against `slab_mlp_reference` and the JAX
    `slab_mlp_block` in f32 in interpret mode, for the three activations,
    at M = 74 and 130 (a ragged second row tile) and at widths the bf16 K5
    is not built for, D = 80 among them (fc1's K = 80: a last k-step half
    zeros);
  - K8 f32: dequant_weight_kernel<Tf32SplitRows>'s walk (a thread a 16-byte
    piece of a row's codes, each value code -> f32, * d, + m, then split),
    bit for bit the TF32 split of `dequant_weight(W, f32)` and of its
    transpose's split_tf32_t walk, for the five formats, packed and int8
    SoA; then K1 f32's six launches on those planes, bit for bit the same
    walk on the "dequant" route's weights, and held against
    `quant_layer_reference` and the JAX `slab_layer_block_quant` in f32 in
    interpret mode;
  - the model: a 2-layer f32 ViT (D = 128, 2 heads) with fuse_mlp=True,
    dense and from a q4_0 file, against the JAX forward with the same
    options (its slab_mlp_block and slab_layer_block_quant interpreted).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (caps torch's threads under xdist)
from test_torch_gemm_tiles import EPS, SCALE, emulate_layer_norm_rows
from test_torch_mlp_tiles import ACTIVATIONS, F32_ATOL_F16_GELU, FORMATS
from test_torch_quant import _jax_ql, _to_port
from test_torch_tf32x3 import emulate_f32_linear, emulate_tf32x3_gemm, split_tf32_t, tf32_split

from dinov2_tpu.io.synthetic import write_synthetic_gguf
from dinov2_tpu.models import params as jparams
from dinov2_tpu.models import vit as jvit
from dinov2_tpu.models.config import DinoConfig
from dinov2_tpu.ops import fused_attention as jfused
from dinov2_tpu.ops import fused_quant_attention as jfqa
from dinov2_tpu.ops import qmatmul as jqmatmul
from dinov2_tpu.quant.quantize import quantize_gguf
from dinov2_tpu_torch.models import params, vit
from dinov2_tpu_torch.ops.fused_attention import _slab_reference, slab_mlp_reference
from dinov2_tpu_torch.ops.fused_quant_attention import quant_layer_reference
from dinov2_tpu_torch.ops.qmatmul import apply_activation, dequant_weight

F32_ATOL = 1e-5  # summation order only
# the forward against JAX: tests/test_torch_quant.py's f32 token bound
TOKEN_ATOL, PROB_ATOL = 5e-5, 1e-6
DEQUANT_PIECE = 16  # dequant_weight_kernel: a thread's bytes of codes


def _atol(activation):
    return F32_ATOL_F16_GELU if activation == "gelu_tanh_f16" else F32_ATOL


def emulate_slab_mlp_f32(x, ln_scale, ln_bias, w1, b1, w2, b2, ls2, activation):
    """dinov2_slab_mlp_f32's five launches: LN2, w1's planes, fc1 with F32Act
    into the (M, 4D) hidden buffer, w2's planes, fc2 with F32Residual."""
    b, t, d = x.shape
    x2 = x.reshape(b * t, d)
    h = emulate_layer_norm_rows(x2, ln_scale, ln_bias, EPS)
    hidden = emulate_f32_linear(
        h, w1, lambda acc, r, c: apply_activation(acc + b1[c], activation))
    assert hidden.shape == (b * t, 4 * d) and hidden.dtype == torch.float32
    out = emulate_f32_linear(hidden, w2, lambda acc, r, c: x2[r, c] + (acc + b2[c]) * ls2[c])
    return out.reshape(b, t, d)


def _mlp_inputs(m, d, seed):
    rng = np.random.default_rng(seed)
    arrays = [
        rng.standard_normal((1, m, d)),
        rng.uniform(0.5, 1.5, d),
        rng.standard_normal(d) * 0.1,
        rng.standard_normal((d, 4 * d)) * 0.05,
        rng.standard_normal(4 * d) * 0.1,
        rng.standard_normal((4 * d, d)) * 0.05,
        rng.standard_normal(d) * 0.1,
        rng.uniform(0.1, 1.0, d),
    ]
    return [torch.from_numpy(a.astype(np.float32)) for a in arrays]


@pytest.mark.parametrize("m, d", [(74, 64), (130, 96), (74, 80)])
@pytest.mark.parametrize("activation", ACTIVATIONS)
def test_k5_f32_walk_matches_plain_version_and_jax(activation, m, d):
    """K5 f32's walk against slab_mlp_reference in f32 and the JAX
    slab_mlp_block in f32 (interpret mode). D = 64, 80 and 96 are no widths
    of the bf16 K5; at D = 96 fc1's 384 columns are three tiles and fc2's 96
    a ragged one; at D = 80 fc1's K = 80 ends in a k-step half zeros.
    gelu_tanh_f16 with F32_ATOL_F16_GELU (tests/test_torch_mlp_tiles.py says
    why)."""
    args = _mlp_inputs(m, d, seed=m + d)
    got = emulate_slab_mlp_f32(*args, activation)
    assert got.shape == args[0].shape and torch.isfinite(got).all()
    want = slab_mlp_reference(*args, activation, EPS)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=_atol(activation), rtol=0)
    kernel = np.asarray(jfused.slab_mlp_block(
        *[jnp.asarray(a.numpy()) for a in args], activation, EPS, True))
    np.testing.assert_allclose(got.numpy(), kernel, atol=_atol(activation), rtol=0)


def test_f32_gelu_tanh_f16_saturates_as_jax_does():
    """F32Act's gelu_tanh_f16 on an f32 sum is f16(gelu_tanh(f32(f16(y))))
    with round-to-nearest-even casts and no clamp: past 65504 f16(y) is
    +-inf and the result inf or NaN (-inf * 0). The plain version the
    kernel is held to gives the JAX package's f32 values bit for bit there
    and on ordinary inputs."""
    y = np.array([0.1234567, -2.5000001, 3.0, -3.0, 7.9, 65504.0, 65519.0, 65520.0, 1e6, -1e6],
                 np.float32)
    got = apply_activation(torch.from_numpy(y), "gelu_tanh_f16").numpy()
    want = np.asarray(jqmatmul.apply_activation(jnp.asarray(y), "gelu_tanh_f16"))
    np.testing.assert_array_equal(got, want)
    assert got[7] == np.inf and np.isnan(got[9])


def emulate_dequant_split(ql):
    """dequant_weight_kernel<Tf32SplitRows>'s walk on a QuantLinear (N, K):
    a thread a 16-byte piece of a row's codes, 16 int8 SoA values or 16
    packed bytes whose low nibbles are values j0..j0+15 and high nibbles
    K/2+j0..K/2+j0+15 with their 5th bits; each value code -> f32, * d, + m
    in f32, then split into the hi and lo planes, (N, K) each, where K1 f32's
    GEMM reads them."""
    n, row_bytes = ql.codes.shape
    k = row_bytes * (2 if ql.packed else 1)
    hi, lo = torch.full((n, k), float("nan")), torch.full((n, k), float("nan"))

    def store(k0, q):
        v = q.to(torch.float32) * ql.d[:, k0 // 32][:, None]
        if ql.m is not None:
            v = v + ql.m[:, k0 // 32][:, None]
        hi[:, k0 : k0 + DEQUANT_PIECE], lo[:, k0 : k0 + DEQUANT_PIECE] = tf32_split(v)

    for j0 in range(0, row_bytes, DEQUANT_PIECE):
        raw = ql.codes[:, j0 : j0 + DEQUANT_PIECE].to(torch.int32)
        if not ql.packed:
            store(j0, raw)
            continue
        for high in (0, 1):
            q = raw >> 4 if high else raw & 0xF
            if ql.qh_lo is not None:
                qh = (ql.qh_hi if high else ql.qh_lo)[:, j0 // 8 : j0 // 8 + 2].to(torch.int32)
                bits = qh[:, 0] | (qh[:, 1] << 8)
                q = q | (((bits[:, None] >> torch.arange(DEQUANT_PIECE)) & 1) << 4)
            store(j0 + high * row_bytes, q - ql.zero_point)
    return hi, lo


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "soa"])
@pytest.mark.parametrize("fmt", FORMATS)
def test_k8_f32_planes_are_the_split_of_the_dequantized_weight(fmt, packed):
    """K8 f32's dequantize launches write the TF32 split of dequant_weight(W,
    f32) bit for bit, which is what K1 f32's split_tf32_t walk makes of its
    transpose (so both run the GEMM on the same planes), at N = 160 and N =
    100, K = 128 (both planes of a packed row)."""
    for n, seed in ((160, 1), (100, 2)):
        w = (np.random.default_rng(seed).standard_normal((n, 128)) * 0.5).astype(np.float32)
        ql = _to_port(_jax_ql(w, fmt, packed))
        hi, lo = emulate_dequant_split(ql)
        assert hi.shape == lo.shape == (n, 128)
        dense = dequant_weight(ql, torch.float32)
        want = tf32_split(dense)
        assert torch.equal(hi, want[0]) and torch.equal(lo, want[1])
        split = split_tf32_t(dense.T.contiguous())
        assert torch.equal(hi, split[0]) and torch.equal(lo, split[1])


def emulate_half_layer_f32(x, ln_scale, ln_bias, qkv_planes, b_qkv, proj_planes, b_proj, ls1,
                           heads):
    """launch_f32_half_layer's six launches given each weight's TF32 planes
    (hi, lo): LN1, (qkv's planes), the QKV GEMM with F32Bias, the attention
    (K3 f32's plain version), (proj's planes), the proj GEMM with
    F32Residual."""
    b, t, d = x.shape
    x2 = x.reshape(b * t, d)
    h = emulate_layer_norm_rows(x2, ln_scale, ln_bias, EPS)
    qkv = emulate_tf32x3_gemm(h, qkv_planes, lambda acc, r, c: acc + b_qkv[c])
    attn = _slab_reference(qkv.reshape(b, t, 3 * d), heads, SCALE).reshape(b * t, d)
    out = emulate_tf32x3_gemm(attn, proj_planes,
                              lambda acc, r, c: x2[r, c] + (acc + b_proj[c]) * ls1[c])
    return out.reshape(b, t, d)


def _layer_inputs(t, fmt, packed, seed, d=128):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, t, d)).astype(np.float32)
    rows = [rng.uniform(0.5, 1.5, d), rng.standard_normal(d) * 0.1,
            rng.standard_normal(3 * d) * 0.1, rng.standard_normal(d) * 0.1,
            rng.uniform(0.1, 1.0, d)]
    lns, lnb, bq, bp, ls = (r.astype(np.float32) for r in rows)
    jq = _jax_ql((rng.standard_normal((3 * d, d)) * 0.05).astype(np.float32), fmt, packed)
    jp = _jax_ql((rng.standard_normal((d, d)) * 0.05).astype(np.float32), fmt, packed)
    return (x, lns, lnb, bq, bp, ls), jq, jp


@pytest.mark.parametrize("t", [5, 65])
@pytest.mark.parametrize("fmt, packed", [("q4_0", True), ("q5_1", True), ("q8_0", False),
                                         ("q4_1", False)])
def test_k8_f32_walk_is_the_dequant_route_and_matches_jax(fmt, packed, t):
    """K8 f32's six launches: each weight dequantized into its TF32 planes
    just before its GEMM, K1 f32's walk on them, which gives the "dequant"
    route's bits (K1 f32's walk on dequant_weight(W, f32).T, its planes made
    by split_tf32_t); within F32_ATOL of quant_layer_reference and of the
    JAX slab_layer_block_quant in f32, interpret mode (M = 10 and 130: a
    ragged second row tile)."""
    heads, d = 2, 128
    (x, lns, lnb, bq, bp, ls), jq, jp = _layer_inputs(t, fmt, packed, seed=t)
    qkv_ql, proj_ql = _to_port(jq), _to_port(jp)
    rows = [torch.from_numpy(a) for a in (x, lns, lnb, bq, bp, ls)]
    xt, lnst, lnbt, bqt, bpt, lst = rows
    planes = [emulate_dequant_split(qkv_ql), emulate_dequant_split(proj_ql)]
    assert [tuple(p[0].shape) for p in planes] == [(3 * d, d), (d, d)]
    got = emulate_half_layer_f32(xt, lnst, lnbt, planes[0], bqt, planes[1], bpt, lst, heads)
    dense = [split_tf32_t(dequant_weight(ql, torch.float32).T.contiguous())
             for ql in (qkv_ql, proj_ql)]
    assert torch.equal(got, emulate_half_layer_f32(xt, lnst, lnbt, dense[0], bqt, dense[1], bpt,
                                                   lst, heads))
    want = quant_layer_reference(xt, lnst, lnbt, qkv_ql, bqt, proj_ql, bpt, lst, heads, SCALE, EPS)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=F32_ATOL, rtol=0)
    kernel = np.asarray(jfqa.slab_layer_block_quant(
        *map(jnp.asarray, (x, lns, lnb)), jq, jnp.asarray(bq), jp, *map(jnp.asarray, (bp, ls)),
        heads, SCALE, EPS, True))
    np.testing.assert_allclose(got.numpy(), kernel, atol=F32_ATOL, rtol=0)


# ------------------------------------------------------------- the model

MODEL = DinoConfig(hidden_size=128, num_hidden_layers=2, num_attention_heads=2,
                   num_classes=4, patch_size=14, img_size=70)


@pytest.fixture(scope="module")
def model_files(tmp_path_factory):
    """The 2-layer D = 128 model, dense and in q4_0."""
    root = tmp_path_factory.mktemp("f32_mlp")
    dense = write_synthetic_gguf(root / "m.gguf", MODEL, seed=3)
    return {"dense": dense, "q4_0": quantize_gguf(dense, root / "m.q4_0.gguf", "q4_0")}


@pytest.mark.parametrize("which", ["dense", "q4_0"])
def test_f32_fuse_mlp_forward_matches_jax(model_files, which):
    """The whole f32 forward with fuse_mlp=True on the slab route, dense (K1
    and K5 plain) and from the q4_0 file in quant_mode="fused" (K8 and K5
    on the dequantized fc1/fc2, K7 for the head, all plain), against the
    JAX forward with the same options: its slab_mlp_block (and, forced,
    its slab_layer_block_quant) in interpret mode, f32."""
    x = np.random.default_rng(5).standard_normal((2, 70, 70, 3)).astype(np.float32)
    path = model_files[which]
    loaded = jparams.load_params(path, dtype=jnp.float32, quant_mode="fused")
    jopts = jvit.ModelOptions(parity="hf", compute_dtype=jnp.float32, flash_attention="slab",
                              fuse_mlp=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DINOV2_TPU_QUANT_SLAB", "kernel")
        mp.setenv("DINOV2_TPU_QUANT_BACKEND", "xla")
        jax.clear_caches()
        want = jvit.forward(loaded.params, jnp.asarray(x), loaded.config, jopts, classify=True)
        want = {k: np.asarray(v) for k, v in want.items()}
    jax.clear_caches()
    mine = params.load_params(path, dtype=torch.float32, quant_mode="fused")
    assert mine.quantized == (which == "q4_0")
    opts = vit.ModelOptions(parity="hf", compute_dtype=torch.float32, flash_attention="slab",
                            fuse_mlp=True)
    got = vit.forward(mine.params, torch.from_numpy(x), mine.config, opts, classify=True)
    for key in ("cls_token", "patch_tokens"):
        assert got[key].dtype == torch.float32
        np.testing.assert_allclose(got[key].numpy(), want[key], atol=TOKEN_ATOL, rtol=0)
    np.testing.assert_allclose(got["probs"].numpy(), want["probs"], atol=PROB_ATOL, rtol=0)
