"""The tile algebra of the Hopper flash-attention kernels, on the CPU.

csrc/flash_attention.cu (K4) and csrc/flash_backward.cu (K6) cannot run
here. This file emulates their tile loops in plain PyTorch, step for step:
blocks of 64 or 128 rows, a warpgroup per 64 rows, 64-row streamed tiles
(the f32 kernels' 128-row blocks and 32-row tiles for f32 inputs),
rows past T zero-filled and masked, the online softmax on raw scores with a
base-2 exponent (scale * log2(e) folded into one FMA), one reciprocal of the
row sum, p and dS rounded to the inputs' dtype before the second products,
dK/dV accumulated over query tiles and dQ over key tiles in order. The
emulation is held against the plain versions `flash_forward_reference` and
`flash_backward_reference`, so that a wrong mask, a wrong rescale or a wrong
exponent base shows before any time on a card is spent.

It also holds the routing repair (`resolve_attention_path` with the
activation dtype, head_dim and device type) and three `Trainer.step`s in
bf16 compute over f32 masters against the JAX trainer.
"""

import logging
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (caps torch's threads under xdist)

from dinov2_tpu.models.config import DinoConfig as JaxDinoConfig
from dinov2_tpu.models.params import init_params as jax_init_params
from dinov2_tpu.models.vit import ModelOptions as JaxModelOptions
from dinov2_tpu.ops import attention as jax_attention
from dinov2_tpu.parallel.train import make_trainer as jax_make_trainer
from dinov2_tpu_torch.models.config import DinoConfig
from dinov2_tpu_torch.models.params import params_from_numpy
from dinov2_tpu_torch.models.vit import ModelOptions
from dinov2_tpu_torch.ops import attention
from dinov2_tpu_torch.ops.attention import resolve_attention_path, split_heads
from dinov2_tpu_torch.ops.flash_attention import (
    flash_backward_reference,
    flash_forward_reference,
)
from dinov2_tpu_torch.parallel.train import make_trainer

TILE = 64  # rows of a warpgroup and of a streamed tile
F32_FORWARD_TILES = (128, 32)  # csrc/f32_attention.cuh: a block's queries, a streamed tile's keys
LOG2E = 1.4426950408889634
SCALE = 0.125
RAGGED_T = (1, 63, 64, 65, 127, 128, 129, 257, 300)
# f32: the emulation and the plain version differ by summation order and the
# exponent's base only (tests/test_torch_flash_backward.py's tolerances)
F32_FORWARD_ATOL = 1e-5
F32_BACKWARD_ATOL = 2e-5


def _tile(x: torch.Tensor, r0: int, n: int = TILE) -> torch.Tensor:
    """Rows r0..r0+n-1 of (B, T, H, 64) x as (B, H, n, 64) f32, rows past T
    zero-filled, as the kernels' cp.async fills a shared tile."""
    rows = x[:, r0 : r0 + n].permute(0, 2, 1, 3).float()
    return torch.nn.functional.pad(rows, (0, 0, 0, n - rows.shape[2]))


def _rounded(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x rounded to the operand dtype of a second product, as f32 values."""
    return x.to(dtype).float()


def emulate_forward(q, k, v, scale, block_rows, key_rows=TILE, product=None):
    """K4's loops: (out, lse) of (B, T, H, 64) q, k, v. Blocks of block_rows
    queries, a warpgroup per 64, streamed tiles of key_rows keys. By default
    s = q k^T takes the inputs as they are and p is rounded to the inputs'
    dtype for P.V (the bf16 kernel); `product(a, b)` instead multiplies both
    operand pairs as a kernel does (K4 f32's 3xTF32,
    tests/test_torch_tf32x3.py). Each tile's P.V is a chunk folded in as
    o * alpha + chunk."""
    b, t, heads, _ = q.shape
    out = torch.empty((b, t, heads, 64), dtype=q.dtype)
    lse = torch.empty((b, heads, t), dtype=torch.float32)
    scale_log2 = np.float32(scale * LOG2E)
    first = product or (lambda a, c: a @ c)
    second = product or (lambda a, c: _rounded(a, q.dtype) @ c)
    for block in range(0, t, block_rows):
        for q0 in range(block, block + block_rows, TILE):  # one warpgroup each
            if q0 >= t:
                continue  # the warpgroup's rows all lie past T: it writes nothing
            q_tile = _tile(q, q0)
            o = torch.zeros((b, heads, TILE, 64))
            m = torch.full((b, heads, TILE), -math.inf)
            l = torch.zeros((b, heads, TILE))
            for k0 in range(0, t, key_rows):
                s = first(q_tile, _tile(k, k0, key_rows).transpose(-1, -2))
                if k0 + key_rows > t:
                    s[..., t - k0 :] = -math.inf
                m_new = torch.maximum(m, s.amax(dim=-1))
                alpha = torch.exp2((m - m_new) * scale_log2)
                p = torch.exp2(s * scale_log2 - (m_new * scale_log2)[..., None])
                l = l * alpha + p.sum(dim=-1)
                o = o * alpha[..., None] + second(p, _tile(v, k0, key_rows))
                m = m_new
            rows = min(TILE, t - q0)
            result = o * (1.0 / l)[..., None]
            out[:, q0 : q0 + rows] = result[:, :, :rows].permute(0, 2, 1, 3).to(q.dtype)
            lse[:, :, q0 : q0 + rows] = (m * scale + torch.log(l.clamp_min(1e-30)))[..., :rows]
    return out, lse


def emulate_backward(q, k, v, o, lse, g, scale, block_rows, stream_rows=TILE, product=None):
    """K6's loops: (dq, dk, dv); p and dS in f32. Blocks of block_rows keys
    (dK/dV) or queries (dQ), a warpgroup per 64, stream tiles of
    stream_rows queries (keys). By default the first products take the
    inputs as they are and p and dS are rounded to the inputs' dtype for
    the second (the bf16 kernel); `product(a, b)` instead multiplies every
    operand pair as a kernel does (K6 f32's 3xTF32, tests/test_torch_tf32x3.py),
    each tile's product a chunk added to the running sums."""
    b, t, heads, _ = q.shape
    dq, dk, dv = (torch.empty((b, t, heads, 64), dtype=q.dtype) for _ in range(3))
    delta = (g.float() * o.float()).sum(dim=-1).permute(0, 2, 1)  # the prologue kernel
    scale_log2 = np.float32(scale * LOG2E)
    first = product or (lambda a, c: a @ c)
    second = product or (lambda a, c: _rounded(a, q.dtype) @ c)

    def stats(x, r0, n):  # (B, H, n) rows of lse or delta, 0 past T
        rows = x[:, :, r0 : r0 + n]
        return torch.nn.functional.pad(rows, (0, n - rows.shape[2]))

    def valid(r0, n=TILE):  # (n,) which rows of a tile lie below T
        return torch.arange(r0, r0 + n) < t

    def store(dst, acc, r0):
        rows = min(TILE, t - r0)
        dst[:, r0 : r0 + rows] = acc[:, :, :rows].permute(0, 2, 1, 3).to(dst.dtype)

    n = stream_rows
    # the dK/dV kernel: a warpgroup owns 64 keys, loops over the query tiles,
    # and works on the transposed tiles s^T = K Q^T, dP^T = V dO^T
    for block in range(0, t, block_rows):
        for k0 in range(block, min(block + block_rows, t), TILE):
            k_tile, v_tile = _tile(k, k0), _tile(v, k0)
            dk_acc = torch.zeros((b, heads, TILE, 64))
            dv_acc = torch.zeros((b, heads, TILE, 64))
            for q0 in range(0, t, n):
                q_tile, do_tile = _tile(q, q0, n), _tile(g, q0, n)
                st = first(k_tile, q_tile.transpose(-1, -2))
                dpt = first(v_tile, do_tile.transpose(-1, -2))
                neg_lse = -stats(lse, q0, n) * np.float32(LOG2E)
                pt = torch.exp2(st * scale_log2 + neg_lse[:, :, None, :])
                pt = pt * (valid(k0)[:, None] & valid(q0, n)[None, :])
                dst = pt * (dpt - stats(delta, q0, n)[:, :, None, :]) * scale
                dv_acc += second(pt, do_tile)
                dk_acc += second(dst, q_tile)
            store(dk, dk_acc, k0)
            store(dv, dv_acc, k0)
    # the dQ kernel: a warpgroup owns 64 queries and loops over the key tiles
    for block in range(0, t, block_rows):
        for q0 in range(block, min(block + block_rows, t), TILE):
            q_tile, do_tile = _tile(q, q0), _tile(g, q0)
            neg_lse = -stats(lse, q0, TILE) * np.float32(LOG2E)
            d = stats(delta, q0, TILE)
            dq_acc = torch.zeros((b, heads, TILE, 64))
            for k0 in range(0, t, n):
                k_tile, v_tile = _tile(k, k0, n), _tile(v, k0, n)
                s = first(q_tile, k_tile.transpose(-1, -2))
                dp = first(do_tile, v_tile.transpose(-1, -2))
                p = torch.exp2(s * scale_log2 + neg_lse[..., None])
                p = p * (valid(q0)[:, None] & valid(k0, n)[None, :])
                ds = p * (dp - d[..., None]) * scale
                dq_acc += second(ds, k_tile)
            store(dq, dq_acc, q0)
    return dq, dk, dv


def _inputs(t, heads, slab, dtype, seed):
    """q, k, v as (B, T, H, 64) tensors, contiguous or the head views of one
    (B, T, 3D) slab, and an output gradient; from numpy, as every port test."""
    rng = np.random.default_rng(seed)
    b = 2
    qkv = torch.from_numpy(rng.standard_normal((b, t, 3 * 64 * heads)) * 1.5).to(dtype)
    g = torch.from_numpy(rng.standard_normal((b, t, heads, 64))).to(dtype)
    q, k, v = split_heads(qkv, heads)
    if not slab:
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    return q, k, v, g


def _held(got, plain, want, what):
    """The card's rule (chip_smoke.py::check_kernel): in bf16 the tile loops
    may be twice as far from f32 as the plain version, plus 1e-3 of the
    output's scale; 1e-5 more where the exact result is 0 (dq, dk at T=1)."""
    err = (got.float() - want).abs().max().item()
    err_plain = (plain.float() - want).abs().max().item()
    bound = 2 * err_plain + 1e-3 * want.abs().max().item() + 1e-5
    assert err <= bound, (what, err, err_plain, bound)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("slab", [False, True], ids=["contiguous", "slab"])
@pytest.mark.parametrize("heads", [1, 3, 12, 24])  # 12 and 24: K3's shapes (ViT-B, ViT-g)
@pytest.mark.parametrize("t", RAGGED_T)
def test_forward_tile_loops_match_plain_version(t, heads, slab, dtype):
    q, k, v, _ = _inputs(t, heads, slab, dtype, seed=t + heads)
    want, want_lse = flash_forward_reference(q.float(), k.float(), v.float(), SCALE)
    plain, _ = flash_forward_reference(q, k, v, SCALE)
    # bf16: 64- or 128-row blocks, 64-key tiles; f32: f32_attention.cuh's
    # 128-row blocks and 32-key tiles
    walks = [(64, TILE), (128, TILE)] if dtype == torch.bfloat16 else [F32_FORWARD_TILES]
    for block_rows, key_rows in walks:
        out, lse = emulate_forward(q, k, v, SCALE, block_rows, key_rows)
        assert out.dtype == dtype and out.shape == q.shape and lse.shape == (2, heads, t)
        np.testing.assert_allclose(lse.numpy(), want_lse.numpy(), atol=F32_FORWARD_ATOL, rtol=0)
        if dtype == torch.float32:
            np.testing.assert_allclose(out.numpy(), want.numpy(), atol=F32_FORWARD_ATOL, rtol=0)
        else:
            _held(out, plain, want, f"out, {block_rows}-row blocks")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("slab", [False, True], ids=["contiguous", "slab"])
@pytest.mark.parametrize("heads", [1, 3])
@pytest.mark.parametrize("t", RAGGED_T)
def test_backward_tile_loops_match_plain_version(t, heads, slab, dtype):
    q, k, v, g = _inputs(t, heads, slab, dtype, seed=100 + t + heads)
    out32, lse32 = flash_forward_reference(q.float(), k.float(), v.float(), SCALE)
    want = flash_backward_reference(q.float(), k.float(), v.float(), out32, lse32, g.float(), SCALE)
    out, lse = flash_forward_reference(q, k, v, SCALE)
    plain = flash_backward_reference(q, k, v, out, lse, g, SCALE)
    for block_rows in (64, 128):
        got = emulate_backward(q, k, v, out, lse, g, SCALE, block_rows)
        for name, a, p, w in zip(("dq", "dk", "dv"), got, plain, want):
            assert a.dtype == dtype and a.shape == q.shape
            if dtype == torch.float32:
                np.testing.assert_allclose(a.numpy(), w.numpy(), atol=F32_BACKWARD_ATOL, rtol=0,
                                           err_msg=name)
            else:
                _held(a, p, w, f"{name}, {block_rows}-row blocks")


# ---------------------------------------------------------------- routing

@pytest.mark.parametrize(
    ("flash", "t", "dtype", "head_dim", "device_type", "route"),
    [
        # "auto" on a card: bf16 and f32 at head_dim 64 take the kernels, what
        # the kernels do not take goes to the plain route
        ("auto", 257, torch.float32, 64, "cuda", "slab"),
        ("auto", 1370, torch.float32, 64, "cuda", "flash"),
        ("auto", 257, torch.float16, 64, "cuda", "vanilla"),
        ("auto", 257, torch.bfloat16, 32, "cuda", "vanilla"),
        ("auto", 1370, torch.bfloat16, 128, "cuda", "vanilla"),
        ("auto", 257, torch.bfloat16, 64, "cuda", "slab"),
        ("auto", 1370, torch.bfloat16, 64, "cuda", "flash"),
        # on the CPU the plain versions take any input
        ("auto", 257, torch.float32, 64, "cpu", "slab"),
        ("auto", 1370, torch.float32, 32, "cpu", "flash"),
        ("auto", 257, None, None, None, "slab"),
        # explicit routes select themselves whatever the input
        ("slab", 257, torch.float32, 64, "cuda", "slab"),
        ("flash", 257, torch.float32, 32, "cuda", "flash"),
        (True, 257, torch.float32, 64, "cuda", "flash"),
        ("vanilla", 1370, torch.bfloat16, 64, "cuda", "vanilla"),
        (False, 1370, torch.bfloat16, 64, "cuda", "vanilla"),
    ],
)
def test_resolve_attention_path_by_dtype_head_dim_and_device(
    flash, t, dtype, head_dim, device_type, route
):
    assert resolve_attention_path(flash, t, dtype, head_dim, device_type) == route


def test_auto_route_of_f32_lands_where_the_jax_resolver_lands(monkeypatch):
    """f32 on a card lands where the JAX resolver's TPU gate lands for f32
    (itemsize 4): the slab for ViT-S/B/L at 224 px (fits_slab(257, D, 4)),
    flash at 518 px (T=1370, past the slab budget)."""
    monkeypatch.setattr(jax_attention.jax, "default_backend", lambda: "tpu")
    for t in (257, 1370):
        for d in (384, 768, 1024):
            want = jax_attention.resolve_attention_path("auto", t, d, 4)
            assert want == ("slab" if t == 257 else "flash"), (t, d)
            assert resolve_attention_path("auto", t, torch.float32, 64, "cuda") == want


def test_auto_route_warns_once_per_reason(caplog):
    attention._warn_vanilla_route.cache_clear()
    with caplog.at_level(logging.WARNING, logger="dinov2_tpu_torch"):
        for _ in range(3):
            resolve_attention_path("auto", 257, torch.float16, 64, "cuda")
        resolve_attention_path("auto", 1370, torch.bfloat16, 32, "cuda")
        resolve_attention_path("auto", 257, torch.bfloat16, 64, "cuda")
        resolve_attention_path("auto", 257, torch.float32, 64, "cuda")
        resolve_attention_path("slab", 257, torch.float16, 64, "cuda")
    messages = [r.getMessage() for r in caplog.records if r.name == "dinov2_tpu_torch"]
    assert len(messages) == 2
    assert "torch.float16" in messages[0] and "vanilla" in messages[0]
    assert "head_dim is 32" in messages[1]
    attention._warn_vanilla_route.cache_clear()


# ------------------------------------------- bf16 compute over f32 masters

TINY = dict(hidden_size=128, num_hidden_layers=2, num_attention_heads=2, num_classes=5,
            patch_size=14, img_size=28)
# The port rounds a master weight to bf16 and multiplies in bf16
# (dinov2_tpu_torch/ops/qmatmul.py::apply_linear); the JAX package promotes
# the bf16 activation to the f32 weight (dinov2_tpu/ops/qmatmul.py). Read on
# the tiny config: losses within 9.8e-4 over three steps.
BF16_LOSS_TOL = 2e-3


@pytest.mark.parametrize("route", ["auto", True, False], ids=["auto", "flash", "vanilla"])
def test_three_bf16_trainer_steps_match_jax(route):
    """Three `Trainer.step`s in bf16 compute over f32 master weights, the
    mode every training number from the card is taken in, against the JAX
    trainer with the same options, parameters and batch."""
    jconfig = JaxDinoConfig(**TINY)
    jparams = jax_init_params(jconfig, seed=2, dtype=jnp.float32)
    rng = np.random.default_rng(3)
    images = rng.integers(0, 256, (4, 32, 32, 3), dtype=np.uint8)
    labels = rng.integers(0, TINY["num_classes"], 4)
    jopts = JaxModelOptions(parity="hf", compute_dtype=jnp.bfloat16, remat=True,
                            flash_attention=route)
    opts = ModelOptions(parity="hf", compute_dtype=torch.bfloat16, remat=True,
                        flash_attention=route)
    jtrainer = jax_make_trainer(jconfig, learning_rate=1e-4, opts=jopts)
    trainer = make_trainer(DinoConfig(**TINY), learning_rate=1e-4, opts=opts, device="cpu")
    params, opt_state = trainer.place(
        params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams))
    )
    assert all(leaf.dtype == torch.float32 for leaf in jax.tree_util.tree_leaves(params))
    jstate = jtrainer.place(jparams)
    losses = []
    for _ in range(3):
        params, opt_state, metrics = trainer.step(params, opt_state, images, labels)
        *jstate, jmetrics = jtrainer.step(*jstate, images, labels)
        losses.append((float(metrics["loss"]), float(jmetrics["loss"])))
    for got, want in losses:
        assert math.isfinite(got) and abs(got - want) <= BF16_LOSS_TOL, losses
