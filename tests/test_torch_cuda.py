"""The port's hand-written CUDA kernels against their plain PyTorch versions,
their autograd Functions and a trainer step per route, on the card. Every test here is marked `cuda` and skips without a GPU.

The GPU machine has no jax, and tests/conftest.py imports it, so run there:

    python -m pytest -p no:cacheprovider --noconftest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from dinov2_tpu_torch.io.synthetic import write_synthetic_gguf
from dinov2_tpu_torch.models.config import DinoConfig
from dinov2_tpu_torch.ops.attention import split_heads, vanilla_attention
from dinov2_tpu_torch.ops.flash_attention import flash_attention, flash_attention_slab
from dinov2_tpu_torch.ops.fused_attention import (
    _slab_block_reference,
    _slab_reference,
    slab_attention,
    slab_attention_block,
    slab_layer_block,
    slab_layer_buffers,
    slab_layer_reference,
    slab_mlp_block,
    slab_mlp_reference,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from dinov2_tpu_torch.ops.qmatmul import set_cuda_matmul_precision

    set_cuda_matmul_precision()
    return torch.device("cuda")


def _half_layer_args(b, t, d, seed, device):
    rng = np.random.default_rng(seed)
    arrays = [
        (rng.standard_normal((b, t, d)), torch.bfloat16),
        (rng.uniform(0.5, 1.5, d), torch.float32),
        (rng.standard_normal(d) * 0.1, torch.float32),
        (rng.standard_normal((d, 3 * d)) * 0.05, torch.bfloat16),
        (rng.standard_normal(3 * d) * 0.1, torch.float32),
        (rng.standard_normal((d, d)) * 0.05, torch.bfloat16),
        (rng.standard_normal(d) * 0.1, torch.float32),
        (rng.uniform(0.1, 1.0, d), torch.float32),
    ]
    return [torch.from_numpy(a).to(device, dt) for a, dt in arrays]


@pytest.mark.parametrize(
    "b, t, heads",
    [(1, 1, 1), (2, 5, 2), (2, 37, 4), (3, 64, 2), (3, 65, 2), (2, 257, 12), (1, 1370, 6)],
)
def test_slab_layer_kernel_matches_plain(cuda, b, t, heads):
    """K1 against the plain version in bf16 and in f32 on the same
    bf16-rounded inputs: the kernel may be at most twice as far from f32 as
    the plain bf16 version, plus 1e-3 of the output's scale (the kernel
    rounds unnormalized probabilities, the plain version normalized ones).
    T covers one row, ragged key tiles, an exact tile and many tiles."""
    d = 64 * heads
    args = _half_layer_args(b, t, d, seed=t, device=cuda)
    got = slab_layer_block(*args, heads, 0.125, 1e-6)
    plain = slab_layer_reference(*args, heads, 0.125, 1e-6)
    want = slab_layer_reference(*[a.float() for a in args], heads, 0.125, 1e-6)
    torch.cuda.synchronize()
    assert got.shape == (b, t, d) and got.dtype == torch.bfloat16
    assert torch.isfinite(got).all()
    err = (got.float() - want).abs().max().item()
    err_plain = (plain.float() - want).abs().max().item()
    assert err <= 2 * err_plain + 1e-3 * want.abs().max().item()


def test_launch_counter_counts_kernel_calls_only(cuda):
    args = _half_layer_args(2, 37, 128, seed=0, device=cuda)
    before = slab_layer_block.launches
    slab_layer_block(*args, 2, 0.125, 1e-6)
    slab_layer_block(*args, 2, 0.125, 1e-6)
    slab_layer_reference(*args, 2, 0.125, 1e-6)
    slab_layer_block(*[a.cpu() for a in args], 2, 0.125, 1e-6)
    assert slab_layer_block.launches == before + 2


def test_kernel_refuses_f32_activations(cuda):
    args = _half_layer_args(1, 5, 64, seed=0, device=cuda)
    args[0] = args[0].float()
    with pytest.raises(NotImplementedError, match="bf16"):
        slab_layer_block(*args, 1, 0.125, 1e-6)


def test_engine_on_cuda_close_to_cpu_f32(cuda, tmp_path):
    """DinoEngine bf16 on the card against the same checkpoint in f32 on the
    CPU; the relative probs bound is that of the CPU bf16 slice test."""
    from dinov2_tpu_torch.runtime.engine import DinoEngine

    config = DinoConfig(hidden_size=128, num_hidden_layers=2, num_attention_heads=2,
                        num_classes=4, patch_size=14, img_size=70)
    path = write_synthetic_gguf(tmp_path / "tiny.gguf", config, seed=3)
    imgs = np.random.default_rng(0).integers(0, 256, (3, 90, 100, 3), dtype=np.uint8)
    gpu = DinoEngine(path, dtype=torch.bfloat16, device="cuda")
    before = slab_layer_block.launches
    got = gpu.classify_probs(imgs)
    assert slab_layer_block.launches == before + config.num_hidden_layers
    want = DinoEngine(path, dtype=torch.float32, device="cpu").classify_probs(imgs)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-2, atol=0)


def _slab(b, t, heads, seed, device, dtype=torch.bfloat16, hd=64):
    """A (B, T, 3*H*hd) qkv slab of N(0, 1.5²) values: peaked softmax rows."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal((b, t, 3 * heads * hd)) * 1.5).to(device, dtype)


@pytest.mark.parametrize("entry", ["flash_attention", "flash_attention_slab"])
@pytest.mark.parametrize(
    "b, t, heads", [(1, 1, 1), (2, 5, 2), (3, 64, 2), (2, 65, 3), (1, 1370, 4), (1, 4500, 2)]
)
def test_flash_attention_kernel_matches_plain(cuda, entry, b, t, heads):
    """K4 against the plain version in bf16 and in f32 on the same bf16
    inputs, with K1's bound (the kernel at most twice as far from f32 as the
    plain bf16 version, plus 1e-3 of the output's scale). T covers one row,
    ragged tiles, an exact tile, the 518 px sequence and one past 4096 keys
    (70 key tiles of online softmax), through both entries: the slab's
    strided views and contiguous (B, T, H, 64) tensors."""
    qkv = _slab(b, t, heads, seed=t, device=cuda)
    q, k, v = split_heads(qkv, heads)
    if entry == "flash_attention":
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        got = flash_attention(q, k, v, 0.125)
    else:
        got = flash_attention_slab(qkv, heads, 0.125).reshape(b, t, heads, 64)
    plain = vanilla_attention(q, k, v, 0.125)
    want = vanilla_attention(q.float(), k.float(), v.float(), 0.125)
    torch.cuda.synchronize()
    assert got.shape == (b, t, heads, 64) and got.dtype == torch.bfloat16
    assert got.is_contiguous() and torch.isfinite(got).all()
    err = (got.float() - want).abs().max().item()
    err_plain = (plain.float() - want).abs().max().item()
    assert err <= 2 * err_plain + 1e-3 * want.abs().max().item()


def test_flash_launch_counter_counts_kernel_calls_only(cuda):
    qkv = _slab(2, 37, 2, seed=0, device=cuda)
    q, k, v = split_heads(qkv, 2)
    before = flash_attention.launches
    flash_attention(q, k, v, 0.125)
    flash_attention_slab(qkv, 2, 0.125)
    vanilla_attention(q, k, v, 0.125)
    flash_attention_slab(qkv.cpu(), 2, 0.125)
    assert flash_attention.launches == before + 2


@pytest.mark.parametrize("case", ["f32", "head_dim 32"])
def test_flash_kernel_refuses(cuda, case):
    if case == "f32":
        qkv, heads = _slab(1, 5, 2, seed=0, device=cuda, dtype=torch.float32), 2
    else:
        qkv, heads = _slab(1, 5, 2, seed=0, device=cuda, hd=32), 2
    before = flash_attention.launches
    with pytest.raises(NotImplementedError):
        flash_attention_slab(qkv, heads, 0.125)
    assert flash_attention.launches == before


def test_engine_features_on_cuda_close_to_cpu_f32(cuda, tmp_path):
    """DinoEngine.extract_features and PCA in bf16 on the card, on the flash
    route, against the same checkpoint in f32 on the CPU: tokens within
    K1's bf16 bound of 5e-2 of max|token| (chip_smoke.py)."""
    from dinov2_tpu_torch.runtime.engine import DinoEngine

    config = DinoConfig(hidden_size=128, num_hidden_layers=2, num_attention_heads=2,
                        num_classes=0, patch_size=14, img_size=70)
    path = write_synthetic_gguf(tmp_path / "tiny.gguf", config, seed=3)
    imgs = np.random.default_rng(0).integers(0, 256, (3, 90, 100, 3), dtype=np.uint8)
    gpu = DinoEngine(path, dtype=torch.bfloat16, flash_attention=True, device="cuda")
    k1, k4 = slab_layer_block.launches, flash_attention.launches
    got = gpu.extract_features(imgs)
    assert flash_attention.launches == k4 + config.num_hidden_layers
    assert slab_layer_block.launches == k1
    cpu = DinoEngine(path, dtype=torch.float32, flash_attention=True, device="cpu")
    want = cpu.extract_features(imgs)
    assert got["grid"] == want["grid"] == (7, 8)
    for key in ("cls_token", "patch_tokens"):
        assert got[key].shape == want[key].shape and np.isfinite(got[key]).all()
        scale = np.abs(want[key]).max()
        assert np.abs(got[key] - want[key]).max() <= 5e-2 * scale
    vis = gpu.pca_visualizations(list(imgs))
    assert [v.shape for v in vis] == [(90, 100, 3)] * 3 and vis[0].dtype == np.uint8
    frame = gpu.pca_visualization_async(imgs[0])
    assert frame.is_cuda and frame.dtype == torch.uint8 and tuple(frame.shape) == (1, 7, 8, 3)


QUANT_FORMATS = ["q4_0", "q4_1", "q5_0", "q5_1", "q8_0"]


def _ql(fmt, n, k, seed, device, packed=True, scale=0.05):
    from dinov2_tpu_torch.models.params import quantize_linear

    w = np.random.default_rng(seed).standard_normal((n, k)).astype(np.float32) * scale
    return quantize_linear(w, fmt, packed, device)


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("fmt", QUANT_FORMATS)
def test_quant_matmul_kernel_dequantizes_exactly(cuda, fmt, packed):
    """Through an identity input K7's output is its dequantized weight:
    bit for bit dequant_weight's, in bf16 and in f32."""
    from dinov2_tpu_torch.ops.qmatmul import dequant_weight
    from dinov2_tpu_torch.ops.qmatmul_kernel import quant_matmul_kernel

    ql = _ql(fmt, 200, 256, seed=1, device=cuda, packed=packed, scale=0.5)
    for dtype in (torch.bfloat16, torch.float32):
        got = quant_matmul_kernel(torch.eye(256, dtype=dtype, device=cuda), ql)
        assert torch.equal(got, dequant_weight(ql, dtype).T)


@pytest.mark.parametrize(
    "m, k, n, activation, dtype, packed",
    [
        (300, 256, 200, "gelu_tanh_f16", torch.bfloat16, True),
        (65, 256, 1000, "gelu_erf", torch.bfloat16, False),  # the head's N edge
        (130, 128, 33, "gelu_tanh", torch.bfloat16, True),  # odd N: scalar stores
        (1, 384, 64, None, torch.bfloat16, True),
        (64, 1536, 1000, None, torch.float32, True),  # the f32 classifier head
        (77, 256, 70, "gelu_erf", torch.float32, False),
    ],
)
@pytest.mark.parametrize("fmt", QUANT_FORMATS)
def test_quant_matmul_kernel_matches_plain(cuda, fmt, m, k, n, activation, dtype, packed):
    """K7 against its plain version in x's dtype and in f32 on the same
    inputs, with K1's bound (at most twice the plain version's distance from
    f32, plus 1e-3 of the output's scale); f32 x holds 1e-5 of that scale."""
    from dinov2_tpu_torch.ops.qmatmul_kernel import quant_matmul_kernel, quant_matmul_reference

    ql = _ql(fmt, n, k, seed=m, device=cuda, packed=packed)
    rng = np.random.default_rng(k)
    x = torch.from_numpy(rng.standard_normal((m, k))).to(cuda, dtype)
    bias = torch.from_numpy(rng.standard_normal(n) * 0.1).to(cuda, torch.float32)
    got = quant_matmul_kernel(x, ql, bias, activation)
    plain = quant_matmul_reference(x, ql, bias, activation)
    want = quant_matmul_reference(x.float(), ql, bias, activation)
    torch.cuda.synchronize()
    assert got.shape == (m, n) and got.dtype == dtype and torch.isfinite(got).all()
    err = (got.float() - want).abs().max().item()
    scale = want.abs().max().item()
    if dtype == torch.float32:
        assert err <= 1e-5 * scale
    else:
        assert err <= 2 * (plain.float() - want).abs().max().item() + 1e-3 * scale


@pytest.mark.parametrize("b, t, heads", [(1, 1, 2), (2, 37, 2), (3, 65, 4), (2, 257, 12)])
@pytest.mark.parametrize("fmt, packed", [(f, True) for f in QUANT_FORMATS] + [("q4_1", False)])
def test_quant_layer_kernel_matches_plain(cuda, fmt, packed, b, t, heads):
    """K8 against its plain version with K1's bound, and bit for bit K1 on
    the dequantized weights (the two differ only in their weight loader)."""
    from dinov2_tpu_torch.ops.fused_quant_attention import (
        quant_layer_reference,
        slab_layer_block_quant,
    )
    from dinov2_tpu_torch.ops.qmatmul import dequant_weight

    d = 64 * heads
    x, lns, lnb, _, bq, _, bp, ls = _half_layer_args(b, t, d, seed=t, device=cuda)
    wq = _ql(fmt, 3 * d, d, seed=1, device=cuda, packed=packed)
    wp = _ql(fmt, d, d, seed=2, device=cuda, packed=packed)
    got = slab_layer_block_quant(x, lns, lnb, wq, bq, wp, bp, ls, heads, 0.125, 1e-6)
    plain = quant_layer_reference(x, lns, lnb, wq, bq, wp, bp, ls, heads, 0.125, 1e-6)
    want = quant_layer_reference(x.float(), lns, lnb, wq, bq, wp, bp, ls, heads, 0.125, 1e-6)
    dense = [dequant_weight(w, torch.bfloat16).T.contiguous() for w in (wq, wp)]
    k1 = slab_layer_block(x, lns, lnb, dense[0], bq, dense[1], bp, ls, heads, 0.125, 1e-6)
    torch.cuda.synchronize()
    assert got.shape == (b, t, d) and torch.isfinite(got).all()
    err = (got.float() - want).abs().max().item()
    assert err <= 2 * (plain.float() - want).abs().max().item() + 1e-3 * want.abs().max().item()
    assert torch.equal(got, k1)


def test_quant_launch_counters_count_kernel_calls_only(cuda):
    from dinov2_tpu_torch.ops.fused_quant_attention import (
        quant_layer_reference,
        slab_layer_block_quant,
    )
    from dinov2_tpu_torch.ops.qmatmul_kernel import quant_matmul_kernel, quant_matmul_reference

    ql = _ql("q4_0", 64, 128, seed=0, device=cuda)
    x = torch.zeros((5, 128), dtype=torch.bfloat16, device=cuda)
    before = quant_matmul_kernel.launches
    quant_matmul_kernel(x, ql)
    quant_matmul_kernel(x.float(), ql)
    quant_matmul_reference(x, ql)
    quant_matmul_kernel(x.cpu(), ql.map(torch.Tensor.cpu))
    assert quant_matmul_kernel.launches == before + 2

    x, lns, lnb, _, bq, _, bp, ls = _half_layer_args(2, 37, 128, seed=0, device=cuda)
    wq, wp = _ql("q8_0", 384, 128, 1, cuda), _ql("q8_0", 128, 128, 2, cuda)
    before = slab_layer_block_quant.launches
    slab_layer_block_quant(x, lns, lnb, wq, bq, wp, bp, ls, 2, 0.125, 1e-6)
    quant_layer_reference(x, lns, lnb, wq, bq, wp, bp, ls, 2, 0.125, 1e-6)
    cpu = [a.cpu() for a in (x, lns, lnb)]
    slab_layer_block_quant(*cpu, wq.map(torch.Tensor.cpu), bq.cpu(), wp.map(torch.Tensor.cpu),
                           bp.cpu(), ls.cpu(), 2, 0.125, 1e-6)
    assert slab_layer_block_quant.launches == before + 1


@pytest.mark.parametrize("case", ["K8 f32", "K8 packed D=64", "K7 packed K=64", "K7 f16"])
def test_quant_kernels_refuse(cuda, case):
    from dinov2_tpu_torch.ops.fused_quant_attention import slab_layer_block_quant
    from dinov2_tpu_torch.ops.qmatmul_kernel import quant_matmul_kernel

    counts = (slab_layer_block_quant.launches, quant_matmul_kernel.launches)
    if case.startswith("K8"):
        d = 128 if case == "K8 f32" else 64
        x, lns, lnb, _, bq, _, bp, ls = _half_layer_args(1, 5, d, seed=0, device=cuda)
        if case == "K8 f32":
            x = x.float()
        wq, wp = _ql("q4_0", 3 * d, d, 1, cuda), _ql("q4_0", d, d, 2, cuda)
        with pytest.raises(NotImplementedError, match="bf16" if case == "K8 f32" else "K/2"):
            slab_layer_block_quant(x, lns, lnb, wq, bq, wp, bp, ls, d // 64, 0.125, 1e-6)
    else:
        k = 64 if case == "K7 packed K=64" else 128
        dtype = torch.float16 if case == "K7 f16" else torch.bfloat16
        with pytest.raises(NotImplementedError):
            quant_matmul_kernel(torch.zeros((3, k), dtype=dtype, device=cuda), _ql("q5_1", 8, k, 0, cuda))
    assert (slab_layer_block_quant.launches, quant_matmul_kernel.launches) == counts


@pytest.mark.parametrize("fmt", ["q4_0", "q5_1", "q8_0"])
def test_engine_quant_classify_on_cuda_close_to_cpu_f32(cuda, tmp_path, fmt):
    """DinoEngine(quant_mode="fused") in bf16 on the card (K8 in every layer,
    K7 for fc1, fc2 and the head) against the same file in f32 on the CPU,
    with the dense engine test's bound."""
    from dinov2_tpu_torch.ops.fused_quant_attention import slab_layer_block_quant
    from dinov2_tpu_torch.ops.qmatmul_kernel import quant_matmul_kernel
    from dinov2_tpu_torch.quant import quantize_gguf
    from dinov2_tpu_torch.runtime.engine import DinoEngine

    config = DinoConfig(hidden_size=128, num_hidden_layers=2, num_attention_heads=2,
                        num_classes=4, patch_size=14, img_size=70)
    dense = write_synthetic_gguf(tmp_path / "tiny.gguf", config, seed=3)
    path = quantize_gguf(dense, tmp_path / f"tiny.{fmt}.gguf", fmt)
    imgs = np.random.default_rng(0).integers(0, 256, (3, 90, 100, 3), dtype=np.uint8)
    gpu = DinoEngine(path, dtype=torch.bfloat16, device="cuda", quant_mode="fused")
    counts = (slab_layer_block_quant.launches, quant_matmul_kernel.launches, slab_layer_block.launches)
    got = gpu.classify_probs(imgs)
    layers = config.num_hidden_layers
    assert (slab_layer_block_quant.launches, quant_matmul_kernel.launches,
            slab_layer_block.launches) == (counts[0] + layers, counts[1] + 2 * layers + 1, counts[2])
    want = DinoEngine(path, dtype=torch.float32, device="cpu", quant_mode="dequant").classify_probs(imgs)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-2, atol=0)


def _bound_holds(got, plain, want):
    """K1's bound: at most twice the plain bf16 version's distance from f32,
    plus 1e-3 of the output's scale."""
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == torch.bfloat16 and torch.isfinite(got).all()
    err = (got.float() - want).abs().max().item()
    err_plain = (plain.float() - want).abs().max().item()
    assert err <= 2 * err_plain + 1e-3 * want.abs().max().item()


@pytest.mark.parametrize(
    "b, t, heads",
    [(1, 1, 1), (2, 5, 2), (3, 64, 6), (2, 65, 12), (2, 257, 16), (2, 257, 24), (1, 1370, 6)],
)
def test_slab_attention_kernels_match_plain(cuda, b, t, heads):
    """K3 and K2 against their plain versions in bf16 and f32 on the same
    slab, with K1's bound; H covers ViT-S, B, L and g; T one row, ragged key
    tiles, an exact tile, T=257 and many tiles."""
    d = 64 * heads
    x, _, _, _, _, wp, bp, ls = _half_layer_args(b, t, d, seed=t, device=cuda)
    qkv = _slab(b, t, heads, seed=t + heads, device=cuda)
    _bound_holds(slab_attention(qkv, heads, 0.125), _slab_reference(qkv, heads, 0.125),
                 _slab_reference(qkv.float(), heads, 0.125))
    block = (x, qkv, wp, bp, ls)
    _bound_holds(slab_attention_block(*block, heads, 0.125),
                 _slab_block_reference(*block, heads, 0.125),
                 _slab_block_reference(*[a.float() for a in block], heads, 0.125))


@pytest.mark.parametrize("b, t, heads", [(2, 37, 2), (4, 257, 12), (2, 257, 24)])
def test_slab_attention_kernels_equal_k1_on_its_slab(cuda, b, t, heads):
    """On the qkv slab K1 makes, K3 is K1's attention output and K2 K1's
    output, bit for bit: they run K1's second and third launches."""
    args = _half_layer_args(b, t, 64 * heads, seed=heads, device=cuda)
    x, _, _, _, _, wp, bp, ls = args
    out, qkv, attn = slab_layer_buffers(*args, heads, 0.125, 1e-6)
    assert torch.equal(out, slab_layer_block(*args, heads, 0.125, 1e-6))
    assert torch.equal(slab_attention(qkv, heads, 0.125), attn)
    assert torch.equal(slab_attention_block(x, qkv, wp, bp, ls, heads, 0.125), out)


def _mlp_args(b, t, d, seed, device, dh=None):
    dh = 4 * d if dh is None else dh
    rng = np.random.default_rng(seed)
    arrays = [
        (rng.standard_normal((b, t, d)), torch.bfloat16),
        (rng.uniform(0.5, 1.5, d), torch.float32),
        (rng.standard_normal(d) * 0.1, torch.float32),
        (rng.standard_normal((d, dh)) * 0.05, torch.bfloat16),
        (rng.standard_normal(dh) * 0.1, torch.float32),
        (rng.standard_normal((dh, d)) * 0.05, torch.bfloat16),
        (rng.standard_normal(d) * 0.1, torch.float32),
        (rng.uniform(0.1, 1.0, d), torch.float32),
    ]
    return [torch.from_numpy(a).to(device, dt) for a, dt in arrays]


@pytest.mark.parametrize("activation", ["gelu_tanh_f16", "gelu_erf", "gelu_tanh"])
@pytest.mark.parametrize(
    "b, t, d", [(1, 1, 384), (2, 37, 384), (3, 32, 768), (2, 257, 768), (1, 1370, 1024), (5, 33, 1024)]
)
def test_slab_mlp_kernel_matches_plain(cuda, b, t, d, activation):
    """K5 against its plain version in bf16 and f32 on the same inputs, with
    K1's bound; every width it is built for, row counts of one row, a ragged
    last tile, an exact tile (96 rows) and many tiles."""
    args = _mlp_args(b, t, d, seed=t + d, device=cuda)
    _bound_holds(slab_mlp_block(*args, activation, 1e-6),
                 slab_mlp_reference(*args, activation, 1e-6),
                 slab_mlp_reference(*[a.float() for a in args], activation, 1e-6))


def test_slab_launch_counters_count_kernel_calls_only(cuda):
    qkv = _slab(2, 37, 2, seed=0, device=cuda)
    x, _, _, _, _, wp, bp, ls = _half_layer_args(2, 37, 128, seed=0, device=cuda)
    mlp = _mlp_args(2, 37, 384, seed=0, device=cuda)
    before = (slab_attention.launches, slab_attention_block.launches, slab_mlp_block.launches)
    slab_attention(qkv, 2, 0.125)
    slab_attention(qkv.cpu(), 2, 0.125)
    _slab_reference(qkv, 2, 0.125)
    slab_attention_block(x, qkv, wp, bp, ls, 2, 0.125)
    slab_attention_block(*[a.cpu() for a in (x, qkv, wp, bp, ls)], 2, 0.125)
    slab_mlp_block(*mlp, "gelu_erf", 1e-6)
    slab_mlp_block(*mlp, "gelu_tanh", 1e-6)
    slab_mlp_block(*[a.cpu() for a in mlp], "gelu_erf", 1e-6)
    slab_mlp_reference(*mlp, "gelu_erf", 1e-6)
    assert (slab_attention.launches, slab_attention_block.launches,
            slab_mlp_block.launches) == (before[0] + 1, before[1] + 1, before[2] + 2)


@pytest.mark.parametrize("case", ["K3 f32", "K3 head_dim 32", "K2 f32", "K5 f32", "K5 DH = 2 D",
                                  "K5 D=128"])
def test_slab_kernels_refuse(cuda, case):
    counts = (slab_attention.launches, slab_attention_block.launches, slab_mlp_block.launches)
    with pytest.raises(NotImplementedError):
        if case == "K3 f32":
            slab_attention(_slab(1, 5, 2, seed=0, device=cuda, dtype=torch.float32), 2, 0.125)
        elif case == "K3 head_dim 32":
            slab_attention(_slab(1, 5, 2, seed=0, device=cuda, hd=32), 2, 0.125)
        elif case == "K2 f32":
            x, _, _, _, _, wp, bp, ls = _half_layer_args(1, 5, 128, seed=0, device=cuda)
            qkv = _slab(1, 5, 2, seed=0, device=cuda, dtype=torch.float32)
            slab_attention_block(x.float(), qkv, wp, bp, ls, 2, 0.125)
        elif case == "K5 f32":
            args = _mlp_args(1, 5, 384, seed=0, device=cuda)
            slab_mlp_block(args[0].float(), *args[1:], "gelu_erf", 1e-6)
        elif case == "K5 DH = 2 D":
            slab_mlp_block(*_mlp_args(1, 5, 384, seed=0, device=cuda, dh=768), "gelu_erf", 1e-6)
        else:
            slab_mlp_block(*_mlp_args(1, 5, 128, seed=0, device=cuda), "gelu_erf", 1e-6)
    assert (slab_attention.launches, slab_attention_block.launches,
            slab_mlp_block.launches) == counts


@pytest.mark.parametrize("options, kernels", [
    ({"slab_fusion": "core"}, {"K3": 2}),
    ({"slab_fusion": "proj"}, {"K2": 2}),
    ({"slab_fusion": "layer"}, {"K1": 2}),
])
def test_engine_swiglu_on_cuda_close_to_cpu_f32(cuda, tmp_path, options, kernels):
    """A tiny SwiGLU model (ViT-g/14's FFN) in bf16 on the card at each level
    of the slab route against the same file in f32 on the CPU, with the
    dense engine test's bound; each level launches its kernel once a layer."""
    from dinov2_tpu_torch.runtime.engine import DinoEngine

    config = DinoConfig(hidden_size=128, num_hidden_layers=2, num_attention_heads=2,
                        num_classes=4, patch_size=14, img_size=70, use_swiglu_ffn=True,
                        swiglu_hidden=160)
    path = write_synthetic_gguf(tmp_path / "tiny_g.gguf", config, seed=3)
    imgs = np.random.default_rng(0).integers(0, 256, (3, 90, 100, 3), dtype=np.uint8)
    gpu = DinoEngine(path, dtype=torch.bfloat16, device="cuda", **options)
    counters = {"K1": slab_layer_block, "K2": slab_attention_block, "K3": slab_attention}
    before = {k: c.launches for k, c in counters.items()}
    got = gpu.classify_probs(imgs)
    assert {k: c.launches - before[k] for k, c in counters.items()} == {
        k: kernels.get(k, 0) for k in counters}
    want = DinoEngine(path, dtype=torch.float32, device="cpu").classify_probs(imgs)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-2, atol=0)


def test_engine_fuse_mlp_on_cuda_close_to_cpu_f32(cuda, tmp_path):
    """fuse_mlp=True at D=384 in bf16 on the card: K1 and K5 once a layer;
    probs within the dense engine test's bound (1e-2 relative) of the same
    engine with fuse_mlp=False on the card, which differs only in summation
    order, and within twice that of the CPU f32 engine's: the bf16 token
    noise grows with the width (D=384 against that test's D=128; one prob
    read 1.002e-2 here)."""
    from dinov2_tpu_torch.runtime.engine import DinoEngine

    config = DinoConfig(hidden_size=384, num_hidden_layers=2, num_attention_heads=6,
                        num_classes=4, patch_size=14, img_size=70)
    path = write_synthetic_gguf(tmp_path / "tiny_s.gguf", config, seed=3)
    imgs = np.random.default_rng(0).integers(0, 256, (3, 90, 100, 3), dtype=np.uint8)
    gpu = DinoEngine(path, dtype=torch.bfloat16, device="cuda", fuse_mlp=True)
    before = slab_layer_block.launches, slab_mlp_block.launches
    got = gpu.classify_probs(imgs)
    assert (slab_layer_block.launches, slab_mlp_block.launches) == (before[0] + 2, before[1] + 2)
    assert np.isfinite(got).all()
    unfused = DinoEngine(path, dtype=torch.bfloat16, device="cuda").classify_probs(imgs)
    assert slab_mlp_block.launches == before[1] + 2
    np.testing.assert_allclose(got, unfused, rtol=1e-2, atol=0)
    want = DinoEngine(path, dtype=torch.float32, device="cpu").classify_probs(imgs)
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=0)


# ---------------------------------------------------------------------------
# Training: K4 with lse, K6, the autograd Functions and the trainer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "b, t, heads", [(1, 1, 1), (2, 5, 2), (3, 64, 2), (2, 65, 3), (2, 257, 12), (1, 1370, 4)]
)
def test_flash_forward_lse_matches_plain(cuda, b, t, heads):
    """K4's with_lse variant: out equal to the kernel without lse bit for
    bit, lse within 1e-3 of the plain f32 logsumexp of the same bf16 inputs."""
    from dinov2_tpu_torch.ops.flash_attention import flash_forward_lse, flash_forward_reference

    q, k, v = split_heads(_slab(b, t, heads, seed=t, device=cuda), heads)
    before = flash_attention.launches
    out, lse = flash_forward_lse(q, k, v, 0.125)
    assert flash_attention.launches == before + 1
    _, want = flash_forward_reference(q.float(), k.float(), v.float(), 0.125)
    torch.cuda.synchronize()
    assert lse.shape == (b, heads, t) and lse.dtype == torch.float32
    assert torch.equal(out, flash_attention(q, k, v, 0.125))
    assert (lse - want).abs().max().item() <= 1e-3


@pytest.mark.parametrize("slab", [False, True])
@pytest.mark.parametrize(
    "b, t, heads", [(1, 1, 1), (2, 5, 2), (3, 64, 2), (2, 65, 3), (2, 257, 12), (1, 1370, 4)]
)
def test_flash_backward_kernel_matches_plain(cuda, b, t, heads, slab):
    """K6 against its plain version in bf16 and in f32 on the same inputs,
    with K1's bound for each of dq, dk, dv, plus 1e-5: dS = p (dP - delta)
    cancels two f32 sums that the kernel takes in other orders than the
    plain version (at T=1 they cancel to exactly 0 there and to ~2e-6 here).
    T covers one row, ragged tiles, an exact tile and many tiles. With `slab`, q/k/v are the strided head
    views of a qkv slab and the gradients are written into the head views of
    one (B, T, 3D) slab."""
    from dinov2_tpu_torch.ops.flash_attention import (
        flash_backward,
        flash_backward_reference,
        flash_forward_lse,
        flash_forward_reference,
    )

    qkv = _slab(b, t, heads, seed=t + 1, device=cuda)
    g = _slab(b, t, heads, seed=t + 2, device=cuda)[..., : 64 * heads].reshape(b, t, heads, 64)
    q, k, v = split_heads(qkv, heads)
    if not slab:
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out, lse = flash_forward_lse(q, k, v, 0.125)
    before = flash_backward.launches
    if slab:
        d_qkv = torch.full_like(qkv, float("nan"))
        got = flash_backward(q, k, v, out, lse, g, 0.125, into=split_heads(d_qkv, heads))
        assert all(a.data_ptr() == view.data_ptr() for a, view in zip(got, split_heads(d_qkv, heads)))
    else:
        got = flash_backward(q, k, v, out, lse, g, 0.125)
        assert all(a.is_contiguous() for a in got)
    assert flash_backward.launches == before + 1
    plain = flash_backward_reference(q, k, v, out, lse, g, 0.125)
    out32, lse32 = flash_forward_reference(q.float(), k.float(), v.float(), 0.125)
    want = flash_backward_reference(q.float(), k.float(), v.float(), out32, lse32, g.float(), 0.125)
    torch.cuda.synchronize()
    for a, p, w in zip(got, plain, want):
        assert a.shape == (b, t, heads, 64) and a.dtype == torch.bfloat16
        assert torch.isfinite(a).all()
        err = (a.float() - w).abs().max().item()
        err_plain = (p.float() - w).abs().max().item()
        assert err <= 2 * err_plain + 1e-3 * w.abs().max().item() + 1e-5


@pytest.mark.parametrize("case", ["f32", "head_dim 32", "lse shape", "o strided"])
def test_flash_backward_refuses(cuda, case):
    from dinov2_tpu_torch.ops.flash_attention import flash_backward

    dtype = torch.float32 if case == "f32" else torch.bfloat16
    hd = 32 if case == "head_dim 32" else 64
    q, k, v = split_heads(_slab(1, 5, 2, seed=0, device=cuda, dtype=dtype, hd=hd), 2)
    o = torch.zeros((1, 5, 2, hd), dtype=dtype, device=cuda)
    lse = torch.zeros((1, 2, 5) if case != "lse shape" else (1, 5, 2), device=cuda)
    if case == "o strided":
        o = torch.zeros((1, 2, 5, hd), dtype=dtype, device=cuda).transpose(1, 2)
    before = flash_backward.launches
    with pytest.raises((NotImplementedError, ValueError)):
        flash_backward(q, k, v, o, lse, torch.zeros_like(q), 0.125)
    assert flash_backward.launches == before


def _leaves(tensors):
    return [a.detach().clone().requires_grad_() for a in tensors]


def _assert_grads(out, leaves, what):
    """No silent detach: the output is in the graph and every input gets a
    finite gradient of its own shape and dtype."""
    assert out.grad_fn is not None, f"{what}: the output is cut from the graph"
    grads = torch.autograd.grad(out.float().sum(), leaves)
    torch.cuda.synchronize()
    for leaf, grad in zip(leaves, grads):
        assert grad is not None and grad.shape == leaf.shape and grad.dtype == leaf.dtype, what
        assert torch.isfinite(grad).all(), what
    return grads


@pytest.mark.parametrize("wrapper", ["K1", "K2", "K3", "K4", "K4 slab", "K5"])
def test_no_wrapper_detaches_silently(cuda, wrapper):
    """Every kernel wrapper on CUDA tensors that require grad returns a tensor
    with a grad_fn, and every input's gradient is present and finite; f32
    master weights get f32 gradients."""
    b, t, heads = 2, 70, 6
    d = 64 * heads
    x, lns, lnb, wq, bq, wp, bp, ls = _half_layer_args(b, t, d, seed=3, device=cuda)
    wq, wp = wq.float(), wp.float()
    qkv = _slab(b, t, heads, seed=4, device=cuda)
    if wrapper == "K1":
        leaves = _leaves((x, lns, lnb, wq, bq, wp, bp, ls))
        out = slab_layer_block(*leaves, heads, 0.125, 1e-6)
    elif wrapper == "K2":
        leaves = _leaves((x, qkv, wp, bp, ls))
        out = slab_attention_block(*leaves, heads, 0.125)
    elif wrapper == "K3":
        leaves = _leaves((qkv,))
        out = slab_attention(*leaves, heads, 0.125)
    elif wrapper == "K4":
        leaves = _leaves(t.contiguous() for t in split_heads(qkv, heads))
        out = flash_attention(*leaves, 0.125)
    elif wrapper == "K4 slab":
        leaves = _leaves((qkv,))
        out = flash_attention_slab(*leaves, heads, 0.125)
    else:
        leaves = _leaves(a if i not in (3, 5) else a.float()
                         for i, a in enumerate(_mlp_args(b, t, d, seed=5, device=cuda)))
        out = slab_mlp_block(*leaves, "gelu_erf", 1e-6)
    _assert_grads(out, leaves, wrapper)


@pytest.mark.parametrize("wrapper", ["K7", "K8", "apply_linear"])
def test_quant_wrappers_refuse_inputs_that_require_grad(cuda, wrapper):
    """The quantized kernels have no backward: an input that requires grad
    raises instead of coming back cut from the graph."""
    from dinov2_tpu_torch.ops.fused_quant_attention import slab_layer_block_quant
    from dinov2_tpu_torch.ops.qmatmul import apply_linear
    from dinov2_tpu_torch.ops.qmatmul_kernel import quant_matmul_kernel

    d = 128
    x, lns, lnb, _, bq, _, bp, ls = _half_layer_args(1, 5, d, seed=0, device=cuda)
    x.requires_grad_()
    with pytest.raises(RuntimeError, match="aren't trainable"):
        if wrapper == "K7":
            quant_matmul_kernel(x, _ql("q4_0", d, d, 0, cuda), bp)
        elif wrapper == "apply_linear":
            apply_linear(x, {"kernel": _ql("q4_0", d, d, 0, cuda), "bias": bp})
        else:
            slab_layer_block_quant(x, lns, lnb, _ql("q4_0", 3 * d, d, 1, cuda), bq,
                                   _ql("q4_0", d, d, 2, cuda), bp, ls, 2, 0.125, 1e-6)


@pytest.mark.parametrize("t", [70, 300])
def test_flash_function_gradients_match_plain_autograd(cuda, t):
    """The gradient through flash_attention_slab's Function (K4 with lse, K6)
    against autograd through the plain attention in bf16 and in f32."""
    heads = 3
    qkv = _slab(2, t, heads, seed=t, device=cuda)
    g = _slab(2, t, heads, seed=t + 1, device=cuda)[..., : 64 * heads]

    def grad_of(fn, slab):
        leaf = slab.detach().clone().requires_grad_()
        return torch.autograd.grad(fn(leaf), leaf, g.to(slab.dtype))[0]

    got = grad_of(lambda s: flash_attention_slab(s, heads, 0.125), qkv)
    plain = grad_of(lambda s: _slab_reference(s, heads, 0.125), qkv)
    want = grad_of(lambda s: _slab_reference(s, heads, 0.125), qkv.float())
    torch.cuda.synchronize()
    assert got.shape == qkv.shape
    _bound_holds(got, plain, want)


@pytest.mark.parametrize("route", ["plain", "flash"])
def test_slab_attention_backward_routes(cuda, route):
    from dinov2_tpu_torch.ops.flash_attention import flash_backward
    from dinov2_tpu_torch.ops.fused_attention import slab_attention_backward

    heads = 2
    qkv = _slab(2, 130, heads, seed=0, device=cuda)
    g = _slab(2, 130, heads, seed=1, device=cuda)[..., : 64 * heads]
    before = flash_backward.launches
    got = slab_attention_backward(qkv, g, heads, 0.125, route)
    plain = slab_attention_backward(qkv, g, heads, 0.125, "plain")
    want = slab_attention_backward(qkv.float(), g.float(), heads, 0.125, "plain")
    torch.cuda.synchronize()
    assert flash_backward.launches == before + (route == "flash")
    _bound_holds(got, plain, want)


@pytest.mark.parametrize("route", [True, "auto", "slab-core", "fuse_mlp"])
def test_trainer_step_on_cuda(cuda, route):
    """One Trainer.step per route on the card, tiny model, bf16 over f32
    masters with remat: the loss is finite and within 2e-2 of the CPU f32
    step's, every leaf moved, and the route's kernels launched (with remat
    the forward kernels run twice a step)."""
    from dinov2_tpu_torch.models.params import init_params, tree_leaves
    from dinov2_tpu_torch.models.vit import ModelOptions
    from dinov2_tpu_torch.ops.flash_attention import flash_backward
    from dinov2_tpu_torch.parallel.train import make_trainer

    config = DinoConfig(hidden_size=384, num_hidden_layers=2, num_attention_heads=6,
                        num_classes=7, patch_size=14, img_size=70)
    source = init_params(config, seed=0, dtype=torch.float32)
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (4, 64, 64, 3), dtype=np.uint8)
    labels = rng.integers(0, 7, 4)
    extra = {"slab-core": dict(flash_attention="auto", slab_fusion="core"),
             "fuse_mlp": dict(flash_attention="auto", fuse_mlp=True)}.get(
                 route, dict(flash_attention=route))
    counters = {True: (flash_attention, flash_backward), "auto": (slab_layer_block,),
                "slab-core": (slab_attention, flash_backward),
                "fuse_mlp": (slab_layer_block, slab_mlp_block)}[route]
    before = [c.launches for c in counters]

    trainer = make_trainer(config, opts=ModelOptions(
        parity="hf", compute_dtype=torch.bfloat16, remat=True, **extra))
    assert trainer.device.type == "cuda"
    params, opt_state = trainer.place(source)
    start = [p.detach().clone() for p in tree_leaves(params)]
    params, opt_state, metrics = trainer.step(params, opt_state, images, labels)
    torch.cuda.synchronize()

    cpu = make_trainer(config, device="cpu")
    _, _, cpu_metrics = cpu.step(*cpu.place(source), images, labels)
    assert torch.isfinite(metrics["loss"])
    assert abs(float(metrics["loss"]) - float(cpu_metrics["loss"])) <= 2e-2
    assert all(p.device.type == "cuda" and not torch.equal(p, s)
               for p, s in zip(tree_leaves(params), start))
    launched = [c.launches - b for c, b in zip(counters, before)]
    layers = config.num_hidden_layers
    # forward kernels run twice a step under remat; K6 once a layer (T=257 is
    # at or above SLAB_BWD_FLASH_MIN_T, so K3's backward takes the flash route)
    expected = {True: [2 * layers, layers], "auto": [2 * layers],
                "slab-core": [2 * layers, layers], "fuse_mlp": [2 * layers, 2 * layers]}[route]
    assert launched == expected


# ---------------------------------------------------------------------------
# The wgmma flash kernels over ragged lengths and widths; the default trainer
# ---------------------------------------------------------------------------

RAGGED_T = (1, 63, 64, 65, 127, 128, 129, 257, 300, 1370)


@pytest.mark.parametrize("slab", [False, True], ids=["contiguous", "slab"])
@pytest.mark.parametrize("b, heads", [(1, 6), (2, 12), (1, 16), (2, 24)])
@pytest.mark.parametrize("t", RAGGED_T)
def test_flash_kernels_over_ragged_lengths(cuda, t, b, heads, slab):
    """K4, K4 with lse and K6 against their plain versions where a tile is
    one row, one short of full, full, one over, and many tiles with a ragged
    tail, at the presets' head counts: out and each of dq, dk, dv within
    twice the plain bf16 version's distance from f32 plus 1e-3 of the
    output's scale (plus 1e-5 where the exact gradient is 0, T=1); the lse
    variant's out bit for bit K4's; K6 run twice gives the same bits (two
    deterministic kernels, no atomics). With `slab`, q/k/v are the strided
    head views of a qkv slab and the gradients go into the head views of one
    (B, T, 3D) slab through `into=`."""
    from dinov2_tpu_torch.ops.flash_attention import (
        flash_backward,
        flash_backward_reference,
        flash_forward_lse,
        flash_forward_reference,
    )

    qkv = _slab(b, t, heads, seed=t + heads, device=cuda)
    g = _slab(b, t, heads, seed=t + heads + 1, device=cuda)[..., : 64 * heads]
    g = g.reshape(b, t, heads, 64)
    q, k, v = split_heads(qkv, heads)
    if not slab:
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out, lse = flash_forward_lse(q, k, v, 0.125)
    assert torch.equal(out, flash_attention(q, k, v, 0.125))
    out32, lse32 = flash_forward_reference(q.float(), k.float(), v.float(), 0.125)
    _bound_holds(out, vanilla_attention(q, k, v, 0.125), out32)
    assert (lse - lse32).abs().max().item() <= 1e-3

    def run():
        if not slab:
            return flash_backward(q, k, v, out, lse, g, 0.125)
        d_qkv = torch.full_like(qkv, float("nan"))
        flash_backward(q, k, v, out, lse, g, 0.125, into=split_heads(d_qkv, heads))
        assert torch.isfinite(d_qkv).all()
        return split_heads(d_qkv, heads)

    got, again = run(), run()
    plain = flash_backward_reference(q, k, v, out, lse, g, 0.125)
    want = flash_backward_reference(q.float(), k.float(), v.float(), out32, lse32, g.float(), 0.125)
    torch.cuda.synchronize()
    for a, a2, p, w in zip(got, again, plain, want):
        assert torch.equal(a, a2)
        assert torch.isfinite(a).all()
        err = (a.float() - w).abs().max().item()
        err_plain = (p.float() - w).abs().max().item()
        assert err <= 2 * err_plain + 1e-3 * w.abs().max().item() + 1e-5


def test_flash_kernels_report_their_tile_rows(cuda):
    """The C entries pick a block's rows by shape: 128-query forward blocks
    once the grid fills the card twice over (eight times for a short ragged
    T), 64 otherwise; K6 always 64 keys and 128 queries."""
    from dinov2_tpu_torch.ops.flash_attention import kernel_tile_rows

    assert kernel_tile_rows(8, 1370, 16) == {
        "forward": 128, "backward_keys": 64, "backward_queries": 128}
    assert kernel_tile_rows(32, 257, 12)["forward"] == 64
    assert kernel_tile_rows(64, 257, 12)["forward"] == 128
    assert kernel_tile_rows(1, 1370, 16)["forward"] == 64
    assert kernel_tile_rows(1, 4226, 16)["forward"] == 128


def test_default_trainer_takes_a_step_on_cuda(cuda):
    """`make_trainer(config)` with its own options (f32 compute, route
    "auto", device "cuda") takes a step on the card: f32 activations go to
    the plain attention route, no kernel launches, and the loss equals the
    CPU's f32 step within f32 summation noise. An explicit kernel route with
    f32 activations still raises in the wrapper."""
    from dinov2_tpu_torch.models.params import init_params
    from dinov2_tpu_torch.models.vit import ModelOptions
    from dinov2_tpu_torch.ops.flash_attention import flash_backward
    from dinov2_tpu_torch.parallel.train import make_trainer

    config = DinoConfig(hidden_size=384, num_hidden_layers=2, num_attention_heads=6,
                        num_classes=7, patch_size=14, img_size=70)
    source = init_params(config, seed=0, dtype=torch.float32)
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (4, 64, 64, 3), dtype=np.uint8)
    labels = rng.integers(0, 7, 4)
    counters = (slab_layer_block, slab_attention, flash_attention, flash_backward)
    before = [c.launches for c in counters]

    trainer = make_trainer(config)
    assert trainer.device.type == "cuda" and trainer.opts.compute_dtype == torch.float32
    assert trainer.opts.flash_attention == "auto"
    _, _, metrics = trainer.step(*trainer.place(source), images, labels)
    torch.cuda.synchronize()
    cpu = make_trainer(config, device="cpu")
    _, _, cpu_metrics = cpu.step(*cpu.place(source), images, labels)
    assert torch.isfinite(metrics["loss"])
    assert abs(float(metrics["loss"]) - float(cpu_metrics["loss"])) <= 1e-4
    assert [c.launches for c in counters] == before

    for route in ("slab", True):
        forced = make_trainer(config, opts=ModelOptions(
            parity="hf", compute_dtype=torch.float32, remat=True, flash_attention=route))
        with pytest.raises(NotImplementedError):
            forced.step(*forced.place(source), images, labels)
