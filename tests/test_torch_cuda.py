"""The port's hand-written CUDA kernels against their plain PyTorch versions,
their autograd Functions and a trainer step per route, on the card. Every test here is marked `cuda` and skips without a GPU.

The GPU machine has no jax, and tests/conftest.py imports it, so run there:

    python -m pytest -p no:cacheprovider --noconftest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (caps torch's threads under xdist)

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
    """K1 takes bf16 and f32 activations (f32: its own kernel, counted in
    `.f32_launches`); f16 it refuses, and counts nothing."""
    args = _half_layer_args(1, 5, 64, seed=0, device=cuda)
    args[0] = args[0].half()
    before = (slab_layer_block.launches, slab_layer_block.f32_launches)
    with pytest.raises(NotImplementedError, match="bf16 or f32"):
        slab_layer_block(*args, 1, 0.125, 1e-6)
    args[0] = args[0].float()
    slab_layer_block(*args, 1, 0.125, 1e-6)
    assert (slab_layer_block.launches, slab_layer_block.f32_launches) == (before[0],
                                                                          before[1] + 1)


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


@pytest.mark.parametrize("case", ["f16", "head_dim 32"])
def test_flash_kernel_refuses(cuda, case):
    if case == "f16":  # the kernels take bf16 and f32
        qkv, heads = _slab(1, 5, 2, seed=0, device=cuda, dtype=torch.float16), 2
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
    bit for bit dequant_weight's in bf16. In f32 it is the weight the 3xTF32
    GEMM multiplies, the sum of its two TF32 planes (hi = tf32(w) with
    cvt.rna's rounding, lo = tf32(w - hi)), bit for bit: dequant_weight's
    itself in q4_0, q5_0 and q8_0, whose values have at most 19
    significant bits; within 2^-22 of it in q4_1 and q5_1 (+ m adds bits)."""
    from dinov2_tpu_torch.ops.qmatmul import dequant_weight
    from dinov2_tpu_torch.ops.qmatmul_kernel import quant_matmul_kernel

    def tf32(x):
        return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)

    ql = _ql(fmt, 200, 256, seed=1, device=cuda, packed=packed, scale=0.5)
    got = quant_matmul_kernel(torch.eye(256, dtype=torch.bfloat16, device=cuda), ql)
    assert torch.equal(got, dequant_weight(ql, torch.bfloat16).T)
    w = dequant_weight(ql, torch.float32)
    hi = tf32(w)
    planes = hi + tf32(w - hi)
    got = quant_matmul_kernel(torch.eye(256, dtype=torch.float32, device=cuda), ql)
    assert torch.equal(got, planes.T)
    if ql.m is None:
        assert torch.equal(planes, w)
    else:
        assert ((planes.double() - w.double()).abs() <= 2.0**-22 * w.double().abs()).all()


@pytest.mark.parametrize("n, k", [(200, 256), (33, 768), (3072, 768)])
@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("fmt", QUANT_FORMATS)
def test_dequant_weight_kernel_equals_dequant_weight(cuda, fmt, packed, n, k):
    """The first of K7's two bf16 launches alone: the (N, K) bf16 weight it
    writes is dequant_weight(W, bf16) bit for bit, in every format and
    layout, at a ragged N and at ViT-B's fc1; it counts its launch and takes
    the plain version for a weight on the CPU."""
    from dinov2_tpu_torch.ops.qmatmul import dequant_weight
    from dinov2_tpu_torch.ops.qmatmul_kernel import dequant_weight_kernel

    ql = _ql(fmt, n, k, seed=n, device=cuda, packed=packed, scale=0.5)
    before = dequant_weight_kernel.launches
    got = dequant_weight_kernel(ql)
    assert got.shape == (n, k) and got.dtype == torch.bfloat16
    assert torch.equal(got, dequant_weight(ql, torch.bfloat16))
    assert torch.equal(dequant_weight_kernel(ql.map(torch.Tensor.cpu)), got.cpu())
    assert dequant_weight_kernel.launches == before + 1


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


# K8 against K1 on the dequantized weights: equal bits. Both run the same
# four launches on the same dense bf16 weights; K8's GEMMs read them as the
# k-major (out, in) operand, K1's as the mn-major (in, out) operand through
# the descriptor's transpose bit, and both add the same k16 products into
# f32 in k order. On an NVIDIA H100 80GB HBM3 the two gave equal bits at
# every case below and at B=64, T=257, D=768 and B=16, D=1536.

# (B, T, heads, format, packed): every format in the load path's layout at
# a ragged first and second tile and ViT-B's width, the int8 SoA layout at
# D = 192 (3D = 576 and D no multiple of 256: the last column tile of each
# GEMM has a 64-column atom past N) and at D = 768, and ViT-g's D = 1536
QUANT_LAYER_CASES = (
    [(b, t, heads, f, True) for b, t, heads in ((1, 1, 2), (2, 37, 2), (3, 65, 4), (2, 257, 12))
     for f in QUANT_FORMATS]
    + [(b, t, heads, "q4_1", False) for b, t, heads in ((1, 1, 2), (2, 37, 2), (3, 65, 4),
                                                       (2, 257, 12))]
    + [(2, 37, 3, f, False) for f in QUANT_FORMATS]
    + [(2, 257, 12, "q8_0", False), (2, 257, 24, "q4_0", True), (2, 257, 24, "q5_1", True)]
)


def _quant_layer_inputs(b, t, heads, fmt, packed, device):
    d = 64 * heads
    x, lns, lnb, _, bq, _, bp, ls = _half_layer_args(b, t, d, seed=t, device=device)
    wq = _ql(fmt, 3 * d, d, seed=1, device=device, packed=packed)
    wp = _ql(fmt, d, d, seed=2, device=device, packed=packed)
    return x, lns, lnb, wq, bq, wp, bp, ls


@pytest.mark.parametrize("b, t, heads, fmt, packed", QUANT_LAYER_CASES)
def test_quant_layer_kernel_matches_plain(cuda, b, t, heads, fmt, packed):
    """K8 against its plain version with K1's bound, and bit for bit against
    K1 on the dequantized weights."""
    from dinov2_tpu_torch.ops.fused_quant_attention import (
        quant_layer_reference,
        slab_layer_block_quant,
    )
    from dinov2_tpu_torch.ops.qmatmul import dequant_weight

    args = _quant_layer_inputs(b, t, heads, fmt, packed, cuda)
    x, lns, lnb, wq, bq, wp, bp, ls = args
    got = slab_layer_block_quant(*args, heads, 0.125, 1e-6)
    plain = quant_layer_reference(*args, heads, 0.125, 1e-6)
    want = quant_layer_reference(x.float(), *args[1:], heads, 0.125, 1e-6)
    dense = [dequant_weight(w, torch.bfloat16).T.contiguous() for w in (wq, wp)]
    k1 = slab_layer_block(x, lns, lnb, dense[0], bq, dense[1], bp, ls, heads, 0.125, 1e-6)
    torch.cuda.synchronize()
    assert got.shape == (b, t, 64 * heads) and torch.isfinite(got).all()
    err = (got.float() - want).abs().max().item()
    assert err <= 2 * (plain.float() - want).abs().max().item() + 1e-3 * want.abs().max().item()
    assert torch.equal(got, k1)


def test_quant_layer_kernel_frees_its_scratch_and_repeats_its_bits(cuda):
    """A K8 call at ViT-B's width holds nothing after it returns but its
    output, peaks at most its four buffers (qkv slab, attention output,
    output, the (4D, D) dequantized weights) above where it started, and two
    calls give equal bits."""
    from dinov2_tpu_torch.ops.fused_quant_attention import slab_layer_block_quant

    b, t, heads = 4, 257, 12
    d = 64 * heads
    args = _quant_layer_inputs(b, t, heads, "q4_0", True, cuda)
    first = slab_layer_block_quant(*args, heads, 0.125, 1e-6)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    requested = torch.cuda.memory_stats()["requested_bytes.all.current"]
    torch.cuda.reset_peak_memory_stats()
    second = slab_layer_block_quant(*args, heads, 0.125, 1e-6)
    torch.cuda.synchronize()
    # bytes asked of the allocator (it may hand out a cached block up to 1 MB
    # larger, which max_memory_allocated counts)
    peak = torch.cuda.memory_stats()["requested_bytes.all.peak"] - requested
    assert torch.equal(first, second)
    del second
    assert torch.cuda.memory_allocated() == before
    buffers = 2 * (b * t * 3 * d + 2 * b * t * d + 4 * d * d)  # bf16 bytes
    assert peak <= buffers


@pytest.mark.parametrize("fmt", QUANT_FORMATS)
@pytest.mark.parametrize("b, heads", [(2, 12), (1, 24)])
def test_quant_layer_kernel_launch_order(cuda, fmt, b, heads):
    """One K8 call is six kernels on the card, in this order: the dequantize
    kernel for qkv and for proj, K1's layer norm, the QKV GEMM, the
    attention kernel and the proj GEMM, at ViT-B's and ViT-g's widths."""
    from torch.profiler import ProfilerActivity, profile

    from dinov2_tpu_torch.ops.fused_quant_attention import slab_layer_block_quant

    args = _quant_layer_inputs(b, 257, heads, fmt, True, cuda)
    slab_layer_block_quant(*args, heads, 0.125, 1e-6)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        # three calls, the last one read: the profile has been seen to lose
        # records at the start of its window (chip_smoke.py::launch_order)
        for _ in range(3):
            slab_layer_block_quant(*args, heads, 0.125, 1e-6)
        torch.cuda.synchronize()
    events = sorted((e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                     and "Memcpy" not in e.name and "Memset" not in e.name),
                    key=lambda e: e.time_range.start)
    words = ["dequant_weight_kernel", "dequant_weight_kernel", "layer_norm_rows_kernel",
             "BiasEpilogue", "flash_forward_kernel", "ResidualEpilogue"]
    kernels = events[-len(words):]
    assert len(kernels) == len(words), [e.name for e in kernels]
    for event, word in zip(kernels, words):
        assert word in event.name, [e.name for e in kernels]


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


@pytest.mark.parametrize("case", ["K8 f16", "K8 packed D=64", "K7 packed K=64", "K7 f16"])
def test_quant_kernels_refuse(cuda, case):
    from dinov2_tpu_torch.ops.fused_quant_attention import slab_layer_block_quant
    from dinov2_tpu_torch.ops.qmatmul_kernel import quant_matmul_kernel

    counts = (slab_layer_block_quant.launches, quant_matmul_kernel.launches)
    if case.startswith("K8"):
        d = 128 if case == "K8 f16" else 64
        x, lns, lnb, _, bq, _, bp, ls = _half_layer_args(1, 5, d, seed=0, device=cuda)
        if case == "K8 f16":
            x = x.half()
        wq, wp = _ql("q4_0", 3 * d, d, 1, cuda), _ql("q4_0", d, d, 2, cuda)
        with pytest.raises(NotImplementedError, match="bf16" if case == "K8 f16" else "K/2"):
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
    output, bit for bit: they run K1's attention and proj launches."""
    args = _half_layer_args(b, t, 64 * heads, seed=heads, device=cuda)
    x, _, _, _, _, wp, bp, ls = args
    out, qkv, attn = slab_layer_buffers(*args, heads, 0.125, 1e-6)
    assert torch.equal(out, slab_layer_block(*args, heads, 0.125, 1e-6))
    assert torch.equal(slab_attention(qkv, heads, 0.125), attn)
    assert torch.equal(slab_attention_block(x, qkv, wp, bp, ls, heads, 0.125), out)


RAGGED_T = (1, 63, 64, 65, 127, 128, 129, 257, 300)


@pytest.mark.parametrize("heads", [1, 3, 12])
@pytest.mark.parametrize("t", RAGGED_T)
def test_slab_kernels_match_plain_over_ragged_shapes(cuda, t, heads):
    """K1, K2 and K3 each against its plain version with K1's bound, over
    sequence lengths around the 64-key tiles and row counts M = 3 T around
    the GEMM's 128-row tiles, at D = 64, 192 (N = 64 * odd: a last column
    tile with one or three of its four swizzle atoms) and 768; K1 twice
    gives equal bits."""
    b, d = 3, 64 * heads
    args = _half_layer_args(b, t, d, seed=t + heads, device=cuda)
    x, _, _, _, _, wp, bp, ls = args
    got = slab_layer_block(*args, heads, 0.125, 1e-6)
    _bound_holds(got, slab_layer_reference(*args, heads, 0.125, 1e-6),
                 slab_layer_reference(*[a.float() for a in args], heads, 0.125, 1e-6))
    assert torch.equal(got, slab_layer_block(*args, heads, 0.125, 1e-6))
    qkv = _slab(b, t, heads, seed=t + heads, device=cuda)
    _bound_holds(slab_attention(qkv, heads, 0.125), _slab_reference(qkv, heads, 0.125),
                 _slab_reference(qkv.float(), heads, 0.125))
    block = (x, qkv, wp, bp, ls)
    _bound_holds(slab_attention_block(*block, heads, 0.125),
                 _slab_block_reference(*block, heads, 0.125),
                 _slab_block_reference(*[a.float() for a in block], heads, 0.125))


@pytest.mark.parametrize("b, t, heads", [(2, 37, 3), (4, 257, 12), (16, 257, 24), (1, 1370, 6)])
def test_flash_slab_and_slab_attention_give_equal_bits(cuda, b, t, heads):
    """flash_attention_slab and slab_attention on one slab: one kernel behind
    both, so equal bits."""
    qkv = _slab(b, t, heads, seed=t, device=cuda)
    assert torch.equal(flash_attention_slab(qkv, heads, 0.125), slab_attention(qkv, heads, 0.125))


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


@pytest.mark.parametrize("activation", ["gelu_tanh_f16", "gelu_erf", "gelu_tanh"])
@pytest.mark.parametrize("b, t, d", [(64, 1, 768), (1, 129, 384), (3, 43, 1024), (7, 300, 384)])
def test_slab_mlp_kernel_over_ragged_rows(cuda, b, t, d, activation):
    """K5's three launches where M = B T is no multiple of the GEMM's
    128-row tile (T = 1 at B = 64 is one tile exactly, the rest ragged: 129,
    129 and 2100 rows), against the plain version with K1's bound."""
    args = _mlp_args(b, t, d, seed=b + t + d, device=cuda)
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


@pytest.mark.parametrize("case", ["K3 f16", "K3 head_dim 32", "K2 f16", "K5 f16", "K5 DH = 2 D",
                                  "K5 D=128"])
def test_slab_kernels_refuse(cuda, case):
    counts = (slab_attention.launches, slab_attention_block.launches, slab_mlp_block.launches)
    with pytest.raises(NotImplementedError):
        if case == "K3 f16":  # K2, K3 and K5 take bf16 and f32
            slab_attention(_slab(1, 5, 2, seed=0, device=cuda, dtype=torch.float16), 2, 0.125)
        elif case == "K3 head_dim 32":
            slab_attention(_slab(1, 5, 2, seed=0, device=cuda, hd=32), 2, 0.125)
        elif case == "K2 f16":
            x, _, _, _, _, wp, bp, ls = _half_layer_args(1, 5, 128, seed=0, device=cuda)
            qkv = _slab(1, 5, 2, seed=0, device=cuda, dtype=torch.float16)
            slab_attention_block(x.half(), qkv, wp, bp, ls, 2, 0.125)
        elif case == "K5 f16":
            args = _mlp_args(1, 5, 384, seed=0, device=cuda)
            slab_mlp_block(args[0].half(), *args[1:], "gelu_erf", 1e-6)
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


@pytest.mark.parametrize("case", ["f16", "head_dim 32", "lse shape", "o strided"])
def test_flash_backward_refuses(cuda, case):
    """K6 takes bf16 and f32 (f32 since its f32 entry); f16 and bad shapes
    or strides it refuses, and counts nothing."""
    from dinov2_tpu_torch.ops.flash_attention import flash_backward

    dtype = torch.float16 if case == "f16" else torch.bfloat16
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
    once the grid fills the card twice over (four times for a short ragged
    T: both K3 shapes, B=64, H=12 and B=16, H=24 at T=257, and the training
    batch), 64 otherwise; K6 always 64 keys and 128 queries."""
    from dinov2_tpu_torch.ops.flash_attention import kernel_tile_rows

    assert kernel_tile_rows(8, 1370, 16) == {
        "forward": 128, "backward_keys": 64, "backward_queries": 128}
    assert kernel_tile_rows(16, 257, 12)["forward"] == 64
    assert kernel_tile_rows(32, 257, 12)["forward"] == 128
    assert kernel_tile_rows(16, 257, 24)["forward"] == 128
    assert kernel_tile_rows(64, 257, 12)["forward"] == 128
    assert kernel_tile_rows(1, 1370, 16)["forward"] == 64
    assert kernel_tile_rows(1, 4226, 16)["forward"] == 128


def test_default_trainer_takes_a_step_on_cuda(cuda):
    """`make_trainer(config)` with its own options (f32 compute, route
    "auto", device "cuda") takes a step on the card through the f32 K1
    (twice a layer with remat; the backward recomputes through the plain
    version), no bf16 kernel, and the loss equals the CPU's f32 step within
    1e-5. The explicit routes take the f32 kernels too: "slab" K1, True K4
    with lse and K6."""
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

    def counts():
        return [(c.launches, c.f32_launches) for c in counters]

    before = counts()
    trainer = make_trainer(config)
    assert trainer.device.type == "cuda" and trainer.opts.compute_dtype == torch.float32
    assert trainer.opts.flash_attention == "auto"
    _, _, metrics = trainer.step(*trainer.place(source), images, labels)
    torch.cuda.synchronize()
    cpu = make_trainer(config, device="cpu")
    _, _, cpu_metrics = cpu.step(*cpu.place(source), images, labels)
    assert torch.isfinite(metrics["loss"])
    assert abs(float(metrics["loss"]) - float(cpu_metrics["loss"])) <= 1e-5
    layers = config.num_hidden_layers
    want = [before[0][:1] + (before[0][1] + 2 * layers,), *before[1:]]
    assert counts() == want

    for route, kernels in (("slab", {0: 2 * layers}), (True, {2: 2 * layers, 3: layers})):
        forced = make_trainer(config, opts=ModelOptions(
            parity="hf", compute_dtype=torch.float32, remat=True, flash_attention=route))
        before = counts()
        _, _, forced_metrics = forced.step(*forced.place(source), images, labels)
        assert abs(float(forced_metrics["loss"]) - float(cpu_metrics["loss"])) <= 1e-5
        assert counts() == [(n, f + kernels.get(i, 0)) for i, (n, f) in enumerate(before)]


# The f32 kernels (csrc/f32_gemm.cuh, f32_attention.cuh, f32_backward.cuh):
# each against its plain f32 version on the same card, within 1e-5 (forward,
# lse) and 2e-5 (gradients) of max(1, max|plain|), at ragged T.


def _f32_close(got, want, tol):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for a, w in zip(got, want):
        assert a.dtype == torch.float32 and torch.isfinite(a).all()
        err = (a.reshape(w.shape) - w).abs().max().item()
        assert err <= tol * max(1.0, w.abs().max().item()), err


@pytest.mark.parametrize("t", [1, 5, 64, 65, 130, 261])
def test_f32_kernels_match_plain(cuda, t):
    from dinov2_tpu_torch.ops.flash_attention import (
        flash_backward,
        flash_backward_reference,
        flash_forward_lse,
        flash_forward_reference,
    )

    b, heads, d, scale = 2, 2, 128, 0.125
    qkv = _slab(b, t, heads, seed=t, device=cuda, dtype=torch.float32)
    q, k, v = split_heads(qkv, heads)
    args = [a.float() for a in _half_layer_args(b, t, d, seed=t, device=cuda)]
    x, _, _, _, _, wp, bp, ls = args
    counters = (slab_layer_block, slab_attention_block, slab_attention, flash_attention)
    before = [(c.launches, c.f32_launches) for c in counters]
    _f32_close(slab_layer_block(*args, heads, scale, 1e-6),
               slab_layer_reference(*args, heads, scale, 1e-6), 1e-5)
    _f32_close(slab_attention_block(x, qkv, wp, bp, ls, heads, scale),
               _slab_block_reference(x, qkv, wp, bp, ls, heads, scale), 1e-5)
    _f32_close(slab_attention(qkv, heads, scale), _slab_reference(qkv, heads, scale), 1e-5)
    _f32_close(flash_attention_slab(qkv, heads, scale), vanilla_attention(q, k, v, scale), 1e-5)
    assert [(c.launches, c.f32_launches) for c in counters] == [(n, f + 1) for n, f in before]
    out, lse = flash_forward_lse(q, k, v, scale)
    _f32_close((out, lse), flash_forward_reference(q, k, v, scale), 1e-5)
    assert torch.equal(out, flash_attention(q, k, v, scale))
    g = torch.from_numpy(np.random.default_rng(t).standard_normal((b, t, heads, 64))).to(
        cuda, torch.float32)
    _f32_close(flash_backward(q, k, v, out, lse, g, scale),
               flash_backward_reference(q, k, v, out, lse, g, scale), 2e-5)


@pytest.mark.parametrize("activation", ["gelu_tanh_f16", "gelu_erf", "gelu_tanh"])
@pytest.mark.parametrize("b, t, d", [(1, 1, 64), (2, 37, 128), (1, 130, 384), (3, 43, 1024)])
def test_f32_slab_mlp_kernel_matches_plain(cuda, b, t, d, activation):
    """K5 f32 (csrc/slab_mlp.cu's f32 entry) against its plain f32 version
    at widths the bf16 K5 is not built for and at ragged row counts, counted
    in `.f32_launches`. gelu_tanh_f16 rounds g to f16, so a last-bit
    difference of fc1's sums can move g by one f16 step: its bound is
    tests/test_torch_mlp_tiles.py's F32_ATOL_F16_GELU."""
    args = [a.float() for a in _mlp_args(b, t, d, seed=t + d, device=cuda)]
    before = (slab_mlp_block.launches, slab_mlp_block.f32_launches)
    _f32_close(slab_mlp_block(*args, activation, 1e-6),
               slab_mlp_reference(*args, activation, 1e-6),
               5e-4 if activation == "gelu_tanh_f16" else 1e-5)
    assert (slab_mlp_block.launches, slab_mlp_block.f32_launches) == (before[0], before[1] + 1)


@pytest.mark.parametrize("fmt, packed", [("q4_0", True), ("q5_1", True), ("q8_0", False),
                                         ("q4_1", False)])
@pytest.mark.parametrize("t", [5, 130])
def test_f32_quant_layer_kernel_is_k1_f32_on_the_dequantized_weights(cuda, fmt, packed, t):
    """K8 f32 (csrc/quant_layer.cu's f32 entry) is bit for bit K1 f32 on
    dequant_weight(W, f32).T, the "dequant" route, and within 1e-5 of its
    plain version; counted in `.f32_launches`."""
    from dinov2_tpu_torch.ops.fused_quant_attention import (
        quant_layer_reference,
        slab_layer_block_quant,
    )
    from dinov2_tpu_torch.ops.qmatmul import dequant_weight

    d, heads = 128, 2
    x, lns, lnb, _, bq, _, bp, ls = [
        a.float() for a in _half_layer_args(2, t, d, seed=t, device=cuda)]
    wq = _ql(fmt, 3 * d, d, 1, cuda, packed=packed)
    wp = _ql(fmt, d, d, 2, cuda, packed=packed)
    before = (slab_layer_block_quant.launches, slab_layer_block_quant.f32_launches)
    got = slab_layer_block_quant(x, lns, lnb, wq, bq, wp, bp, ls, heads, 0.125, 1e-6)
    assert (slab_layer_block_quant.launches, slab_layer_block_quant.f32_launches) == (
        before[0], before[1] + 1)
    dense = [dequant_weight(w, torch.float32).T.contiguous() for w in (wq, wp)]
    assert torch.equal(got, slab_layer_block(x, lns, lnb, dense[0], bq, dense[1], bp, ls, heads,
                                             0.125, 1e-6))
    _f32_close(got, quant_layer_reference(x, lns, lnb, wq, bq, wp, bp, ls, heads, 0.125, 1e-6),
               1e-5)


# K9, the int8 matmul (csrc/int8_matmul.cu): each launch bit for bit its
# plain version on the same card. The plain GEMM is the exact s32 product
# (ops/qmatmul.py::int8_product, f64 sums of integers below 2^53) and the
# same epilogue; the plain quantize is the same f32 arithmetic with an IEEE
# division.


def _int8_linear(n, k, seed, device):
    from dinov2_tpu_torch.models.params import Int8Linear

    w = np.random.default_rng(seed).standard_normal((n, k)).astype(np.float32) * 0.05
    s = np.maximum(np.abs(w).max(axis=1) / 127.0, 1e-12)
    codes = np.clip(np.rint(w / s[:, None]), -127, 127).astype(np.int8)
    return Int8Linear(codes=torch.from_numpy(codes).to(device),
                      s=torch.from_numpy(s.astype(np.float32)).to(device), shape=(n, k))


def _int8_x(m, k, dtype, seed, device):
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal((m, k)) * 2).to(device, dtype)
    x[min(3, m - 1)] = 0  # the absmax floor
    return x


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m, k", [(1, 16), (257, 768), (514, 3072), (33, 1536), (1370 * 2, 1024)])
def test_int8_quantize_kernel_equals_plain(cuda, m, k, dtype):
    from dinov2_tpu_torch.ops.int8_matmul_kernel import quantize_rows_int8_kernel
    from dinov2_tpu_torch.ops.qmatmul import quantize_rows_int8

    x = _int8_x(m, k, dtype, seed=m + k, device=cuda)
    got8, got_sx = quantize_rows_int8_kernel(x)
    want8, want_sx = quantize_rows_int8(x)
    torch.cuda.synchronize()
    assert torch.equal(got8, want8)
    assert torch.equal(got_sx.view(torch.int32), want_sx.view(torch.int32))


INT8_GEMM_CASES = [
    (16448, 768, 3072, "gelu_tanh_f16", torch.bfloat16),  # ViT-B/14 fc1
    (16448, 3072, 768, None, torch.bfloat16),  # fc2
    (64, 1536, 1000, None, torch.float32),  # the head on f32 features
    (2740, 1024, 3072, None, torch.bfloat16),  # qkv at T=1370
    (257, 384, 1000, "gelu_erf", torch.bfloat16),
    (514, 640, 33, "gelu_tanh", torch.float32),  # K = 128 * 5, N = 33 stored value by value
    (1, 128, 40, None, torch.bfloat16),
]


@pytest.mark.parametrize("m, k, n, activation, dtype", INT8_GEMM_CASES)
def test_int8_gemm_kernel_equals_plain(cuda, m, k, n, activation, dtype):
    from dinov2_tpu_torch.ops.int8_matmul_kernel import (
        int8_gemm_kernel,
        int8_matmul_kernel,
        quantize_rows_int8_kernel,
    )
    from dinov2_tpu_torch.ops.qmatmul import int8_epilogue, int8_matmul_reference, int8_product

    il = _int8_linear(n, k, seed=n, device=cuda)
    x = _int8_x(m, k, dtype, seed=k, device=cuda)
    bias = torch.from_numpy(np.random.default_rng(1).standard_normal(n) * 0.1).to(cuda, torch.float32)
    x8, sx = quantize_rows_int8_kernel(x)
    for b in (bias, None):
        got = int8_gemm_kernel(x8, sx, il, b, activation, dtype)
        want = int8_epilogue(int8_product(x8, il.codes), sx, il.s, dtype, b, activation)
        torch.cuda.synchronize()
        assert got.dtype == dtype and got.shape == (m, n)
        assert torch.equal(got, want), (got.float() - want.float()).abs().max().item()
    assert torch.equal(int8_matmul_kernel(x, il, bias, activation),
                       int8_matmul_reference(x, il, bias, activation))


def test_int8_launch_counters_count_kernel_calls_only(cuda):
    from dinov2_tpu_torch.ops.int8_matmul_kernel import (
        int8_gemm_kernel,
        int8_matmul_kernel,
        quantize_rows_int8_kernel,
    )
    from dinov2_tpu_torch.ops.qmatmul import int8_matmul_reference

    il = _int8_linear(256, 384, seed=0, device=cuda)
    x = _int8_x(20, 384, torch.bfloat16, seed=0, device=cuda)
    before = quantize_rows_int8_kernel.launches, int8_gemm_kernel.launches
    int8_matmul_reference(x, il)
    int8_matmul_kernel(x.cpu(), _int8_linear(256, 384, seed=0, device="cpu"))
    assert (quantize_rows_int8_kernel.launches, int8_gemm_kernel.launches) == before
    int8_matmul_kernel(x, il)
    assert (quantize_rows_int8_kernel.launches, int8_gemm_kernel.launches) == (
        before[0] + 1, before[1] + 1)


@pytest.mark.parametrize("case", ["K % 128", "f16 x", "weight on the CPU"])
def test_int8_kernel_refuses(cuda, case):
    from dinov2_tpu_torch.ops.int8_matmul_kernel import int8_matmul_kernel

    k = 192 if case == "K % 128" else 256
    il = _int8_linear(64, k, seed=0, device="cpu" if case == "weight on the CPU" else cuda)
    x = _int8_x(8, k, torch.float16 if case == "f16 x" else torch.bfloat16, seed=0, device=cuda)
    with pytest.raises((NotImplementedError, ValueError)):
        int8_matmul_kernel(x, il)


@pytest.mark.parametrize("quant_slab", ["auto", "off"])
def test_engine_int8_classify_on_cuda_close_to_cpu_f32(cuda, tmp_path, quant_slab):
    """DinoEngine(quant_mode="int8") in bf16 on the card against the same
    file in f32 on the CPU: "auto" runs K1 on the dequantized qkv/proj and
    K9 for fc1, fc2 and the head; "off" K9 for every linear around K3. A bf16
    activation quantizes to codes one step from the f32 one's in places, so
    the bound is the int8 mode's own against dense (JAX's 0.15 in
    tests/test_int8_mode.py) cut to 2e-2, with top-1 equal."""
    from dinov2_tpu_torch.ops.int8_matmul_kernel import int8_gemm_kernel, quantize_rows_int8_kernel
    from dinov2_tpu_torch.runtime.engine import DinoEngine

    config = DinoConfig(hidden_size=128, num_hidden_layers=2, num_attention_heads=2,
                        num_classes=4, patch_size=14, img_size=70)
    path = write_synthetic_gguf(tmp_path / "tiny.gguf", config, seed=3)
    imgs = np.random.default_rng(0).integers(0, 256, (3, 90, 100, 3), dtype=np.uint8)
    gpu = DinoEngine(path, dtype=torch.bfloat16, device="cuda", quant_mode="int8",
                     quant_slab=quant_slab)
    counts = (quantize_rows_int8_kernel.launches, int8_gemm_kernel.launches,
              slab_layer_block.launches)
    got = gpu.classify_probs(imgs)
    layers = config.num_hidden_layers
    per_layer = 2 if quant_slab == "auto" else 4
    assert (quantize_rows_int8_kernel.launches - counts[0], int8_gemm_kernel.launches - counts[1],
            slab_layer_block.launches - counts[2]) == (
        per_layer * layers + 1, per_layer * layers + 1, layers if quant_slab == "auto" else 0)
    want = DinoEngine(path, dtype=torch.float32, device="cpu", quant_mode="int8",
                      quant_slab=quant_slab).classify_probs(imgs)
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() < 2e-2
    assert (got.argmax(-1) == want.argmax(-1)).all()


def _operator_cases():
    from test_torch_custom_ops import NAMES

    return NAMES


@pytest.mark.parametrize("name", _operator_cases())
def test_operator_cuda_implementation_matches_plain(cuda, name):
    """Each dinov2_tpu_torch operator on CUDA tensors (the kernel launch)
    against its CPU implementation (the plain version) on the same inputs in
    bf16 and in f32, as test_slab_layer_kernel_matches_plain bounds K1; and
    the wrapper's launch count gains one (`.f32_launches` for f32 x where
    the wrapper keeps one)."""
    from test_torch_custom_ops import _op, cases

    from dinov2_tpu_torch.ops import fused_attention, fused_quant_attention, qmatmul_kernel
    from dinov2_tpu_torch.ops.flash_attention import flash_attention

    counters = {
        "slab_layer_block": fused_attention.slab_layer_block,
        "slab_attention_block": fused_attention.slab_attention_block,
        "slab_attention": fused_attention.slab_attention, "flash_attention": flash_attention,
        "flash_attention_lse": flash_attention, "slab_mlp_block": fused_attention.slab_mlp_block,
        "quant_matmul": qmatmul_kernel.quant_matmul_kernel,
        "slab_layer_block_quant": fused_quant_attention.slab_layer_block_quant,
    }
    args, _ = cases()[name]
    counter = counters[name.split()[0]]
    field = ("f32_launches" if args[0].dtype == torch.float32 and hasattr(counter, "f32_launches")
             else "launches")
    before = getattr(counter, field)
    got = _op(name)(*[a.to(cuda) if torch.is_tensor(a) else a for a in args])
    torch.cuda.synchronize()
    assert getattr(counter, field) == before + 1
    plain = _op(name)(*args)
    want = _op(name)(*[a.float() if torch.is_tensor(a) and a.dtype == torch.bfloat16 else a
                       for a in args])
    for g, p, w in zip(*(o if isinstance(o, tuple) else (o,) for o in (got, plain, want))):
        assert g.shape == p.shape and g.dtype == p.dtype and torch.isfinite(g).all()
        err = (g.cpu().float() - w).abs().max().item()
        err_plain = (p.float() - w).abs().max().item()
        assert err <= 2 * err_plain + 1e-3 * w.abs().max().item()


@pytest.mark.parametrize(
    "quant, options, counter",
    [(None, {}, "K1"), (None, {"flash_attention": True}, "K4"),
     ("q4_0", {}, "K8"), ("q4_0", {"quant_slab": "off"}, "K7")],
)
def test_artifact_equals_the_eager_forward_on_cuda(cuda, tmp_path, quant, options, counter):
    """An artifact exported for the card runs the same kernels as the eager
    forward on the same weights and input: equal bit for bit, and each call
    launches the kernel once a layer (K7: fc1, fc2 and the head too, and
    qkv and proj under quant_slab="off")."""
    from dinov2_tpu_torch.models.params import load_params
    from dinov2_tpu_torch.models.vit import ModelOptions, forward
    from dinov2_tpu_torch.ops.fused_quant_attention import slab_layer_block_quant
    from dinov2_tpu_torch.ops.qmatmul_kernel import quant_matmul_kernel
    from dinov2_tpu_torch.quant import quantize_gguf
    from dinov2_tpu_torch.runtime.aot import export_forward, load_artifact, save_artifact

    config = DinoConfig(hidden_size=128, num_hidden_layers=2, num_attention_heads=2,
                        num_classes=4, patch_size=14, img_size=70)
    path = write_synthetic_gguf(tmp_path / "tiny.gguf", config, seed=3)
    if quant:
        path = quantize_gguf(path, tmp_path / "q.gguf", quant)
    loaded = load_params(path, dtype=torch.bfloat16, device="cuda",
                         quant_mode="fused" if quant else "dequant")
    opts = ModelOptions(**options)
    save_artifact(tmp_path / "m.aot", export_forward(loaded.params, config, opts, batch=2,
                                                     height=70, width=70, platforms=("cuda",)))
    art = load_artifact(tmp_path / "m.aot")
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 70, 70, 3))).to(
        cuda, torch.float32)
    kernel = {"K1": slab_layer_block, "K4": flash_attention, "K8": slab_layer_block_quant,
              "K7": quant_matmul_kernel}[counter]
    with torch.inference_mode():
        want = forward(loaded.params, x, config, opts, classify=True)
        before = kernel.launches
        got = art(loaded.params, x)
        torch.cuda.synchronize()
    per_call = {"K1": 2, "K4": 2, "K8": 2, "K7": 4 * 2 + 1}[counter]
    assert kernel.launches - before == per_call
    for key in want:
        assert torch.equal(got[key], want[key]), key


MESH_CONFIG = DinoConfig(hidden_size=256, num_hidden_layers=4, num_attention_heads=4,
                         num_classes=4, patch_size=14, img_size=70)


def _mesh_weights(tmp_path, quant):
    """MESH_CONFIG's weights on the card, bf16, dense or in `quant` (fused)."""
    from dinov2_tpu_torch.models.params import load_params
    from dinov2_tpu_torch.quant import quantize_gguf

    path = write_synthetic_gguf(tmp_path / "mesh.gguf", MESH_CONFIG, seed=5)
    if quant:
        path = quantize_gguf(path, tmp_path / "mesh.q.gguf", quant)
    return path, load_params(path, dtype=torch.bfloat16, device="cuda",
                             quant_mode="fused" if quant else "dequant")


def _mesh_input(cuda, b):
    return torch.from_numpy(np.random.default_rng(1).standard_normal((b, 224, 224, 3))).to(
        cuda, torch.float32)


@pytest.mark.parametrize("quant", [None, "q4_0"])
def test_mesh_tp_two_shards_on_one_card(cuda, tmp_path, quant):
    """A 2-way TP forward with both shards on the card (K3 on each shard's 2
    heads, K7 on the weight shards when quantized) against the
    single-device forward, both held to the CPU f32 forward on the same
    weights: the TP tokens at most twice the single-device route's distance
    plus 1e-3 of their scale."""
    from dinov2_tpu_torch.models.params import load_params
    from dinov2_tpu_torch.models.vit import ModelOptions, forward
    from dinov2_tpu_torch.ops.qmatmul_kernel import quant_matmul_kernel
    from dinov2_tpu_torch.parallel.mesh import make_mesh, place
    from dinov2_tpu_torch.parallel.tp_fused import (
        make_tp_forward,
        tp_prepare_dense_params,
        tp_prepare_params,
    )

    path, loaded = _mesh_weights(tmp_path, quant)
    mesh = make_mesh({"model": 2}, devices=[cuda] * 2)
    prepare = tp_prepare_params if quant else tp_prepare_dense_params
    params_tp, specs = prepare(loaded.params, MESH_CONFIG, 2)
    placed = place(params_tp, mesh, specs)
    opts = ModelOptions()
    x = _mesh_input(cuda, 4)
    with torch.inference_mode():
        counts = slab_attention.launches, quant_matmul_kernel.launches
        got = make_tp_forward(MESH_CONFIG, opts, mesh)[True](placed, x)
        torch.cuda.synchronize()
        layers = MESH_CONFIG.num_hidden_layers
        assert slab_attention.launches - counts[0] == 2 * layers
        assert quant_matmul_kernel.launches - counts[1] == (8 * layers + 1 if quant else 0)
        single = forward(loaded.params, x, MESH_CONFIG, opts, classify=True)
        cpu = load_params(path, dtype=torch.float32, device="cpu")
        want = forward(cpu.params, x.cpu(), MESH_CONFIG,
                       ModelOptions(compute_dtype=torch.float32), classify=True)
    for key in ("patch_tokens", "probs"):
        err = (got[key].cpu() - want[key]).abs().max().item()
        err_single = (single[key].cpu() - want[key]).abs().max().item()
        assert err <= 2 * err_single + 1e-3 * want[key].abs().max().item(), key


@pytest.mark.parametrize("quant", [None, "q4_0"])
def test_mesh_data_parallel_bit_for_bit(cuda, tmp_path, quant):
    """{"data": 4} on one card: each slice is the single-device forward on
    that slice, bit for bit (K1 or K8 and K7 in each replica). Against one
    call on the whole batch of 8 it was not, on an H100: the slices' rows
    round differently somewhere outside the layers, since the pipeline test
    below runs the layers on microbatches of the same 2 rows, after one
    whole-batch embedding, and holds bit for bit. The likely place is the
    patch embedding's f32 matmul, which a library may compute by another
    algorithm at 512 rows than at 2048 (not isolated)."""
    from dinov2_tpu_torch.models.vit import ModelOptions, forward
    from dinov2_tpu_torch.parallel.mesh import make_mesh, replicate, shard_map_data_parallel

    _, loaded = _mesh_weights(tmp_path, quant)
    mesh = make_mesh({"data": 4}, devices=[cuda] * 4)
    opts = ModelOptions()
    x = _mesh_input(cuda, 8)

    def fn(params, xs):
        return forward(params, xs, MESH_CONFIG, opts, classify=True)

    with torch.inference_mode():
        got = shard_map_data_parallel(fn, mesh)(replicate(loaded.params, mesh), x)
        slices = [fn(loaded.params, x[i: i + 2]) for i in range(0, 8, 2)]
        want = {key: torch.cat([s[key] for s in slices]) for key in slices[0]}
    for key in want:
        assert torch.equal(got[key], want[key]), key


def test_mesh_pipeline_bit_for_bit(cuda, tmp_path):
    """pipeline_forward over 2 stages on one card, 4 microbatches, against
    the sequential forward on the whole batch, bit for bit."""
    from dinov2_tpu_torch.models.vit import ModelOptions, forward
    from dinov2_tpu_torch.parallel.mesh import make_mesh
    from dinov2_tpu_torch.parallel.pipeline import pipeline_forward, place_pipeline_params

    _, loaded = _mesh_weights(tmp_path, None)
    mesh = make_mesh({"stage": 2}, devices=[cuda] * 2)
    opts = ModelOptions()
    x = _mesh_input(cuda, 8)
    with torch.inference_mode():
        before = slab_layer_block.launches
        got = pipeline_forward(place_pipeline_params(loaded.params, mesh), x, MESH_CONFIG, opts,
                               mesh, num_microbatches=4, classify=True)
        assert slab_layer_block.launches - before == 4 * MESH_CONFIG.num_hidden_layers
        want = forward(loaded.params, x, MESH_CONFIG, opts, classify=True)
    for key in want:
        assert torch.equal(got[key], want[key]), key


class _SGD:
    """p -= g: after one step p0 - p1 is the step's raw gradient."""

    def init(self, params):
        return {}

    @torch.no_grad()
    def update_(self, params, grads, state):
        from dinov2_tpu_torch.models.params import tree_leaves

        torch._foreach_add_(tree_leaves(params), grads, alpha=-1.0)


@pytest.mark.parametrize("axes, route, sp", [
    ({"data": 2, "model": 2}, True, False),
    ({"data": 2, "model": 2}, "auto", False),
    ({"data": 2, "model": 2}, True, True),
    ({"data": 4}, "auto", False),
], ids=["tp-flash", "tp-auto", "tp-sp-flash", "dp-auto"])
def test_mesh_train_step_on_one_card(cuda, axes, route, sp):
    """One Trainer(mesh=) step with every position on the card, bf16 over f32
    masters, remat, SGD(1.0): its launches (TP: K4 with lse twice and K6 once
    a shard a layer on the flash route; K3 twice, K4 with lse and K6 once in
    its backward on "auto"; DP: K1 twice a replica a layer), and each leaf's
    raw gradient (p0 - p1) within twice the single-device bf16 step's
    distance from the single-device f32 step (plain attention), plus 1e-3
    of the leaf's max|g|."""
    from dinov2_tpu_torch.models.params import init_params, tree_leaves
    from dinov2_tpu_torch.models.vit import ModelOptions
    from dinov2_tpu_torch.parallel.mesh import make_mesh
    from dinov2_tpu_torch.parallel.train import Trainer

    source = init_params(MESH_CONFIG, seed=5, dtype=torch.float32)
    rng = np.random.default_rng(2)
    images = rng.integers(0, 256, (8, 256, 256, 3), dtype=np.uint8)
    labels = rng.integers(0, MESH_CONFIG.num_classes, 8)
    counters = {"K1": slab_layer_block, "K3": slab_attention, "K4": flash_attention}

    def step(mesh, route, dtype, sp=False):
        from dinov2_tpu_torch.ops.flash_attention import flash_backward

        opts = ModelOptions(parity="hf", flash_attention=route, compute_dtype=dtype, remat=True,
                            sequence_parallel=sp)
        trainer = Trainer(MESH_CONFIG, opts, _SGD(), mesh=mesh, device="cuda")
        params, state = trainer.place(source)
        before = {k: c.launches for k, c in {**counters, "K6": flash_backward}.items()}
        trainer.step(params, state, images, labels)
        torch.cuda.synchronize()
        launches = {k: c.launches - before[k]
                    for k, c in {**counters, "K6": flash_backward}.items()}
        after = tree_leaves(trainer.unplace(params)[0])
        return [s.to(cuda) - p for s, p in zip(tree_leaves(source), after)], launches

    grads32, _ = step(None, False, torch.float32)
    single, _ = step(None, route, torch.bfloat16)
    mesh = make_mesh(axes, devices=[cuda] * int(np.prod(list(axes.values()))))
    got, launches = step(mesh, route, torch.bfloat16, sp)
    n, layers = mesh.size, MESH_CONFIG.num_hidden_layers
    if "model" not in axes:
        want = {"K1": 2 * layers * n}
    elif route is True:
        want = {"K4": 2 * layers * n, "K6": layers * n}
    else:
        want = {"K3": 2 * layers * n, "K4": layers * n, "K6": layers * n}
    assert launches == {k: want.get(k, 0) for k in launches}
    for g, s, w in zip(got, single, grads32):
        bound = 2 * (s - w).abs().max().item() + 1e-3 * w.abs().max().item()
        assert (g - w).abs().max().item() <= bound


@pytest.fixture
def two_cards(cuda):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    return [torch.device("cuda", 0), torch.device("cuda", 1)]


def _mesh_batch():
    rng = np.random.default_rng(2)
    return (rng.integers(0, 256, (8, 256, 256, 3), dtype=np.uint8),
            rng.integers(0, MESH_CONFIG.num_classes, 8))


@pytest.mark.parametrize("route", [True, "auto"], ids=["flash", "auto"])
def test_tp_remat_across_two_cards_is_one_card(two_cards, route):
    """A TP {"data": 1, "model": 2} Trainer step with remat, its positions
    on cuda:0 and cuda:1, against the same mesh with both positions on
    cuda:0: the loss and every unplaced parameter bit for bit. Each layer's
    shards then span two cards, and its recompute is reached from both
    devices' autograd threads: torch.utils.checkpoint raced there (one
    counted 61 saved tensors against 60), which
    parallel/tp_fused.py::_RematLayer repairs; a return of the race fails
    here."""
    from dinov2_tpu_torch.models.params import init_params, tree_leaves
    from dinov2_tpu_torch.models.vit import ModelOptions
    from dinov2_tpu_torch.parallel.mesh import make_mesh
    from dinov2_tpu_torch.parallel.train import AdamW, Trainer

    source = init_params(MESH_CONFIG, seed=5, dtype=torch.float32)
    images, labels = _mesh_batch()

    def run(devices):
        opts = ModelOptions(parity="hf", flash_attention=route, compute_dtype=torch.bfloat16,
                            remat=True)
        trainer = Trainer(MESH_CONFIG, opts, AdamW(1e-4, 0.05),
                          mesh=make_mesh({"data": 1, "model": 2}, devices=devices),
                          device="cuda")
        params, state = trainer.place(source)
        params, state, metrics = trainer.step(params, state, images, labels)
        return float(metrics["loss"]), tree_leaves(trainer.unplace(params)[0])

    loss_two, two = run(two_cards)
    loss_one, one = run([two_cards[0]] * 2)
    assert loss_two == loss_one
    for a, b in zip(two, one):
        assert torch.equal(a.to(b.device), b)


def test_pipeline_across_two_cards_is_one_card(two_cards):
    """{"stage": 2} in one process with stage s on cuda:s (each hand-off a
    copy between the cards, forward and backward) against both stages on
    cuda:0: pipeline_forward's outputs, and the losses and every unplaced
    parameter after two AdamW steps of make_pipeline_train_step ("auto",
    remat), bit for bit."""
    from dinov2_tpu_torch.image.preprocess import classify_preprocess
    from dinov2_tpu_torch.models.params import init_params, tree_leaves
    from dinov2_tpu_torch.models.vit import ModelOptions
    from dinov2_tpu_torch.parallel.mesh import make_mesh, unplace
    from dinov2_tpu_torch.parallel.pipeline import (
        layer_pspecs,
        make_pipeline_train_step,
        pipeline_forward,
        place_pipeline_params,
    )
    from dinov2_tpu_torch.parallel.train import AdamW

    source = init_params(MESH_CONFIG, seed=5, dtype=torch.float32)
    images, labels = _mesh_batch()
    x = classify_preprocess(torch.from_numpy(images).to(two_cards[0]))

    def run(devices):
        mesh = make_mesh({"stage": 2}, devices=devices)
        opts = ModelOptions(parity="hf", compute_dtype=torch.bfloat16, remat=True)
        with torch.inference_mode():
            out = pipeline_forward(place_pipeline_params(source, mesh), x, MESH_CONFIG, opts,
                                   mesh, num_microbatches=4, classify=True)
        step, place = make_pipeline_train_step(MESH_CONFIG, opts, mesh, AdamW(1e-4, 0.05), 4)
        params, state = place(source)
        losses = [float(step(params, state, x, labels)[2]["loss"]) for _ in range(2)]
        return out, losses, tree_leaves(unplace(params, mesh, layer_pspecs(params[0])))

    out_two, losses_two, two = run(two_cards)
    out_one, losses_one, one = run([two_cards[0]] * 2)
    for key in out_one:
        assert torch.equal(out_two[key].to(two_cards[0]), out_one[key]), key
    assert losses_two == losses_one
    for a, b in zip(two, one):
        assert torch.equal(a.to(b.device), b)
