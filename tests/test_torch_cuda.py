"""The port's hand-written CUDA kernels against their plain PyTorch versions,
on the card. Every test here is marked `cuda` and skips without a GPU.

The GPU machine has no jax, and tests/conftest.py imports it, so run there:

    python -m pytest -p no:cacheprovider --noconftest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from dinov2_tpu_torch.io.synthetic import write_synthetic_gguf
from dinov2_tpu_torch.models.config import DinoConfig
from dinov2_tpu_torch.ops.fused_attention import slab_layer_block, slab_layer_reference

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
