"""The port's DinoEngine (CPU, f32) against the JAX DinoEngine on the same
tiny GGUF and images."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (caps torch's threads under xdist)

from dinov2_tpu.io.synthetic import write_synthetic_gguf
from dinov2_tpu.models.config import DinoConfig
from dinov2_tpu.runtime.engine import DinoEngine as JaxEngine
from dinov2_tpu_torch.runtime.engine import DinoEngine

TINY = DinoConfig(hidden_size=64, num_hidden_layers=2, num_attention_heads=2,
                  num_classes=4, patch_size=14, img_size=70)
PROB_ATOL = 1e-6  # f32 envelope of docs/PARITY.md on probs


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    path = write_synthetic_gguf(tmp_path_factory.mktemp("ckpt") / "tiny.gguf", TINY, seed=3)
    return (
        JaxEngine(path, dtype=jnp.float32),
        DinoEngine(path, dtype=torch.float32, device="cpu"),
    )


@pytest.mark.parametrize("n", [1, 3, 4])
def test_classify_probs_matches_jax(engines, n):
    """Batches of 1, 3 (padded to the bucket of 4) and 4 images."""
    jax_engine, engine = engines
    imgs = np.random.default_rng(n).integers(0, 256, (n, 100, 120, 3), dtype=np.uint8)
    want = jax_engine.classify_probs(imgs)
    got = engine.classify_probs(imgs)
    assert got.shape == (n, TINY.num_classes) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=PROB_ATOL, rtol=0)
    assert engine.last_compute_ms > 0


def test_mixed_sizes_match_jax(engines):
    jax_engine, engine = engines
    rng = np.random.default_rng(9)
    imgs = [
        rng.integers(0, 256, (100, 120, 3), dtype=np.uint8),
        rng.integers(0, 256, (64, 64, 3), dtype=np.uint8),
        rng.integers(0, 256, (100, 120, 3), dtype=np.uint8),
    ]
    got = engine.classify_probs(imgs)
    np.testing.assert_allclose(got, jax_engine.classify_probs(imgs), atol=PROB_ATOL, rtol=0)
    for i, img in enumerate(imgs):  # one batch equals per-image runs
        np.testing.assert_allclose(got[i], engine.classify_probs(img)[0], atol=PROB_ATOL)


def test_classify_topk_and_metadata(engines):
    jax_engine, engine = engines
    imgs = np.random.default_rng(5).integers(0, 256, (2, 80, 80, 3), dtype=np.uint8)
    got = engine.classify(imgs, topk=2)
    want = jax_engine.classify(imgs, topk=2)
    assert [[label for label, _ in row] for row in got] == [
        [label for label, _ in row] for row in want
    ]
    assert engine.config.__dict__ == jax_engine.config.__dict__  # the port's own class
    assert engine.id2label == jax_engine.id2label
    assert engine.loaded.has_classifier
    engine.warmup((80, 80), batch=2)


def test_cuda_engine_raises_without_a_gpu(tmp_path, monkeypatch):
    """device='cuda' never falls back to the CPU."""
    path = write_synthetic_gguf(tmp_path / "tiny.gguf", TINY, seed=3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DinoEngine(path, device="cuda")


def test_profile_script_needs_a_gpu(monkeypatch, capsys):
    """The classify-path profile runs on a CUDA device only and prints no
    numbers without one."""
    from dinov2_tpu_torch.utils import profile_slice

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert profile_slice.main() == 1
    out = capsys.readouterr()
    assert out.out == "" and "no CUDA device" in out.err
