"""DinoEngine's staging (CPU, f32, a tiny GGUF): one reused host buffer that
each image is written into once, padding made on the device. Its answers
against the host staging of tests/torch_host_staging.py (stack, pad on the
host, copy), its reuse across calls, and its counters."""

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (caps torch's threads under xdist)

import torch_host_staging as host_staging
from dinov2_tpu_torch.io.synthetic import write_synthetic_gguf
from dinov2_tpu_torch.models.config import DinoConfig
from dinov2_tpu_torch.runtime.engine import DinoEngine

TINY = DinoConfig(hidden_size=64, num_hidden_layers=2, num_attention_heads=2,
                  num_classes=4, patch_size=14, img_size=70)
# Mixed-size classify preprocesses a group at its own row count where the
# host staging preprocessed it at its bucket: the bicubic resize is matmuls
# whose batch folds into N, and BLAS may round 48 rows otherwise than 64.
MIXED_PROB_ATOL = 1e-6


@pytest.fixture(scope="module")
def path(tmp_path_factory):
    return write_synthetic_gguf(tmp_path_factory.mktemp("ckpt") / "tiny.gguf", TINY, seed=3)


def _engine(path):
    return DinoEngine(path, dtype=torch.float32, device="cpu")


@pytest.fixture(scope="module")
def engine(path):
    return _engine(path)


def _images(seed, sizes, dtype=np.uint8):
    """Images of the given (count, H, W), shuffled by the seed."""
    rng = np.random.default_rng(seed)
    imgs = [rng.integers(0, 256, (h, w, 3)).astype(dtype)
            for n, h, w in sizes for _ in range(n)]
    return [imgs[i] for i in rng.permutation(len(imgs))]


# name -> (sizes, tolerance): groups whose row counts are their buckets are
# preprocessed on the same rows as by the host staging, so bit for bit
MIXES = {
    "48+16": ([(48, 28, 42), (16, 42, 28)], MIXED_PROB_ATOL),
    "5+2+1": ([(5, 30, 40), (2, 40, 30), (1, 33, 33)], MIXED_PROB_ATOL),
    "4+2": ([(4, 28, 42), (2, 42, 28)], 0.0),
}


@pytest.mark.parametrize("mix", MIXES)
def test_mixed_classify_equals_the_host_staging(engine, mix):
    sizes, atol = MIXES[mix]
    imgs = _images(7, sizes)
    got = engine.classify_probs(imgs)
    want = host_staging.classify_probs(engine, imgs)
    assert got.shape == want.shape == (len(imgs), TINY.num_classes)
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


def test_mixed_classify_keeps_the_input_order(engine):
    """Each image's answer follows it wherever it stands in the call."""
    imgs = _images(8, MIXES["5+2+1"][0])
    got = engine.classify_probs(imgs)
    perm = np.random.default_rng(1).permutation(len(imgs))
    np.testing.assert_allclose(engine.classify_probs([imgs[i] for i in perm]), got[perm],
                               atol=MIXED_PROB_ATOL, rtol=0)
    for i in (0, len(imgs) - 1):
        np.testing.assert_allclose(engine.classify_probs(imgs[i])[0], got[i],
                                   atol=MIXED_PROB_ATOL, rtol=0)


@pytest.mark.parametrize("n", [1, 3, 4])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_single_size_entries_equal_the_host_staging_bit_for_bit(engine, n, dtype):
    """One size: the device pads the rows the host padded, so preprocess
    sees the same batch; float images take their own dtype's slice."""
    imgs = _images(n, [(n, 42, 56)], dtype)
    np.testing.assert_array_equal(engine.classify_probs(np.stack(imgs)),
                                  host_staging.classify_probs(engine, imgs))
    got, want = engine.extract_features(imgs), host_staging.extract_features(engine, imgs)
    assert got["grid"] == (4, 5)
    for key in ("cls_token", "patch_tokens"):
        np.testing.assert_array_equal(got[key], want[key])


def test_pca_visualizations_equal_the_host_staging_bit_for_bit(engine):
    imgs = _images(9, [(3, 42, 56), (2, 56, 42)])
    for got, want in zip(engine.pca_visualizations(imgs),
                         host_staging.pca_visualizations(engine, imgs)):
        np.testing.assert_array_equal(got, want)


def test_consecutive_calls_give_a_fresh_engines_answers(path):
    """A reused buffer aliases no result: each call's answer, kept across the
    next call on other images, is a fresh engine's on its own images."""
    engine = _engine(path)
    first, second = _images(10, MIXES["48+16"][0]), _images(11, MIXES["48+16"][0])
    probs = [engine.classify_probs(first), engine.classify_probs(second)]
    np.testing.assert_array_equal(probs[0], _engine(path).classify_probs(first))
    np.testing.assert_array_equal(probs[1], _engine(path).classify_probs(second))
    frames = _images(12, [(2, 42, 56)])
    queued = [engine.pca_visualization_async(f) for f in frames]
    for frame, vis in zip(frames, queued):
        np.testing.assert_array_equal(vis.numpy(),
                                      _engine(path).pca_visualization_async(frame).numpy())
    feats = [engine.extract_features(f[None]) for f in frames]
    for frame, got in zip(frames, feats):
        want = _engine(path).extract_features(frame[None])
        np.testing.assert_array_equal(got["patch_tokens"], want["patch_tokens"])


def test_the_staging_buffer_is_reused(path):
    """Allocated once for a shape and kept across calls of that shape; grown
    once by a larger call and kept for smaller ones; never pinned on the
    CPU."""
    engine = _engine(path)
    imgs = _images(13, MIXES["48+16"][0])
    engine.classify_probs(imgs)
    allocs, buffer = DinoEngine.staging_allocs, engine._staging
    for _ in range(3):
        engine.classify_probs(imgs)
    assert DinoEngine.staging_allocs == allocs and engine._staging is buffer
    larger = imgs + _images(14, [(8, 56, 56)])
    engine.classify_probs(larger)
    assert DinoEngine.staging_allocs == allocs + 1
    grown = engine._staging
    assert grown.numel() > buffer.numel()
    engine.extract_features(_images(15, [(3, 42, 56)]))
    engine.pca_visualizations(imgs)
    engine.classify_probs(larger)
    assert DinoEngine.staging_allocs == allocs + 1 and engine._staging is grown
    assert not grown.is_pinned()


def test_the_row_counters_on_the_cpu(engine):
    """Every row crosses once, none of them padding and none from pinned
    memory."""
    before = (DinoEngine.uploaded_rows, DinoEngine.padded_rows, DinoEngine.pinned_rows)
    engine.classify_probs(_images(16, [(3, 28, 42), (2, 42, 28)]))
    engine.extract_features(_images(17, [(3, 42, 56)]))
    after = (DinoEngine.uploaded_rows, DinoEngine.padded_rows, DinoEngine.pinned_rows)
    assert tuple(a - b for a, b in zip(after, before)) == (8, 0, 0)


def test_mixed_sizes_in_one_feature_batch_raise(engine):
    with pytest.raises(ValueError, match="of one size"):
        engine.extract_features(_images(18, [(1, 42, 56), (1, 56, 42)]))
