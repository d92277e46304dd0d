"""The port's image loading (runtime/loader.py: list_images, BatchLoader)
against the JAX package's on the same files, and an eval batch through both
engines."""

import threading

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (caps torch's threads under xdist)

from dinov2_tpu.io.synthetic import write_synthetic_gguf
from dinov2_tpu.models.config import DinoConfig
from dinov2_tpu.runtime import loader as jloader
from dinov2_tpu.runtime.engine import DinoEngine as JaxEngine
from dinov2_tpu_torch.runtime.engine import DinoEngine
from dinov2_tpu_torch.runtime.loader import BatchLoader, list_images

TINY = DinoConfig(hidden_size=64, num_hidden_layers=2, num_attention_heads=2,
                  num_classes=4, patch_size=14, img_size=70)
PROB_ATOL = 1e-5  # probs of one eval batch, port f32 against JAX f32


@pytest.fixture
def image_dir(tmp_path):
    """Seven images of different sizes, two in a subdirectory, mixed-case
    extensions, and a file that is not an image."""
    rng = np.random.default_rng(7)
    d = tmp_path / "imgs"
    (d / "sub").mkdir(parents=True)
    names = ["b.jpg", "a.png", "C.JPG", "sub/d.bmp", "sub/e.png", "f.jpeg", "g.webp"]
    for i, name in enumerate(names):
        cv2.imwrite(str(d / name), rng.integers(0, 256, (60 + 3 * i, 80 + i, 3), dtype=np.uint8))
    (d / "notes.txt").write_text("not an image")
    return d


def test_list_images_matches_jax(image_dir):
    got = list_images(image_dir)
    assert got == jloader.list_images(image_dir)
    assert len(got) == 7 and got == sorted(got)
    assert list_images(got[0]) == [got[0]]  # a file lists itself


@pytest.mark.parametrize("interpolation", ["nearest", "cubic-float"])
def test_batches_match_jax(image_dir, interpolation):
    """The same paths and the same arrays, batch by batch: uint8 for
    "nearest", float32 in [0, 1] for "cubic-float"."""
    paths = list_images(image_dir)
    kwargs = dict(batch_size=3, size=(64, 72), interpolation=interpolation)
    got = list(BatchLoader(paths, **kwargs))
    want = list(jloader.BatchLoader(paths, **kwargs))
    assert len(got) == len(want) == 3 == len(BatchLoader(paths, **kwargs))
    assert [b[1].shape[0] for b in got] == [3, 3, 1]
    for (gp, gi), (wp, wi) in zip(got, want):
        assert gp == wp
        assert gi.dtype == wi.dtype == (np.uint8 if interpolation == "nearest" else np.float32)
        assert gi.shape[1:] == (64, 72, 3)
        np.testing.assert_array_equal(gi, wi)
    if interpolation == "cubic-float":
        # the reference's order: float32/255 first, then INTER_CUBIC
        ref = cv2.resize(jloader.decode_rgb(paths[0]).astype(np.float32) / 255.0, (72, 64),
                         interpolation=cv2.INTER_CUBIC)
        np.testing.assert_array_equal(got[0][1][0], ref)


def test_no_resize_keeps_the_decoded_image(image_dir):
    paths = list_images(image_dir)[:1]
    (_, batch), = list(BatchLoader(paths, batch_size=1, size=None))
    np.testing.assert_array_equal(batch[0], jloader.decode_rgb(paths[0]))


def test_unknown_interpolation_raises():
    with pytest.raises(ValueError, match="interpolation"):
        BatchLoader([], interpolation="bilinear")


def test_eval_batch_classifies_as_jax(image_dir, tmp_path):
    """A cubic-float batch (float32, the eval CLI's) through the port's
    engine and the JAX engine: the float branch of preprocessing."""
    ckpt = write_synthetic_gguf(tmp_path / "m.gguf", TINY, seed=3)
    (_, batch), = list(BatchLoader(list_images(image_dir)[:4], batch_size=4, size=(256, 256),
                                   interpolation="cubic-float"))
    got = DinoEngine(ckpt, dtype=torch.float32, device="cpu").classify_probs(batch)
    want = JaxEngine(ckpt, dtype=jnp.float32).classify_probs(batch)
    assert got.shape == (4, 4)
    np.testing.assert_allclose(got, want, atol=PROB_ATOL, rtol=0)


def _consume(loader, how):
    """Run the loader on a thread with a deadline: 'all' lists it, 'first'
    takes one batch and leaves. Returns the outcome."""
    result = {}

    def run():
        try:
            if how == "all":
                list(loader)
            else:
                next(iter(loader))
            result["outcome"] = "done"
        except ValueError as e:
            result["outcome"], result["msg"] = "raised", str(e)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive(), "the consumer hung"
    return result


def test_corrupt_file_raises_in_the_consumer(image_dir):
    """A decode error reaches the consumer through the error marker."""
    (image_dir / "zz_bad.jpg").write_bytes(b"definitely not a jpeg")
    result = _consume(BatchLoader(list_images(image_dir), batch_size=4, size=(64, 64)), "all")
    assert result["outcome"] == "raised" and "zz_bad" in result["msg"]


def test_early_exit_does_not_hang(image_dir):
    """A consumer that leaves after the first batch unblocks the producer."""
    loader = BatchLoader(list_images(image_dir), batch_size=1, size=(32, 32), prefetch=1)
    assert _consume(loader, "first")["outcome"] == "done"
