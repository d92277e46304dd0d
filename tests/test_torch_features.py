"""Feature mode and PCA in the port against the JAX package on the CPU:
preprocessing, nearest resize, PCA, the whole forward on the flash route,
the engine's feature and PCA entry points, and the debug helpers.

Inputs come from numpy seeds and go through both packages in f32. The JAX
flash kernel runs in interpret mode, as the JAX package's tests run it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (caps torch's threads under xdist)

from dinov2_tpu.image import pca as jpca
from dinov2_tpu.image import preprocess as jpre
from dinov2_tpu.image import resize as jresize
from dinov2_tpu.io.synthetic import write_synthetic_gguf
from dinov2_tpu.models import params as jparams
from dinov2_tpu.models import vit as jvit
from dinov2_tpu.models.config import DinoConfig
from dinov2_tpu.runtime.engine import DinoEngine as JaxEngine
from dinov2_tpu.utils import debug as jdebug
from dinov2_tpu_torch.image import pca, preprocess, resize
from dinov2_tpu_torch.models import vit
from dinov2_tpu_torch.models.params import params_from_numpy
from dinov2_tpu_torch.runtime.engine import DinoEngine
from dinov2_tpu_torch.utils import debug

# the engine fixture's checkpoint, as in test_torch_engine.py
TINY = DinoConfig(hidden_size=64, num_hidden_layers=2, num_attention_heads=2,
                  num_classes=4, patch_size=14, img_size=70)
# the bounds of test_torch_slice.py (see there): the f32 envelope of
# docs/PARITY.md plus the f16 GELU roundings of reference mode
TOKEN_ATOL = {"hf": 2e-5, "reference": 5e-5}


def _u8(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def _agree_u8(got: np.ndarray, want: np.ndarray) -> None:
    """PCA images: at most 1 level apart on at least 99% of pixels (an f32
    rounding of the projection can move a value across a .5 boundary)."""
    assert got.shape == want.shape and got.dtype == np.uint8
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert (diff <= 1).mean() >= 0.99


@pytest.mark.parametrize("hw", [(60, 75), (28, 42), (512, 512)])
def test_feature_target_size_matches_jax(hw):
    """Quirk Q4: one extra patch, even on exact multiples (28 x 42)."""
    assert preprocess.feature_target_size(*hw, 14) == jpre.feature_target_size(*hw, 14)
    if hw == (512, 512):
        assert preprocess.feature_target_size(*hw, 14) == (518, 518)


@pytest.mark.parametrize("hw", [(60, 75), (28, 42)])
def test_feature_preprocess_matches_jax(hw):
    img = _u8(hw[0], (2, *hw, 3))
    want = np.asarray(jpre.feature_preprocess(jnp.asarray(img), 14))
    got = preprocess.feature_preprocess(torch.from_numpy(img), 14)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("src, dst", [(5, 17), (37, 512), (17, 5), (7, 7)])
def test_resize_nearest_matches_jax(src, dst):
    np.testing.assert_array_equal(
        resize.nearest_resize_index(src, dst), jresize.nearest_resize_index(src, dst)
    )
    img = _u8(src, (2, src, src + 3, 3))
    want = np.asarray(jresize.resize_nearest(jnp.asarray(img), dst, dst + 1))
    got = resize.resize_nearest(torch.from_numpy(img), dst, dst + 1).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        pca.resize_nearest_host(img, dst, dst + 1), jpca.resize_nearest_host(img, dst, dst + 1)
    )


def _tokens(seed, n=30, d=48, batch=()):
    """Patch tokens with three well separated principal directions (variances
    9, 4 and 1 over unit noise of 0.1), so the top basis is stable in f32."""
    rng = np.random.default_rng(seed)
    basis = np.linalg.qr(rng.standard_normal((d, 3)))[0]
    coeff = rng.standard_normal((*batch, n, 3)) * np.array([3.0, 2.0, 1.0])
    noise = rng.standard_normal((*batch, n, d)) * 0.1
    return (coeff @ basis.T + noise + 0.5).astype(np.float32)


def test_pca_project_matches_jax():
    """Both canonicalize each component's sign (largest |loading| positive),
    so the projections agree to f32 eigensolver noise, sign included."""
    tokens = _tokens(0)
    want = np.asarray(jpca.pca_project(jnp.asarray(tokens), 3))
    got = pca.pca_project(torch.from_numpy(tokens), 3).numpy()
    assert got.shape == (30, 3)
    np.testing.assert_allclose(np.abs(got), np.abs(want), atol=1e-4)  # up to sign
    np.testing.assert_allclose(got, want, atol=1e-4)  # and the same sign
    # the sign does not depend on the input's: -x projects to the same values
    flipped = pca.pca_project(torch.from_numpy(-tokens), 3).numpy()
    np.testing.assert_allclose(np.abs(flipped), np.abs(got), atol=1e-4)


def test_pca_to_u8_grid_matches_jax():
    """Global min-max, round half to even, clip: bit for bit on one input."""
    proj = np.random.default_rng(1).standard_normal((20, 3)).astype(np.float32)
    want = np.asarray(jpca.pca_to_u8_grid(jnp.asarray(proj), (4, 5)))
    got = pca.pca_to_u8_grid(torch.from_numpy(proj), (4, 5)).numpy()
    assert got.dtype == np.uint8 and got.shape == (4, 5, 3)
    np.testing.assert_array_equal(got, want)


def test_pca_visualization_matches_jax():
    tokens = _tokens(2, n=30)
    want = np.asarray(jpca.pca_visualization(jnp.asarray(tokens), (5, 6), (40, 47)))
    got = pca.pca_visualization(torch.from_numpy(tokens), (5, 6), (40, 47)).numpy()
    _agree_u8(got, want)


@pytest.mark.parametrize("out_hw", [None, (11, 13)])
def test_pca_visualization_batch_matches_jax(out_hw):
    """Each image of the batch keeps its own basis and range (one batched
    eigh in the port, vmap in JAX)."""
    tokens = _tokens(3, n=30, batch=(3,))
    tokens[1] *= 5.0  # another scale per image
    want = np.asarray(jpca.pca_visualization_batch(jnp.asarray(tokens), (5, 6), out_hw))
    got = pca.pca_visualization_batch(torch.from_numpy(tokens), (5, 6), out_hw).numpy()
    _agree_u8(got, want)
    for i in range(3):  # the batch equals per-image runs
        one = pca.pca_visualization_batch(torch.from_numpy(tokens[i : i + 1]), (5, 6), out_hw)
        np.testing.assert_array_equal(one.numpy()[0], got[i])


def _run_forward_both(parity, registers, px, flash):
    config = DinoConfig(hidden_size=64, num_hidden_layers=2, num_attention_heads=2,
                        num_classes=4, num_register_tokens=registers, patch_size=14,
                        img_size=70)
    jax_params = jparams.init_params(config, seed=11, dtype=jnp.float32)
    x = np.random.default_rng(px).standard_normal((2, px, px, 3)).astype(np.float32)
    want = jvit.forward(
        jax_params, jnp.asarray(x), config,
        jvit.ModelOptions(parity=parity, compute_dtype=jnp.float32, flash_attention=flash),
        classify=True,
    )
    tree = params_from_numpy(jax.tree_util.tree_map(np.asarray, jax_params))
    got = vit.forward(
        tree, torch.from_numpy(x), config,
        vit.ModelOptions(parity=parity, flash_attention=flash, compute_dtype=torch.float32),
        classify=True,
    )
    return got, {k: np.asarray(v) for k, v in want.items()}


@pytest.mark.parametrize(
    "parity, registers, px",
    [("reference", 4, 70), ("reference", 0, 84), ("hf", 0, 70), ("hf", 4, 56), ("hf", 4, 84)],
)
def test_forward_flash_route_matches_jax(parity, registers, px):
    """The whole forward with flash_attention=True: LN1 and the unfused
    half-layer around K4 (its plain version here, the JAX flash kernel
    interpreted there). In reference mode an f16 GELU rounding flip can
    carry f32 noise past the bound at some inputs, on every route alike
    (test_torch_slice.py::test_reference_gap_is_the_f16_gelu_rounding);
    test_flash_half_layer_matches_jax holds the attention half-layer alone."""
    got, want = _run_forward_both(parity, registers, px, True)
    for key in ("cls_token", "patch_tokens"):
        assert tuple(got[key].shape) == want[key].shape
        np.testing.assert_allclose(got[key].numpy(), want[key], atol=TOKEN_ATOL[parity], rtol=0)
    np.testing.assert_allclose(got["probs"].numpy(), want["probs"], atol=1e-6, rtol=0)


@pytest.mark.parametrize("t", [26, 300])
def test_flash_half_layer_matches_jax(t):
    """One attention half-layer on the flash route, LN1 included, against
    JAX's with its flash kernel interpreted: a few f32 ulps of O(1) values."""
    config = DinoConfig(hidden_size=64, num_hidden_layers=1, num_attention_heads=2,
                        num_classes=4, patch_size=14, img_size=70)
    tree = jax.tree_util.tree_map(np.asarray, jparams.init_params(config, seed=0, dtype=jnp.float32))
    jlayer = jax.tree_util.tree_map(lambda a: a[0], tree["layers"])
    x = np.random.default_rng(t).standard_normal((4, t, 64)).astype(np.float32)
    want = jvit._attention_half_layer(jnp.asarray(x), jlayer, config, jvit.ModelOptions(
        parity="reference", compute_dtype=jnp.float32, flash_attention=True))
    got = vit._attention_half_layer(torch.from_numpy(x), params_from_numpy(jlayer), config,
                                    vit.ModelOptions(compute_dtype=torch.float32,
                                                     flash_attention=True))
    assert np.abs(got.numpy() - np.asarray(want)).max() <= 5e-7


def test_forward_routes_agree():
    """On the CPU the slab (K1 plain), flash (K4 plain) and vanilla routes are
    one computation in two orderings: tokens within f32 noise."""
    config = DinoConfig(hidden_size=64, num_hidden_layers=2, num_attention_heads=2,
                        num_classes=4, patch_size=14, img_size=70)
    tree = params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams.init_params(config, seed=5, dtype=jnp.float32))
    )
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 70, 70, 3)).astype(np.float32))
    outs = {
        route: vit.forward(tree, x, config, vit.ModelOptions(
            parity="hf", flash_attention=route, compute_dtype=torch.float32))["patch_tokens"]
        for route in ("slab", "flash", "vanilla")
    }
    torch.testing.assert_close(outs["flash"], outs["slab"], atol=1e-5, rtol=0)
    torch.testing.assert_close(outs["flash"], outs["vanilla"], atol=1e-6, rtol=0)


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    path = write_synthetic_gguf(tmp_path_factory.mktemp("ckpt") / "tiny.gguf", TINY, seed=3)
    return (
        JaxEngine(path, dtype=jnp.float32, flash_attention=True),
        DinoEngine(path, dtype=torch.float32, flash_attention=True, device="cpu"),
    )


@pytest.mark.parametrize("n, hw", [(1, (70, 70)), (3, (60, 75))])
def test_extract_features_matches_jax(engines, n, hw):
    """One image at an exact patch multiple (quirk Q4: a 6x6 grid), and 3
    images padded to the bucket of 4."""
    jax_engine, engine = engines
    imgs = _u8(n, (n, *hw, 3))
    want = jax_engine.extract_features(imgs)
    got = engine.extract_features(imgs)
    assert got["grid"] == want["grid"]
    for key in ("cls_token", "patch_tokens"):
        assert got[key].shape == want[key].shape and got[key].dtype == np.float32
        np.testing.assert_allclose(got[key], want[key], atol=TOKEN_ATOL["reference"], rtol=0)
    assert engine.last_compute_ms > 0


def test_extract_features_mixed_matches_jax(engines):
    jax_engine, engine = engines
    imgs = [_u8(1, (60, 75, 3)), _u8(2, (42, 42, 3)), _u8(3, (60, 75, 3))]
    want = jax_engine.extract_features_mixed(imgs)
    got = engine.extract_features_mixed(imgs)
    assert [g["grid"] for g in got] == [w["grid"] for w in want] == [(5, 6), (4, 4), (5, 6)]
    for g, w in zip(got, want):
        for key in ("cls_token", "patch_tokens"):
            np.testing.assert_allclose(g[key], w[key], atol=TOKEN_ATOL["reference"], rtol=0)


def test_pca_visualizations_match_jax(engines):
    jax_engine, engine = engines
    imgs = [_u8(4, (60, 75, 3)), _u8(5, (42, 50, 3)), _u8(6, (60, 75, 3))]
    want = jax_engine.pca_visualizations(imgs)
    got = engine.pca_visualizations(imgs)
    for g, w, img in zip(got, want, imgs):
        assert g.shape == img.shape
        _agree_u8(g, w)
    _agree_u8(engine.pca_visualization(imgs[1]), want[1])


def test_pca_visualization_async_returns_the_grid(engines):
    """The queued result stays a tensor on the engine's device: the padded
    batch of patch-grid images, row 0 the frame."""
    _, engine = engines
    img = _u8(4, (60, 75, 3))
    vis = engine.pca_visualization_async(img)
    assert isinstance(vis, torch.Tensor) and vis.dtype == torch.uint8
    assert tuple(vis.shape) == (1, 5, 6, 3)
    want = engine.pca_visualizations([img])[0]
    np.testing.assert_array_equal(pca.resize_nearest_host(vis.numpy()[0], 60, 75), want)


def test_warmup_features(engines):
    _, engine = engines
    engine.warmup((42, 42), batch=2, classify=False)
    assert engine.last_compute_ms > 0


def test_check_finite_only_with_the_debug_switch(monkeypatch):
    out = {"cls_token": torch.tensor([1.0, float("nan")]), "grid": [torch.zeros(2)]}
    monkeypatch.delenv("DINOV2_TPU_DEBUG_NAN", raising=False)
    assert not debug.nan_debug_enabled()
    debug.check_finite(out, "features:")  # a no-op
    monkeypatch.setenv("DINOV2_TPU_DEBUG_NAN", "1")
    assert debug.nan_debug_enabled() == jdebug.nan_debug_enabled()
    with pytest.raises(FloatingPointError, match=r"features:\['cls_token'\]"):
        debug.check_finite(out, "features:")
    debug.check_finite({"ok": torch.zeros(3), "ids": torch.arange(3)}, "features:")


def test_print_tensor_matches_jax(capsys):
    arr = np.random.default_rng(0).standard_normal((7, 12)).astype(np.float32)
    jdebug.print_tensor("t", arr, n=4)
    want = capsys.readouterr().out
    debug.print_tensor("t", torch.from_numpy(arr), n=4)
    assert capsys.readouterr().out == want
