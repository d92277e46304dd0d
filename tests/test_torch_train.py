"""The port's training slice (remat, the Trainer and its AdamW, checkpoint,
GGUF export, the train CLI) against the JAX package on the CPU.

Tiny sizes (2 layers, D=128, 2 heads), inputs from numpy seeds, f32, the
same parameters in both packages through `params_from_numpy`. Tolerances
are stated at each test.
"""

import subprocess
import sys
from pathlib import Path

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dinov2_tpu.io.export import export_gguf as jax_export_gguf
from dinov2_tpu.models.config import DinoConfig as JaxDinoConfig
from dinov2_tpu.models.params import init_params as jax_init_params
from dinov2_tpu.models.vit import ModelOptions as JaxModelOptions
from dinov2_tpu.parallel.train import make_trainer as jax_make_trainer
from dinov2_tpu_torch.io.export import export_gguf
from dinov2_tpu_torch.io.synthetic import write_synthetic_gguf
from dinov2_tpu_torch.models.config import DinoConfig
from dinov2_tpu_torch.models.params import (
    init_params,
    params_from_numpy,
    params_to_numpy,
    quantize_linear,
    trainable_params,
    tree_leaves,
    tree_map,
)
from dinov2_tpu_torch.models.vit import ModelOptions, forward_features, head_logits
from dinov2_tpu_torch.parallel import train as parallel_train
from dinov2_tpu_torch.parallel.checkpoint import (
    latest_step,
    restore_train_state,
    save_train_state,
)
from dinov2_tpu_torch.parallel.train import AdamW, Trainer, make_trainer

REPO = Path(__file__).resolve().parent.parent
TINY = dict(hidden_size=128, num_hidden_layers=2, num_attention_heads=2, num_classes=5,
            patch_size=14, img_size=70)
LOSS_TOL = 1e-5
LEAF_TOL = 1e-5


def _jax_params(seed=0, **overrides):
    config = JaxDinoConfig(**{**TINY, **overrides})
    return config, jax_init_params(config, seed=seed, dtype=jnp.float32)


def _batch(seed, n, px=32):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (n, px, px, 3), dtype=np.uint8)
    labels = rng.integers(0, TINY["num_classes"], n)
    return images, labels


@pytest.mark.parametrize("route", ["auto", True, False])
def test_remat_gradients_equal_no_remat(route):
    """`remat=True` runs each layer under torch.utils.checkpoint: the same
    ops on the same values, so every gradient is equal bit for bit, and it
    lands in the stacked (L, ...) leaf."""
    config = DinoConfig(**TINY)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 28, 42, 3))).float()
    grads = {}
    for remat in (False, True):
        params = trainable_params(init_params(config, seed=1, dtype=torch.float32))
        opts = ModelOptions(parity="hf", compute_dtype=torch.float32, flash_attention=route,
                            remat=remat, fuse_mlp=route == "auto")
        logits = head_logits(params, forward_features(params, x, config, opts), config, opts)
        grads[remat] = torch.autograd.grad(logits.square().sum(), tree_leaves(params))
    assert len(grads[True]) == len(tree_leaves(params))
    for a, b, leaf in zip(grads[True], grads[False], tree_leaves(params)):
        assert a.shape == leaf.shape and torch.equal(a, b)
    assert any(g.abs().max() > 0 for g in grads[True])


def test_remat_is_off_by_default_and_idle_without_grad(monkeypatch):
    """Inference is untouched: no checkpoint call unless remat is on and grad
    is enabled."""
    from dinov2_tpu_torch.models import vit

    calls = []
    monkeypatch.setattr(vit, "checkpoint", lambda fn, *a, **k: calls.append(1) or fn(*a))
    config = DinoConfig(**TINY)
    params = init_params(config, seed=1, dtype=torch.float32)
    x = torch.zeros(1, 28, 28, 3)
    assert ModelOptions().remat is False
    forward_features(params, x, config, ModelOptions(compute_dtype=torch.float32))
    with torch.no_grad():
        forward_features(params, x, config, ModelOptions(compute_dtype=torch.float32, remat=True))
    assert calls == []
    forward_features(params, x, config, ModelOptions(compute_dtype=torch.float32, remat=True))
    assert len(calls) == config.num_hidden_layers


def test_adamw_matches_optax():
    """The functional AdamW against optax.adamw on one tree over four
    steps, with gradients of mixed magnitudes: within one f32 ulp of O(1)
    leaves (the same formula in another association)."""
    rng = np.random.default_rng(0)
    tree = {"a": rng.standard_normal((3, 4)).astype(np.float32),
            "b": {"c": rng.standard_normal(7).astype(np.float32)}}
    grads = [jax.tree_util.tree_map(
        lambda p: (rng.standard_normal(p.shape) * 10.0 ** rng.integers(-6, 1)).astype(np.float32),
        tree) for _ in range(4)]
    tx = optax.adamw(3e-3, weight_decay=0.05)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    jstate = tx.init(jparams)
    opt = AdamW(3e-3, 0.05)
    params = params_from_numpy(tree)
    state = opt.init(params)
    for g in grads:
        updates, jstate = tx.update(jax.tree_util.tree_map(jnp.asarray, g), jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        opt.update_(params, tree_leaves(params_from_numpy(g)), state)
    assert state["count"] == 4
    for got, want in zip(tree_leaves(params), jax.tree_util.tree_leaves(jparams)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-7, atol=2e-7)


@pytest.mark.parametrize("route", ["default", "flash"])
def test_three_trainer_steps_match_jax(route):
    """Three `Trainer.step`s on the same parameters and batch against the
    JAX `make_trainer`: the loss of every step within 1e-5, every leaf after
    the third within 1e-5 (the port's AdamW is optax's formula, so there is
    no lr² · wd cross term to add). "default" is `make_trainer`'s own options
    in both packages (parity hf, f32, remat; the port's "auto" runs the K1
    Function with its recompute backward, JAX's the vanilla route off the
    TPU); "flash" sends both through their flash Functions (JAX: the Pallas
    forward and backward kernels, interpreted).

    Adam turns a gradient element into a step of roughly ±lr whatever its
    size, so an element whose gradient is rounding noise (below ~1e-7, where
    the two packages' f32 sums differ in the leading digits) moves by a
    noise-sized share of lr. The k third of the qkv bias is all such elements
    (softmax is invariant to a shift of every key by a constant vector, so
    its true gradient is 0), and a dense leaf has a few by chance (measured
    here: 1 of 75264 in the patch kernel, none elsewhere). So: the k bias
    within 3 steps x lr; of every other leaf at most one element in 10^4
    beyond 1e-5, and none beyond 3 x lr."""
    jconfig, jparams = _jax_params(seed=2)
    images, labels = _batch(3, 4)
    lr = 1e-4
    if route == "default":
        jopts = opts = None
    else:
        jopts = JaxModelOptions(parity="hf", compute_dtype=jnp.float32, remat=True,
                                flash_attention=True)
        opts = ModelOptions(parity="hf", compute_dtype=torch.float32, remat=True,
                            flash_attention=True)
    jtrainer = jax_make_trainer(jconfig, learning_rate=lr, opts=jopts)
    trainer = make_trainer(DinoConfig(**TINY), learning_rate=lr, opts=opts, device="cpu")
    assert trainer.opts.remat and trainer.opts.parity == "hf"
    assert trainer.opts.compute_dtype == torch.float32

    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams))
    params, opt_state = trainer.place(params)
    jstate = jtrainer.place(jparams)
    for _ in range(3):
        params, opt_state, metrics = trainer.step(params, opt_state, images, labels)
        *jstate, jmetrics = jtrainer.step(*jstate, images, labels)
        assert set(metrics) == {"loss", "accuracy"}
        assert abs(float(metrics["loss"]) - float(jmetrics["loss"])) <= LOSS_TOL
        assert float(metrics["accuracy"]) == float(jmetrics["accuracy"])
    assert opt_state["count"] == 3

    d = TINY["hidden_size"]
    got = params_to_numpy(params)
    want = jax.tree_util.tree_map(np.asarray, jstate[0])
    flat_got = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    flat_want = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    assert flat_got.keys() == flat_want.keys()
    for path, leaf in flat_got.items():
        name = jax.tree_util.keystr(path)
        delta = np.abs(leaf - flat_want[path])
        if name == "['layers']['qkv']['bias']":
            assert delta[:, d : 2 * d].max() <= 3 * lr, name
            delta = np.concatenate([delta[:, :d], delta[:, 2 * d :]], axis=1)
        assert (delta > LEAF_TOL).mean() <= 1e-4, (name, int((delta > LEAF_TOL).sum()))
        assert delta.max() <= 3 * lr, (name, delta.max())


def test_trainer_place_copies_and_step_updates_in_place():
    config = DinoConfig(**TINY)
    source = init_params(config, seed=4, dtype=torch.bfloat16)
    trainer = make_trainer(config, device="cpu")
    params, opt_state = trainer.place(source)
    leaves = tree_leaves(params)
    assert all(p.dtype == torch.float32 and p.requires_grad and p.is_leaf for p in leaves)
    assert source["cls_token"].dtype == torch.float32 and not source["cls_token"].requires_grad
    assert source["layers"]["qkv"]["kernel"].dtype == torch.bfloat16  # the caller's tree is kept
    before = [p.detach().clone() for p in leaves]
    images, labels = _batch(5, 2)
    out_params, out_state, metrics = trainer.step(params, opt_state, images, labels)
    assert out_params is params and out_state is opt_state and out_state["count"] == 1
    assert all(not torch.equal(a, b) for a, b in zip(before, tree_leaves(params)))
    assert all(p.grad is None for p in leaves)  # functional: no .grad left behind
    assert torch.isfinite(metrics["loss"]) and not metrics["loss"].requires_grad


def test_trainer_without_preprocess_takes_preprocessed_input():
    config = DinoConfig(**TINY)
    trainer = make_trainer(config, preprocess_in_step=False, device="cpu")
    params, opt_state = trainer.place(init_params(config, seed=6, dtype=torch.float32))
    x = np.random.default_rng(0).standard_normal((2, 28, 42, 3)).astype(np.float32)
    _, _, metrics = trainer.step(params, opt_state, x, np.array([0, 1]))
    assert torch.isfinite(metrics["loss"])


def test_trainer_refuses_a_mesh_and_a_missing_gpu():
    config = DinoConfig(**TINY)
    with pytest.raises(NotImplementedError, match="mesh"):
        make_trainer(config, mesh=object(), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_trainer(config)  # the default device is the card


def test_trainable_params_refuses_quantized_leaves():
    tree = {"w": {"kernel": quantize_linear(np.zeros((64, 64), np.float32), "q8_0")}}
    with pytest.raises(ValueError, match="aren't trainable"):
        trainable_params(tree)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_params_to_numpy_inverts_params_from_numpy(dtype):
    """Round trip of a tree through both, bit for bit, bf16 included (numpy
    holds it as ml_dtypes' extension type, which jax installs)."""
    import ml_dtypes

    np_dtype = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.dtype(dtype)
    rng = np.random.default_rng(0)
    tree = {"a": (rng.standard_normal((3, 5)) * 50).astype(np_dtype),
            "b": {"c": (rng.standard_normal(4) * 50).astype(np_dtype)}}
    tensors = params_from_numpy(tree)
    assert tensors["a"].dtype == getattr(torch, dtype)
    back = params_to_numpy(tree_map(lambda t: t.clone().requires_grad_(t.is_floating_point()),
                                    tensors))
    assert back["a"].dtype == np_dtype and back["b"]["c"].dtype == np_dtype
    assert back["a"].tobytes() == tree["a"].tobytes()
    assert back["b"]["c"].tobytes() == tree["b"]["c"].tobytes()


def test_checkpoint_round_trip(tmp_path):
    """save -> restore gives the step and every leaf back bit for bit, on the
    `*_like` leaves' dtype and requires_grad; the newest step is the default;
    the file loads with weights_only=True."""
    config = DinoConfig(**TINY)
    trainer = make_trainer(config, device="cpu")
    params, opt_state = trainer.place(init_params(config, seed=7, dtype=torch.float32))
    images, labels = _batch(8, 2)
    params, opt_state, _ = trainer.step(params, opt_state, images, labels)
    save_train_state(tmp_path / "ck", 1, params, opt_state)
    kept = [p.detach().clone() for p in tree_leaves(params)]
    kept_mu = [m.clone() for m in tree_leaves(opt_state["mu"])]
    params, opt_state, _ = trainer.step(params, opt_state, images, labels)
    save_train_state(tmp_path / "ck", 2, params, opt_state)
    assert latest_step(tmp_path / "ck") == 2
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == [
        "step_00000001.pt", "step_00000002.pt"]
    torch.load(tmp_path / "ck" / "step_00000002.pt", weights_only=True)

    fresh, fresh_state = trainer.place(init_params(config, seed=9, dtype=torch.float32))
    step, restored, restored_state = restore_train_state(tmp_path / "ck", fresh, fresh_state)
    assert step == 2 and restored_state["count"] == 2
    for a, b in zip(tree_leaves(restored), tree_leaves(params)):
        assert torch.equal(a, b) and a.requires_grad and a.dtype == torch.float32
    step, restored, restored_state = restore_train_state(tmp_path / "ck", fresh, fresh_state, step=1)
    assert step == 1 and restored_state["count"] == 1
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(restored), kept))
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(restored_state["mu"]), kept_mu))
    # training goes on from a restored state
    trainer.step(restored, restored_state, images, labels)
    with pytest.raises(FileNotFoundError):
        restore_train_state(tmp_path / "empty", fresh, fresh_state)
    with pytest.raises(FileNotFoundError):
        restore_train_state(tmp_path / "ck", fresh, fresh_state, step=7)


@pytest.mark.parametrize("variant", ["gelu", "swiglu_registers", "no_classifier"])
def test_export_gguf_equals_jax_file(tmp_path, variant):
    """`export_gguf` on the same parameters writes the JAX package's file
    byte for byte, and the port's loader reads it back."""
    overrides = {
        "gelu": {},
        "swiglu_registers": dict(use_swiglu_ffn=True, swiglu_hidden=160, num_register_tokens=2),
        "no_classifier": dict(num_classes=0),
    }[variant]
    jconfig, jparams = _jax_params(seed=10, **overrides)
    id2label = None if variant == "no_classifier" else {i: f"class {i}" for i in range(5)}
    want = jax_export_gguf(tmp_path / "jax.gguf", jparams, jconfig, id2label)
    params = trainable_params(params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams)))
    got = export_gguf(tmp_path / "port.gguf", params, DinoConfig(**{**TINY, **overrides}), id2label)
    assert got.read_bytes() == want.read_bytes()

    from dinov2_tpu_torch.models.params import load_params

    loaded = load_params(got, dtype=torch.float32)
    assert loaded.has_classifier == (variant != "no_classifier")
    np.testing.assert_array_equal(
        loaded.params["layers"]["qkv"]["kernel"].numpy(),
        params["layers"]["qkv"]["kernel"].detach().half().float().numpy(),
    )


def test_export_gguf_refuses_quantized_leaves(tmp_path):
    config = DinoConfig(**TINY)
    params = init_params(config, seed=0, dtype=torch.float32)
    params["classifier"]["kernel"] = quantize_linear(np.zeros((5, 256), np.float32), "q8_0")
    with pytest.raises(ValueError, match="fused-quantized"):
        export_gguf(tmp_path / "q.gguf", params, config)


# ---------------------------------------------------------------------------
# The train CLI (tests/test_train_cli.py mirrored)
# ---------------------------------------------------------------------------


@pytest.fixture
def dataset(tmp_path, rng):
    """Two trivially separable classes: red-ish vs blue-ish images."""
    root = tmp_path / "data"
    for name, base in [("blue", (40, 40, 200)), ("red", (200, 40, 40))]:
        d = root / name
        d.mkdir(parents=True)
        for i in range(12):
            img = np.clip(
                np.asarray(base, np.int16) + rng.integers(-30, 30, (64, 64, 3)), 0, 255,
            ).astype(np.uint8)
            cv2.imwrite(str(d / f"{i}.png"), cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
    return root


@pytest.fixture
def backbone(tmp_path):
    return write_synthetic_gguf(
        tmp_path / "backbone.gguf",
        DinoConfig(hidden_size=64, num_hidden_layers=2, num_attention_heads=2,
                   num_classes=0, patch_size=14, img_size=70),
        seed=3,
        with_classifier=False,
    )


def test_train_export_classify(dataset, backbone, tmp_path, rng):
    """Train on the separable dataset in a fresh process, checkpoint, export,
    reload the GGUF with the port's engine and check the learned classes."""
    out = tmp_path / "tuned.gguf"
    ckdir = tmp_path / "ckpts"
    script = (
        f"import sys; sys.path.insert(0, {str(REPO)!r}); "
        "from dinov2_tpu_torch.cli import train; "
        f"rc = train.main(['-m', {str(backbone)!r}, '--data', {str(dataset)!r}, "
        f"'--epochs', '4', '--batch', '8', '--lr', '3e-3', '--device', 'cpu', "
        f"'--checkpoint-dir', {str(ckdir)!r}, '--export', {str(out)!r}, '--log-every', '2']); "
        "assert 'jax' not in sys.modules and 'dinov2_tpu' not in sys.modules; sys.exit(rc)"
    )
    r = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "step 12 loss" in r.stderr  # 4 epochs x 3 batches, logged every 2
    assert out.exists()
    assert sorted(p.name for p in ckdir.iterdir())[-1] == "step_00000012.pt"

    from dinov2_tpu_torch.runtime.engine import DinoEngine

    engine = DinoEngine(out, dtype=torch.float32, parity="hf", device="cpu")
    assert engine.id2label == {0: "blue", 1: "red"}
    blue, red = (
        np.clip(np.asarray(base, np.int16) + rng.integers(-30, 30, (64, 64, 3)), 0, 255)
        .astype(np.uint8)
        for base in ((40, 40, 200), (200, 40, 40))
    )
    results = engine.classify([blue, red], topk=1)
    assert results[0][0][0] == "blue"
    assert results[1][0][0] == "red"


def test_train_ships_uint8_batches_and_normalizes(dataset, backbone, monkeypatch):
    """classify_preprocess divides by 255 only for uint8 input, so the train
    loop must hand the step uint8 frames, and the model must see them
    ImageNet-normalized at 224 px (a float32 [0,255] batch would skip the
    divide and feed the backbone values 255x off-distribution)."""
    from dinov2_tpu_torch.cli import train as train_cli

    dtypes, model_inputs = [], []
    real_make, real_features = parallel_train.make_trainer, parallel_train.forward_features

    def spy(*a, **k):
        trainer = real_make(*a, **k)
        orig = trainer.step

        def step(params, opt_state, images, labels):
            dtypes.append((np.asarray(images).dtype, np.asarray(images).shape[1:]))
            return orig(params, opt_state, images, labels)

        trainer.step = step
        return trainer

    def features(params, x, config, opts):
        model_inputs.append((x.dtype, tuple(x.shape[1:]), float(x.min()), float(x.max())))
        return real_features(params, x, config, opts)

    monkeypatch.setattr(parallel_train, "make_trainer", spy)
    monkeypatch.setattr(parallel_train, "forward_features", features)
    rc = train_cli.main(["-m", str(backbone), "--data", str(dataset), "--epochs", "1",
                         "--batch", "8", "--device", "cpu"])
    assert rc == 0
    assert len(dtypes) == 3 and all(d == (np.uint8, (256, 256, 3)) for d in dtypes), dtypes
    assert len(model_inputs) == 3
    for dtype, shape, lo, hi in model_inputs:
        assert dtype == torch.float32 and shape == (224, 224, 3)
        # (0 - 0.485) / 0.229 = -2.12 and (1 - 0.406) / 0.225 = 2.64 bound a normalized image
        assert -2.2 <= lo and hi <= 2.7


def test_train_refuses_dataset_smaller_than_batch(dataset, backbone):
    """With fewer samples than --batch the drop-last loop runs ZERO steps and
    --export would write the random-init classifier; refuse loudly instead."""
    from dinov2_tpu_torch.cli import train as train_cli

    with pytest.raises(SystemExit, match="lower --batch"):
        train_cli.main(["-m", str(backbone), "--data", str(dataset), "--batch", "999",
                        "--device", "cpu"])


def test_train_refuses_a_mesh(dataset, backbone):
    from dinov2_tpu_torch.cli import train as train_cli

    with pytest.raises(SystemExit, match="not ported"):
        train_cli.main(["-m", str(backbone), "--data", str(dataset), "--batch", "8",
                        "--mesh", "2", "--device", "cpu"])


def test_train_defaults_to_the_card():
    """The CLIs and the Trainer run on the card unless the caller asks for the
    CPU, and the defaults resolve together to something that runs there: the
    train CLI's and `make_trainer`'s f32 compute with the route "auto" takes
    the plain attention on a card (the CUDA kernels take bf16), the slab route
    on the CPU, and bf16 the kernels."""
    import argparse
    import inspect

    from dinov2_tpu_torch.cli import train as train_cli
    from dinov2_tpu_torch.cli._common import add_common_args, dtype_of, mesh_axes_of
    from dinov2_tpu_torch.ops.attention import resolve_attention_path

    p = argparse.ArgumentParser()
    add_common_args(p)
    args = p.parse_args([])
    assert args.device == "cuda" and dtype_of(args) == torch.bfloat16
    assert mesh_axes_of(args) is None
    assert mesh_axes_of(p.parse_args(["--mesh", "2,4"])) == {"data": 2, "model": 4}
    assert Trainer.__dataclass_fields__["device"].default == "cuda"
    assert inspect.signature(make_trainer).parameters["device"].default == "cuda"

    args = train_cli.build_parser().parse_args(["--data", "x"])
    assert (args.device, args.parity, args.flash_attn) == ("cuda", "hf", False)
    assert dtype_of(args) == torch.float32
    config = DinoConfig(**TINY)
    opts = make_trainer(config, device="cpu").opts
    assert (opts.compute_dtype, opts.flash_attention) == (torch.float32, "auto")
    head_dim = config.hidden_size // config.num_attention_heads
    assert resolve_attention_path("auto", 257, dtype_of(args), head_dim, args.device) == "vanilla"
    assert resolve_attention_path(
        opts.flash_attention, 257, opts.compute_dtype, head_dim, "cuda") == "vanilla"
    assert resolve_attention_path(
        opts.flash_attention, 257, opts.compute_dtype, head_dim, "cpu") == "slab"
    assert resolve_attention_path(
        opts.flash_attention, 257, torch.bfloat16, head_dim, "cuda") == "slab"
