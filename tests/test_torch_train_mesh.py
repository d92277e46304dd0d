"""The port's training on a mesh (Trainer(mesh=), make_pipeline_train_step,
parallel/mesh.py's collectives, unplace and replica reduction, checkpoints
and `cli.train --mesh`) against the JAX package's sharded steps on the CPU.

The JAX side runs on the eight virtual host devices of tests/conftest.py,
the port's meshes name the CPU once per position. The inputs are the JAX
package's own test batches (tests/test_parallel.py: 8 images of 70 px from
a numpy seed, preprocess_in_step=False) and parameters made by the JAX
package and copied into the port. The port runs with remat on (the JAX
steps without), which changes no value. Bounds are the JAX package's own:
  - loss: rtol 1e-5;
  - parameters after one AdamW step: rtol 5e-4, atol 1e-5, with the
    allowance of tests/test_torch_train.py for elements whose gradient is
    rounding noise. Adam turns a gradient element into a step of about lr
    whatever its size, so such an element moves by a noise-sized share of
    lr in each package: at most one element in 10^4 of a leaf may lie
    beyond the bound, and none beyond lr. The k third of the qkv bias is
    all such elements (its true gradient is 0: softmax does not see a
    shift of every key by one vector) and is held within lr. The SGD check
    below holds every gradient, these included;
  - raw gradients through SGD(1.0) (p0 - p1), against jax.grad of the
    sequential loss: rtol 1e-4, atol 1e-6 (the JAX pipeline test's).
"""

import dataclasses

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch_threads  # noqa: F401  (caps torch's threads under xdist)

from dinov2_tpu.models import params as jparams
from dinov2_tpu.models import vit as jvit
from dinov2_tpu.models.config import DinoConfig
from dinov2_tpu.parallel import mesh as jmesh
from dinov2_tpu.parallel import pipeline as jpipeline
from dinov2_tpu.parallel.train import Trainer as JaxTrainer
from dinov2_tpu_torch.io.synthetic import write_synthetic_gguf
from dinov2_tpu_torch.models import vit
from dinov2_tpu_torch.models.params import params_from_numpy, tree_leaves, tree_map
from dinov2_tpu_torch.parallel import mesh, pipeline, tp_fused
from dinov2_tpu_torch.parallel.checkpoint import restore_train_state, save_train_state
from dinov2_tpu_torch.parallel.train import AdamW, Trainer, make_trainer, masters_of

CPU = torch.device("cpu")
TINY = DinoConfig(hidden_size=64, num_hidden_layers=2, num_attention_heads=2, num_classes=8,
                  patch_size=14, img_size=70)
# four heads, so that tp=2 and tp=4 split them; T=26 splits 13 + 13 and 7+7+7+5
WIDE = dataclasses.replace(TINY, hidden_size=128, num_attention_heads=4)
SWIGLU = dataclasses.replace(WIDE, use_swiglu_ffn=True, swiglu_hidden=256)
PIPE = dataclasses.replace(TINY, num_hidden_layers=8)
LR = 1e-4
LOSS_RTOL = 1e-5
PARAM_RTOL, PARAM_ATOL = 5e-4, 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
# name -> (config, mesh axes, sequence_parallel), tests/test_parallel.py's
# cases and two with heads that split under sequence parallelism
CASES = {
    "tp": (TINY, {"data": 4, "model": 2}, False),
    "sp": (TINY, {"data": 2, "model": 4}, True),  # 2 heads: replicated in the port
    "sp_split": (WIDE, {"data": 2, "model": 2}, True),
    "sp_ragged": (WIDE, {"data": 2, "model": 4}, True),
    "dp": (TINY, {"data": 8}, False),
}


def _batch(seed=1):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((8, 70, 70, 3)).astype(np.float32),
            rng.integers(0, 8, (8,)))


def _cpu_mesh(axes):
    return mesh.make_mesh(axes, [CPU] * int(np.prod(list(axes.values()))))


def _opts(sp=False):
    return vit.ModelOptions(parity="hf", compute_dtype=torch.float32, remat=True,
                            sequence_parallel=sp)


def _source(config, seed=0):
    """The JAX package's parameters, as numpy."""
    return jax.tree_util.tree_map(
        np.asarray, jparams.init_params(config, seed=seed, dtype=jnp.float32))


def _jax_loss(config, images, labels):
    def loss(p):
        tokens = jvit.forward_features(p, jnp.asarray(images), config,
                                       jvit.ModelOptions(parity="hf", compute_dtype=jnp.float32))
        logits = jvit.head_logits(p, tokens, config,
                                  jvit.ModelOptions(parity="hf", compute_dtype=jnp.float32))
        return optax.softmax_cross_entropy_with_integer_labels(logits, jnp.asarray(labels)).mean()

    return loss


class SGD:
    """p -= lr * g; records every tensor it updates."""

    def __init__(self, learning_rate=1.0):
        self.learning_rate, self.updated = learning_rate, []

    def init(self, params):
        return {}

    @torch.no_grad()
    def update_(self, params, grads, state):
        leaves = tree_leaves(params)
        self.updated += [id(t) for t in leaves]
        torch._foreach_add_(leaves, grads, alpha=-self.learning_rate)


class Counting:
    """An optimizer that records every tensor it updates."""

    def __init__(self, inner):
        self.inner, self.updated = inner, []

    def init(self, params):
        return self.inner.init(params)

    def update_(self, params, grads, state):
        self.updated += [id(t) for t in tree_leaves(params)]
        self.inner.update_(params, grads, state)


@pytest.fixture(scope="module")
def jax_ref():
    """Each JAX reference once per module, on first use: ("step", case) ->
    (loss, params) of the JAX sharded AdamW step, ("grad", config) -> the
    sequential loss's gradient, ("pipeline",) -> the pipeline step's."""
    made = {}

    def get(*key):
        if key in made:
            return made[key]
        images, labels = _batch()
        if key[0] == "step":
            config, axes, sp = CASES[key[1]]
            jm = jmesh.make_mesh(axes, devices=jax.devices()[: int(np.prod(list(axes.values())))])
            trainer = JaxTrainer(
                config, jvit.ModelOptions(parity="hf", compute_dtype=jnp.float32,
                                          sequence_parallel=sp),
                optax.adamw(LR, weight_decay=0.05), mesh=jm, tensor_parallel=True,
                preprocess_in_step=False)
            params, state = trainer.place(jax.tree_util.tree_map(jnp.asarray, _source(config)))
            params, _, metrics = trainer.step(params, state, images, labels)
            made[key] = float(metrics["loss"]), jax.tree_util.tree_map(np.asarray, params)
        elif key[0] == "grad":
            config = key[1]
            grads = jax.grad(_jax_loss(config, images, labels))(
                jax.tree_util.tree_map(jnp.asarray, _source(config)))
            made[key] = jax.tree_util.tree_map(np.asarray, grads)
        else:
            jm = jmesh.make_mesh({"stage": 4}, devices=jax.devices()[:4])
            step, place = jpipeline.make_pipeline_train_step(
                PIPE, jvit.ModelOptions(parity="hf", compute_dtype=jnp.float32), jm,
                optax.adamw(LR, weight_decay=0.05), num_microbatches=4)
            params, state = place(jax.tree_util.tree_map(jnp.asarray, _source(PIPE)))
            params, _, metrics = step(params, state, jnp.asarray(images), jnp.asarray(labels))
            made[key] = float(metrics["loss"]), jax.tree_util.tree_map(np.asarray, params)
        return made[key]

    return get


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v.detach().numpy() if torch.is_tensor(v) else np.asarray(v)
    return out


def _assert_params(got, want, config, steps=1):
    """Within the bound of the module docstring after `steps` steps of LR."""
    got, want = _flat(got), _flat(want)
    assert got.keys() == want.keys()
    d = config.hidden_size
    for name, leaf in got.items():
        ref = want[name]
        delta = np.abs(leaf - ref)
        assert delta.max() <= steps * LR, (name, delta.max())
        if name == "layers/qkv/bias":
            leaf, ref = np.delete(leaf, np.s_[d: 2 * d], 1), np.delete(ref, np.s_[d: 2 * d], 1)
        beyond = np.abs(leaf - ref) > PARAM_ATOL + PARAM_RTOL * np.abs(ref)
        assert beyond.sum() <= 1e-4 * beyond.size, (name, int(beyond.sum()))


def _assert_grads(p0, p1, want):
    p0 = _flat(p0)
    got = {k: p0[k] - v for k, v in _flat(p1).items()}
    want = _flat(want)
    assert got.keys() == want.keys()
    for name, g in got.items():
        np.testing.assert_allclose(g, want[name], rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=name)


def _mesh_trainer(case, optimizer=None):
    config, axes, sp = CASES[case]
    return Trainer(config, _opts(sp), optimizer or AdamW(LR, 0.05), mesh=_cpu_mesh(axes),
                   preprocess_in_step=False, device="cpu")


@pytest.mark.parametrize("case", list(CASES))
def test_mesh_step_matches_jax(case, jax_ref):
    """One AdamW step of the port's mesh Trainer against the JAX package's
    sharded step on the same mesh: the loss and every parameter, unplaced."""
    config = CASES[case][0]
    images, labels = _batch()
    want_loss, want_params = jax_ref("step", case)
    trainer = _mesh_trainer(case)
    params, state = trainer.place(params_from_numpy(_source(config)))
    params, state, metrics = trainer.step(params, state, images, labels)
    np.testing.assert_allclose(float(metrics["loss"]), want_loss, rtol=LOSS_RTOL)
    assert set(metrics) == {"loss", "accuracy"}
    _assert_params(trainer.unplace(params)[0], want_params, config)


@pytest.mark.parametrize("case", list(CASES))
def test_mesh_gradients_match_jax(case, jax_ref):
    """The raw gradient of the mesh step (SGD(1.0): p0 - p1) against
    jax.grad of the sequential loss: a wrong replica sum or shard scale
    shows here, where Adam would hide it."""
    config = CASES[case][0]
    images, labels = _batch()
    source = _source(config)
    trainer = _mesh_trainer(case, SGD(1.0))
    params, state = trainer.place(params_from_numpy(source))
    params, state, _ = trainer.step(params, state, images, labels)
    _assert_grads(source, trainer.unplace(params)[0], jax_ref("grad", config))
    # every distinct master once
    distinct = {id(t) for tree in params for t in tree_leaves(tree)}
    assert sorted(trainer.optimizer.updated) == sorted(distinct)


def test_pipeline_train_step_matches_jax(jax_ref):
    """make_pipeline_train_step, 4 stages x 4 microbatches of 2 images, 8
    layers: the loss and the parameters after one AdamW step against the
    JAX pipeline step, the raw SGD(1.0) gradient against jax.grad, and a
    second step that runs."""
    images, labels = _batch()
    source = _source(PIPE)
    m = _cpu_mesh({"stage": 4})
    step, place = pipeline.make_pipeline_train_step(PIPE, _opts(), m, AdamW(LR, 0.05), 4)
    params, state = place(params_from_numpy(source))
    assert params[0]["layers"]["ls1"].shape[0] == 2 and params[3]["cls_token"] is params[0]["cls_token"]
    params, state, metrics = step(params, state, images, labels)
    want_loss, want_params = jax_ref("pipeline")
    np.testing.assert_allclose(float(metrics["loss"]), want_loss, rtol=LOSS_RTOL)
    specs = pipeline.layer_pspecs(params[0])
    _assert_params(mesh.unplace(params, m, specs), want_params, PIPE)
    _, _, again = step(params, state, images, labels)
    assert float(again["loss"]) < float(metrics["loss"]) and state["count"] == 2

    sgd = SGD(1.0)
    step, place = pipeline.make_pipeline_train_step(PIPE, _opts(), m, sgd, 4)
    params, state = place(params_from_numpy(source))
    params, _, _ = step(params, state, images, labels)
    _assert_grads(source, mesh.unplace(params, m, specs), jax_ref("grad", PIPE))
    assert len(sgd.updated) == len(set(sgd.updated)) == len(tree_leaves(source)) + 3 * len(
        tree_leaves(source["layers"]))


@pytest.mark.parametrize("case", ["tp", "dp"])
def test_cloned_replicas_take_the_same_step(case):
    """Every replica cloned, as distinct cards hold them: the step reduces
    their gradients, so it gives the shared replicas' parameters, every
    clone of a shard stays bit for bit the others, and each distinct master
    is updated once."""
    config, axes, _ = CASES[case]
    images, labels = _batch()
    source = params_from_numpy(_source(config))
    shared = _mesh_trainer(case)
    params, state = shared.place(source)
    params, state, metrics = shared.step(params, state, images, labels)

    counting = Counting(AdamW(LR, 0.05))
    trainer = _mesh_trainer(case, counting)
    placed, _ = trainer.place(source)
    cloned = [tree_map(lambda t: t.detach().clone().requires_grad_(True), tree) for tree in placed]
    assert len(masters_of(cloned)) == len(cloned)
    cloned_state = counting.init(masters_of(cloned))
    cloned, cloned_state, cloned_metrics = trainer.step(cloned, cloned_state, images, labels)

    np.testing.assert_allclose(float(cloned_metrics["loss"]), float(metrics["loss"]), rtol=1e-6)
    _assert_params(trainer.unplace(cloned)[0], shared.unplace(params)[0], config)
    assert sorted(counting.updated) == sorted(id(t) for tree in cloned for t in tree_leaves(tree))
    specs = trainer.specs(cloned)
    for name, first in _flat(cloned[0]).items():
        path = tuple(name.split("/"))
        spec = () if specs is None else mesh._spec_of(specs, path)
        for position, tree in enumerate(cloned):
            coords = trainer.mesh.coords(position)
            twin = trainer.mesh.position({a: c for a, c in coords.items() if a in spec})
            np.testing.assert_array_equal(_flat(tree)[name], _flat(cloned[twin])[name])


@pytest.mark.parametrize("config, axes", [(TINY, {"data": 4, "model": 2}),
                                          (SWIGLU, {"model": 4}),
                                          (WIDE, {"data": 2})],
                         ids=["tp", "swiglu_tp", "dp"])
def test_unplace_inverts_place(config, axes):
    """Trainer.unplace(Trainer.place(p)) is p bit for bit, qkv's and
    SwiGLU's permutation undone, the optimizer state too; and
    mesh.unplace inverts mesh.place for TP and stage specs."""
    source = params_from_numpy(_source(config))
    m = _cpu_mesh(axes)
    trainer = make_trainer(config, mesh=m, device="cpu")
    placed, state = trainer.place(source)
    if "model" in axes:
        assert placed[1]["layers"]["qkv"]["kernel"].shape[-1] == 3 * config.hidden_size // axes["model"]
    logical, logical_state = trainer.unplace(placed, state)
    for want, got in zip(tree_leaves(source), tree_leaves(logical)):
        assert torch.equal(want, got)
    assert logical_state["count"] == 0
    assert all(not t.any() for t in tree_leaves(logical_state["mu"]))
    # a state placed from its logical form comes back as it was
    state["mu"] = tree_map(lambda t: torch.randn_like(t), state["mu"])
    again, again_state = trainer.place(*trainer.unplace(placed, state))
    for a, b in zip(tree_leaves(trainer.unplace(again, again_state)[1]["mu"]),
                    tree_leaves(trainer.unplace(placed, state)[1]["mu"])):
        assert torch.equal(a, b)
    specs = pipeline.layer_pspecs(source)
    staged = _cpu_mesh({"stage": 2})
    for want, got in zip(tree_leaves(source),
                         tree_leaves(mesh.unplace(mesh.place(source, staged, specs), staged, specs))):
        assert torch.equal(want, got)
    params_tp, specs = tp_fused.tp_prepare_dense_params(source, config, 2)
    two = _cpu_mesh({"model": 2})
    back = tp_fused.tp_restore_dense_params(
        mesh.unplace(mesh.place(params_tp, two, specs), two, specs), config, 2)
    for want, got in zip(tree_leaves(source), tree_leaves(back)):
        assert torch.equal(want, got)


def test_token_collectives_are_each_others_transpose():
    """all_gather_tokens and reduce_scatter_tokens on ragged slices (T=26
    over 4: 7, 7, 7, 5), against their definitions, forward and backward."""
    assert mesh.token_slices(26, 4) == [(0, 7), (7, 7), (14, 7), (21, 5)]
    assert mesh.token_slices(257, 2) == [(0, 129), (129, 128)]
    assert mesh.token_slices(5, 4) == [(0, 2), (2, 2), (4, 1), (5, 0)]
    g = torch.Generator().manual_seed(0)
    full = torch.randn(2, 26, 3, generator=g, dtype=torch.float64)
    slices = [full[:, s: s + n].clone().requires_grad_() for s, n in mesh.token_slices(26, 4)]
    gathered = mesh.all_gather_tokens(slices)
    assert all(torch.equal(t, full) for t in gathered)
    weights = [torch.randn(2, 26, 3, generator=g, dtype=torch.float64) for _ in range(4)]
    sum((t * w).sum() for t, w in zip(gathered, weights)).backward()
    total = sum(weights)
    for s, (start, n) in zip(slices, mesh.token_slices(26, 4)):
        assert torch.allclose(s.grad, total[:, start: start + n])
    parts = [torch.randn(2, 26, 3, generator=g, dtype=torch.float64, requires_grad=True)
             for _ in range(4)]
    scattered = mesh.reduce_scatter_tokens(parts)
    psum = mesh.psum([p.detach() for p in parts])[0]
    for got, (start, n) in zip(scattered, mesh.token_slices(26, 4)):
        assert torch.equal(got, psum[:, start: start + n])
    ups = [torch.randn(t.shape, generator=g, dtype=torch.float64) for t in scattered]
    sum((t * u).sum() for t, u in zip(scattered, ups)).backward()
    for p in parts:
        assert torch.equal(p.grad, torch.cat(ups, dim=1))
    assert torch.autograd.gradcheck(
        lambda *xs: tuple(mesh.reduce_scatter_tokens(list(xs))),
        tuple(p.detach().requires_grad_() for p in parts[:2]))


def test_checkpoint_moves_between_a_mesh_and_one_device(tmp_path):
    """A state saved under a TP mesh restores on one device as the mesh's
    logical state, bit for bit, and a single-device file restores under the
    mesh; both then take a step."""
    source = params_from_numpy(_source(TINY))
    images, labels = _batch()
    trainer = make_trainer(TINY, mesh=_cpu_mesh({"data": 2, "model": 2}), opts=_opts(),
                           preprocess_in_step=False, device="cpu")
    params, state = trainer.place(source)
    params, state, _ = trainer.step(params, state, images, labels)
    save_train_state(tmp_path / "mesh", 1, params, state, trainer=trainer)
    single = make_trainer(TINY, opts=_opts(), preprocess_in_step=False, device="cpu")
    step, got, got_state = restore_train_state(tmp_path / "mesh", *single.place(source))
    want, want_state = trainer.unplace(params, state)
    assert step == 1 and got_state["count"] == 1
    for a, b in zip(tree_leaves({"p": want, "mu": want_state["mu"], "nu": want_state["nu"]}),
                    tree_leaves({"p": got, "mu": got_state["mu"], "nu": got_state["nu"]})):
        assert torch.equal(a, b.detach())
    single.step(got, got_state, images, labels)

    save_train_state(tmp_path / "one", 2, got, got_state)
    step, back, back_state = restore_train_state(tmp_path / "one", *trainer.place(source),
                                                 trainer=trainer)
    logical, logical_state = trainer.unplace(back, back_state)
    assert step == 2 and back_state["count"] == 2
    for a, b in zip(tree_leaves({"p": got, "mu": got_state["mu"]}),
                    tree_leaves({"p": logical, "mu": logical_state["mu"]})):
        assert torch.equal(a.detach(), b)
    trainer.step(back, back_state, images, labels)


def _tree(value):
    return tree_map(lambda t: t.detach().clone(), value)


def test_train_cli_mesh_exports_the_single_device_model(tmp_path, monkeypatch):
    """`cli.train --device cpu --mesh 2,2` exports the model the single-
    device run exports: the trees handed to export_gguf within the params
    bound (the mesh's is unplaced and unpermuted), the files within that
    and one f16 step (both hold f16 weights), and the mesh's checkpoint
    restores on one device."""
    from dinov2_tpu_torch.cli import train as train_cli
    from dinov2_tpu_torch.io import export
    from dinov2_tpu_torch.models.params import load_params

    rng = np.random.default_rng(0)
    data = tmp_path / "data"
    for name, base in [("blue", (40, 40, 200)), ("red", (200, 40, 40))]:
        (data / name).mkdir(parents=True)
        for i in range(8):
            img = np.clip(np.asarray(base, np.int16) + rng.integers(-30, 30, (32, 32, 3)),
                          0, 255).astype(np.uint8)
            cv2.imwrite(str(data / name / f"{i}.png"), img)
    backbone = write_synthetic_gguf(tmp_path / "b.gguf", WIDE, seed=3, with_classifier=False)
    exported = {}
    real = export.export_gguf

    def spy(path, params, config, id2label=None):
        exported[path] = _tree(params)
        return real(path, params, config, id2label)

    monkeypatch.setattr(export, "export_gguf", spy)
    common = ["-m", str(backbone), "--data", str(data), "--batch", "8", "--device", "cpu"]
    assert train_cli.main([*common, "--export", str(tmp_path / "one.gguf")]) == 0
    assert train_cli.main([*common, "--mesh", "2,2", "--export", str(tmp_path / "mesh.gguf"),
                           "--checkpoint-dir", str(tmp_path / "ck")]) == 0
    one, meshed = exported[str(tmp_path / "one.gguf")], exported[str(tmp_path / "mesh.gguf")]
    _assert_params(meshed, one, WIDE, steps=2)
    files = [load_params(tmp_path / f"{n}.gguf", dtype=torch.float32, device="cpu").params
             for n in ("one", "mesh")]
    for a, b in zip(tree_leaves(files[0]), tree_leaves(files[1])):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=PARAM_RTOL + 2.0**-10,
                                   atol=PARAM_ATOL)
    trainer = make_trainer(dataclasses.replace(WIDE, num_classes=2), device="cpu")
    step, restored, _ = restore_train_state(tmp_path / "ck", *trainer.place(meshed))
    assert step == 2
    for a, b in zip(tree_leaves(meshed), tree_leaves(restored)):
        assert torch.equal(a, b.detach())


def test_mesh_devices_follow_the_device_flag():
    """`--device cuda` takes every card (make_mesh's default); the CPU or a
    card named by its index holds every position."""
    assert mesh.mesh_devices("cuda", 4) is None
    assert mesh.mesh_devices("cuda:0", 2) == [torch.device("cuda", 0)] * 2
    assert mesh.mesh_devices("cpu", 3) == [CPU] * 3
