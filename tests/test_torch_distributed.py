"""The port's multi-process mode (parallel/mesh.py::init_distributed on
torch.distributed, a Mesh whose positions span ranks, the collectives
across ranks, Trainer(mesh=), checkpoints and the engine across ranks) on
the CPU, against the port's one-process mesh and the JAX package.

  - The plumbing, as the JAX package's test_init_distributed_plumbs_arguments
    does it: `dist.init_process_group` monkeypatched, the arguments reach
    it, one process is a no-op, and torchrun's environment is read where
    the arguments are None.
  - One two-rank gloo launch over localhost for the whole module
    (tests/torch_rank_worker.py, each process with its own timeout): every
    case runs in both ranks, which save their results; the tests read them.
    The ranks and this process use THREADS torch threads, so that the CPU
    GEMMs round alike. A two-rank step is held bit for bit to the one-process
    mesh of the same axes (`[cpu] * n`): the collectives across ranks sum the
    same parts in the same order. It is held to the JAX package's sharded
    step on its 8 host devices with tests/test_torch_train_mesh.py's bounds
    (loss rtol 1e-5; parameters rtol 5e-4, atol 1e-5 with that file's
    allowance), and its raw SGD(1.0) gradient to jax.grad of the sequential
    loss (rtol 1e-4, atol 1e-6).
"""

import dataclasses
import os
import socket
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from datetime import timedelta
from pathlib import Path

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
from dinov2_tpu.parallel.train import Trainer as JaxTrainer
from dinov2_tpu_torch.io.synthetic import write_synthetic_gguf
from dinov2_tpu_torch.models import vit
from dinov2_tpu_torch.models.params import params_from_numpy, tree_leaves
from dinov2_tpu_torch.parallel import mesh
from dinov2_tpu_torch.parallel.checkpoint import restore_train_state, save_train_state
from dinov2_tpu_torch.parallel.mesh import _at
from dinov2_tpu_torch.parallel.train import AdamW, Trainer, _owners
from dinov2_tpu_torch.runtime.engine import DinoEngine

ROOT = Path(__file__).resolve().parent.parent
WORKER = ROOT / "tests" / "torch_rank_worker.py"
WORLD = 2
THREADS = 1
RANK_TIMEOUT_S = 120
JAX_THREADS = 4
CPU = torch.device("cpu")
TINY = DinoConfig(hidden_size=64, num_hidden_layers=2, num_attention_heads=2, num_classes=8,
                  patch_size=14, img_size=70)
WIDE = dataclasses.replace(TINY, hidden_size=128, num_attention_heads=4)
CONFIGS = {"tiny": TINY, "wide": WIDE}
LR = 1e-4
LOSS_RTOL = 1e-5
PARAM_RTOL, PARAM_ATOL = 5e-4, 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
# name -> (config, mesh axes, sequence_parallel): with two ranks, DP puts a
# 'data' slice on each, TP and TP + SP a 'model' shard on each, and
# {"data": 2, "model": 2} a whole 'model' group on each
KINDS = {"dp": ({"data": 2}, False), "tp": ({"data": 1, "model": 2}, False),
         "sp": ({"data": 1, "model": 2}, True), "dp_tp": ({"data": 2, "model": 2}, False)}
CASES = {f"{c}_{k}": (c, axes, sp) for c in CONFIGS for k, (axes, sp) in KINDS.items()}
CHECKPOINT_CASE = "wide_dp_tp"


def _batch(seed=1):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((8, 70, 70, 3)).astype(np.float32),
            rng.integers(0, 8, (8,)))


def _source(config, seed=0):
    """The JAX package's parameters, as numpy."""
    return jax.tree_util.tree_map(
        np.asarray, jparams.init_params(config, seed=seed, dtype=jnp.float32))


def _trainer(case, optimizer=None):
    """The one-process port on `[cpu] * n`."""
    name, axes, sp = CASES[case]
    opts = vit.ModelOptions(parity="hf", compute_dtype=torch.float32, remat=True,
                            sequence_parallel=sp)
    m = mesh.make_mesh(axes, [CPU] * int(np.prod(list(axes.values()))))
    return Trainer(CONFIGS[name], opts, optimizer or AdamW(LR, 0.05), mesh=m,
                   preprocess_in_step=False, device="cpu")


class SGD:
    def init(self, params):
        return {}

    @torch.no_grad()
    def update_(self, params, grads, state):
        torch._foreach_add_(tree_leaves(params), grads, alpha=-1.0)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Ranks:
    """The two rank processes of the module, started at once and read on
    first use."""

    def __init__(self, out: Path):
        self.out = out
        port = _free_port()
        env = {k: v for k, v in os.environ.items()
               if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
        self.procs = [
            subprocess.Popen([sys.executable, str(WORKER), str(r), str(WORLD), str(port),
                              str(out), str(THREADS)],
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                             env=env, cwd=ROOT)
            for r in range(WORLD)
        ]
        self.found = None

    def get(self) -> list:
        if self.found is None:
            failed = []
            for rank, proc in enumerate(self.procs):
                try:
                    _, err = proc.communicate(timeout=RANK_TIMEOUT_S)
                except subprocess.TimeoutExpired:
                    self.kill()
                    _, err = proc.communicate()
                    failed.append(f"rank {rank} passed its {RANK_TIMEOUT_S} s limit:\n{err}")
                    continue
                if proc.returncode:
                    failed.append(f"rank {rank} exited {proc.returncode}:\n{err}")
            assert not failed, "\n".join(failed)
            self.found = [torch.load(self.out / f"rank{r}.pt", weights_only=False)
                          for r in range(WORLD)]
        return self.found

    def kill(self):
        for proc in self.procs:
            if proc.poll() is None:
                proc.kill()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("ranks")
    images, labels = _batch()
    engine_images = np.random.default_rng(2).integers(0, 256, (3, 60, 75, 3), dtype=np.uint8)
    gguf = write_synthetic_gguf(out / "m.gguf", WIDE, seed=3)
    sources = {name: _source(config) for name, config in CONFIGS.items()}
    # a one-process state after one step, for the ranks to restore
    one = _trainer(CHECKPOINT_CASE)
    params, state = one.place(params_from_numpy(sources["wide"]))
    params, state, _ = one.step(params, state, images, labels)
    save_train_state(out / "one", 1, params, state, trainer=one)
    torch.save({
        "images": images, "labels": labels, "engine_images": engine_images, "gguf": str(gguf),
        "configs": {name: dataclasses.asdict(c) for name, c in CONFIGS.items()},
        "sources": sources, "cases": CASES, "checkpoint_case": CHECKPOINT_CASE,
    }, out / "inputs.pt")
    threads = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    started = Ranks(out)
    yield started
    started.kill()
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def one_process(ranks):
    """Each case's one-process AdamW step on first use: (trainer, params,
    state, metrics)."""
    made = {}

    def get(case):
        if case not in made:
            trainer = _trainer(case)
            params, state = trainer.place(params_from_numpy(_source(CONFIGS[CASES[case][0]])))
            made[case] = (trainer, *trainer.step(params, state, *_batch()))
        return made[case]

    return get


# ---------------------------------------------------------------------------
# init_distributed's plumbing
# ---------------------------------------------------------------------------

TORCHRUN = {"WORLD_SIZE": "2", "RANK": "1", "LOCAL_RANK": "0", "MASTER_ADDR": "10.0.0.2",
            "MASTER_PORT": "29500"}


@pytest.mark.parametrize("args, env, want", [
    (("10.0.0.1:1234", 4, 2), {}, ("tcp://10.0.0.1:1234", 4, 2, "gloo")),
    (("10.0.0.1:1234", 4, 2, "nccl"), {}, ("tcp://10.0.0.1:1234", 4, 2, "nccl")),
    (("10.0.0.1:1234", 1, 0), {}, None),
    ((), {}, None),
    ((), TORCHRUN, ("tcp://10.0.0.2:29500", 2, 1, "gloo")),
], ids=["arguments", "backend", "one_process", "no_environment", "torchrun_environment"])
def test_init_distributed_plumbs_arguments(monkeypatch, args, env, want):
    """The JAX package's test of its wrapper, on torch.distributed: the
    arguments (or torchrun's environment) reach init_process_group with a
    finite timeout; one process, or no arguments and no WORLD_SIZE, is a
    no-op."""
    calls = []
    for key in TORCHRUN:
        monkeypatch.delenv(key, raising=False)
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda backend, **kw: calls.append((backend, kw)))
    monkeypatch.setattr(mesh, "_gather_devices", lambda device: [(0, device)])
    monkeypatch.setattr(mesh, "_RANK_DEVICES", None)
    mesh.init_distributed(*args)
    if want is None:
        assert calls == []
        return
    method, world, rank, backend = want
    assert calls == [(backend, dict(init_method=method, world_size=world, rank=rank,
                                    timeout=timedelta(seconds=mesh.PROCESS_GROUP_TIMEOUT_S)))]
    assert mesh.process_index() == 0 and mesh.process_count() == 1  # no group was made


# ---------------------------------------------------------------------------
# Two ranks
# ---------------------------------------------------------------------------


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v.detach().numpy() if torch.is_tensor(v) else np.asarray(v)
    return out


def _jax_step(case):
    """The JAX package's sharded AdamW step of a case on its host devices:
    (loss, params)."""
    name, axes, sp = CASES[case]
    config = CONFIGS[name]
    jm = jmesh.make_mesh(axes, devices=jax.devices()[: int(np.prod(list(axes.values())))])
    trainer = JaxTrainer(
        config, jvit.ModelOptions(parity="hf", compute_dtype=jnp.float32, sequence_parallel=sp),
        optax.adamw(LR, weight_decay=0.05), mesh=jm, tensor_parallel=True,
        preprocess_in_step=False)
    params, state = trainer.place(jax.tree_util.tree_map(jnp.asarray, _source(config)))
    params, _, metrics = trainer.step(params, state, *_batch())
    return float(metrics["loss"]), jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def jax_step():
    """Every case's JAX step, compiled on JAX_THREADS threads at first use
    (while the ranks run)."""
    made = {}

    def get(case):
        if not made:
            with ThreadPoolExecutor(JAX_THREADS) as pool:
                made.update(zip(CASES, pool.map(_jax_step, CASES)))
        return made[case]

    return get


@pytest.mark.parametrize("case", list(CASES))
def test_two_rank_step_matches_jax(case, ranks, jax_step):
    """The two ranks' step against the JAX package's sharded step on the
    same axes: each rank's loss, and the parameters of both ranks' positions
    put together and unplaced in this process, within the bounds of
    tests/test_torch_train_mesh.py (at most one element in 10^4 of a leaf
    beyond rtol/atol, none beyond lr; the k third of the qkv bias, whose
    true gradient is 0, within lr)."""
    want_loss, want = jax_step(case)
    found = ranks.get()
    trainer = _trainer(case)
    placed = [next(f[case]["placed"][p] for f in found if f[case]["placed"][p] is not None)
              for p in range(trainer.mesh.size)]
    for f in found:
        np.testing.assert_allclose(f[case]["loss"], want_loss, rtol=LOSS_RTOL)
    got, want = _flat(trainer.unplace(placed)[0]), _flat(want)
    assert got.keys() == want.keys()
    d = CONFIGS[CASES[case][0]].hidden_size
    for name, leaf in got.items():
        ref = want[name]
        assert np.abs(leaf - ref).max() <= LR, name
        if name == "layers/qkv/bias":
            leaf, ref = np.delete(leaf, np.s_[d: 2 * d], 1), np.delete(ref, np.s_[d: 2 * d], 1)
        beyond = np.abs(leaf - ref) > PARAM_ATOL + PARAM_RTOL * np.abs(ref)
        assert beyond.sum() <= 1e-4 * beyond.size, (name, int(beyond.sum()))


@pytest.fixture(scope="module")
def jax_grad():
    made = {}

    def get(name):
        if name not in made:
            config = CONFIGS[name]
            images, labels = _batch()
            opts = jvit.ModelOptions(parity="hf", compute_dtype=jnp.float32)

            def loss(p):
                tokens = jvit.forward_features(p, jnp.asarray(images), config, opts)
                logits = jvit.head_logits(p, tokens, config, opts)
                return optax.softmax_cross_entropy_with_integer_labels(
                    logits, jnp.asarray(labels)).mean()

            grads = jax.jit(jax.grad(loss))(jax.tree_util.tree_map(jnp.asarray, _source(config)))
            made[name] = _flat(jax.tree_util.tree_map(np.asarray, grads))
        return made[name]

    return get


@pytest.mark.parametrize("case", list(CASES))
def test_two_rank_gradients_match_jax(case, ranks, jax_grad):
    """The raw gradient of the two ranks' step (SGD(1.0): p0 - p1, the
    tree unplaced collectively in each rank) against jax.grad of the
    sequential loss: a gradient counted twice, or once for every rank,
    shows here. Both ranks unplace the same tree, bit for bit."""
    name = CASES[case][0]
    want = jax_grad(name)
    source = _flat(params_from_numpy(_source(CONFIGS[name])))
    first, second = (f[case]["sgd"] for f in ranks.get())
    _equal_trees(first, second, "the ranks' unplaced trees")
    got = {k: source[k] - v for k, v in _flat(first).items()}
    assert got.keys() == want.keys()
    for key, g in got.items():
        np.testing.assert_allclose(g, want[key], rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=key)


def test_two_rank_psum(ranks):
    """The JAX package's two-process smoke: a psum across the ranks gives
    1 + 2 = 3 in both, over gloo."""
    found = ranks.get()
    assert [f["psum"] for f in found] == [3.0, 3.0]
    assert [(f["rank"], f["count"], f["backend"]) for f in found] == [(0, 2, "gloo"),
                                                                    (1, 2, "gloo")]


def test_default_mesh_spans_both_ranks(ranks):
    """make_mesh() after init_distributed is one 'data' axis over every
    rank's device, each position owned by its rank."""
    for f in ranks.get():
        assert f["default_mesh"] == ({"data": 2}, ["cpu", "cpu"], [0, 1])


def _equal_trees(a, b, what):
    assert a.keys() == b.keys(), what
    for key in a:
        if isinstance(a[key], dict):
            _equal_trees(a[key], b[key], f"{what}/{key}")
        else:
            assert torch.equal(a[key].detach(), b[key].detach()), f"{what}/{key}"


@pytest.mark.parametrize("case", list(CASES))
def test_two_rank_step_is_the_one_process_step(case, ranks, one_process):
    """One AdamW step across two ranks: the same loss and accuracy on both
    ranks, bit for bit the one-process mesh's, and every position a rank
    owns (parameters and first moments) bit for bit the one-process
    mesh's at that position; the positions it does not own are None."""
    trainer, params, state, metrics = one_process(case)
    m = trainer.mesh
    for rank, found in enumerate(ranks.get()):
        got = found[case]
        assert got["loss"] == float(metrics["loss"]), (rank, got["loss"], float(metrics["loss"]))
        assert got["accuracy"] == float(metrics["accuracy"])
        owned = [p for p in range(m.size) if p * WORLD // m.size == rank]
        assert [p for p, tree in enumerate(got["placed"]) if tree is not None] == owned
        for position in owned:
            _equal_trees(got["placed"][position], params[position], f"rank {rank} {position}")
        # a rank's first position of a leaf holds its moment; in one process
        # the first position of all that hold the same tensor does
        assert got["mu"].keys() <= set(owned)
        owners = _owners(params)
        for position, tree in got["mu"].items():
            for path, moment in _flat(tree).items():
                keys = tuple(path.split("/"))
                one = _at(state["mu"][_at(owners[position], keys)], keys)
                assert np.array_equal(moment, one.numpy()), (rank, position, path)


def test_checkpoint_moves_between_ranks_and_one_process(ranks, one_process):
    """A state saved by the two ranks restores into a one-process trainer
    bit for bit that trainer's own state after the same step; a state saved
    by one process restores onto the two ranks as it was saved."""
    ranks.get()
    trainer, params, state, _ = one_process(CHECKPOINT_CASE)
    want, want_state = trainer.unplace(params, state)
    step, got, got_state = restore_train_state(
        ranks.out / "ck", *trainer.place(params_from_numpy(_source(WIDE))), trainer=trainer)
    logical, logical_state = trainer.unplace(got, got_state)
    assert step == 1 and logical_state["count"] == 1
    _equal_trees(logical, want, "params")
    _equal_trees(logical_state["mu"], want_state["mu"], "mu")
    _equal_trees(logical_state["nu"], want_state["nu"], "nu")
    saved = torch.load(ranks.out / "one" / "step_00000001.pt", weights_only=True)
    for f in ranks.get():
        restored, restored_state = f["restored"]
        _equal_trees(restored, saved["params"], "restored params")
        _equal_trees(restored_state["nu"], saved["opt_state"]["nu"], "restored nu")


def test_engine_model_axis_across_ranks(ranks):
    """DinoEngine(mesh_axes={"model": 2}) across the ranks (one shard a
    rank, the psums across them): both ranks return the same outputs, bit
    for bit the one-process engine's on the same axes."""
    found = ranks.get()
    images = np.random.default_rng(2).integers(0, 256, (3, 60, 75, 3), dtype=np.uint8)
    one = DinoEngine(ranks.out / "m.gguf", dtype=torch.float32, device="cpu",
                     mesh_axes={"model": 2})
    probs = one.classify_probs(images)
    features = one.extract_features(images)
    for f in found:
        assert "ranks=[0, 1]" in f["engine_mesh"]
        np.testing.assert_array_equal(f["engine_probs"], probs)
        for key in ("cls_token", "patch_tokens"):
            np.testing.assert_array_equal(f["engine_features"][key], features[key])


def test_engine_data_axis_across_ranks_raises(ranks):
    """A 'data' axis across the ranks refuses, saying why: its outputs would
    lie on the other process, which the JAX engine cannot fetch either."""
    for f in ranks.get():
        assert f["data_axis_error"] is not None
        assert "spans ranks" in f["data_axis_error"]
        assert "non-addressable" in f["data_axis_error"]
