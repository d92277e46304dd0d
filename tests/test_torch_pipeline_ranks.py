"""The port's pipeline across ranks (parallel/pipeline.py on a 'stage' mesh
whose positions span processes, parallel/mesh.py::hand_off) on the CPU,
against the port's one-process pipeline and the JAX package's.

One two-rank gloo launch over localhost for the module
(tests/torch_pipeline_rank_worker.py, each process with its own timeout):
every case runs in both ranks, which save their results; the tests read
them. The ranks and this process use THREADS torch threads, so that the CPU
GEMMs round alike. The config is tests/test_torch_train_mesh.py's PIPE (8
layers, hidden 64, 2 heads, 70 px), 8 images in 4 microbatches, on
{"stage": 2} and {"stage": 4} in rank blocks and {"stage": 4} interleaved
over the ranks (stages 0, 1, 2, 3 on ranks 0, 1, 0, 1: hand-offs both ways
between the ranks at one step). Bounds:
  - against the one-process pipeline of the same axes: bit for bit, on both
    ranks (`pipeline_forward`'s outputs; the losses, accuracies and every
    position a rank owns after one and two AdamW steps);
  - against the JAX package's pipeline_forward: tokens within TOKEN_ATOL,
    probs within SHARD_RTOL / SHARD_ATOL (tests/test_torch_parallel.py's);
  - against its make_pipeline_train_step: loss rtol 1e-5, parameters rtol
    5e-4, atol 1e-5 with tests/test_torch_train_mesh.py's allowance (at
    most one element in 10^4 of a leaf beyond, none beyond lr a step; the
    k third of the qkv bias within lr a step);
  - the raw SGD(1.0) gradient against jax.grad of the sequential loss:
    rtol 1e-4, atol 1e-6.
"""

import dataclasses
import os
import socket
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
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
from dinov2_tpu.parallel import pipeline as jpipeline
from dinov2_tpu_torch.models import vit
from dinov2_tpu_torch.models.params import params_from_numpy, tree_map
from dinov2_tpu_torch.parallel import mesh, pipeline
from dinov2_tpu_torch.parallel.train import AdamW

ROOT = Path(__file__).resolve().parent.parent
WORKER = ROOT / "tests" / "torch_pipeline_rank_worker.py"
WORLD = 2
THREADS = 1
RANK_TIMEOUT_S = 120
CPU = torch.device("cpu")
PIPE = DinoConfig(hidden_size=64, num_hidden_layers=8, num_attention_heads=2, num_classes=8,
                  patch_size=14, img_size=70)
MICROBATCHES = 4
LR = 1e-4
TOKEN_ATOL = 2e-5
SHARD_RTOL, SHARD_ATOL = 1e-5, 1e-6
LOSS_RTOL = 1e-5
PARAM_RTOL, PARAM_ATOL = 5e-4, 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
# name -> (stages, the rank of each position; None: make_mesh's rank blocks)
CASES = {"stage2": (2, None), "stage4": (4, None), "stage4_interleaved": (4, [0, 1, 0, 1])}


def _batch(seed=1):
    """tests/test_parallel.py's batch: preprocessed images and labels."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((8, 70, 70, 3)).astype(np.float32),
            rng.integers(0, 8, (8,)))


def _source(seed=0):
    """The JAX package's parameters, as numpy."""
    return jax.tree_util.tree_map(
        np.asarray, jparams.init_params(PIPE, seed=seed, dtype=jnp.float32))


def _opts():
    return vit.ModelOptions(parity="hf", compute_dtype=torch.float32, remat=True)


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
                    self.kill()  # the other would wait on its hand-offs
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
    out = tmp_path_factory.mktemp("pipeline_ranks")
    images, labels = _batch()
    torch.save({"images": images, "labels": labels, "config": dataclasses.asdict(PIPE),
                "source": _source(), "cases": CASES, "microbatches": MICROBATCHES},
               out / "inputs.pt")
    started = Ranks(out)
    yield started
    started.kill()


class SGD:
    def init(self, params):
        return {}

    @torch.no_grad()
    def update_(self, params, grads, state):
        from dinov2_tpu_torch.models.params import tree_leaves

        torch._foreach_add_(tree_leaves(params), grads, alpha=-1.0)


def _one_process(stages: int) -> dict:
    """The one-process pipeline on [cpu] * stages: the forward, two AdamW
    steps (loss, accuracy, the placed list after each) and the SGD(1.0)
    step's unplaced tree."""
    m = mesh.make_mesh({"stage": stages}, [CPU] * stages)
    images, labels = (torch.from_numpy(a) for a in _batch())
    source = _source()
    placed = pipeline.place_pipeline_params(params_from_numpy(source), m)
    found = {"forward": pipeline.pipeline_forward(placed, images, PIPE, _opts(), m,
                                                  num_microbatches=MICROBATCHES, classify=True)}
    step, place = pipeline.make_pipeline_train_step(PIPE, _opts(), m, AdamW(LR, 0.05),
                                                    MICROBATCHES)
    params, state = place(params_from_numpy(source))
    found["steps"] = []
    for _ in range(2):
        params, state, metrics = step(params, state, images, labels)
        found["steps"].append({
            "loss": float(metrics["loss"]), "accuracy": float(metrics["accuracy"]),
            "placed": [tree_map(lambda t: t.detach().clone(), tree) for tree in params]})
    step, place = pipeline.make_pipeline_train_step(PIPE, _opts(), m, SGD(), MICROBATCHES)
    params, state = place(params_from_numpy(source))
    step(params, state, images, labels)
    found["sgd"] = mesh.unplace(params, m, pipeline.layer_pspecs(params[0]))
    return found


@pytest.fixture(scope="module")
def one_process(ranks):
    """Each stage count's one-process pipeline, on THREADS threads (as the
    ranks), on first use."""
    made = {}

    def get(stages):
        if stages not in made:
            threads = torch.get_num_threads()
            torch.set_num_threads(THREADS)
            try:
                made[stages] = _one_process(stages)
            finally:
                torch.set_num_threads(threads)
        return made[stages]

    return get


def _jax_refs(stages: int) -> dict:
    """The JAX package's pipeline_forward and two make_pipeline_train_step
    AdamW steps on `stages` of its host devices."""
    images, labels = (jnp.asarray(a) for a in _batch())
    jm = jmesh.make_mesh({"stage": stages}, devices=jax.devices()[:stages])
    jopts = jvit.ModelOptions(parity="hf", compute_dtype=jnp.float32)
    source = jax.tree_util.tree_map(jnp.asarray, _source())
    forward = jpipeline.pipeline_forward(
        jpipeline.place_pipeline_params(source, jm), images, PIPE, jopts, jm,
        num_microbatches=MICROBATCHES, classify=True)
    step, place = jpipeline.make_pipeline_train_step(
        PIPE, jopts, jm, optax.adamw(LR, weight_decay=0.05), num_microbatches=MICROBATCHES)
    params, state = place(source)
    steps = []
    for _ in range(2):
        params, state, metrics = step(params, state, images, labels)
        steps.append((float(metrics["loss"]), jax.tree_util.tree_map(np.asarray, params)))
    return {"forward": {k: np.asarray(v) for k, v in forward.items()}, "steps": steps}


def _jax_grad() -> dict:
    images, labels = _batch()
    opts = jvit.ModelOptions(parity="hf", compute_dtype=jnp.float32)

    def loss(p):
        tokens = jvit.forward_features(p, jnp.asarray(images), PIPE, opts)
        logits = jvit.head_logits(p, tokens, PIPE, opts)
        return optax.softmax_cross_entropy_with_integer_labels(logits, jnp.asarray(labels)).mean()

    grads = jax.jit(jax.grad(loss))(jax.tree_util.tree_map(jnp.asarray, _source()))
    return jax.tree_util.tree_map(np.asarray, grads)


@pytest.fixture(scope="module", autouse=True)
def jax_ref(ranks):
    """The JAX references, built once for the module on three threads of
    this process, started with the module's first test (while the ranks
    run): "grad" and each stage count."""
    keys = ["grad", *sorted({stages for stages, _ in CASES.values()})]
    pool = ThreadPoolExecutor(len(keys))
    made = {k: pool.submit(_jax_grad) if k == "grad" else pool.submit(_jax_refs, k)
            for k in keys}
    yield lambda key: made[key].result()
    pool.shutdown(cancel_futures=True)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v.detach().numpy() if torch.is_tensor(v) else np.asarray(v)
    return out


def _equal_trees(a, b, what):
    assert a.keys() == b.keys(), what
    for key in a:
        if isinstance(a[key], dict):
            _equal_trees(a[key], b[key], f"{what}/{key}")
        else:
            assert torch.equal(a[key].detach(), b[key].detach()), f"{what}/{key}"


def _assert_params(got, want, steps):
    """tests/test_torch_train_mesh.py's bound after `steps` steps of LR."""
    got, want = _flat(got), _flat(want)
    assert got.keys() == want.keys()
    d = PIPE.hidden_size
    for name, leaf in got.items():
        ref = want[name]
        delta = np.abs(leaf - ref)
        assert delta.max() <= steps * LR, (name, delta.max())
        if name == "layers/qkv/bias":
            leaf, ref = np.delete(leaf, np.s_[d: 2 * d], 1), np.delete(ref, np.s_[d: 2 * d], 1)
        beyond = np.abs(leaf - ref) > PARAM_ATOL + PARAM_RTOL * np.abs(ref)
        assert beyond.sum() <= 1e-4 * beyond.size, (name, int(beyond.sum()))


def _owners(case: str) -> list[int]:
    """The rank of each position."""
    stages, placement = CASES[case]
    return placement or [p * WORLD // stages for p in range(stages)]


def _owned(case: str, rank: int) -> list[int]:
    return [p for p, r in enumerate(_owners(case)) if r == rank]


@pytest.mark.parametrize("case", list(CASES))
def test_forward_is_the_one_process_pipeline(case, ranks, one_process):
    """pipeline_forward across the ranks: on both ranks every output bit for
    bit the one-process pipeline's on the same axes."""
    want = one_process(CASES[case][0])["forward"]
    for rank, found in enumerate(ranks.get()):
        got = found[case]["forward"]
        assert got.keys() == want.keys()
        for key in want:
            assert torch.equal(got[key], want[key]), (rank, key)


@pytest.mark.parametrize("case", list(CASES))
def test_forward_matches_jax(case, ranks, jax_ref):
    """pipeline_forward across the ranks against the JAX package's on the
    same stage count, within tests/test_torch_parallel.py's bounds."""
    want = jax_ref(CASES[case][0])["forward"]
    for found in ranks.get():
        got = found[case]["forward"]
        for key in ("cls_token", "patch_tokens", "probs"):
            tol = ({"rtol": SHARD_RTOL, "atol": SHARD_ATOL} if key == "probs"
                   else {"rtol": 0, "atol": TOKEN_ATOL})
            np.testing.assert_allclose(got[key].numpy(), want[key], err_msg=key, **tol)


@pytest.mark.parametrize("case", list(CASES))
def test_train_steps_are_the_one_process_steps(case, ranks, one_process):
    """Two AdamW steps of make_pipeline_train_step across the ranks: the
    same loss and accuracy on both ranks, bit for bit the one-process
    pipeline's, and after each step every position a rank owns bit for bit
    the one-process pipeline's at that position; the others are None."""
    want = one_process(CASES[case][0])["steps"]
    for rank, found in enumerate(ranks.get()):
        assert f"ranks={_owners(case)}" in found[case]["mesh"]
        for i, (got, ref) in enumerate(zip(found[case]["steps"], want)):
            assert (got["loss"], got["accuracy"]) == (ref["loss"], ref["accuracy"]), (rank, i)
            owned = _owned(case, rank)
            assert [p for p, tree in enumerate(got["placed"]) if tree is not None] == owned
            for position in owned:
                _equal_trees(got["placed"][position], ref["placed"][position],
                             f"rank {rank} step {i + 1} position {position}")


@pytest.mark.parametrize("case", list(CASES))
def test_train_steps_match_jax(case, ranks, jax_ref):
    """Both ranks' losses and the parameters of both ranks' positions put
    together (unplaced in this process) after one and two AdamW steps,
    against the JAX package's make_pipeline_train_step on the same stage
    count."""
    stages = CASES[case][0]
    want = jax_ref(stages)["steps"]
    found = ranks.get()
    m = mesh.make_mesh({"stage": stages}, [CPU] * stages)
    for i, (want_loss, want_params) in enumerate(want):
        for f in found:
            np.testing.assert_allclose(f[case]["steps"][i]["loss"], want_loss, rtol=LOSS_RTOL)
        placed = [found[_owners(case)[p]][case]["steps"][i]["placed"][p] for p in range(stages)]
        _assert_params(mesh.unplace(placed, m, pipeline.layer_pspecs(placed[0])), want_params,
                       i + 1)


@pytest.mark.parametrize("case", list(CASES))
def test_raw_gradient_matches_jax(case, ranks, jax_ref):
    """The raw gradient of the step across the ranks (SGD(1.0): p0 - p1, the
    tree unplaced collectively in each rank, bit for bit the same on both)
    against jax.grad of the sequential loss: a replicated leaf's gradient
    counted once for every rank, or a microbatch's gradient sent to another
    microbatch, shows here."""
    first, second = (f[case]["sgd"] for f in ranks.get())
    _equal_trees(first, second, "the ranks' unplaced trees")
    source = _flat(params_from_numpy(_source()))
    got = {k: source[k] - v for k, v in _flat(first).items()}
    want = _flat(jax_ref("grad"))
    assert got.keys() == want.keys()
    for key, g in got.items():
        np.testing.assert_allclose(g, want[key], rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=key)


@pytest.mark.parametrize("what, message", [
    ("forward microbatches", "^batch 8 % microbatches 3 != 0$"),
    ("forward layers", "^6 layers do not split over 4 stages$"),
    ("train microbatches", "^batch 8 % microbatches 3 != 0$"),
])
def test_refusals_are_raised_on_every_rank(what, message, ranks):
    """A call the pipeline refuses raises the same message on both ranks
    before any hand-off, so neither rank is left waiting: both go on to run
    every case after it (the other tests read those)."""
    import re

    for found in ranks.get():
        assert found["refusals"][what] is not None, what
        assert re.match(message, found["refusals"][what]), found["refusals"][what]


def test_hand_off_within_a_rank_is_the_tensor_on_its_device():
    """In one process a hand-off is `Tensor.to` the destination's device:
    the tensor itself where both stages share a device, and no process
    group is asked for."""
    m = mesh.make_mesh({"stage": 2}, [CPU] * 2)
    t = torch.arange(6.0).reshape(1, 2, 3)
    got = mesh.hand_off(m, [("k", 0, 1, t, (1, 2, 3), torch.float32, 0)])
    assert got.keys() == {"k"} and got["k"] is t
