"""One rank of tests/test_torch_pipeline_ranks.py's two-process run (not a
test module: the test starts it twice). Imports torch and the port, never
jax.

    python tests/torch_pipeline_rank_worker.py RANK WORLD PORT DIR THREADS

DIR holds `inputs.pt` (written by the test: the preprocessed batch, the
labels, the config's fields, its parameters and the cases); the rank writes
`rank<RANK>.pt` there: the refusals it raised, and for every case the
outputs of `pipeline_forward`, the losses and accuracies of two AdamW steps
of `make_pipeline_train_step` with this rank's positions after each, and the
unplaced tree after one SGD(1.0) step. Every rank runs the same program, as
a user's would.
"""

import sys
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

LR = 1e-4


class SGD:
    """p -= lr * g."""

    def init(self, params):
        return {}

    @torch.no_grad()
    def update_(self, params, grads, state):
        from dinov2_tpu_torch.models.params import tree_leaves

        torch._foreach_add_(tree_leaves(params), grads, alpha=-1.0)


def _cpu(tree):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    return tree.detach().clone()


def stage_mesh(stages: int, ranks):
    """{"stage": stages} on the CPU: in equal rank blocks (make_mesh) where
    `ranks` is None, else with position k on rank ranks[k]."""
    from dinov2_tpu_torch.parallel.mesh import Mesh, make_mesh

    devices = [torch.device("cpu")] * stages
    if ranks is None:
        return make_mesh({"stage": stages}, devices)
    grid = np.empty(stages, dtype=object)
    grid[:] = devices
    return Mesh(grid, ("stage",), ranks=ranks)


def refusals(config, images, labels, opts) -> dict:
    """The messages each refusal raises, before any hand-off."""
    import dataclasses

    from dinov2_tpu_torch.models.params import init_params
    from dinov2_tpu_torch.parallel.mesh import replicate
    from dinov2_tpu_torch.parallel.pipeline import (
        make_pipeline_train_step,
        pipeline_forward,
        place_pipeline_params,
    )
    from dinov2_tpu_torch.parallel.train import AdamW

    mesh = stage_mesh(4, [0, 1, 0, 1])
    params = init_params(config, seed=0, dtype=torch.float32)
    found = {}

    def refused(what, fn):
        try:
            fn()
            found[what] = None
        except ValueError as e:
            found[what] = str(e)

    placed = place_pipeline_params(params, mesh)
    refused("forward microbatches",
            lambda: pipeline_forward(placed, images, config, opts, mesh, num_microbatches=3))
    six = dataclasses.replace(config, num_hidden_layers=6)
    refused("forward layers", lambda: pipeline_forward(
        replicate(init_params(six, seed=0, dtype=torch.float32), mesh), images, six, opts, mesh))
    step, place = make_pipeline_train_step(config, opts, mesh, AdamW(LR, 0.05), 3)
    refused("train microbatches", lambda: step(*place(params), images, labels))
    return found


def run(rank: int, world: int, port: int, out: Path) -> dict:
    from dinov2_tpu_torch.models.config import DinoConfig
    from dinov2_tpu_torch.models.params import params_from_numpy
    from dinov2_tpu_torch.models.vit import ModelOptions
    from dinov2_tpu_torch.parallel import mesh as pmesh
    from dinov2_tpu_torch.parallel.pipeline import (
        layer_pspecs,
        make_pipeline_train_step,
        pipeline_forward,
        place_pipeline_params,
    )
    from dinov2_tpu_torch.parallel.train import AdamW

    inputs = torch.load(out / "inputs.pt", weights_only=False)
    pmesh.init_distributed(f"127.0.0.1:{port}", num_processes=world, process_id=rank)
    config = DinoConfig(**inputs["config"])
    opts = ModelOptions(parity="hf", compute_dtype=torch.float32, remat=True)
    images, labels = torch.from_numpy(inputs["images"]), torch.from_numpy(inputs["labels"])
    source, m = inputs["source"], inputs["microbatches"]
    found: dict = {"rank": pmesh.process_index(),
                   "refusals": refusals(config, images, labels, opts)}
    for name, (stages, ranks) in inputs["cases"].items():
        mesh = stage_mesh(stages, ranks)
        placed = place_pipeline_params(params_from_numpy(source), mesh)
        got = {"mesh": repr(mesh),
               "forward": _cpu(pipeline_forward(placed, images, config, opts, mesh,
                                                num_microbatches=m, classify=True))}
        step, place = make_pipeline_train_step(config, opts, mesh, AdamW(LR, 0.05), m)
        params, state = place(params_from_numpy(source))
        got["steps"] = []
        for _ in range(2):
            params, state, metrics = step(params, state, images, labels)
            got["steps"].append({"loss": float(metrics["loss"]),
                                 "accuracy": float(metrics["accuracy"]),
                                 "placed": [_cpu(tree) for tree in params]})
        step, place = make_pipeline_train_step(config, opts, mesh, SGD(), m)
        params, state = place(params_from_numpy(source))
        params, state, _ = step(params, state, images, labels)
        got["sgd"] = _cpu(pmesh.unplace(params, mesh, layer_pspecs(pmesh.first_local(params))))
        found[name] = got
    return found


def main() -> int:
    rank, world, port = (int(a) for a in sys.argv[1:4])
    out = Path(sys.argv[4])
    torch.set_num_threads(int(sys.argv[5]))
    try:
        found = run(rank, world, port, out)
    except BaseException:
        traceback.print_exc()
        return 1
    torch.save(found, out / f"rank{rank}.pt")
    return 0


if __name__ == "__main__":
    sys.exit(main())
