"""One rank of tests/test_torch_distributed.py's two-process run (not a test
module: the test starts it twice). Imports torch and the port, never jax.

    python tests/torch_rank_worker.py RANK WORLD PORT DIR THREADS

DIR holds `inputs.pt` (written by the test: the batch, each config's
fields and parameters, the cases, a GGUF path) and `one/`, a checkpoint
saved by one process; the rank writes `rank<RANK>.pt` there: for every
case the loss, accuracy and this rank's positions' parameters and first
moments after one AdamW step, and the unplaced tree after one SGD(1.0)
step; `one/` restored onto the ranks; the engine's outputs. The ranks also
save one case's state to `ck/`. Every rank runs the same program, as a user's would.
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

    def __init__(self, learning_rate=1.0):
        self.learning_rate = learning_rate

    def init(self, params):
        return {}

    @torch.no_grad()
    def update_(self, params, grads, state):
        from dinov2_tpu_torch.models.params import tree_leaves

        torch._foreach_add_(tree_leaves(params), grads, alpha=-self.learning_rate)


def _cpu(tree):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    return tree.detach().clone() if torch.is_tensor(tree) else tree


def trainer_for(config, axes, sp, optimizer):
    from dinov2_tpu_torch.models.vit import ModelOptions
    from dinov2_tpu_torch.parallel.mesh import make_mesh
    from dinov2_tpu_torch.parallel.train import Trainer

    n = int(np.prod(list(axes.values())))
    opts = ModelOptions(parity="hf", compute_dtype=torch.float32, remat=True,
                        sequence_parallel=sp)
    return Trainer(config, opts, optimizer, mesh=make_mesh(axes, [torch.device("cpu")] * n),
                   preprocess_in_step=False, device="cpu")


def run(rank: int, world: int, port: int, out: Path) -> dict:
    from dinov2_tpu_torch.models.config import DinoConfig
    from dinov2_tpu_torch.models.params import params_from_numpy
    from dinov2_tpu_torch.parallel import mesh
    from dinov2_tpu_torch.parallel.checkpoint import restore_train_state, save_train_state
    from dinov2_tpu_torch.parallel.train import AdamW
    from dinov2_tpu_torch.runtime.engine import DinoEngine

    inputs = torch.load(out / "inputs.pt", weights_only=False)
    mesh.init_distributed(f"127.0.0.1:{port}", num_processes=world, process_id=rank)
    found: dict = {"rank": mesh.process_index(), "count": mesh.process_count(),
                   "backend": torch.distributed.get_backend()}

    # the JAX package's two-process smoke: 1 + 2 on both ranks
    m = mesh.make_mesh()
    found["default_mesh"] = (m.shape, [str(d) for d in m.devices.flat], m.ranks.tolist())
    part = torch.full((1,), float(rank + 1))
    found["psum"] = mesh.psum(_place_one(m, part), m.group(range(m.size)))[rank].item()

    images, labels = inputs["images"], inputs["labels"]
    for name, (config_name, axes, sp) in inputs["cases"].items():
        config = DinoConfig(**inputs["configs"][config_name])
        source = inputs["sources"][config_name]
        trainer = trainer_for(config, axes, sp, AdamW(LR, 0.05))
        params, state = trainer.place(params_from_numpy(source))
        params, state, metrics = trainer.step(params, state, images, labels)
        found[name] = {
            "loss": float(metrics["loss"]), "accuracy": float(metrics["accuracy"]),
            "placed": [_cpu(tree) for tree in params],
            "mu": _cpu(state["mu"]),
        }
        if name == inputs["checkpoint_case"]:
            save_train_state(out / "ck", 1, params, state, trainer=trainer)
            # and the reverse: a file saved by one process, placed on both ranks
            _, back, back_state = restore_train_state(
                out / "one", *trainer.place(params_from_numpy(source)), trainer=trainer)
            found["restored"] = _cpu(trainer.unplace(back, back_state))
        sgd = trainer_for(config, axes, sp, SGD(1.0))
        params, state = sgd.place(params_from_numpy(source))
        params, state, _ = sgd.step(params, state, images, labels)
        found[name]["sgd"] = _cpu(sgd.unplace(params)[0])

    engine = DinoEngine(inputs["gguf"], dtype=torch.float32, device="cpu",
                        mesh_axes={"model": world})
    found["engine_mesh"] = repr(engine.mesh)
    found["engine_probs"] = engine.classify_probs(inputs["engine_images"])
    found["engine_features"] = engine.extract_features(inputs["engine_images"])
    try:
        DinoEngine(inputs["gguf"], dtype=torch.float32, device="cpu", mesh_axes={"data": world})
        found["data_axis_error"] = None
    except ValueError as e:
        found["data_axis_error"] = str(e)
    return found


def _place_one(m, value):
    from dinov2_tpu_torch.parallel.mesh import place

    return place(value, m)


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
