"""Training checkpoint and resume (port of dinov2_tpu/parallel/checkpoint.py).

Inference-side interop stays GGUF (io/gguf.py, io/export.py). This module
keeps what training needs, full train-state snapshots (parameters, optimizer
state and step), with the JAX package's signatures. The JAX package writes
Orbax directories; the port writes its own format, one file per step,
`<directory>/step_<step, 8 digits>.pt`: `torch.save` of {"step", "params",
"opt_state"} with every tensor on the CPU, read back with
`torch.load(weights_only=True)` (tensors, dicts and numbers only; no code
runs at load). The two formats do not read each other; a model moves
between the packages as GGUF.

A state placed on a mesh is written as its logical tree (`trainer=`: the
Trainer that placed it; Trainer.unplace concatenates the shards and undoes
the tensor-parallel permutation) and placed again at restore
(Trainer.place), so one file serves every layout: a file written under a
mesh restores on one device, and the reverse.

On a mesh across ranks (parallel/mesh.py::init_distributed) both are
called by every rank: saving unplaces collectively, the mesh's lowest rank
writes the file, and every rank waits for it; restoring, every rank reads
the file and places its own positions. A file saved by several ranks
restores in one process, and the reverse.
"""

from __future__ import annotations

import os
import re
from pathlib import Path
from typing import Any

import torch

from dinov2_tpu_torch.models.params import tree_map

_STEP_FILE = re.compile(r"step_(\d{8,})\.pt")


def _to_cpu(tree: Any) -> Any:
    return tree_map(lambda leaf: leaf.detach().cpu() if torch.is_tensor(leaf) else leaf, tree)


def _like(value: Any, like: Any) -> Any:
    """A restored leaf with the device, dtype and requires_grad of `like`."""
    if not torch.is_tensor(like):
        return type(like)(value)
    if tuple(value.shape) != tuple(like.shape):
        raise ValueError(f"checkpoint leaf {tuple(value.shape)} does not fit {tuple(like.shape)}")
    return value.to(device=like.device, dtype=like.dtype).requires_grad_(like.requires_grad)


def save_train_state(directory: str | Path, step: int, params: Any, opt_state: Any,
                     trainer: Any = None) -> None:
    """Write `<directory>/step_<step>.pt`; a mesh-placed state is written as
    `trainer.unplace` gives it (by the lowest rank of a mesh across ranks,
    after which every rank returns)."""
    mesh = getattr(trainer, "mesh", None)
    if trainer is not None:
        params, opt_state = trainer.unplace(params, opt_state)
    if mesh is not None and mesh.rank != mesh.all_ranks[0]:
        mesh.barrier()  # the lowest rank writes
        return
    directory = Path(directory).resolve()
    directory.mkdir(parents=True, exist_ok=True)
    path = directory / f"step_{step:08d}.pt"
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    torch.save(
        {"step": int(step), "params": _to_cpu(params), "opt_state": _to_cpu(opt_state)}, tmp
    )
    os.replace(tmp, path)  # a reader never sees a partial file
    if mesh is not None:
        mesh.barrier()


def latest_step(directory: str | Path) -> int | None:
    """The largest step saved under `directory`, or None."""
    steps = [
        int(m.group(1))
        for p in Path(directory).glob("step_*.pt")
        if (m := _STEP_FILE.fullmatch(p.name))
    ]
    return max(steps, default=None)


def restore_train_state(
    directory: str | Path,
    params_like: Any,
    opt_state_like: Any,
    step: int | None = None,
    trainer: Any = None,
) -> tuple[int, Any, Any]:
    """Restore (step, params, opt_state). `*_like` give the structure and,
    leaf by leaf, the device, dtype and requires_grad to restore to (e.g.
    what `Trainer.place` returned for freshly initialized parameters). With
    `trainer`, `*_like` are a state that trainer placed, and the file's
    logical state is placed as it places one (Trainer.place)."""
    if trainer is not None:
        params_like, opt_state_like = trainer.unplace(params_like, opt_state_like)
    directory = Path(directory).resolve()
    step = latest_step(directory) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {directory}")
    path = directory / f"step_{step:08d}.pt"
    if not path.exists():
        raise FileNotFoundError(f"no checkpoint for step {step} under {directory}")
    state = torch.load(path, map_location="cpu", weights_only=True)
    params = tree_map(_like, state["params"], params_like)
    opt_state = tree_map(_like, state["opt_state"], opt_state_like)
    if trainer is not None:
        params, opt_state = trainer.place(params, opt_state)
    return int(state["step"]), params, opt_state
