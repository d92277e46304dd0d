"""Device meshes, placement and collectives for multi-device inference
(port of dinov2_tpu/parallel/mesh.py).

Single-controller, as in the JAX package: one process drives every device
of a `Mesh`, places each shard of a tree on its device and issues that
shard's launches there. What XLA does from sharding annotations is explicit
here:
  - `place(tree, mesh, specs)` is `jax.device_put(tree, NamedSharding(mesh,
    spec))`: a spec is JAX's PartitionSpec as a tuple, an axis name or None
    for each leading dimension, `()` for a replicated leaf. A placed tree is
    a list with one tree per mesh position, in the mesh's row-major order;
  - `shard_map_data_parallel` runs an unchanged forward on each 'data'
    slice of the batch on its device's replica;
  - the collectives are plain functions on lists of per-shard tensors:
    `psum` over an axis and `gather` over 'data'. The pipeline's stage
    hand-off is a copy to the next stage's device (parallel/pipeline.py).
No torch.distributed: one process, no process group.

A mesh may name one device several times: several shards then live on that
device and run one after the other. `Tensor.to` a tensor's own device
returns the tensor itself, so replicas on one device share their weights,
and a split leaf is copied once per (slice, device). That is how the CPU
tests build the JAX tests' eight host devices (`[torch.device("cpu")] * 8`)
and how one card runs a 2- or 4-way tensor-parallel forward.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from dinov2_tpu_torch.models.params import PACKED_WEIGHTS
from dinov2_tpu_torch.utils.logging import get_logger


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Multi-host initialization: a no-op for one process (the single
    controller drives every device it sees). Several processes are not
    ported: they raise."""
    if num_processes is None or num_processes <= 1:
        return
    raise NotImplementedError(
        f"init_distributed({coordinator_address!r}, num_processes={num_processes}, "
        f"process_id={process_id}): multi-process runs are not ported to dinov2_tpu_torch "
        "(ROADMAP.md, 'Modules to port': multi-process init_distributed on torch.distributed)"
    )


class Mesh:
    """Named axes over an array of torch.device in their shape."""

    def __init__(self, devices: np.ndarray, axis_names: tuple[str, ...]):
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-D devices for axes {axis_names}")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    def position(self, coords: dict[str, int]) -> int:
        """The row-major index of the position at `coords`; an axis left out
        is at 0."""
        return int(np.ravel_multi_index(
            tuple(coords.get(a, 0) for a in self.axis_names), self.devices.shape))

    def device(self, position: int) -> torch.device:
        return self.devices.flat[position]

    def coords(self, position: int) -> dict[str, int]:
        return dict(zip(self.axis_names, np.unravel_index(position, self.devices.shape)))

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={list(self.devices.flat)})"


def make_mesh(axes: dict[str, int] | None = None, devices=None) -> Mesh:
    """Build a mesh. Default: one 'data' axis over every visible CUDA device.
    `devices` is taken as given, repeats included (several shards on one
    device); a mesh that needs more devices than there are raises, one that
    uses fewer warns."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if axes is None:
        if not devices:
            raise ValueError("make_mesh: no CUDA device is visible; pass devices=")
        axes = {"data": len(devices)}
    shape = tuple(axes.values())
    need = int(np.prod(shape))
    if need > len(devices):
        raise ValueError(f"mesh {axes} needs {need} devices, have {len(devices)}")
    if need < len(devices):
        # a prefix subset is intentional for debug meshes, but a mistyped
        # --mesh would otherwise silently idle most of the hardware
        get_logger().warning(
            "mesh %s uses %d of %d available devices", axes, need, len(devices)
        )
    grid = np.empty(need, dtype=object)
    grid[:] = devices[:need]
    return Mesh(grid.reshape(shape), tuple(axes))


# ---------------------------------------------------------------------------
# Placement
# ---------------------------------------------------------------------------


def _walk(fn, tree: Any, path: tuple = ()) -> Any:
    """fn(path, leaf) over a parameter tree; a QuantLinear or an Int8Linear
    is one leaf."""
    if isinstance(tree, dict):
        return {k: _walk(fn, v, (*path, k)) for k, v in tree.items()}
    return fn(path, tree)


def _spec_of(specs: Any, path: tuple) -> tuple:
    node = specs
    for key in path:
        node = node[key]
    return node


def place(tree: Any, mesh: Mesh, specs: Any = None) -> list:
    """The tree's shards on the mesh: one tree per position (row-major), each
    leaf sliced by its spec at that position's coordinates and moved to its
    device. `specs` is a tree of specs like `tree`, or one spec for a single
    tensor; None replicates everything. Every field of a QuantLinear or an
    Int8Linear takes its leaf's spec. A split dimension must divide evenly.
    A replica on the leaf's own device is the leaf itself; a split leaf is a
    contiguous copy (the kernels take contiguous operands), made once for
    each slice and device."""
    made: dict = {}

    def shard(t: torch.Tensor, spec: tuple, coords: dict, device: torch.device) -> torch.Tensor:
        cut = []
        for dim, axis in enumerate(spec):
            if axis is None:
                continue
            n = mesh.shape[axis]
            if t.shape[dim] % n:
                raise ValueError(
                    f"dimension {dim} of a {tuple(t.shape)} tensor does not split over "
                    f"{axis}={n}"
                )
            step = t.shape[dim] // n
            cut.append((dim, coords[axis] * step, step))
        key = (id(t), tuple(cut), device)
        if key not in made:
            part = t
            for dim, start, length in cut:
                part = part.narrow(dim, start, length)
            part = part.to(device)
            made[key] = part.contiguous() if cut else part
        return made[key]

    def leaf(spec: tuple, value, coords: dict, device: torch.device):
        if isinstance(value, PACKED_WEIGHTS):
            return value.map(lambda t: shard(t, spec, coords, device))
        return shard(value, spec, coords, device)

    placed = []
    for position in range(mesh.size):
        coords, device = mesh.coords(position), mesh.device(position)
        if torch.is_tensor(tree):
            placed.append(leaf(specs or (), tree, coords, device))
        else:
            placed.append(_walk(
                lambda path, v: leaf(() if specs is None else _spec_of(specs, path), v, coords,
                                     device),
                tree,
            ))
    # the tensors are kept alive by `placed`, so no id in `made` was reused
    return placed


def replicate(tree: Any, mesh: Mesh) -> list:
    """The whole tree on every position of the mesh."""
    return place(tree, mesh)


def shard_batch(x: torch.Tensor, mesh: Mesh, axis: str = "data") -> list:
    """The leading (batch) axis split over `axis`; on a mesh without it (a
    pure 'model' mesh) every position holds the whole batch."""
    return place(x, mesh, (axis,) if axis in mesh.axis_names else ())


def gather(parts: list, device: torch.device) -> torch.Tensor:
    """The 'data' gather: per-slice tensors concatenated in order on
    `device`."""
    return torch.cat([p.to(device) for p in parts])


def psum(parts: list) -> list:
    """All-reduce over an axis: the partials summed in shard order on the
    first shard's device, in their (compute) dtype, then the sum copied to
    each shard's device."""
    total = parts[0]
    for part in parts[1:]:
        total = total + part.to(total.device)
    return [total.to(p.device) for p in parts]


def shard_map_data_parallel(fn, mesh: Mesh, axis: str = "data"):
    """Wrap `fn(params, x) -> dict of tensors` for data parallelism on
    `placed` params (a list from `place`/`replicate`): the batch is split
    over `axis`, slice i runs the unchanged fn on its device's replica (the
    first position of that 'data' index), and each output is concatenated in
    order on the mesh's first device. No collective inside the forward."""
    n = mesh.shape.get(axis, 1)
    first = mesh.device(0)

    def run(placed: list, x: torch.Tensor) -> dict:
        if x.shape[0] % n:
            raise ValueError(f"batch {x.shape[0]} does not split over {axis}={n}")
        rows = x.shape[0] // n
        outs = []
        for i in range(n):
            position = mesh.position({axis: i})
            part = x.narrow(0, i * rows, rows).to(mesh.device(position))
            outs.append(fn(placed[position], part))
        return {key: gather([o[key] for o in outs], first) for key in outs[0]}

    return run


# ---------------------------------------------------------------------------
# Tensor-parallel param specs (Megatron-style column/row split per block)
# ---------------------------------------------------------------------------


def param_pspecs(params: Any, model_axis: str = "model") -> Any:
    """Specs for the DINOv2 parameter tree: the dense qkv/fc1/win kernels
    are column-split (out features on `model_axis`), proj/fc2/wout row-split
    (in features), so each attention/MLP block needs exactly one psum on its
    output. Kernels are stored (in, out) and layer-stacked, hence the
    leading None. Row-split biases are replicated (added after the psum), as
    is everything else, QuantLinear and Int8Linear weights included."""
    col = (None, None, model_axis)  # (L, in, out): split out
    row = (None, model_axis, None)  # (L, in, out): split in
    col_bias = (None, model_axis)  # (L, out)

    def spec_for(path: tuple, leaf) -> tuple:
        if "layers" not in path or isinstance(leaf, PACKED_WEIGHTS):
            return ()
        if {"qkv", "fc1", "win"} & set(path):
            return {"kernel": col, "bias": col_bias}.get(path[-1], ())
        if {"proj", "fc2", "wout"} & set(path) and path[-1] == "kernel":
            return row
        return ()

    return _walk(spec_for, params)


def shard_params(params: Any, mesh: Mesh, tensor_parallel: bool = False) -> list:
    """Place params on the mesh: replicated, or split by `param_pspecs`
    when asked for on a mesh with a 'model' axis."""
    if not tensor_parallel or "model" not in mesh.axis_names:
        return replicate(params, mesh)
    return place(params, mesh, param_pspecs(params))
