"""Device meshes, placement and collectives for multi-device inference and
training (port of dinov2_tpu/parallel/mesh.py).

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
    `psum` over an axis and `gather` over 'data', and for sequence
    parallelism `all_gather_tokens` and `reduce_scatter_tokens` over
    'model' (each the other's transpose). All are differentiable. The
    pipeline's stage hand-off is a copy to the next stage's device
    (parallel/pipeline.py);
  - `unplace` is `np.asarray` of a sharded array: the logical tree back
    from its shards;
  - `reduce_replica_grads` is what GSPMD does for a replicated input's
    gradient: the sum over every position that holds the same shard.
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


def mesh_devices(device, count: int) -> list | None:
    """The devices of a `count`-position mesh for a `device` flag: None (every
    visible card, `make_mesh`'s default) for "cuda" without an index; the
    one device at every position for the CPU or a card named by its index
    ("cuda:0": several shards on that card)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return None
    return [device] * count


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
        for dim, axis in enumerate(spec):
            if axis is not None and t.shape[dim] % mesh.shape[axis]:
                raise ValueError(
                    f"dimension {dim} of a {tuple(t.shape)} tensor does not split over "
                    f"{axis}={mesh.shape[axis]}"
                )
        cut = _shard_cut(t.shape, spec, mesh, coords)
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


def _shard_cut(shape, spec: tuple, mesh: Mesh, coords: dict) -> list[tuple[int, int, int]]:
    """(dim, start, length) of the position at `coords` in each split
    dimension of a leaf of `shape`."""
    cut = []
    for dim, axis in enumerate(spec):
        if axis is not None:
            step = shape[dim] // mesh.shape[axis]
            cut.append((dim, coords[axis] * step, step))
    return cut


def unplace(placed: list, mesh: Mesh, specs: Any = None) -> Any:
    """The inverse of `place`: the logical tree, each split dimension
    concatenated over its axis on position 0's device, each replicated leaf
    the one at position 0. Dense tensor leaves only; the result holds no
    autograd history."""

    def leaf(path: tuple, first: torch.Tensor) -> torch.Tensor:
        spec = (specs or ()) if torch.is_tensor(placed[0]) else (
            () if specs is None else _spec_of(specs, path))
        if not any(axis is not None for axis in spec):
            return first.detach()
        split = {axis for axis in spec if axis is not None}
        shape = list(first.shape)
        for dim, axis in enumerate(spec):
            if axis is not None:
                shape[dim] *= mesh.shape[axis]
        full = torch.empty(shape, dtype=first.dtype, device=first.device)
        for position in range(mesh.size):
            coords = mesh.coords(position)
            if any(coords[a] for a in mesh.axis_names if a not in split):
                continue  # a replica of a shard already taken
            part = placed[position]
            for key in path:
                part = part[key]
            target = full
            for dim, start, length in _shard_cut(shape, spec, mesh, coords):
                target = target.narrow(dim, start, length)
            target.copy_(part.detach())
        return full

    if torch.is_tensor(placed[0]):
        return leaf((), placed[0])
    return _walk(leaf, placed[0])


def reduce_replica_grads(placed: list, grads: dict, mesh: Mesh, specs: Any = None) -> dict:
    """The replica reduction of a placed tree's gradients. `grads` maps
    id(tensor) -> the gradient of that tensor of `placed`. For every logical
    (leaf, shard), the gradients of the distinct tensors that hold it (a
    tensor at several positions counts once) are summed in position order
    on the first one's device, and each of those tensors gets the sum on its
    own device. A shard held by one tensor keeps its gradient as it is.
    Returns id -> reduced gradient."""
    groups: dict = {}
    for position in range(mesh.size):
        coords = mesh.coords(position)

        def visit(path: tuple, t: torch.Tensor) -> None:
            spec = () if specs is None else _spec_of(specs, path)
            key = (path, tuple((axis, coords[axis]) for axis in spec if axis is not None))
            members = groups.setdefault(key, [])
            if all(m is not t for m in members):
                members.append(t)

        _walk(visit, placed[position])
    reduced = {}
    for members in groups.values():
        if len(members) == 1:
            reduced[id(members[0])] = grads[id(members[0])]
            continue
        total = grads[id(members[0])]
        for m in members[1:]:
            total = total + grads[id(m)].to(total.device)
        for m in members:
            reduced[id(m)] = total.to(m.device)
    return reduced


def replicate(tree: Any, mesh: Mesh) -> list:
    """The whole tree on every position of the mesh."""
    return place(tree, mesh)


def shard_batch(x: torch.Tensor, mesh: Mesh, axis: str = "data") -> list:
    """The leading (batch) axis split over `axis`; on a mesh without it (a
    pure 'model' mesh) every position holds the whole batch."""
    return place(x, mesh, (axis,) if axis in mesh.axis_names else ())


def gather(parts: list, device: torch.device, dim: int = 0) -> torch.Tensor:
    """The 'data' gather: per-slice tensors concatenated in order (on
    dimension `dim`) on `device`."""
    return torch.cat([p.to(device) for p in parts], dim=dim)


def token_slices(t: int, n: int) -> list[tuple[int, int]]:
    """(start, length) of each of n shards' token slices of T tokens, as
    GSPMD pads a split: ceil(T/n) tokens a slice, the last ones shorter
    (possibly empty)."""
    step = -(-t // n)
    return [(min(j * step, t), max(0, min(step, t - j * step))) for j in range(n)]


class _AllGatherTokens(torch.autograd.Function):
    """Forward: the token slices concatenated on every shard's device.
    Backward: the reduce-scatter of the full-length gradients."""

    @staticmethod
    def forward(ctx, dim: int, *slices):
        ctx.dim = dim
        ctx.lengths = [s.shape[dim] for s in slices]
        return tuple(gather(slices, s.device, dim) for s in slices)

    @staticmethod
    def backward(ctx, *grads):
        total = _sum_in_order(grads)
        starts = np.cumsum([0, *ctx.lengths[:-1]])
        return (None, *(total.narrow(ctx.dim, int(start), length).to(g.device)
                        for g, start, length in zip(grads, starts, ctx.lengths)))


class _ReduceScatterTokens(torch.autograd.Function):
    """Forward: the partials summed in shard order, each shard keeping its
    token slice. Backward: the all-gather of the slices' gradients."""

    @staticmethod
    def forward(ctx, dim: int, *parts):
        ctx.dim = dim
        total = _sum_in_order(parts)
        bounds = token_slices(total.shape[dim], len(parts))
        return tuple(total.narrow(dim, start, length).to(p.device).contiguous()
                     for p, (start, length) in zip(parts, bounds))

    @staticmethod
    def backward(ctx, *grads):
        return (None, *(gather(grads, g.device, ctx.dim) for g in grads))


def all_gather_tokens(slices: list, dim: int = 1) -> list:
    """The sequence-parallel all-gather over 'model': shard j's token slice
    (dimension `dim`) concatenated in shard order, on every shard's device.
    Differentiable; its transpose is `reduce_scatter_tokens`."""
    if len(slices) == 1:
        return list(slices)
    return list(_AllGatherTokens.apply(dim, *slices))


def reduce_scatter_tokens(parts: list, dim: int = 1) -> list:
    """The sequence-parallel reduce-scatter over 'model': the full-length
    partials summed in shard order (as `psum`), then shard j keeps its slice
    `token_slices(T, n)[j]` on its device (the last slices may be shorter).
    Differentiable; its transpose is `all_gather_tokens`."""
    if len(parts) == 1:
        return list(parts)
    return list(_ReduceScatterTokens.apply(dim, *parts))


def _sum_in_order(parts) -> torch.Tensor:
    total = parts[0]
    for part in parts[1:]:
        total = total + part.to(total.device)
    return total


def psum(parts: list) -> list:
    """All-reduce over an axis: the partials summed in shard order on the
    first shard's device, in their (compute) dtype, then the sum copied to
    each shard's device."""
    total = _sum_in_order(parts)
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
