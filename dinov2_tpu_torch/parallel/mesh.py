"""Device meshes, placement and collectives for multi-device inference and
training (port of dinov2_tpu/parallel/mesh.py).

SPMD, as in the JAX package: every process runs the same program, and one
process drives every position of a `Mesh` that it owns, places each shard
of a tree on its device and launches that shard's kernels there. Without
`init_distributed` there is one process and it owns every position (the
JAX package's single controller). What XLA does from sharding annotations
is explicit here:
  - `place(tree, mesh, specs)` is `jax.device_put(tree, NamedSharding(mesh,
    spec))`: a spec is JAX's PartitionSpec as a tuple, an axis name or None
    for each leading dimension, `()` for a replicated leaf. A placed tree is
    a list with one tree per mesh position, in the mesh's row-major order,
    None at the positions another process owns;
  - `shard_map_data_parallel` runs an unchanged forward on each 'data'
    slice of the batch on its device's replica;
  - the collectives are plain functions on lists of per-shard tensors:
    `psum` over an axis and `gather` over 'data', and for sequence
    parallelism `all_gather_tokens` and `reduce_scatter_tokens` over
    'model' (each the other's transpose). All are differentiable. The
    pipeline's stage hand-off (`hand_off`) is a copy to the next stage's
    device, or a point-to-point message where that stage is another rank's
    (parallel/pipeline.py);
  - `unplace` is `np.asarray` of a sharded array: the logical tree back
    from its shards;
  - `reduce_replica_grads` is what GSPMD does for a replicated input's
    gradient: the sum over every position that holds the same shard.

A mesh may name one device several times: several shards then live on that
device and run one after the other. `Tensor.to` a tensor's own device
returns the tensor itself, so replicas on one device share their weights,
and a split leaf is copied once per (slice, device). That is how the CPU
tests build the JAX tests' eight host devices (`[torch.device("cpu")] * 8`)
and how one card runs a 2- or 4-way tensor-parallel forward.

Across processes (`init_distributed`, torch.distributed): `make_mesh`
records the rank that owns each position, and a collective whose members
sit on several ranks is a `Group` of positions over a process group made
once for each slice of the mesh. Such a collective all-gathers every
member's part over its process group (`_exchange`) and then computes what
the one-process version computes from the same parts in the same order,
so a run over ranks is bit for bit the one-process mesh of the same axes.
Every rank calls each collective of its members in the same order,
forward and backward, also where its share is zero.
"""

from __future__ import annotations

import atexit
import itertools
import os
from datetime import timedelta
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from dinov2_tpu_torch.models.params import PACKED_WEIGHTS
from dinov2_tpu_torch.utils.logging import get_logger

# a collective that waits longer than this fails its rank (gloo raises; NCCL
# aborts the communicator), so a rank that dies or diverges cannot hang a run
PROCESS_GROUP_TIMEOUT_S = 300.0
_RANK_DEVICES: list | None = None  # every rank's device, in rank order, from init
_PROCESS_GROUPS: dict = {}  # sorted ranks -> process group


def process_index() -> int:
    """This process's rank (jax.process_index); 0 without init_distributed."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def process_count() -> int:
    """The number of processes (jax.process_count); 1 without
    init_distributed."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def _rank_device(process_id: int, local_rank: int | None = None) -> torch.device:
    """The device a rank drives: cuda:LOCAL_RANK, else card process_id %
    device_count, where there is a card; the CPU otherwise."""
    if not torch.cuda.is_available():
        return torch.device("cpu")
    index = local_rank if local_rank is not None else process_id % torch.cuda.device_count()
    return torch.device("cuda", index)


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    backend: str | None = None,
) -> None:
    """Multi-process initialization (jax.distributed.initialize): call it in
    every process, with the same program after it. A no-op for one process,
    and where the arguments are None and torchrun's WORLD_SIZE is not set.
    Arguments left None are read from torchrun's environment (MASTER_ADDR,
    MASTER_PORT, WORLD_SIZE, RANK; LOCAL_RANK picks the card).

    The process's device (`_rank_device`) is made current before any
    collective. `backend` defaults to "nccl" on a card and "gloo" on the
    CPU; several ranks on one card need backend="gloo" (NCCL refuses a card
    shared by two ranks, and that error is raised as it is). The group has
    a finite timeout (PROCESS_GROUP_TIMEOUT_S) and is destroyed at exit.
    Every rank's device is gathered once here: `make_mesh()`'s default
    device list is then every rank's device in rank order, as
    `jax.devices()` spans every process after initialize."""
    global _RANK_DEVICES
    env = os.environ
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if num_processes is None or num_processes <= 1:
        return
    if process_id is None:
        process_id = int(env["RANK"])
    if coordinator_address is None:
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    local_rank = int(env["LOCAL_RANK"]) if "LOCAL_RANK" in env else None
    device = _rank_device(process_id, local_rank)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}", world_size=num_processes,
        rank=process_id, timeout=timedelta(seconds=PROCESS_GROUP_TIMEOUT_S),
    )
    atexit.register(_shutdown)
    _RANK_DEVICES = _gather_devices(device)


def _gather_devices(device: torch.device) -> list:
    """[(rank, its device)] of every rank, in rank order."""
    names: list = [None] * dist.get_world_size()
    dist.all_gather_object(names, str(device))
    return [(rank, torch.device(name)) for rank, name in enumerate(names)]


def _shutdown() -> None:
    """Destroy the process group (and the mesh groups) if there is one."""
    global _RANK_DEVICES
    _PROCESS_GROUPS.clear()
    _RANK_DEVICES = None
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def _process_group(ranks: tuple):
    """The process group over `ranks` (sorted): the default group for every
    rank, else one made by dist.new_group, once. Every rank must ask for
    the same groups in the same order (new_group is a collective)."""
    if ranks == tuple(range(process_count())):
        return dist.group.WORLD
    if ranks not in _PROCESS_GROUPS:
        _PROCESS_GROUPS[ranks] = dist.new_group(
            list(ranks), timeout=timedelta(seconds=PROCESS_GROUP_TIMEOUT_S))
    return _PROCESS_GROUPS[ranks]


class Mesh:
    """Named axes over an array of torch.device in their shape, and the rank
    that owns each position (all this process's without `ranks`)."""

    def __init__(self, devices: np.ndarray, axis_names: tuple[str, ...], ranks=None):
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-D devices for axes {axis_names}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.rank = process_index()
        self.ranks = (np.full(devices.shape, self.rank) if ranks is None
                      else np.asarray(ranks, dtype=int).reshape(devices.shape))
        self.all_ranks = tuple(sorted({int(r) for r in self.ranks.flat}))
        self.spans_ranks = len(self.all_ranks) > 1
        if self.spans_ranks:
            self._make_process_groups()

    def _make_process_groups(self) -> None:
        """The process group of every slice of the mesh over every set of
        its axes that spans more than one rank, made on every rank in the
        same order."""
        dims = range(self.devices.ndim)
        for count in range(1, self.devices.ndim + 1):
            for axes in itertools.combinations(dims, count):
                rest = [d for d in dims if d not in axes]
                slices = np.moveaxis(self.ranks, rest, list(range(len(rest))))
                for row in slices.reshape(-1, int(np.prod([self.ranks.shape[d] for d in axes]))):
                    span = tuple(sorted({int(r) for r in row}))
                    if len(span) > 1:
                        _process_group(span)

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

    def is_local(self, position: int) -> bool:
        """Whether this process owns the position."""
        return int(self.ranks.flat[position]) == self.rank

    @property
    def local_positions(self) -> list[int]:
        return [p for p in range(self.size) if self.is_local(p)]

    @property
    def local_device(self) -> torch.device:
        """The device of this process's first position."""
        return self.device(self.local_positions[0])

    def group(self, positions, everyone: bool = False) -> "Group":
        """The collective of these positions (in this order); `everyone`:
        every rank of the mesh takes part, members or not."""
        return Group(self, positions, everyone)

    def barrier(self) -> None:
        """Wait for every rank of the mesh (nothing without ranks)."""
        if self.spans_ranks:
            dist.barrier(group=_process_group(self.all_ranks))

    def require_local_slices(self, what: str, axis: str = "data") -> None:
        """Raise unless this process owns a position in every `axis` slice:
        otherwise an output split over `axis` lies on other ranks, and the
        JAX package cannot fetch such an array either (a jax.Array that
        spans non-addressable devices)."""
        n = self.shape.get(axis, 1)
        missing = [i for i in range(n) if not any(
            self.is_local(p) for p in range(self.size) if self.coords(p).get(axis, 0) == i)]
        if missing:
            raise ValueError(
                f"{what}: the {axis!r} axis ({n}) spans ranks; rank {self.rank} holds no "
                f"position of {axis} slices {missing}, so their outputs live on other "
                "processes, which the JAX package cannot fetch either (np.asarray of a "
                "jax.Array that spans non-addressable devices raises). Use a 'model' axis "
                "across ranks, or 'data' within each rank"
            )

    def __repr__(self) -> str:
        ranks = f", ranks={self.ranks.ravel().tolist()}" if self.spans_ranks else ""
        return f"Mesh({self.shape}, devices={list(self.devices.flat)}{ranks})"


class Group:
    """The members of one collective: positions of a mesh, in order, with
    the rank that owns each and the process group over their ranks (None
    where one rank owns them all: the collective is then this process's
    own copies and adds). With `everyone`, every rank of the mesh takes
    part, also one that owns no member (it receives)."""

    def __init__(self, mesh: Mesh, positions, everyone: bool = False):
        self.positions = tuple(positions)
        self.ranks = tuple(int(mesh.ranks.flat[p]) for p in self.positions)
        self.rank = mesh.rank
        self.span = mesh.all_ranks if everyone else tuple(sorted(set(self.ranks)))
        self.process_group = _process_group(self.span) if len(self.span) > 1 else None

    @property
    def local(self) -> tuple[bool, ...]:
        return tuple(r == self.rank for r in self.ranks)


def _global_devices() -> list:
    """[(rank, device)]: every rank's device after init_distributed, else
    this process's visible cards."""
    if _RANK_DEVICES is not None and process_count() > 1:
        return list(_RANK_DEVICES)
    return [(0, torch.device("cuda", i)) for i in range(torch.cuda.device_count())]


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
    """Build a mesh. Default: one 'data' axis over every visible CUDA device,
    or after init_distributed over every rank's device in rank order (each
    position then owned by its rank). `devices` is taken as given, repeats
    included (several shards on one device); a mesh that needs more devices
    than there are raises, one that uses fewer warns. Across processes the
    given `devices` are split over the ranks in equal contiguous blocks, in
    rank order, and each rank reads the entries of its own positions only
    (each rank may pass its own device for all of them)."""
    world = process_count()
    ranks = None
    if devices is None:
        pairs = _global_devices()
        devices = [d for _, d in pairs]
        if world > 1:
            ranks = [r for r, _ in pairs]
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
    if ranks is not None:
        ranks = ranks[:need]
    elif world > 1:
        if need % world:
            raise ValueError(f"mesh {axes}: {need} positions do not split over {world} "
                             "processes in equal blocks")
        ranks = [p * world // need for p in range(need)]
    grid = np.empty(need, dtype=object)
    grid[:] = devices[:need]
    return Mesh(grid.reshape(shape), tuple(axes), ranks)


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


def _at(tree: Any, path: tuple) -> Any:
    for key in path:
        tree = tree[key]
    return tree


def first_local(placed: list) -> Any:
    """The tree of this process's first position of a placed list."""
    return next(tree for tree in placed if tree is not None)


def place(tree: Any, mesh: Mesh, specs: Any = None) -> list:
    """The tree's shards on the mesh: one tree per position (row-major), each
    leaf sliced by its spec at that position's coordinates and moved to its
    device; None at the positions another process owns (no process builds
    another's shard). `specs` is a tree of specs like `tree`, or one spec
    for a single tensor; None replicates everything. Every field of a
    QuantLinear or an Int8Linear takes its leaf's spec. A split dimension
    must divide evenly. A replica on the leaf's own device is the leaf
    itself; a split leaf is a contiguous copy (the kernels take contiguous
    operands), made once for each slice and device."""
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
        if not mesh.is_local(position):
            placed.append(None)
            continue
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
    concatenated over its axis on this process's first device, each
    replicated leaf the one at this process's first position. Dense tensor
    leaves only; the result holds no autograd history. On a mesh across
    ranks it is a collective: every rank gets the whole tree."""
    single = torch.is_tensor(first_local(placed))

    def leaf(path: tuple, first: torch.Tensor) -> torch.Tensor:
        spec = (specs or ()) if single else (() if specs is None else _spec_of(specs, path))
        if not any(axis is not None for axis in spec):
            return first.detach()
        split = {axis for axis in spec if axis is not None}
        shape = list(first.shape)
        for dim, axis in enumerate(spec):
            if axis is not None:
                shape[dim] *= mesh.shape[axis]
        # one position of each shard: the one at 0 on every other axis
        needed = [p for p in range(mesh.size)
                  if not any(c for a, c in mesh.coords(p).items() if a not in split)]
        parts = {p: _at(placed[p], path).detach() for p in needed if mesh.is_local(p)}
        if mesh.spans_ranks:
            parts = dict(zip(needed, _exchange(
                mesh.group(needed, everyone=True), list(parts.values()), first.device,
                [tuple(first.shape)] * len(needed), first.dtype)))
        full = torch.empty(shape, dtype=first.dtype, device=first.device)
        for position in needed:
            target = full
            for dim, start, length in _shard_cut(shape, spec, mesh, mesh.coords(position)):
                target = target.narrow(dim, start, length)
            target.copy_(parts[position])
        return full

    if single:
        return leaf((), first_local(placed))
    return _walk(leaf, first_local(placed))


def reduce_replica_grads(grads: list, mesh: Mesh, specs: Any = None) -> list:
    """The replica reduction of a placed tree's gradients. grads[k] is the
    gradient tree of position k (None where another process owns it). For
    every logical (leaf, shard), the gradients of every position that holds
    it are summed in position order (on the first one's device; across
    ranks after an all-gather of the parts, the same sum) and each local
    position gets the sum on its own device. Returns the list of reduced
    trees, None where grads has None."""
    groups: dict = {}
    for position in range(mesh.size):
        coords = mesh.coords(position)

        def visit(path: tuple, _) -> None:
            spec = () if specs is None else _spec_of(specs, path)
            key = (path, tuple((axis, coords[axis]) for axis in spec if axis is not None))
            groups.setdefault(key, []).append(position)

        _walk(visit, first_local(grads))
    sums: dict = {}  # (position, path) -> the reduced gradient
    across: dict = {}  # member positions -> the paths they hold, summed in one exchange
    for (path, _), positions in groups.items():
        mine = [p for p in positions if grads[p] is not None]
        if not mine:
            continue
        if len(mine) < len(positions):
            across.setdefault(tuple(positions), []).append(path)
            continue
        total = _sum_in_order([_at(grads[p], path) for p in positions])
        for p in positions:
            sums[p, path] = total.to(mesh.device(p))
    for positions, paths in across.items():
        mine = [p for p in positions if grads[p] is not None]
        flat = [torch.cat([_at(grads[p], path).reshape(-1) for path in paths]) for p in mine]
        parts = _exchange(mesh.group(positions), flat, flat[0].device,
                          [tuple(flat[0].shape)] * len(positions), flat[0].dtype)
        total = _sum_in_order(parts)
        for p in mine:
            offset = 0
            for path in paths:
                g = _at(grads[p], path)
                sums[p, path] = total.narrow(0, offset, g.numel()).view(g.shape).to(g.device)
                offset += g.numel()
    return [None if tree is None else _walk(lambda path, _, p=p: sums[p, path], tree)
            for p, tree in enumerate(grads)]


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


# ---------------------------------------------------------------------------
# Collectives across ranks
# ---------------------------------------------------------------------------

_WIRE_DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.float64, torch.int64,
                torch.int32, torch.int16, torch.int8, torch.uint8, torch.bool)
_MAX_DIMS = 6


def _wire_device(process_group, device: torch.device) -> torch.device:
    """Where a process group's buffers cross: the device itself, or the host
    for a card's tensors under gloo. Gloo's all_gather, send and recv take
    CPU tensors only, so such a message stages through the host: that is the
    backend's transport (two ranks on one card take gloo), not a fallback."""
    if device.type != "cpu" and dist.get_backend(process_group) == "gloo":
        return torch.device("cpu")
    return device


def _exchange_layout(group: Group, tensors: list, wire: torch.device) -> tuple[list, torch.dtype]:
    """Every member's shape and the dtype, from the members' owners (one
    small all-gather), for a collective whose receivers cannot know them."""
    counts = [group.ranks.count(r) for r in group.span]
    rows = torch.zeros(max(counts), 2 + _MAX_DIMS, dtype=torch.int64)
    for row, t in zip(rows, tensors):
        row[0], row[1] = _WIRE_DTYPES.index(t.dtype), t.dim()
        row[2: 2 + t.dim()] = torch.tensor(t.shape, dtype=torch.int64)
    out = [torch.empty_like(rows, device=wire) for _ in group.span]
    dist.all_gather(out, rows.to(wire), group=group.process_group)
    out = [o.cpu() for o in out]
    seen = dict.fromkeys(group.span, 0)
    shapes, dtype = [], None
    for r in group.ranks:
        row = out[group.span.index(r)][seen[r]]
        seen[r] += 1
        dtype = _WIRE_DTYPES[int(row[0])]
        shapes.append(tuple(int(n) for n in row[2: 2 + int(row[1])]))
    return shapes, dtype


def _exchange(group: Group, tensors: list, device: torch.device, shapes: list | None = None,
              dtype: torch.dtype | None = None) -> list:
    """Every member's tensor of `group`, in member order, on this rank:
    `tensors` are this rank's members' (in member order), and every rank of
    the group's process group calls it at the same point of the program.
    One all_gather of each rank's members' bytes (padded to the largest
    rank's); a member of this rank is its own tensor, another's a copy on
    `device`. `shapes` (one a member) and `dtype` are the members' where the
    caller knows them, else they come from the owners (_exchange_layout)."""
    wire = _wire_device(group.process_group, device)
    if shapes is None:
        shapes, dtype = _exchange_layout(group, tensors, wire)
    itemsize = torch.empty((), dtype=dtype).element_size()
    sizes = [int(np.prod(shape)) * itemsize for shape in shapes]
    per_rank = [sum(n for n, r in zip(sizes, group.ranks) if r == rank) for rank in group.span]
    width = max(max(per_rank), 1)
    send = torch.zeros(width, dtype=torch.uint8, device=wire)
    offset = 0
    for t in tensors:
        raw = t.detach().contiguous().reshape(-1).view(torch.uint8)
        send.narrow(0, offset, raw.numel()).copy_(raw)
        offset += raw.numel()
    received = [torch.empty(width, dtype=torch.uint8, device=wire) for _ in group.span]
    dist.all_gather(received, send, group=group.process_group)
    mine = iter(tensors)
    offsets = dict.fromkeys(group.span, 0)
    out = []
    for rank, shape, size in zip(group.ranks, shapes, sizes):
        start = offsets[rank]
        offsets[rank] += size
        if rank == group.rank:
            out.append(next(mine))
            continue
        raw = received[group.span.index(rank)].narrow(0, start, size)
        out.append(raw.view(dtype).reshape(shape).to(device))
    return out


def _scatter(values: list, like: list) -> list:
    """values, one for each non-None entry of `like`, back at those
    entries."""
    values = iter(values)
    return [None if x is None else next(values) for x in like]


def _each_own(total: torch.Tensor, tensors) -> list:
    """`total` on each tensor's device, a tensor of its own for each (a
    Function returns no tensor twice)."""
    out = []
    for t in tensors:
        moved = total.to(t.device)
        out.append(moved.clone() if any(moved is o for o in out) else moved)
    return out


class _CrossPsum(torch.autograd.Function):
    """psum over ranks: the members' parts summed in member order on every
    rank. Backward: the same sum of the outputs' gradients."""

    @staticmethod
    def forward(ctx, group: Group, *parts):
        ctx.group = group
        shapes = [tuple(parts[0].shape)] * len(group.ranks)
        total = _sum_in_order(_exchange(group, list(parts), parts[0].device, shapes,
                                        parts[0].dtype))
        return tuple(_each_own(total, parts))

    @staticmethod
    def backward(ctx, *grads):
        shapes = [tuple(grads[0].shape)] * len(ctx.group.ranks)
        total = _sum_in_order(_exchange(ctx.group, list(grads), grads[0].device, shapes,
                                        grads[0].dtype))
        return (None, *_each_own(total, grads))


class _CrossAllGatherTokens(torch.autograd.Function):
    """all_gather_tokens over ranks. Backward: the reduce-scatter (the
    members' full gradients summed in member order, each its slice)."""

    @staticmethod
    def forward(ctx, group: Group, dim: int, *slices):
        ctx.group, ctx.dim = group, dim
        parts = _exchange(group, list(slices), slices[0].device)
        ctx.lengths = [p.shape[dim] for p in parts]
        return tuple(_each_own(torch.cat(parts, dim=dim), slices))

    @staticmethod
    def backward(ctx, *grads):
        shapes = [tuple(grads[0].shape)] * len(ctx.group.ranks)
        total = _sum_in_order(_exchange(ctx.group, list(grads), grads[0].device, shapes,
                                        grads[0].dtype))
        starts = np.cumsum([0, *ctx.lengths[:-1]])
        mine = [(int(s), n) for s, n, local in zip(starts, ctx.lengths, ctx.group.local) if local]
        return (None, None, *(total.narrow(ctx.dim, s, n).to(g.device).contiguous()
                              for (s, n), g in zip(mine, grads)))


class _CrossReduceScatterTokens(torch.autograd.Function):
    """reduce_scatter_tokens over ranks. Backward: the all-gather of the
    slices' gradients."""

    @staticmethod
    def forward(ctx, group: Group, dim: int, *parts):
        ctx.group, ctx.dim = group, dim
        shapes = [tuple(parts[0].shape)] * len(group.ranks)
        total = _sum_in_order(_exchange(group, list(parts), parts[0].device, shapes,
                                        parts[0].dtype))
        bounds = token_slices(total.shape[dim], len(group.ranks))
        ctx.shapes = [tuple(total.shape[:dim]) + (n,) + tuple(total.shape[dim + 1:])
                      for _, n in bounds]
        mine = [b for b, local in zip(bounds, group.local) if local]
        return tuple(total.narrow(dim, start, length).to(p.device).contiguous()
                     for p, (start, length) in zip(parts, mine))

    @staticmethod
    def backward(ctx, *grads):
        full = torch.cat(_exchange(ctx.group, list(grads), grads[0].device, ctx.shapes,
                                   grads[0].dtype), dim=ctx.dim)
        return (None, None, *_each_own(full, grads))


class _GatherToEvery(torch.autograd.Function):
    """The 'data' gather over ranks, its result on every rank. Every rank
    computes the same function of the result (SPMD), so each owner's part
    takes its own rows of its rank's gradient: summing the ranks' copies
    would count the gradient once for every rank. `tails` are outputs a
    rank computed but does not use: they get zero gradients, so that the
    backward still reaches them and runs the collectives behind them."""

    @staticmethod
    def forward(ctx, group: Group, device, dim: int, count: int, *tensors):
        parts, tails = tensors[:count], tensors[count:]
        got = _exchange(group, list(parts), device)
        lengths = [g.shape[dim] for g in got]
        starts = np.cumsum([0, *lengths[:-1]])
        ctx.dim = dim
        ctx.rows = [(int(s), n) for s, n, local in zip(starts, lengths, group.local) if local]
        ctx.devices = [p.device for p in parts]
        ctx.tails = [(t.shape, t.dtype, t.device) for t in tails]
        return torch.cat([g.to(device) for g in got], dim=dim)

    @staticmethod
    def backward(ctx, g):
        parts = [g.narrow(ctx.dim, s, n).to(d) for (s, n), d in zip(ctx.rows, ctx.devices)]
        tails = [torch.zeros(shape, dtype=dtype, device=device)
                 for shape, dtype, device in ctx.tails]
        return (None, None, None, None, *parts, *tails)


def gather_to_every(parts: list, group: Group, device: torch.device, dim: int = 0,
                    tails=()) -> torch.Tensor:
    """The gather of `group`'s members' parts (None where another rank owns
    the member) in member order on `device`, on every rank of the group
    (`mesh.group(positions, everyone=True)` makes every rank of the mesh
    one). Differentiable on SPMD terms (see _GatherToEvery); `tails` get
    zero gradients."""
    local = [p for p in parts if p is not None]
    return _GatherToEvery.apply(group, device, dim, len(local), *local, *tails)


def hand_off(mesh: Mesh, messages: list) -> dict:
    """One schedule step's stage hand-offs. `messages` are (key, source
    position, destination position, the tensor at the source or None where
    another rank owns it, its shape, its dtype, tag), in one order on every
    rank. Returns {key: the tensor on the destination's device} for the
    destinations this rank owns. A hand-off within this rank is
    `Tensor.to` the destination's device (the tensor itself on its own
    device); across ranks it is an isend / irecv pair of the tensor's bytes
    as they are, its dtype and shape unchanged, over the mesh's process
    group: on the host under gloo (`_wire_device`), card to card under
    NCCL. All of a step's messages are issued at once
    (dist.batch_isend_irecv): gloo matches each by its tag, NCCL by the
    order both ends issue them in, which is `messages`' order on both. Every
    send and receive is waited on before this returns, so no buffer is
    reused while it is in flight, and no message is blocking: a rank issues
    its sends and receives of the step before it waits on any."""
    got, ops, arriving = {}, [], []
    group = None
    for key, source, destination, tensor, shape, dtype, tag in messages:
        here, there = mesh.is_local(source), mesh.is_local(destination)
        if here and there:
            got[key] = tensor.to(mesh.device(destination))
            continue
        if not (here or there):
            continue
        if group is None:  # made on every rank at Mesh construction
            group = _process_group(mesh.all_ranks)
        wire = _wire_device(group, mesh.device(source if here else destination))
        if here:
            raw = tensor.detach().contiguous().reshape(-1).view(torch.uint8).to(wire)
            ops.append(dist.P2POp(dist.isend, raw, int(mesh.ranks.flat[destination]), group,
                                  tag))
            continue
        size = int(np.prod(shape)) * torch.empty((), dtype=dtype).element_size()
        raw = torch.empty(size, dtype=torch.uint8, device=wire)
        arriving.append((key, raw, shape, dtype, mesh.device(destination)))
        ops.append(dist.P2POp(dist.irecv, raw, int(mesh.ranks.flat[source]), group, tag))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    for key, raw, shape, dtype, device in arriving:
        got[key] = raw.view(dtype).reshape(shape).to(device)
    return got


# ---------------------------------------------------------------------------
# The collectives
# ---------------------------------------------------------------------------


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


def _across(group) -> bool:
    return group is not None and group.process_group is not None


def all_gather_tokens(slices: list, dim: int = 1, group: Group | None = None) -> list:
    """The sequence-parallel all-gather over 'model': shard j's token slice
    (dimension `dim`) concatenated in shard order, on every shard's device.
    Differentiable; its transpose is `reduce_scatter_tokens`. `group`: the
    members' Group on a mesh across ranks (None entries of `slices` are
    other ranks' members)."""
    if _across(group):
        return _scatter(_CrossAllGatherTokens.apply(
            group, dim, *(s for s in slices if s is not None)), slices)
    if len(slices) == 1:
        return list(slices)
    return list(_AllGatherTokens.apply(dim, *slices))


def reduce_scatter_tokens(parts: list, dim: int = 1, group: Group | None = None) -> list:
    """The sequence-parallel reduce-scatter over 'model': the full-length
    partials summed in shard order (as `psum`), then shard j keeps its slice
    `token_slices(T, n)[j]` on its device (the last slices may be shorter).
    Differentiable; its transpose is `all_gather_tokens`. `group` as there."""
    if _across(group):
        return _scatter(_CrossReduceScatterTokens.apply(
            group, dim, *(p for p in parts if p is not None)), parts)
    if len(parts) == 1:
        return list(parts)
    return list(_ReduceScatterTokens.apply(dim, *parts))


def _sum_in_order(parts) -> torch.Tensor:
    total = parts[0]
    for part in parts[1:]:
        total = total + part.to(total.device)
    return total


def psum(parts: list, group: Group | None = None) -> list:
    """All-reduce over an axis: the partials summed in shard order on the
    first shard's device, in their (compute) dtype, then the sum copied to
    each shard's device. `group`: the members' Group on a mesh across ranks
    (None entries of `parts` are other ranks' members); the sum is then the
    same, after an all-gather of the parts."""
    if _across(group):
        return _scatter(_CrossPsum.apply(group, *(p for p in parts if p is not None)), parts)
    total = _sum_in_order(parts)
    return [total.to(p.device) for p in parts]


def shard_map_data_parallel(fn, mesh: Mesh, axis: str = "data"):
    """Wrap `fn(params, x) -> dict of tensors` for data parallelism on
    `placed` params (a list from `place`/`replicate`): the batch is split
    over `axis`, slice i runs the unchanged fn on its device's replica (the
    first position of that 'data' index this process owns), and each output
    is concatenated in order on that process's first device. No collective:
    on a mesh across ranks every rank computes every slice on its own
    replica, which is what the JAX package's shard_map does on the devices
    of a 'model' axis; an `axis` that spans ranks raises
    (Mesh.require_local_slices)."""
    n = mesh.shape.get(axis, 1)
    mesh.require_local_slices("shard_map_data_parallel", axis)
    first = mesh.local_device
    runs = [next(p for p in range(mesh.size)
                 if mesh.coords(p).get(axis, 0) == i and mesh.is_local(p)) for i in range(n)]

    def run(placed: list, x: torch.Tensor) -> dict:
        if x.shape[0] % n:
            raise ValueError(f"batch {x.shape[0]} does not split over {axis}={n}")
        rows = x.shape[0] // n
        outs = []
        for i, position in enumerate(runs):
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
