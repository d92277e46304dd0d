"""The training step (fine-tune / linear-probe DINOv2 classification): port of
dinov2_tpu/parallel/train.py, on one device or on a mesh.

    trainer = make_trainer(config, learning_rate=1e-4, weight_decay=0.05)
    params, opt_state = trainer.place(params)
    params, opt_state, metrics = trainer.step(params, opt_state, images, labels)

One step is: uint8 images (B, H, W, 3) through `classify_preprocess` (in
the step unless `preprocess_in_step=False`), `forward_features` and
`head_logits`, the mean softmax cross-entropy and the accuracy, the backward,
and AdamW; `metrics` is {"loss", "accuracy"} as f32 scalars on the device.
The signatures and defaults are the JAX package's (`parity="hf"`, f32
compute, `remat=True`) plus an explicit `device`, "cuda" unless the caller
asks for the CPU.

On a mesh (parallel/mesh.py: 'data' and 'model' axes, one process driving
every position, as the JAX package's jitted step is one program over its
mesh):
  - `place` splits the masters by `param_pspecs` after
    `tp_prepare_dense_params` (Megatron TP: qkv and fc1 by columns, proj
    and fc2 by rows, qkv's [q; k; v] permuted so each shard holds its own
    heads) where 'model' is larger than 1, `tensor_parallel` is on and the
    heads split; everything else is replicated. A replica on one device is
    one tensor, as `place` makes it; across devices each position holds
    its own copy. The optimizer state is initialized on the distinct
    masters (`masters_of`), so it sits beside them;
  - `shard_batch` splits images and labels over 'data' (replicated on a
    pure 'model' mesh);
  - `step` runs each 'data' slice on its 'model' group (the TP training
    forward, parallel/tp_fused.py::make_tp_train_forward, or the
    single-device forward on the slice's replica), gathers the logits on
    the mesh's first device for the mean cross-entropy over the whole
    batch, takes one backward to each position's own leaf aliases (so that
    every position's gradient is its own, also where positions share a
    tensor), sums the gradients of the positions that hold each (leaf,
    shard) in position order (parallel/mesh.py::reduce_replica_grads,
    which GSPMD does in the JAX package) and updates each distinct master
    once;
  - `unplace` gives the logical tree back (the shards concatenated, the
    permutation undone) for checkpoints and export.

Across processes (parallel/mesh.py::init_distributed, a mesh whose
positions span ranks) every rank runs `step` on the same global batch,
places and updates only its own positions, and gets the same metrics:
each rank computes the loss from the logits of every slice, gathered on
every rank (parallel/mesh.py::gather_to_every); the backward reaches each
rank's own positions only from the rows its head computed, zero gradients
reach the shards whose outputs the head does not read, and the replica
sums cross the ranks in position order. The step is then bit for bit the
one-process mesh of the same axes.

`place` makes the parameters f32 master leaves that require grad on the
device (copies: the caller's tree is left alone) and the optimizer state
beside them. `step` updates both in place (PyTorch has no donation; the JAX
step donates its arguments, which comes to the same) and returns them.

The optimizer is any object with `init(params)` and `update_(params,
grads, state)` (grads in `tree_leaves(params)` order). `make_trainer`'s
is a functional AdamW on `torch._foreach_*` ops, not
`torch.optim.AdamW`: it computes what `optax.adamw(lr, weight_decay=wd)`
computes, b1 0.9, b2 0.999, eps 1e-8, decay on every leaf, update
`-lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)`. `torch.optim.AdamW`
multiplies p by (1 - lr * wd) first and so differs by an `lr² * wd` cross
term. The state is {"count", "mu", "nu"}, the moments in the parameters'
tree.

On a card the compute dtype is f32 (the defaults) or bf16
(`ModelOptions(compute_dtype=torch.bfloat16)`) over the f32 masters; the
kernels K1 to K6 take both. With `flash_attention=True` the attention core is the K4 `with_lse`
forward and the K6 backward; on the slab route the forward is K1 (or K2,
K3, K5 by `slab_fusion` and `fuse_mlp`) and the backward recomputes through
the plain versions (ops/fused_attention.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from dinov2_tpu_torch.image.preprocess import classify_preprocess
from dinov2_tpu_torch.models.config import DinoConfig
from dinov2_tpu_torch.models.params import trainable_params, tree_leaves, tree_map
from dinov2_tpu_torch.models.vit import ModelOptions, forward_features, head_logits
from dinov2_tpu_torch.ops.qmatmul import set_cuda_matmul_precision
from dinov2_tpu_torch.parallel.mesh import (
    Mesh,
    _at,
    _walk,
    first_local,
    gather,
    gather_to_every,
    param_pspecs,
    place,
    reduce_replica_grads,
    shard_batch,
    unplace,
)
from dinov2_tpu_torch.parallel.tp_fused import (
    make_tp_train_forward,
    tp_prepare_dense_params,
    tp_restore_dense_params,
)
from dinov2_tpu_torch.utils.logging import get_logger


@dataclass(frozen=True)
class AdamW:
    """optax.adamw(learning_rate, weight_decay=weight_decay), functional."""

    learning_rate: float = 1e-4
    weight_decay: float = 0.05
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def init(self, params: Any) -> dict[str, Any]:
        return {
            "count": 0,
            "mu": tree_map(torch.zeros_like, params),
            "nu": tree_map(torch.zeros_like, params),
        }

    @torch.no_grad()
    def update_(self, params: Any, grads: list[torch.Tensor], state: dict[str, Any]) -> None:
        """One AdamW step on the leaves of `params` and `state`, in place;
        `grads` in `tree_leaves(params)` order."""
        state["count"] += 1
        count = state["count"]
        leaves, mu, nu = tree_leaves(params), tree_leaves(state["mu"]), tree_leaves(state["nu"])
        torch._foreach_lerp_(mu, grads, 1.0 - self.b1)  # mu = b1 mu + (1 - b1) g
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, grads, grads, value=1.0 - self.b2)
        # m_hat / (sqrt(v_hat) + eps), with the bias corrections folded in
        denom = torch._foreach_sqrt(nu)
        torch._foreach_div_(denom, (1.0 - self.b2**count) ** 0.5)
        torch._foreach_add_(denom, self.eps)
        torch._foreach_mul_(denom, 1.0 - self.b1**count)
        update = torch._foreach_div(mu, denom)
        torch._foreach_add_(update, leaves, alpha=self.weight_decay)
        torch._foreach_add_(leaves, update, alpha=-self.learning_rate)


def masters_of(placed: list) -> dict:
    """Every distinct tensor of a placed tree once: {position: the tree of
    the leaves first held at that position}. A tensor shared by several
    positions (replicas on one device) belongs to the first; a position
    that holds no tensor of its own (or another process's) is left out."""
    owners = _owners(placed)
    masters: dict = {}
    for position, tree in enumerate(placed):
        if tree is None:
            continue

        def own(path: tuple, t):
            if _at(owners[position], path) == position:
                node = masters.setdefault(position, {})
                for key in path[:-1]:
                    node = node.setdefault(key, {})
                node[path[-1]] = t

        _walk(own, tree)
    return masters


def _owners(placed: list) -> list:
    """For each position a tree of the position that first holds its leaf
    (None for another process's position)."""
    first: dict = {}

    def owner(position: int):
        return lambda path, t: first.setdefault(id(t), position)

    return [None if tree is None else _walk(owner(position), tree)
            for position, tree in enumerate(placed)]


def _structure(tree: Any) -> Any:
    return {k: _structure(v) for k, v in tree.items()} if isinstance(tree, dict) else None


def position_aliases(placed: list) -> list:
    """Each position's tree of leaves of its own: new leaves that require
    grad on the masters' storage (None stays None). The step runs each
    position on its aliases, so that the backward gives each position its
    own gradient, also where positions share one master."""
    return [None if tree is None else tree_map(lambda t: t.detach().requires_grad_(True), tree)
            for tree in placed]


def apply_gradients(optimizer, placed: list, aliases: list, opt_state: Any, loss: torch.Tensor,
                    mesh: Mesh, specs: Any) -> None:
    """One backward of `loss` to every position's aliases (the trees the
    forward ran on, `position_aliases(placed)`), the replica reduction in
    position order (parallel/mesh.py::reduce_replica_grads) and one
    optimizer update of every distinct master of `placed`, in place. A
    leaf the loss does not reach gets a zero gradient, as in JAX."""
    leaves = [leaf for tree in aliases if tree is not None for leaf in tree_leaves(tree)]
    if loss.requires_grad:
        grads = iter(torch.autograd.grad(loss, leaves, allow_unused=True,
                                         materialize_grads=True))
    else:  # this rank's positions do not reach the loss
        grads = iter(torch.zeros_like(leaf) for leaf in leaves)
    per_position = [None if tree is None else tree_map(lambda _: next(grads), tree)
                    for tree in aliases]
    update_from_gradients(optimizer, placed, per_position, opt_state, mesh, specs)


def update_from_gradients(optimizer, placed: list, grads: list, opt_state: Any, mesh: Mesh,
                          specs: Any) -> None:
    """The replica reduction of each position's gradient tree (`grads`, a
    list like `placed`, None at another rank's positions) in position order
    (parallel/mesh.py::reduce_replica_grads, on every rank) and one
    optimizer update of every distinct master of `placed`, in place."""
    reduced = reduce_replica_grads(grads, mesh, specs)
    masters = masters_of(placed)
    optimizer.update_(masters, tree_leaves({
        position: _walk(lambda path, _, p=position: _at(reduced[p], path), tree)
        for position, tree in masters.items()
    }), opt_state)


def place_masters(params: Any, mesh: Mesh, specs: Any) -> list:
    """`place` of the tree as f32 masters that require grad: one new tensor
    for each distinct placed tensor, so replicas on one device stay one
    tensor; the caller's tree is left alone."""
    made: dict = {}

    def master(path: tuple, t: torch.Tensor) -> torch.Tensor:
        if id(t) not in made:  # trainable_params refuses quantized leaves
            made[id(t)] = trainable_params(t, t.device if torch.is_tensor(t) else None)
        return made[id(t)]

    placed = place(params, mesh, specs)
    return [None if tree is None else _walk(master, tree) for tree in placed]


def as_tensor(x) -> torch.Tensor:
    """A host array (or a tensor, as it is) as a tensor."""
    return x if torch.is_tensor(x) else torch.from_numpy(np.asarray(x))


@dataclass
class Trainer:
    """Holds the train step and the placement of its state on one device or
    a mesh."""

    config: DinoConfig
    opts: ModelOptions
    optimizer: Any
    mesh: Any = None
    tensor_parallel: bool = True
    preprocess_in_step: bool = True
    device: Any = "cuda"

    def __post_init__(self):
        self.device = torch.device(self.device)
        devices = [self.device] if self.mesh is None else [
            self.mesh.device(p) for p in self.mesh.local_positions]
        if self.mesh is not None:
            if not set(self.mesh.axis_names) <= {"data", "model"}:
                raise ValueError(
                    f"Trainer: mesh axes {self.mesh.axis_names}; the step takes 'data' and "
                    "'model' (a 'stage' mesh trains through "
                    "parallel/pipeline.py::make_pipeline_train_step)"
                )
            others = sorted({str(d) for d in devices if d.type != self.device.type})
            if others:
                raise ValueError(
                    f"Trainer(device={str(self.device)!r}): the mesh places shards on {others}; "
                    "pass the device type of the mesh"
                )
            self.device = devices[0]
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "Trainer(device='cuda'): no CUDA device is available "
                    "(use device='cpu' for the plain PyTorch path)"
                )
            count = torch.cuda.device_count()
            missing = sorted({str(d) for d in devices if (d.index or 0) >= count})
            if missing:
                raise ValueError(f"the mesh names {missing}, have {count} CUDA device(s)")
            set_cuda_matmul_precision()
        self._tp = 1
        if self.mesh is not None:
            tp = self.mesh.shape.get("model", 1) if self.tensor_parallel else 1
            if tp > 1 and self.config.num_attention_heads % tp:
                get_logger().warning(
                    "%d heads do not split over tp=%d; replicating over the 'model' axis",
                    self.config.num_attention_heads, tp)
            elif tp > 1:
                self._tp = tp
                self._tp_forward = make_tp_train_forward(self.config, self.opts, self.mesh)
            axis = "data" if "data" in self.mesh.axis_names else None
            n = self.mesh.shape[axis] if axis else 1
            # each 'data' slice's first position: where a replicated slice
            # runs and its logits are taken
            self._slice_positions = [self.mesh.position({"data": i}) for i in range(n)]
            self._slices = self.mesh.group(self._slice_positions, everyone=True)

    def loss_fn(self, params, images: torch.Tensor, labels: torch.Tensor):
        """(mean cross-entropy, accuracy) of a batch on the device."""
        x = classify_preprocess(images) if self.preprocess_in_step else images
        tokens = forward_features(params, x, self.config, self.opts)
        logits = head_logits(params, tokens, self.config, self.opts)
        loss = F.cross_entropy(logits, labels)
        accuracy = (logits.argmax(dim=-1) == labels).float().mean()
        return loss, accuracy

    def _mesh_logits(self, placed: list, images: list) -> torch.Tensor:
        """The logits of the whole batch on the mesh's first device (on a
        mesh across ranks, on this rank's first device, on every rank)."""
        xs = [None if x is None else classify_preprocess(x) if self.preprocess_in_step else x
              for x in images]
        if self._tp > 1:
            return self._tp_forward(placed, xs)
        logits = []
        for position in self._slice_positions:
            if placed[position] is None:
                logits.append(None)
                continue
            tokens = forward_features(placed[position], xs[position], self.config, self.opts)
            logits.append(head_logits(placed[position], tokens, self.config, self.opts))
        if self.mesh.spans_ranks:
            return gather_to_every(logits, self._slices, self.device)
        return gather(logits, self.device)

    # ------------------------------------------------------------------
    def _layout(self, params) -> tuple[Any, Any]:
        """The tree as the mesh holds it (TP-permuted where TP is on) and its
        specs."""
        if self._tp > 1:
            return tp_prepare_dense_params(params, self.config, self._tp)
        return params, None

    def specs(self, placed: list) -> Any:
        """The specs of a tree this trainer placed: `param_pspecs` under TP,
        None (every leaf replicated) otherwise."""
        return param_pspecs(first_local(placed)) if self._tp > 1 else None

    def place(self, params, opt_state=None):
        """The parameters as f32 master leaves that require grad on the
        device (a placed list on a mesh), and the optimizer state: `opt_state`
        (a logical state, as `unplace` gives it) placed beside them, or a new
        one."""
        if self.mesh is None:
            params = trainable_params(params, self.device)
            return params, self.optimizer.init(params) if opt_state is None else opt_state
        layout, specs = self._layout(params)
        placed = place_masters(layout, self.mesh, specs)
        if opt_state is None:
            return placed, self.optimizer.init(masters_of(placed))
        logical = _structure(params)

        def state(node):
            if _structure(node) == logical:
                node = place(self._layout(node)[0], self.mesh, specs)
                return {
                    position: _walk(
                        lambda path, _: _at(node[position], path).detach().to(
                            torch.float32, copy=True), tree)
                    for position, tree in masters_of(placed).items()
                }
            return {k: state(v) for k, v in node.items()} if isinstance(node, dict) else node

        return placed, state(opt_state)

    def unplace(self, params, opt_state=None):
        """The logical (params, opt_state) of a placed state: the shards
        concatenated on the mesh's first device and the TP permutation
        undone (parallel/mesh.py::unplace; a collective on a mesh across
        ranks, which gives every rank the whole state); on one device the
        state as it is."""
        if self.mesh is None:
            return params, opt_state
        owners = _owners(params)
        masters = _structure(masters_of(params))

        def logical(placed: list):
            tree = unplace(placed, self.mesh, self.specs(placed))
            return tp_restore_dense_params(tree, self.config, self._tp) if self._tp > 1 else tree

        def state(node):
            if _structure(node) == masters:
                return logical([
                    None if tree is None else _walk(lambda path, owner: _at(node[owner], path), tree)
                    for tree in owners])
            return {k: state(v) for k, v in node.items()} if isinstance(node, dict) else node

        return logical(params), state(opt_state)

    def shard_batch(self, images, labels):
        """Host arrays (or tensors) -> tensors on the device, labels int64; on
        a mesh, lists of each position's slice (parallel/mesh.py::shard_batch;
        None at another process's positions)."""
        images, labels = as_tensor(images), as_tensor(labels).to(torch.int64)
        if self.mesh is None:
            return images.to(self.device), labels.to(self.device)
        return shard_batch(images, self.mesh), shard_batch(labels, self.mesh)

    def step(self, params, opt_state, images, labels):
        """One training step; params and opt_state are updated in place and
        returned with {"loss", "accuracy"}. On a mesh across ranks every
        rank passes the same global batch and gets the same metrics."""
        if self.mesh is not None:
            labels = as_tensor(labels).to(self.device, torch.int64)
            images = shard_batch(as_tensor(images), self.mesh)
            aliases = position_aliases(params)
            with torch.enable_grad():
                logits = self._mesh_logits(aliases, images)
                loss = F.cross_entropy(logits, labels)
                apply_gradients(self.optimizer, params, aliases, opt_state, loss, self.mesh,
                                self.specs(params))
            accuracy = (logits.detach().argmax(dim=-1) == labels).float().mean()
            return params, opt_state, {"loss": loss.detach(), "accuracy": accuracy}
        images, labels = self.shard_batch(images, labels)
        with torch.enable_grad():
            loss, accuracy = self.loss_fn(params, images, labels)
            # a leaf the loss does not reach gets a zero gradient, as in JAX
            grads = torch.autograd.grad(
                loss, tree_leaves(params), allow_unused=True, materialize_grads=True
            )
        self.optimizer.update_(params, list(grads), opt_state)
        return params, opt_state, {"loss": loss.detach(), "accuracy": accuracy}


def make_trainer(
    config: DinoConfig,
    mesh: Any = None,
    learning_rate: float = 1e-4,
    weight_decay: float = 0.05,
    opts: ModelOptions | None = None,
    tensor_parallel: bool = True,
    preprocess_in_step: bool = True,
    device="cuda",
) -> Trainer:
    """A Trainer with the JAX package's defaults: parity "hf", f32 compute,
    remat, AdamW, attention route "auto", on the card unless `device` says
    otherwise. On a CUDA device "auto" sends the f32 activations to the f32
    kernels (ops/attention.py::resolve_attention_path): K1 forward with its
    recompute backward below FLASH_MIN_TOKENS tokens, K4 with lse and K6 from
    there on; their products and the plain ones run in full f32, TF32 stays
    off (ops/qmatmul.py::set_cuda_matmul_precision). Pass
    `ModelOptions(compute_dtype=torch.bfloat16, ...)` for the bf16 kernels. With
    a `mesh` the step runs on its devices (module docstring); their type
    must be `device`'s."""
    opts = opts or ModelOptions(parity="hf", compute_dtype=torch.float32, remat=True)
    return Trainer(
        config=config,
        opts=opts,
        optimizer=AdamW(learning_rate, weight_decay),
        mesh=mesh,
        tensor_parallel=tensor_parallel,
        preprocess_in_step=preprocess_in_step,
        device=device,
    )
