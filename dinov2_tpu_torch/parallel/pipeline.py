"""Pipeline-parallel DINOv2 forward and train step, GPipe microbatching over
a 'stage' mesh axis (port of dinov2_tpu/parallel/pipeline.py), in one
process or over ranks (parallel/mesh.py::init_distributed).

  - the stacked layer tree is split on its leading L axis over 'stage':
    stage s holds layers [s*L/S, (s+1)*L/S) on the mesh's stage-s position;
    embeddings, the final norm and the head are replicated;
  - the schedule, one code path for one process and for ranks: M
    microbatches take M + S - 1 steps, and step t has two parts:
      (a) every stage this rank owns that has a microbatch runs it: stage s
          runs microbatch t - s through its layers (the unchanged
          models/vit.py::encoder_layer, K1 on a card's default route),
          from the embedded batch on stage 0, else from the hand-off it
          received at step t - 1;
      (b) then the step's hand-offs, boundary by boundary
          (parallel/mesh.py::hand_off): a copy to the next stage's device
          where both stages are this rank's, an isend / irecv pair of the
          activation's bytes where they are not.
    No rank waits in (b) on anything but what its peers make in (a) of the
    same step, so the schedule cannot deadlock, whatever the placement of
    stages on ranks (the interleaved 0, 1, 0, 1 included). The JAX package
    runs every stage at every step and masks the fill and drain steps; here
    a stage with no microbatch simply issues nothing.
Only stage 0's rank embeds (every rank is passed the same global batch).
The last stage's pre-final-norm tokens reach every rank, where each runs
the final norm and the head on its own replica: the output is on every
rank, as the JAX package's out_specs=P() gives it.

`make_pipeline_train_step` trains through the same forward schedule, each
(stage, microbatch) its own autograd graph from an input leaf, and one
explicit backward schedule, the same in one process and across ranks:
  - the last stage's rank computes the loss from its microbatches' outputs
    and takes its backward once: every microbatch's output gradient and the
    final norm's and head's gradients; the logits reach every rank, so that
    every rank returns the same loss and accuracy;
  - then M + S - 1 reverse steps: at step t stage s runs the backward of
    microbatch M + S - 2 - t - s from its output gradient (each layer
    recomputed under torch.utils.checkpoint where `opts.remat` is on), adds
    its weights' gradients to the stage's sum (the microbatches in that
    fixed order, M - 1 first) and hands its input's gradient to stage s - 1,
    with the forward's (a)/(b) split;
  - stage 0's rank runs the embedding's backward once, over its input
    gradients of every microbatch in batch order;
  - the gradients of the replicated embedding, final norm and head are
    summed over the positions (parallel/mesh.py::reduce_replica_grads, on
    every rank, zeros where a position does not reach them), as the JAX
    package's psum of a replicated input's cotangent does, then one
    optimizer update of every master this rank owns.
A run over ranks is then bit for bit the one-process pipeline of the same
mesh: the same (stage, microbatch) work on the same bytes, the same sums
in the same order.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from dinov2_tpu_torch.models.config import DinoConfig
from dinov2_tpu_torch.models.params import PACKED_WEIGHTS, tree_leaves, tree_map
from dinov2_tpu_torch.models.vit import (
    ModelOptions,
    _layer,
    _tokens_from,
    embed_tokens,
    forward_head,
    head_logits,
    layer_norm,
    run_encoder_layer,
)
from dinov2_tpu_torch.parallel.mesh import Mesh, _walk, gather_to_every, hand_off, place
from dinov2_tpu_torch.parallel.train import (
    as_tensor,
    masters_of,
    place_masters,
    position_aliases,
    update_from_gradients,
)

STAGE = "stage"
FORWARD, BACKWARD = 0, 1  # the directions of a hand-off, in its tag


def layer_pspecs(params: Any, axis: str = STAGE) -> Any:
    """Specs splitting the stacked layer tree's leading L axis on `axis`
    (every field of a QuantLinear or Int8Linear alike); everything else
    replicated."""

    def spec_for(path: tuple, leaf) -> tuple:
        if "layers" not in path:
            return ()
        ndim = (leaf.codes if isinstance(leaf, PACKED_WEIGHTS) else leaf).dim()
        return (axis, *([None] * (ndim - 1)))

    return _walk(spec_for, params)


def place_pipeline_params(params: Any, mesh: Mesh) -> list:
    """Layers split over the 'stage' axis, the rest replicated."""
    return place(params, mesh, layer_pspecs(params))


def _stage_scan(layers: Any, tokens: torch.Tensor, config, opts) -> torch.Tensor:
    for i in range(layers["ls1"].shape[0]):
        tokens = run_encoder_layer(tokens, _layer(layers, i), config, opts)
    return tokens


class _Schedule:
    """The GPipe schedule of one call on a 'stage' mesh: each stage's
    position (its other axes at 0), M microbatches, and one microbatch's
    activation shape and dtype, which both ends of a hand-off know. Made on
    every rank from the same arguments, so a refusal is raised on every
    rank before any hand-off."""

    def __init__(self, mesh: Mesh, config: DinoConfig, opts: ModelOptions, x_shape,
                 num_microbatches: int):
        n_stages = mesh.shape[STAGE]
        if config.num_hidden_layers % n_stages:
            raise ValueError(
                f"{config.num_hidden_layers} layers do not split over "
                f"{n_stages} stages"
            )
        m = num_microbatches
        if x_shape[0] % m:
            raise ValueError(f"batch {x_shape[0]} % microbatches {m} != 0")
        self.mesh, self.stages, self.m = mesh, n_stages, m
        self.positions = [mesh.position({STAGE: s}) for s in range(n_stages)]
        self.first, self.last = self.positions[0], self.positions[-1]
        _, h, w, _ = x_shape
        p = config.patch_size
        tokens = 1 + config.num_register_tokens + (h // p) * (w // p)
        self.shape = (x_shape[0] // m, tokens, config.hidden_size)
        self.dtype = opts.compute_dtype

    def local(self, stage: int) -> bool:
        return self.mesh.is_local(self.positions[stage])

    def device(self, stage: int) -> torch.device:
        return self.mesh.device(self.positions[stage])

    @property
    def steps(self) -> int:
        return self.m + self.stages - 1

    def _tag(self, direction: int, boundary: int, microbatch: int) -> int:
        return (direction * (self.stages - 1) + boundary) * self.m + microbatch

    def forward(self, embedded, run_stage) -> dict:
        """The forward steps: stage 0 takes microbatch mb's rows of
        `embedded` (None where another rank owns stage 0), run_stage(s, mb,
        input) is a stage's output. Returns {mb: the last stage's output}
        where this rank owns the last stage."""
        rows = self.shape[0]
        received: dict = {}
        outs: dict = {}
        for step in range(self.steps):
            made: dict = {}
            for s in range(self.stages):  # (a)
                mb = step - s
                if 0 <= mb < self.m and self.local(s):
                    act = embedded.narrow(0, mb * rows, rows) if s == 0 else (
                        received.pop((s, mb)))
                    made[s] = run_stage(s, mb, act)
            if self.stages - 1 in made:
                outs[step - self.stages + 1] = made.pop(self.stages - 1)
            messages = []  # (b): boundary s -> s + 1
            for s in range(self.stages - 1):
                mb = step - s
                if 0 <= mb < self.m:
                    messages.append(((s + 1, mb), self.positions[s], self.positions[s + 1],
                                     made[s].detach() if s in made else None, self.shape,
                                     self.dtype, self._tag(FORWARD, s, mb)))
            received.update(hand_off(self.mesh, messages))
        return outs

    def backward(self, output_grad, run_back) -> None:
        """The reverse steps: stage s runs microbatch M + S - 2 - t - s at
        step t; output_grad(mb) is the last stage's output gradient,
        run_back(s, mb, grad) a stage's backward, which returns its input's
        gradient (handed to stage s - 1; stage 0's stays with the caller)."""
        received: dict = {}
        for step in range(self.steps):
            made: dict = {}
            for s in range(self.stages):  # (a)
                mb = self.steps - 1 - step - s
                if 0 <= mb < self.m and self.local(s):
                    grad = output_grad(mb) if s == self.stages - 1 else received.pop((s, mb))
                    made[s] = run_back(s, mb, grad)
            messages = []  # (b): boundary s - 1 <- s
            for s in range(1, self.stages):
                mb = self.steps - 1 - step - s
                if 0 <= mb < self.m:
                    messages.append(((s - 1, mb), self.positions[s], self.positions[s - 1],
                                     made.get(s), self.shape, self.dtype,
                                     self._tag(BACKWARD, s - 1, mb)))
            received.update(hand_off(self.mesh, messages))

    def to_every_rank(self, tensor) -> torch.Tensor:
        """The last stage's tensor (None on another rank) on every rank: on
        the last stage's device where this rank owns it, else on this
        rank's first device."""
        if not self.mesh.spans_ranks:
            return tensor
        device = self.device(self.stages - 1) if self.local(self.stages - 1) else (
            self.mesh.local_device)
        group = self.mesh.group([self.last], everyone=True)
        with torch.no_grad():
            return gather_to_every([tensor], group, device)

    def head_position(self) -> int:
        """Where this rank runs the final norm and the head: the last
        stage's position, or this rank's first (another replica)."""
        return self.last if self.local(self.stages - 1) else self.mesh.local_positions[0]


def _pipeline_tokens(
    placed: list,
    x: torch.Tensor,
    config: DinoConfig,
    opts: ModelOptions,
    schedule: _Schedule,
) -> torch.Tensor:
    """The GPipe forward: images -> the last stage's pre-final-norm tokens,
    on every rank (`_Schedule.to_every_rank`)."""
    tokens = None
    if schedule.local(0):
        tokens = embed_tokens(placed[schedule.first], x.to(schedule.device(0)), config, opts)

    def run_stage(s: int, mb: int, act: torch.Tensor) -> torch.Tensor:
        return _stage_scan(placed[schedule.positions[s]]["layers"], act, config, opts)

    outs = schedule.forward(tokens, run_stage)
    last = torch.cat([outs[mb] for mb in range(schedule.m)]) if outs else None
    return schedule.to_every_rank(last)


def pipeline_forward(
    placed: list,
    x: torch.Tensor,
    config: DinoConfig,
    opts: ModelOptions,
    mesh: Mesh,
    num_microbatches: int = 4,
    classify: bool = False,
) -> dict[str, torch.Tensor]:
    """Pipeline-parallel equivalent of models/vit.py::forward on
    `place_pipeline_params`'s list; x: (B, H, W, 3) preprocessed images,
    B % num_microbatches == 0, config.num_hidden_layers % the stage count
    == 0. The same layer math in the same order as the sequential forward:
    only the placement and the microbatching change. Across ranks every
    rank passes the same x and gets the same outputs."""
    schedule = _Schedule(mesh, config, opts, tuple(x.shape), num_microbatches)
    tokens = _pipeline_tokens(placed, x, config, opts, schedule)
    head = placed[schedule.head_position()]
    tokens = layer_norm(tokens.float(), head["final_norm"], config.eps)
    out = {
        "cls_token": tokens.select(1, 0),
        "patch_tokens": _tokens_from(tokens, 1 + config.num_register_tokens),
    }
    if classify:
        out["probs"] = forward_head(head, tokens, config, opts)
    return out


def _replicated_leaves(tree: dict) -> list:
    """The leaves of every replicated part of a parameter tree (all but the
    layers), in tree order."""
    return [leaf for k, v in tree.items() if k != "layers" for leaf in tree_leaves(v)]


def _position_grads(tree: dict, layers: list, replicated: list) -> dict:
    """A position's gradient tree, like `tree`, from its layer leaves'
    gradients and its replicated leaves' (in `_replicated_leaves` order)."""
    layers, replicated = iter(layers), iter(replicated)
    return {k: tree_map(lambda _, it=layers if k == "layers" else replicated: next(it), v)
            for k, v in tree.items()}


def make_pipeline_train_step(
    config: DinoConfig,
    opts: ModelOptions,
    mesh: Mesh,
    optimizer: Any,
    num_microbatches: int = 4,
):
    """The classification train step over the stage mesh (GPipe forward and
    backward, module docstring), with the JAX package's signature. Returns
    (train_step, place): `place(params)` splits the layers over 'stage' as
    f32 masters that require grad (parallel/train.py::place_masters) and
    initializes the optimizer on the distinct masters this rank owns;
    `train_step(params, opt_state, x, labels)` takes preprocessed images x
    (B, H, W, 3) and updates both in place, returning them with {"loss",
    "accuracy"} on the last stage's device (on another rank, on its first
    device). Across ranks every rank passes the same global batch and gets
    the same metrics. The optimizer is any object with `init` and
    `update_`, as the Trainer's."""

    def place_fn(params: Any):
        placed = place_masters(params, mesh, layer_pspecs(params))
        return placed, optimizer.init(masters_of(placed))

    def train_step(params: list, opt_state: Any, x, labels):
        x = as_tensor(x)
        schedule = _Schedule(mesh, config, opts, tuple(x.shape), num_microbatches)
        m, n = schedule.m, schedule.stages
        aliases = position_aliases(params)
        graphs: dict = {}  # (stage, mb) -> (its input leaf, its output)
        layer_grads: dict = {}  # stage -> its layer leaves' gradients, summed
        input_grads: dict = {}  # mb -> stage 0's input gradient
        embedded = None
        with torch.enable_grad():
            if schedule.local(0):
                embedded = embed_tokens(aliases[schedule.first],
                                        x.to(schedule.device(0)), config, opts)

            def run_stage(s: int, mb: int, act: torch.Tensor) -> torch.Tensor:
                leaf = act.detach().requires_grad_(True)
                out = _stage_scan(aliases[schedule.positions[s]]["layers"], leaf, config, opts)
                graphs[s, mb] = (leaf, out)
                return out

            outs = schedule.forward(embedded, run_stage)
            logits = output_grads = head_grads = None
            if schedule.local(n - 1):
                head = aliases[schedule.last]
                ys = [outs[mb].detach().requires_grad_(True) for mb in range(m)]
                tokens = layer_norm(torch.cat(ys).float(), head["final_norm"], config.eps)
                logits = head_logits(head, tokens, config, opts)
                loss = F.cross_entropy(
                    logits, as_tensor(labels).to(logits.device, torch.int64))
                grads = torch.autograd.grad(loss, ys + _replicated_leaves(head),
                                            allow_unused=True, materialize_grads=True)
                output_grads, head_grads = grads[:m], grads[m:]
            del outs

            def run_back(s: int, mb: int, grad: torch.Tensor):
                leaf, out = graphs.pop((s, mb))
                weights = tree_leaves(aliases[schedule.positions[s]]["layers"])
                got = torch.autograd.grad(out, [leaf, *weights], grad, allow_unused=True,
                                          materialize_grads=True)
                if s in layer_grads:
                    torch._foreach_add_(layer_grads[s], got[1:])
                else:
                    layer_grads[s] = list(got[1:])
                if s == 0:
                    input_grads[mb] = got[0]
                    return None
                return got[0]

            schedule.backward(lambda mb: output_grads[mb], run_back)
            embed_grads = None
            if schedule.local(0):
                embed_grads = torch.autograd.grad(
                    embedded, _replicated_leaves(aliases[schedule.first]),
                    torch.cat([input_grads[mb] for mb in range(m)]),
                    allow_unused=True, materialize_grads=True)

        per_position = []
        for position, tree in enumerate(aliases):
            if tree is None:
                per_position.append(None)
                continue
            replicated = None
            for part, at in ((embed_grads, schedule.first), (head_grads, schedule.last)):
                if position == at:  # both where one stage is the first and the last
                    replicated = part if replicated is None else torch._foreach_add(
                        list(replicated), list(part))
            if position in schedule.positions:
                layers = layer_grads[schedule.positions.index(position)]
            else:  # another coordinate of the mesh's other axes: runs nothing
                layers = [torch.zeros_like(leaf) for leaf in tree_leaves(tree["layers"])]
            if replicated is None:  # neither the first nor the last stage: zeros
                replicated = [torch.zeros_like(leaf) for leaf in _replicated_leaves(tree)]
            per_position.append(_position_grads(tree, layers, replicated))
        update_from_gradients(optimizer, params, per_position, opt_state, mesh,
                              layer_pspecs(aliases[mesh.local_positions[0]]))

        logits = schedule.to_every_rank(None if logits is None else logits.detach())
        labels = as_tensor(labels).to(logits.device, torch.int64)
        loss = F.cross_entropy(logits, labels)
        accuracy = (logits.argmax(dim=-1) == labels).float().mean()
        return params, opt_state, {"loss": loss, "accuracy": accuracy}

    return train_step, place_fn
