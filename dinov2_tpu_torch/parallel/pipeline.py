"""Pipeline-parallel DINOv2 forward and train step, GPipe microbatching over
a 'stage' mesh axis (port of dinov2_tpu/parallel/pipeline.py).

  - the stacked layer tree is split on its leading L axis over 'stage':
    stage s holds layers [s*L/S, (s+1)*L/S) on the mesh's stage-s device;
    embeddings, the final norm and the head are replicated;
  - the schedule: M microbatches take M + S - 1 steps. At step t stage s
    runs microbatch t - s through its layers (the unchanged
    models/vit.py::encoder_layer, K1 on a card's default route): stage 0
    takes it from the embedded batch (injection), stage s > 0 the output
    stage s - 1 handed off at step t - 1 (a copy to its device), and the
    last stage collects. The JAX package runs every stage at every step and
    masks the fill and drain steps; here a stage with no microbatch simply
    issues nothing.
The embedding runs on stage 0, the final norm and the head on the last
stage, where the result stays.

`make_pipeline_train_step` trains through the same schedule: the loss on
the last stage, one backward through the stage hand-offs (the transpose of
a copy is a copy back), each stage's layers under torch.utils.checkpoint
where `opts.remat` is on, and the gradients of the replicated embedding,
final norm and head summed over the stages
(parallel/mesh.py::reduce_replica_grads), as the JAX package's psum of a
replicated input's cotangent does.

One process drives every stage: a 'stage' mesh whose positions span ranks
(parallel/mesh.py::init_distributed) raises. Across ranks the hand-off
would be a send/recv pair whose backward is the reverse (ROADMAP.md).
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from dinov2_tpu_torch.models.config import DinoConfig
from dinov2_tpu_torch.models.params import PACKED_WEIGHTS
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
from dinov2_tpu_torch.parallel.mesh import Mesh, _walk, place
from dinov2_tpu_torch.parallel.train import (
    apply_gradients,
    as_tensor,
    masters_of,
    place_masters,
    position_aliases,
)

STAGE = "stage"


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


def _pipeline_tokens(
    placed: list,
    x: torch.Tensor,
    config: DinoConfig,
    opts: ModelOptions,
    mesh: Mesh,
    num_microbatches: int,
) -> torch.Tensor:
    """The GPipe schedule: images -> pre-final-norm tokens, on the last
    stage's device."""
    n_stages = mesh.shape[STAGE]
    if config.num_hidden_layers % n_stages:
        raise ValueError(
            f"{config.num_hidden_layers} layers do not split over "
            f"{n_stages} stages"
        )
    m = num_microbatches
    if x.shape[0] % m:
        raise ValueError(f"batch {x.shape[0]} % microbatches {m} != 0")
    if mesh.spans_ranks:
        raise NotImplementedError(
            f"{mesh}: the pipeline runs every stage in one process; a 'stage' axis across "
            "ranks is not ported (ROADMAP.md, 'Still to port')"
        )
    positions = [mesh.position({STAGE: s}) for s in range(n_stages)]
    devices = [mesh.device(p) for p in positions]
    tokens = embed_tokens(placed[positions[0]], x.to(devices[0]), config, opts)
    rows = x.shape[0] // m
    outs: list = [None] * m
    recv: list = [None] * n_stages  # what each stage takes at this step
    for step in range(m + n_stages - 1):
        sent: list = [None] * n_stages
        for s in range(n_stages):
            mb = step - s
            if not 0 <= mb < m:
                continue  # fill or drain: this stage has no microbatch
            act = tokens.narrow(0, mb * rows, rows) if s == 0 else recv[s]
            out = _stage_scan(placed[positions[s]]["layers"], act, config, opts)
            if s == n_stages - 1:
                outs[mb] = out
            else:
                sent[s + 1] = out.to(devices[s + 1])  # the hand-off to the next stage
        recv = sent
    return torch.cat(outs)


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
    only the placement and the microbatching change."""
    tokens = _pipeline_tokens(placed, x, config, opts, mesh, num_microbatches)
    last = placed[mesh.position({STAGE: mesh.shape[STAGE] - 1})]
    tokens = layer_norm(tokens.float(), last["final_norm"], config.eps)
    out = {
        "cls_token": tokens.select(1, 0),
        "patch_tokens": _tokens_from(tokens, 1 + config.num_register_tokens),
    }
    if classify:
        out["probs"] = forward_head(last, tokens, config, opts)
    return out


def make_pipeline_train_step(
    config: DinoConfig,
    opts: ModelOptions,
    mesh: Mesh,
    optimizer: Any,
    num_microbatches: int = 4,
):
    """The classification train step over the stage mesh (GPipe forward and
    backward), with the JAX package's signature. Returns (train_step,
    place): `place(params)` splits the layers over 'stage' as f32 masters
    that require grad (parallel/train.py::place_masters) and initializes
    the optimizer on the distinct masters; `train_step(params, opt_state,
    x, labels)` takes preprocessed images x (B, H, W, 3) and updates both in
    place, returning them with {"loss", "accuracy"} on the last stage's
    device. The optimizer is any object with `init` and `update_`, as the
    Trainer's."""
    stage0 = mesh.device(mesh.position({STAGE: 0}))
    last = mesh.position({STAGE: mesh.shape[STAGE] - 1})

    def place_fn(params: Any):
        placed = place_masters(params, mesh, layer_pspecs(params))
        return placed, optimizer.init(masters_of(placed))

    def train_step(params: list, opt_state: Any, x, labels):
        x = as_tensor(x).to(stage0)
        labels = as_tensor(labels).to(mesh.device(last), torch.int64)
        aliases = position_aliases(params)
        with torch.enable_grad():
            tokens = _pipeline_tokens(aliases, x, config, opts, mesh, num_microbatches)
            tokens = layer_norm(tokens.float(), aliases[last]["final_norm"], config.eps)
            logits = head_logits(aliases[last], tokens, config, opts)
            loss = F.cross_entropy(logits, labels)
            apply_gradients(optimizer, params, aliases, opt_state, loss, mesh,
                            layer_pspecs(params[0]))
        accuracy = (logits.detach().argmax(dim=-1) == labels).float().mean()
        return params, opt_state, {"loss": loss.detach(), "accuracy": accuracy}

    return train_step, place_fn
