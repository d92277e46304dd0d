"""Megatron tensor-parallel inference, quantized and dense, and the dense
training forward (port of dinov2_tpu/parallel/tp_fused.py).

The classic column/row split, one psum per block, on a mesh with a 'model'
axis (parallel/mesh.py), each shard's launches on its own device:
  - qkv / fc1 / weights_in are COLUMN-split (out features). A QuantLinear
    splits on its out axis in either layout (codes/d/m/qh are out-major);
    a dense kernel (in, out) on its last axis. The fused qkv rows (and
    SwiGLU's fused [in1; in2] halves) are PERMUTED once at load so that a
    contiguous S-way split hands each shard its own heads' [q; k; v]
    sections (its [in1; in2] halves): attention runs per shard on
    num_heads/S heads with the single-device kernels (K3 below 1024 tokens,
    K4 from there on a card; ops/attention.py::resolve_attention_path).
  - proj / fc2 / weights_out are ROW-split (in features). Nibble-packed
    codes cannot split on `in` (lo/hi plane elements share bytes), so these
    convert to the int8-SoA layout at load, which splits at any 32-aligned
    boundary; the affine min-correction is linear in x, so the per-shard
    partials psum exactly.
  - biases of row-split layers add AFTER the psum; everything else (norms,
    embeddings, LayerScale, head) is replicated compute.
Each partial is in the compute dtype before the sum, as in the JAX package.

Quantized weights take `tp_prepare_params` (the JAX package's fused-quant
TP); dense ones `tp_prepare_dense_params`, which the JAX package leaves to
GSPMD through parallel/mesh.py::param_pspecs: PyTorch has no GSPMD, so one
forward, `make_tp_forward`, serves both, its dense products plain PyTorch
matmuls (XLA dots in the JAX package) and its quantized ones K7.

`make_tp_train_forward` is the same layer for the mesh Trainer
(parallel/train.py), where JAX's GSPMD partitions its jitted step: logits
out, each layer recomputed in the backward with `opts.remat`, and with
`opts.sequence_parallel` the residual stream held as token slices between
layers (`all_gather_tokens` before LN1, `reduce_scatter_tokens` in place of
the MLP's psum, parallel/mesh.py). `tp_restore_dense_params` undoes the
dense permutation for checkpoints and export.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from dinov2_tpu_torch.models.config import DinoConfig
from dinov2_tpu_torch.models.params import (
    QuantLinear,
    decode_packed_planes,
    tree_leaves,
    tree_map,
)
from dinov2_tpu_torch.models.vit import (
    ModelOptions,
    _layer,
    _tokens_from,
    embed_tokens,
    forward_head,
    head_logits,
    layer_norm,
)
from dinov2_tpu_torch.ops.attention import resolve_attention_path, split_heads, vanilla_attention
from dinov2_tpu_torch.ops.qmatmul import apply_linear
from dinov2_tpu_torch.parallel.mesh import (
    Group,
    Mesh,
    all_gather_tokens,
    first_local,
    gather,
    gather_to_every,
    param_pspecs,
    psum,
    reduce_scatter_tokens,
    token_slices,
)

# ---------------------------------------------------------------------------
# Param preparation (host side, once at engine construction)
# ---------------------------------------------------------------------------


def _to_soa(ql: QuantLinear) -> QuantLinear:
    """Packed-nibble QuantLinear -> int8-SoA (the row split needs it); the
    plane layout's one home is models/params.py::decode_packed_planes."""
    if not ql.packed:
        return ql
    q = decode_packed_planes(ql.codes, ql.qh_lo, ql.qh_hi, ql.zero_point)
    return QuantLinear(
        codes=q.to(torch.int8), d=ql.d, m=ql.m, ggml_type=ql.ggml_type, shape=ql.shape,
        packed=False,
    )


def _section_perm(out_dim: int, sections: int, shards: int) -> np.ndarray | None:
    """Row permutation so a contiguous `shards`-way split of the fused
    [sec0; sec1; ...] out axis gives each shard its slice of EVERY section.
    None when the permutation is the identity (single section)."""
    if sections == 1:
        return None
    sz = out_dim // sections
    if sz % shards:
        raise ValueError(
            f"section size {sz} (out={out_dim}/{sections}) does not split "
            f"over tp={shards}"
        )
    per = sz // shards
    perm = [
        sec * sz + s * per + j
        for s in range(shards)
        for sec in range(sections)
        for j in range(per)
    ]
    return np.asarray(perm)


def _permute_out(x: torch.Tensor, perm: np.ndarray, axis: int) -> torch.Tensor:
    return torch.index_select(x, axis, torch.as_tensor(perm, device=x.device))


def _permute_linear(layer: dict, perm: np.ndarray | None) -> dict:
    """Apply an out-axis permutation to a stacked linear layer dict: a
    QuantLinear kernel (L, out, .) on axis 1, a dense kernel (L, in, out) on
    axis 2, the bias (L, out) on axis 1."""
    if perm is None:  # identity (single-section layers like fc1)
        return layer
    kernel = layer["kernel"]
    out = dict(layer)
    if isinstance(kernel, QuantLinear):
        out["kernel"] = kernel.map(lambda t: _permute_out(t, perm, 1))
    else:
        out["kernel"] = _permute_out(kernel, perm, 2)
    if "bias" in layer:
        out["bias"] = _permute_out(layer["bias"], perm, 1)
    return out


def _mlp_names(params: Any) -> tuple[str, str]:
    return ("win", "wout") if "win" in params["layers"]["mlp"] else ("fc1", "fc2")


def tp_prepare_params(
    params: Any, config: DinoConfig, tp: int, axis: str = "model"
) -> tuple[Any, Any]:
    """Rewrite the fused-quant param tree for Megatron TP and build the
    matching spec tree: `place(params_tp, mesh, specs)` (parallel/mesh.py)
    puts the shards on a mesh. Returns (params_tp,
    specs). Raises ValueError where the split cannot be made (the engine
    then falls back to quant_mode='dequant')."""
    if config.num_attention_heads % tp:
        raise ValueError(
            f"{config.num_attention_heads} heads do not split over tp={tp}"
        )
    layers = dict(params["layers"])
    d_model = config.hidden_size

    for name in ("qkv", "proj"):
        if not isinstance(layers[name]["kernel"], QuantLinear):
            raise ValueError(f"tp_fused expects quantized {name}")
    # the MLP kernels must be quantized too, and the row-split ones must split
    # at 32-block boundaries: raise ValueError HERE so the engine's
    # fallback-to-dequant fires
    mlp_names = _mlp_names(params)
    for name in mlp_names:
        if not isinstance(params["layers"]["mlp"][name]["kernel"], QuantLinear):
            raise ValueError(f"tp_fused expects quantized mlp.{name}")
    in_dim = params["layers"]["mlp"][mlp_names[1]]["kernel"].shape[1]
    if in_dim % (tp * 32):
        raise ValueError(
            f"{mlp_names[1]} in-dim {in_dim} does not split at 32-block "
            f"boundaries over tp={tp}"
        )

    layers["qkv"] = _permute_linear(layers["qkv"], _section_perm(3 * d_model, 3, tp))
    proj = dict(layers["proj"])
    proj["kernel"] = _to_soa(proj["kernel"])
    if proj["kernel"].codes.shape[2] % (tp * 32):
        raise ValueError("proj in-dim does not split at 32-block boundaries")
    layers["proj"] = proj

    mlp = dict(layers["mlp"])
    col_name, row_name = mlp_names
    sections = 2 if col_name == "win" else 1  # SwiGLU (giant): fused [in1; in2] halves
    mlp[col_name] = _permute_linear(mlp[col_name], _section_perm(
        mlp[col_name]["kernel"].codes.shape[1], sections, tp
    ))
    row = dict(mlp[row_name])
    row["kernel"] = _to_soa(row["kernel"])
    mlp[row_name] = row
    layers["mlp"] = mlp

    params_tp = dict(params)
    params_tp["layers"] = layers

    # spec tree: replicate everything, then overwrite the split leaves
    col, row_split, col_bias = (None, axis, None), (None, None, axis), (None, axis)
    specs = param_pspecs(params_tp, axis)  # () for every QuantLinear

    def split(spec_layer: dict, layer: dict, kernel_spec: tuple, bias_spec: tuple) -> dict:
        spec_layer = dict(spec_layer, kernel=kernel_spec)
        if "bias" in layer:
            spec_layer["bias"] = bias_spec
        return spec_layer

    lspecs = dict(specs["layers"])
    lspecs["qkv"] = split(lspecs["qkv"], layers["qkv"], col, col_bias)
    lspecs["proj"] = split(lspecs["proj"], layers["proj"], row_split, ())
    mspec = dict(lspecs["mlp"])
    mspec[col_name] = split(mspec[col_name], mlp[col_name], col, col_bias)
    mspec[row_name] = split(mspec[row_name], mlp[row_name], row_split, ())
    lspecs["mlp"] = mspec
    specs["layers"] = lspecs
    return params_tp, specs


def tp_prepare_dense_params(
    params: Any, config: DinoConfig, tp: int, axis: str = "model"
) -> tuple[Any, Any]:
    """The dense tree for the same forward: qkv's [q; k; v] sections and
    SwiGLU's [in1; in2] halves permuted as `tp_prepare_params` permutes
    them, split by `param_pspecs` (the JAX package's GSPMD specs). Returns
    (params_tp, specs); raises ValueError where the heads or a section do
    not split."""
    if config.num_attention_heads % tp:
        raise ValueError(
            f"{config.num_attention_heads} heads do not split over tp={tp}"
        )
    params_tp = _permute_dense(params, config, tp)
    return params_tp, param_pspecs(params_tp, axis)


def tp_restore_dense_params(params_tp: Any, config: DinoConfig, tp: int) -> Any:
    """The inverse of `tp_prepare_dense_params`'s permutation: a dense tree
    (or one of the same structure, such as an optimizer moment) back in the
    file's [q; k; v] and [in1; in2] order."""
    return _permute_dense(params_tp, config, tp, inverse=True)


def _permute_dense(params: Any, config: DinoConfig, tp: int, inverse: bool = False) -> Any:
    def perm(p: np.ndarray | None) -> np.ndarray | None:
        return np.argsort(p) if inverse and p is not None else p

    layers = dict(params["layers"])
    layers["qkv"] = _permute_linear(
        layers["qkv"], perm(_section_perm(3 * config.hidden_size, 3, tp)))
    col_name = _mlp_names(params)[0]
    mlp = dict(layers["mlp"])
    sections = 2 if col_name == "win" else 1
    mlp[col_name] = _permute_linear(
        mlp[col_name], perm(_section_perm(mlp[col_name]["kernel"].shape[2], sections, tp)))
    layers["mlp"] = mlp
    return dict(params, layers=layers)


def kernel_refusals(params_tp: Any) -> list[str]:
    """The split QuantLinear weights of one placed shard that the K7 kernel
    does not take (K/2 % 64 packed, K % 64 int8 SoA: ops/qmatmul_kernel.py),
    by name and (N, K). JAX's checks split at 32-blocks only; a card's
    route refuses these at construction rather than fall back."""
    from dinov2_tpu_torch.ops.qmatmul_kernel import K_TILE

    found = []
    layers = params_tp["layers"]
    for name, layer in [("qkv", layers["qkv"]), ("proj", layers["proj"]),
                        *((f"mlp.{k}", v) for k, v in layers["mlp"].items())]:
        ql = layer["kernel"]
        if not isinstance(ql, QuantLinear):
            continue
        k = ql.codes.shape[-1] * (2 if ql.packed else 1)
        if k % (2 * K_TILE if ql.packed else K_TILE):
            found.append(f"{name} ({ql.codes.shape[-2]}, {k})")
    return found


# ---------------------------------------------------------------------------
# The forward
# ---------------------------------------------------------------------------


def _attention_core(qkv: torch.Tensor, local_heads: int, head_dim: int,
                    opts: ModelOptions) -> torch.Tensor:
    b, t, three_dl = qkv.shape
    dl = three_dl // 3
    scale = 1.0 / (head_dim**0.5)
    path = resolve_attention_path(opts.flash_attention, t, qkv.dtype, head_dim, qkv.device.type)
    if path == "slab":
        from dinov2_tpu_torch.ops.fused_attention import slab_attention

        return slab_attention(qkv, local_heads, scale)
    q, k, v = split_heads(qkv, local_heads)
    if path == "flash":
        from dinov2_tpu_torch.ops.flash_attention import flash_attention

        return flash_attention(q, k, v, scale).reshape(b, t, dl)
    return vanilla_attention(q, k, v, scale).reshape(b, t, dl)


def _tp_attention_half(xs: list, layers: list, config: DinoConfig,
                       opts: ModelOptions, group: Group | None = None) -> list:
    """The attention half-layer over the shards of a 'model' group: xs[j]
    the (replicated) activations on shard j's device, layers[j] its
    weights (both None for another rank's shard, `group` the members).
    LN1, the shard's QKV columns, attention on its heads and its proj rows,
    then the psum, the proj bias, LayerScale and the residual."""
    head_dim = config.head_dim
    backend = opts.quant_backend
    parts = []
    for x, layer in zip(xs, layers):
        if x is None:
            parts.append(None)
            continue
        h = layer_norm(x, layer["norm1"], config.eps)
        qkv = apply_linear(h, layer["qkv"], backend=backend)  # (B, T, 3*D/S) local columns
        out = _attention_core(qkv, qkv.shape[-1] // 3 // head_dim, head_dim, opts)
        parts.append(apply_linear(out, {"kernel": layer["proj"]["kernel"]}, backend=backend))
    return [
        None if x is None else
        x + (att + layer["proj"]["bias"].to(att.dtype) if "bias" in layer["proj"] else att)
        * layer["ls1"].to(x.dtype)
        for x, att, layer in zip(xs, psum(parts, group), layers)
    ]


def _tp_mlp_parts(xs: list, layers: list, config: DinoConfig, opts: ModelOptions) -> list:
    """Each shard's partial MLP output (LN2, its fc1/win columns, its
    fc2/wout rows), before the sum over the group."""
    backend = opts.quant_backend
    parts = []
    for x, layer in zip(xs, layers):
        if x is None:
            parts.append(None)
            continue
        h = layer_norm(x, layer["norm2"], config.eps)
        mlp = layer["mlp"]
        if "win" in mlp:
            x1, x2 = apply_linear(h, mlp["win"], backend=backend).chunk(2, dim=-1)
            parts.append(apply_linear(F.silu(x1) * x2, {"kernel": mlp["wout"]["kernel"]},
                                      backend=backend))
        else:
            hh = apply_linear(h, mlp["fc1"], activation=opts.gelu_activation, backend=backend)
            parts.append(apply_linear(hh, {"kernel": mlp["fc2"]["kernel"]}, backend=backend))
    return parts


def _tp_mlp_residual(xs: list, ys: list, layers: list) -> list:
    """x + (the summed MLP output + its row bias) * LayerScale, per shard."""
    row = "wout" if "win" in next(w for w in layers if w is not None)["mlp"] else "fc2"
    return [
        None if x is None else
        x + (y + layer["mlp"][row]["bias"].to(y.dtype) if "bias" in layer["mlp"][row] else y)
        * layer["ls2"].to(x.dtype)
        for x, y, layer in zip(xs, ys, layers)
    ]


def _tp_encoder_layer(xs: list, layers: list, config: DinoConfig, opts: ModelOptions,
                      group: Group | None = None) -> list:
    """One encoder layer over the shards of a 'model' group: xs[j] the
    (replicated) activations on shard j's device, layers[j] its weights
    (None for another rank's shard, `group` the members)."""
    xs = _tp_attention_half(xs, layers, config, opts, group)
    return _tp_mlp_residual(xs, psum(_tp_mlp_parts(xs, layers, config, opts), group), layers)


def _slices(xs: list) -> list:
    """Shard j's token slice of its (B, T, D) activations (None stays None)."""
    bounds = token_slices(next(x for x in xs if x is not None).shape[1], len(xs))
    return [None if x is None else x.narrow(1, start, length)
            for x, (start, length) in zip(xs, bounds)]


def _tp_sequence_parallel_layer(slices: list, layers: list, config: DinoConfig,
                                opts: ModelOptions, group: Group | None = None) -> list:
    """One encoder layer with the residual stream held as token slices
    (Megatron-SP): the all-gather before LN1, the attention half-layer on
    every token, the reduce-scatter in place of the MLP's psum and the
    MLP residual on the slices."""
    xs = _tp_attention_half(all_gather_tokens(slices, group=group), layers, config, opts, group)
    ys = reduce_scatter_tokens(_tp_mlp_parts(xs, layers, config, opts), group=group)
    return _tp_mlp_residual(_slices(xs), ys, layers)


def _groups(mesh: Mesh, axis: str) -> tuple[str | None, int, list]:
    """(the data axis or None, its size, the positions of each 'data'
    slice's 'model' group, in 'model' order)."""
    data_axes = [a for a in mesh.axis_names if a != axis]
    data = data_axes[0] if data_axes else None
    n_data = mesh.shape[data] if data else 1
    groups = [
        [mesh.position({data: i, axis: j} if data else {axis: j}) for j in range(mesh.shape[axis])]
        for i in range(n_data)
    ]
    return data, n_data, groups


def make_tp_forward(config: DinoConfig, opts: ModelOptions, mesh: Mesh, axis: str = "model"):
    """Tensor-parallel forwards {classify: fn}, fn(placed, x) -> output dict
    as models/vit.py::forward gives it, on the mesh's first device.

    `placed` is parallel/mesh.py::place's list of the tree and specs that
    `tp_prepare_params` (or `tp_prepare_dense_params`) makes. The batch is split over the
    mesh's other axis when it has one ('data'), and each slice runs its
    layers over its 'model' group; the final LN and the head run on the
    group's first shard, and the slices are gathered in order. Numerics
    are the single-device forward's (same products in the same dtypes; the
    psums add partials in the compute dtype).

    On a mesh across ranks each rank runs its shards, the psums cross the
    ranks, and each rank takes the final LN and the head on its first shard
    of each group: the shards' activations are replicas, bit for bit, so
    every rank returns the same outputs. A 'data' axis across ranks raises
    (Mesh.require_local_slices)."""
    data, n_data, groups = _groups(mesh, axis)
    mesh.require_local_slices("make_tp_forward", data or "data")
    first = mesh.local_device
    members = [mesh.group(group) for group in groups]

    def run(classify: bool, placed: list, x: torch.Tensor) -> dict:
        if x.shape[0] % n_data:
            raise ValueError(f"batch {x.shape[0]} does not split over {data}={n_data}")
        rows = x.shape[0] // n_data
        tokens = []
        for i, group in enumerate(groups):
            part = x.narrow(0, i * rows, rows)
            tokens.append([None if placed[k] is None else
                           embed_tokens(placed[k], part.to(mesh.device(k)), config, opts)
                           for k in group])
        for index in range(config.num_hidden_layers):
            for i, group in enumerate(groups):
                tokens[i] = _tp_encoder_layer(
                    tokens[i], [None if placed[k] is None else _layer(placed[k]["layers"], index)
                                for k in group], config, opts, members[i])
        outs = []
        for i, group in enumerate(groups):
            own = next(j for j, k in enumerate(group) if placed[k] is not None)
            params = placed[group[own]]
            t = layer_norm(tokens[i][own].float(), params["final_norm"], config.eps)
            out = {
                "cls_token": t.select(1, 0),
                "patch_tokens": _tokens_from(t, 1 + config.num_register_tokens),
            }
            if classify:
                out["probs"] = forward_head(params, t, config, opts)
            outs.append(out)
        return {key: gather([o[key] for o in outs], first) for key in outs[0]}

    return {classify: (lambda placed, x, c=classify: run(c, placed, x)) for classify in (False, True)}


class _RematLayer(torch.autograd.Function):
    """`run(tensors)` without autograd in the forward, its inputs saved, and
    again with autograd in the backward for the gradients of every input
    (remat). A layer over several devices is remat'd so, not through
    torch.utils.checkpoint: the engine runs the backward of each device on
    its own thread, and checkpoint's non-reentrant recompute of one frame,
    reached from two of them at once, runs twice and fails its count of
    saved tensors; a Function's backward runs once."""

    @staticmethod
    def forward(ctx, run, *tensors):
        ctx.run = run
        ctx.save_for_backward(*tensors)
        with torch.no_grad():
            return tuple(run(tensors))

    @staticmethod
    @once_differentiable
    def backward(ctx, *grads):
        needs = ctx.needs_input_grad[1:]
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(need) for t, need in zip(ctx.saved_tensors, needs)]
            outs = ctx.run(inputs)
            got = iter(torch.autograd.grad(outs, [t for t in inputs if t.requires_grad], grads,
                                           allow_unused=True, materialize_grads=True))
        return (None, *(next(got) if need else None for need in needs))


def _remat_layer(layer_fn, xs: list, weights: list, config: DinoConfig,
                 opts: ModelOptions, group: Group | None = None) -> list:
    """layer_fn(xs, weights, config, opts, group) through _RematLayer, the
    weights' dense leaves passed as its inputs so that their gradients
    flow; another rank's shards (None) stay None."""
    mine = [j for j, x in enumerate(xs) if x is not None]
    leaves = [leaf for j in mine for leaf in tree_leaves(weights[j])]

    def run(flat):
        full = [None] * len(xs)
        for j, x in zip(mine, flat[:len(mine)]):
            full[j] = x
        rest = iter(flat[len(mine):])
        ws = [None if w is None else tree_map(lambda _: next(rest), w) for w in weights]
        out = layer_fn(full, ws, config, opts, group)
        return [out[j] for j in mine]

    outs = iter(_RematLayer.apply(run, *(xs[j] for j in mine), *leaves))
    return [None if x is None else next(outs) for x in xs]


def make_tp_train_forward(config: DinoConfig, opts: ModelOptions, mesh: Mesh,
                          axis: str = "model"):
    """The tensor-parallel training forward, fn(placed, xs) -> logits (B,
    classes) in f32 on the mesh's first device, differentiable on the
    placed leaves. `placed` is `place` of `tp_prepare_dense_params`'s tree
    and specs (the kernels on quantized weights refuse gradients); xs[k] is
    position k's preprocessed images, its 'data' slice of the batch
    (parallel/mesh.py::shard_batch).

    As `make_tp_forward`, each 'data' slice runs over its 'model' group,
    each shard embedding its slice, and the final LN and the head run on
    the group's first shard. Under `opts.remat` each layer of each group
    runs without keeping its activations and again in the backward
    (_RematLayer), so it launches its forward kernels twice a step. Under `opts.sequence_parallel`
    the residual stream between layers is held as token slices, shard j's
    slice `token_slices(T, S)[j]` (parallel/mesh.py), and gathered on the
    group's first shard after the last layer.

    On a mesh across ranks each rank runs its shards (None elsewhere in
    `placed` and xs), the head still runs on each group's first shard
    alone, and the logits of every slice are gathered on every rank
    (parallel/mesh.py::gather_to_every). A rank's shards that the head does
    not read (the others of a group that spans ranks) are the gather's
    tails: zero gradients reach them, so that their backward runs the
    collectives the head's shard waits for."""
    _, _, groups = _groups(mesh, axis)
    first = mesh.local_device
    members = [mesh.group(group) for group in groups]
    heads = mesh.group([group[0] for group in groups], everyone=True)
    layer_fn = _tp_sequence_parallel_layer if opts.sequence_parallel else _tp_encoder_layer

    def run(placed: list, xs: list) -> torch.Tensor:
        remat = opts.remat and torch.is_grad_enabled()
        tokens = []
        for group in groups:
            embedded = [None if placed[k] is None else embed_tokens(placed[k], xs[k], config, opts)
                        for k in group]
            tokens.append(_slices(embedded) if opts.sequence_parallel and any(
                e is not None for e in embedded) else embedded)
        for index in range(config.num_hidden_layers):
            for i, group in enumerate(groups):
                if all(placed[k] is None for k in group):
                    continue  # no shard of this rank's
                # the layer's weights are views of the stacked leaves, so
                # gradients land in those either way
                weights = [None if placed[k] is None else _layer(placed[k]["layers"], index)
                           for k in group]
                if remat:
                    tokens[i] = _remat_layer(layer_fn, tokens[i], weights, config, opts,
                                             members[i])
                else:
                    tokens[i] = layer_fn(tokens[i], weights, config, opts, members[i])
        logits, tails = [], []
        for i, group in enumerate(groups):
            t = tokens[i]
            if opts.sequence_parallel and members[i].process_group is not None:
                t = all_gather_tokens(t, group=members[i])
            elif opts.sequence_parallel and placed[group[0]] is not None:
                t = [gather(t, mesh.device(group[0]), dim=1)]
            if members[i].process_group is not None:
                tails += [x for x in t[1:] if x is not None]
            if placed[group[0]] is None:
                logits.append(None)
                continue
            params = placed[group[0]]
            t = layer_norm(t[0].float(), params["final_norm"], config.eps)
            logits.append(head_logits(params, t, config, opts))
        if not mesh.spans_ranks:
            return gather(logits, first)
        return gather_to_every(logits, heads, first, tails=tails)

    return run
