"""AOT deployment artifacts (port of dinov2_tpu/runtime/aot.py): the traced
forward, serialized once, offline.

`export_forward` traces `models.vit.forward` with `torch.export` at one
fixed (batch, height, width) and writes it, with a self-describing JSON
header (model config, numerics options, shapes, torch version), into one
artifact. A serving host `load_artifact(path)`s it and calls it with the
weight tree: none of the model-building Python runs at load or at call
(models/vit.py is never imported), and the shape and dtype contract is
enforced by the program itself.

One program per platform, by default both "cuda" and "cpu", as the JAX
package lowers for "tpu" and "cpu". The attention routes depend on the
device (ops/attention.py), so each program is traced on fake tensors of its
own device (`FakeTensorMode`): a CPU-only build box writes the CUDA program.
The kernels are PyTorch operators (ops/_library.py), so the CUDA program
holds one `dinov2_tpu_torch::` node per kernel call, whose CUDA
implementation builds and launches the kernel at run time; the CPU program
holds the same nodes and runs their plain versions.

Weights are not embedded: the tree is the program's first input, a pytree
whose QuantLinear nodes (fused-quant artifacts) are registered under a
stable serialized name. Int8Linear weights (the W8A8 mode) are refused, as
the JAX package's artifacts refuse them.

Format, as the JAX package's: b"DAOT" magic, u8 version, u32 header length,
UTF-8 JSON header, payload. The payload is the platforms' programs, each a
`torch.export.save` file, at the offsets the header's "programs" gives from
the payload's start. `aot_info` reads a header without importing torch, and
reads the JAX package's headers too (and the JAX package's reads these);
`load_artifact` refuses a JAX artifact by its "kind".
"""

from __future__ import annotations

import io
import json
import struct
from dataclasses import asdict
from pathlib import Path

_MAGIC = b"DAOT"
_VERSION = 1
KIND = "dinov2_tpu_torch.forward"
JAX_KIND = "dinov2_tpu.forward"
PLATFORMS = ("cuda", "cpu")
QUANT_LINEAR_NAME = "dinov2_tpu_torch.models.params.QuantLinear"

_REGISTERED = False


def _register() -> None:
    """What a program needs before it is traced or loaded (idempotent): the
    kernels' operators (imported with their wrappers) and QuantLinear as a
    pytree node with a stable serialized name and context codec."""
    global _REGISTERED
    if _REGISTERED:
        return
    import torch.utils._pytree as pytree

    import dinov2_tpu_torch.ops.flash_attention  # noqa: F401  (the operators)
    import dinov2_tpu_torch.ops.fused_attention  # noqa: F401
    import dinov2_tpu_torch.ops.fused_quant_attention  # noqa: F401
    from dinov2_tpu_torch.models.params import QUANT_FIELDS, QuantLinear

    def flatten(ql):
        fields = tuple(ql.tensors())
        return [getattr(ql, f) for f in fields], (fields, ql.ggml_type, ql.shape, ql.packed)

    def unflatten(children, context):
        fields, ggml_type, shape, packed = context
        tensors = dict.fromkeys(QUANT_FIELDS) | dict(zip(fields, children))
        return QuantLinear(**tensors, ggml_type=ggml_type, shape=tuple(shape), packed=packed)

    def flatten_with_keys(ql):
        children, context = flatten(ql)
        return [(pytree.GetAttrKey(f), c) for f, c in zip(context[0], children)], context

    pytree.register_pytree_node(
        QuantLinear, flatten, unflatten,
        serialized_type_name=QUANT_LINEAR_NAME,
        to_dumpable_context=lambda c: [list(c[0]), int(c[1]), list(c[2]), bool(c[3])],
        from_dumpable_context=lambda c: (tuple(c[0]), c[1], tuple(c[2]), c[3]),
        flatten_with_keys_fn=flatten_with_keys,
    )
    _REGISTERED = True


def _opts_meta(opts) -> dict:
    d = asdict(opts)
    d["compute_dtype"] = str(opts.compute_dtype).removeprefix("torch.")
    return d


def _fake_like(params, device: str):
    """The weight tree as fake tensors on `device` (shape, stride and dtype
    kept), made under the caller's FakeTensorMode."""
    import torch

    from dinov2_tpu_torch.models.params import QuantLinear, tree_map

    def fake(t):
        return torch.empty_strided(t.shape, t.stride(), dtype=t.dtype, device=device)

    return tree_map(lambda leaf: leaf.map(fake) if isinstance(leaf, QuantLinear) else fake(leaf),
                    params)


def export_forward(
    params,
    config,
    opts,
    batch: int,
    height: int,
    width: int,
    classify: bool = True,
    platforms: tuple[str, ...] = PLATFORMS,
    extra_meta: dict | None = None,
) -> bytes:
    """Trace `models.vit.forward` at one static shape for each platform and
    return the serialized artifact bytes.

    Only the shapes, strides and dtypes of `params` are read (a tree on any
    device, or of meta tensors); the weights are NOT embedded, so an
    artifact is the size of its programs, not of the model."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from dinov2_tpu_torch.models.params import Int8Linear, tree_leaves
    from dinov2_tpu_torch.models.vit import forward

    if any(isinstance(leaf, Int8Linear) for leaf in tree_leaves(params)):
        raise ValueError(
            "export_forward: Int8Linear weights (quant_mode='int8', the W8A8 mode) do not export, "
            "as in the JAX package: load the checkpoint with quant_mode 'dequant' or 'fused'"
        )
    unknown = [p for p in platforms if p not in PLATFORMS]
    if unknown or not platforms:
        raise ValueError(f"platforms must be a non-empty subset of {PLATFORMS}, got {platforms}")
    _register()

    class Forward(torch.nn.Module):
        def forward(self, p, x):
            return forward(p, x, config, opts, classify=classify)

    blobs = []
    for platform in platforms:
        with FakeTensorMode():
            fake_params = _fake_like(params, platform)
            fake_x = torch.empty((batch, height, width, 3), dtype=torch.float32, device=platform)
        program = torch.export.export(Forward(), (fake_params, fake_x), strict=False)
        program.example_inputs = None  # fake tensors: nothing to keep
        buf = io.BytesIO()
        torch.export.save(program, buf)
        blobs.append(buf.getvalue())

    offsets = [sum(len(b) for b in blobs[:i]) for i in range(len(blobs))]
    header = {
        "kind": KIND,
        "model": {k: v for k, v in asdict(config).items() if not k.startswith("_")},
        "opts": _opts_meta(opts),
        "classify": classify,
        "input": {"batch": batch, "height": height, "width": width, "channels": 3},
        "platforms": list(platforms),
        "programs": {p: {"offset": o, "length": len(b)}
                     for p, o, b in zip(platforms, offsets, blobs)},
        "torch_version": torch.__version__,
    }
    if extra_meta:
        header.update(extra_meta)
    hbytes = json.dumps(header, sort_keys=True).encode("utf-8")
    return _MAGIC + struct.pack("<BI", _VERSION, len(hbytes)) + hbytes + b"".join(blobs)


def save_artifact(path: str | Path, data: bytes) -> None:
    Path(path).write_bytes(data)


def _parse_header(raw: bytes, name: str) -> tuple[dict, int]:
    """(header dict, offset of the payload) from artifact bytes."""
    if raw[:4] != _MAGIC:
        raise ValueError(f"{name}: not a dinov2-tpu AOT artifact (bad magic)")
    if len(raw) < 9:
        raise ValueError(f"{name}: truncated artifact (header prefix cut short)")
    version, hlen = struct.unpack_from("<BI", raw, 4)
    if version != _VERSION:
        raise ValueError(f"{name}: unsupported artifact version {version}")
    if len(raw) < 9 + hlen:
        raise ValueError(f"{name}: truncated artifact (header cut short)")
    return json.loads(raw[9 : 9 + hlen].decode("utf-8")), 9 + hlen


def aot_info(path: str | Path) -> dict:
    """Read an artifact's JSON header without importing torch (cheap
    inventory); a JAX package artifact's header too."""
    return _parse_header(Path(path).read_bytes(), str(path))[0]


class AotForward:
    """A loaded artifact: `meta` (the JSON header), `program(platform)` (its
    torch.export.ExportedProgram, deserialized at first use: deserializing
    is most of a load, so a call on the card never pays for the CPU
    program) and `__call__(params, x)`.

    A call runs the program of x's device type and raises where the artifact
    has none. x must be the header's (batch, height, width, 3) f32; anything
    else raises a ValueError, and a weight tree of another structure, shape
    or dtype raises from the program's own input checks: nothing is traced
    again (there is nothing to trace: each program is one fixed graph). On
    the card the CUDA matmul precision is set as DinoEngine sets it."""

    def __init__(self, meta: dict, blobs: dict[str, bytes]):
        self.meta = meta
        self._blobs = blobs
        self._programs: dict = {}
        self._modules: dict = {}

    def program(self, platform: str):
        if platform not in self._blobs:
            raise ValueError(f"the artifact has no program for {platform} "
                             f"(platforms {self.meta['platforms']})")
        if platform not in self._programs:
            import torch

            self._programs[platform] = torch.export.load(io.BytesIO(self._blobs[platform]))
        return self._programs[platform]

    def __call__(self, params, x):
        import torch

        device = x.device.type
        program = self.program(device)
        shape = tuple(self.meta["input"][k] for k in ("batch", "height", "width", "channels"))
        if tuple(x.shape) != shape or x.dtype != torch.float32:
            raise ValueError(f"the artifact takes a {shape} float32 input, got "
                             f"{tuple(x.shape)} {x.dtype}")
        if device == "cuda":
            from dinov2_tpu_torch.ops.qmatmul import set_cuda_matmul_precision

            set_cuda_matmul_precision()
        if device not in self._modules:
            self._modules[device] = program.module()
        return self._modules[device](params, x)


def load_artifact(path: str | Path) -> AotForward:
    """Read an artifact and register what its programs need (the operators,
    the QuantLinear pytree node); the programs deserialize at first use."""
    raw = Path(path).read_bytes()
    meta, payload = _parse_header(raw, str(path))
    kind = meta.get("kind")
    if kind == JAX_KIND:
        raise ValueError(
            f"{path}: a JAX package artifact (kind {JAX_KIND!r}, jax "
            f"{meta.get('jax_version')}): load it with dinov2_tpu.runtime.aot.load_artifact"
        )
    if kind != KIND:
        raise ValueError(f"{path}: not a {KIND!r} artifact (kind {kind!r})")
    blobs = {}
    for platform, where in meta["programs"].items():
        start, end = payload + where["offset"], payload + where["offset"] + where["length"]
        if end > len(raw):
            raise ValueError(f"{path}: truncated artifact (the {platform} program cut short)")
        blobs[platform] = raw[start:end]
    _register()
    return AotForward(meta, blobs)
