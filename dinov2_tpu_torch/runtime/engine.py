"""Inference engine: load -> classify / features / PCA (port of
dinov2_tpu/runtime/engine.py).

Batches are padded to a power of two (the JAX engine's bucket, which bounds
its jit cache; here it keeps the kernels' shapes to a few), preprocessed on
the device, and run through one forward.
  - classify: mixed-size images are preprocessed per size group and merged
    into one forward batch (all are 224x224 after the crop).
  - features: one forward per size group (the patch grid depends on the
    size, quirk Q4); cls_token and patch_tokens come back to the host.
  - PCA: preprocess, forward and a per-image PCA on the device, grid-sized
    u8 images back to the host, nearest-resized there to the input size.

`flash_attention` picks the attention route (ops/attention.py::
resolve_attention_path); "auto" takes K1 below 1024 tokens and K4 from
there on. A ggml-quantized checkpoint loads with `quant_mode` "dequant"
(dense weights decoded at load) or "fused" (the blocks stay on the device
and run through K8 and K7; `quant_slab` and `quant_backend` pick their
routes, models/vit.py). `slab_fusion` picks the level of the slab route
("layer" K1/K8, "proj" K2, "core" K3; "auto" is "layer") and `fuse_mlp` runs
the MLP half-layer as the K5 kernel (off by default). `device="cuda"` runs the CUDA kernels and needs a GPU: with none,
the constructor raises; it never falls back to the CPU. `device="cpu"` runs
the plain PyTorch versions.

Several devices (parallel/mesh.py; one process drives them all, as in the
JAX package): `mesh_axes`, e.g. {"data": 4, "model": 2}, shards the batch
on 'data' and the weights Megatron-style on 'model'; `data_parallel=True` is
a 'data' mesh over every card (no mesh with one). The routes are the JAX
engine's, with one test of "tensor-parallel" for every weight format:
'model' > 1 (JAX's fused-quant route takes its TP forward for any 'model'
axis, even of size 1, which the CLIs never build):
  - fused-quant weights under 'model' > 1: parallel/tp_fused.py's TP
    forward (K3/K4 on each shard's heads, K7 on its weight shards); heads
    that do not split over it, or a `tp_prepare_params` ValueError, log a
    warning and reload as quant_mode="dequant";
  - int8 weights under 'model' > 1 are replicated, with a warning;
  - dense weights under 'model' > 1: the same TP forward with plain PyTorch
    products (heads that do not split: a warning, replicated);
  - everything else: the single-device forward on each 'data' slice of the
    batch (parallel/mesh.py::shard_map_data_parallel).
Batches are padded to a multiple of the 'data' size. On "cuda" the mesh
takes the visible cards and raises when it needs more; on "cpu" it names
the CPU once per position (several shards on one device), as the JAX
package's tests use eight virtual host devices, and on a card named by its
index ("cuda:0") that card once per position
(parallel/mesh.py::mesh_devices). On a mesh the engine keeps
only the placed trees: the unsharded one (`loaded.params`) is dropped once
they are made, and no single-device `model` is built.

Across processes (parallel/mesh.py::init_distributed, the same program in
every rank): `mesh_axes={"model": n}` spans the ranks, each rank holds its
shards, the psums cross the ranks, and every rank returns the same
outputs. A 'data' axis larger than 1 whose slices lie on different ranks
raises a ValueError: their outputs would live on other processes, which the
JAX engine cannot fetch either.

Staging: every upload goes through one host buffer the engine keeps and
reuses (`_uploads`), pinned on a card and copied to it without blocking,
ordinary memory on the CPU. Each image is written once, from the caller's
array into its row of its size group's slice; each group then goes to the
device in one copy, so the card copies and preprocesses one group while the
host writes the next. The buffer grows only when a call needs more bytes
than it holds, and is rewritten only once the copies out of it have ended
(an event after the last one): `pca_visualization_async` returns while its
copy may still run. Padding rows never cross PCIe: a single-size batch is
padded to its bucket on the device by repeating its last row; mixed-size
classify preprocesses each group at its own row count and pads the merged
batch on the device. The forward sees the bucket-sized batch either way.

Host spans (utils/timing.py::span, on torch's profiler: they show exactly
when a profiler runs) name the engine's stages
`dinov2_tpu_torch.engine.<stage>`:
  - gather: grouping by size (no copy of the images);
  - upload: the wait for the staging buffer, the row writes into it and the
    copy to the device;
  - pad: the padding on the device (`_pad_rows`), once a call;
  - launch: preprocess, the groups' merge and the forward's launches, with
    upload and pad inside it;
  - fetch: slicing the outputs and copying them to the host (PCA: and the
    nearest resize there).
The synchronize that closes `last_compute_ms` lies outside every span.
`last_compute_ms` runs from the start of launch to the end of that
synchronize in every entry. Counters over the process, as the kernel
wrappers' `.launches`: `DinoEngine.uploaded_rows`, the rows sent to the
device; `DinoEngine.padded_rows`, the padding rows among them (none, since
the padding is made on the device); `DinoEngine.pinned_rows`, the rows sent
from pinned memory; `DinoEngine.staging_allocs`, the times a staging buffer
was allocated or grown.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from pathlib import Path
from typing import Any, Sequence

import numpy as np
import torch

from dinov2_tpu_torch.image.pca import pca_visualization_batch, resize_nearest_host
from dinov2_tpu_torch.image.preprocess import (
    classify_preprocess,
    feature_preprocess,
    feature_target_size,
)
from dinov2_tpu_torch.io.gguf import GGUFReader
from dinov2_tpu_torch.models.config import DinoConfig
from dinov2_tpu_torch.models.params import load_params
from dinov2_tpu_torch.models.vit import DinoViT, ModelOptions, forward
from dinov2_tpu_torch.ops.qmatmul import set_cuda_matmul_precision
from dinov2_tpu_torch.parallel.mesh import (
    first_local,
    make_mesh,
    mesh_devices,
    place,
    replicate,
    shard_map_data_parallel,
)
from dinov2_tpu_torch.utils.debug import check_finite
from dinov2_tpu_torch.utils.logging import get_logger, log_model_banner
from dinov2_tpu_torch.utils.timing import span, time_blocked


def _stage(name: str):
    """The engine's host span of stage `name`."""
    return span(f"dinov2_tpu_torch.engine.{name}")


def _bucket(n: int) -> int:
    """Round a batch up to a power of two (1, 2, 4, ...)."""
    b = 1
    while b < n:
        b *= 2
    return b


class DinoEngine:
    # over the process (as the kernel wrappers' `.launches`): rows _uploads
    # sent to the device, the padding rows among them (none: the padding is
    # made on the device), the rows sent from pinned memory, and the times a
    # staging buffer was allocated or grown
    uploaded_rows = 0
    padded_rows = 0
    pinned_rows = 0
    staging_allocs = 0

    def __init__(
        self,
        model_path: str | Path,
        dtype: torch.dtype = torch.bfloat16,
        parity: str = "reference",
        flash_attention="auto",
        device="cuda",
        quant_mode: str = "dequant",
        quant_slab: str = "auto",
        quant_backend: str = "auto",
        slab_fusion: str = "auto",
        fuse_mlp: bool = False,
        data_parallel: bool = False,
        mesh_axes: dict[str, int] | None = None,
    ):
        self.device = torch.device(device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "DinoEngine(device='cuda'): no CUDA device is available "
                    "(use device='cpu' for the plain PyTorch path)"
                )
            set_cuda_matmul_precision()
        self.opts = ModelOptions(
            parity=parity, flash_attention=flash_attention, compute_dtype=dtype,
            quant_slab=quant_slab, quant_backend=quant_backend,
            slab_fusion=slab_fusion, fuse_mlp=fuse_mlp,
        )
        tp = (mesh_axes or {}).get("model", 1)
        if quant_mode == "fused" and tp > 1:
            # Megatron TP x fused-quant runs via parallel/tp_fused.py when the
            # head count splits over the 'model' axis; otherwise dequant
            reader = GGUFReader(model_path)
            heads = DinoConfig.from_gguf_kv(reader.kv).num_attention_heads
            reader.close()
            if heads % tp:
                get_logger().warning("%d heads do not split over tp=%d; falling back to quant_mode='dequant'",
                      heads, tp)
                quant_mode = "dequant"
        self.mesh = None
        self._mesh_forward = None  # {classify: fn(placed, x)} on a mesh
        if mesh_axes is not None:
            self.mesh = make_mesh(mesh_axes, mesh_devices(
                self.device, int(np.prod(list(mesh_axes.values())))))
        elif data_parallel and self.device.type == "cuda" and torch.cuda.device_count() > 1:
            self.mesh = make_mesh()
        if self.mesh is not None:
            self.mesh.require_local_slices(f"DinoEngine(mesh_axes={self.mesh.shape})")
        self.loaded = load_params(model_path, dtype=dtype, device=self.device, quant_mode=quant_mode)
        self.config = self.loaded.config
        self.id2label = self.loaded.id2label
        if quant_mode == "fused" and self.loaded.quantized and tp > 1:
            from dinov2_tpu_torch.parallel.tp_fused import tp_prepare_params

            try:
                self._tensor_parallel(tp_prepare_params, tp)
            except ValueError as e:
                get_logger().warning("TP x fused-quant unavailable (%s); falling back to "
                      "quant_mode='dequant'", e)
                quant_mode = "dequant"
                self.loaded = load_params(model_path, dtype=dtype, device=self.device,
                                          quant_mode="dequant")
        if self._mesh_forward is None and tp > 1:
            if quant_mode == "int8":
                # no Megatron split for Int8Linear (the per-row scales
                # would need the codes' row/column split): replicate
                get_logger().warning("int8 weights are not tensor-parallel sharded; replicating over "
                      "the %d-way 'model' axis", tp)
            else:
                from dinov2_tpu_torch.parallel.tp_fused import tp_prepare_dense_params

                try:
                    self._tensor_parallel(tp_prepare_dense_params, tp)
                except ValueError as e:
                    get_logger().warning("dense TP unavailable (%s); replicating over the %d-way 'model' "
                          "axis", e, tp)
        if self.mesh is not None and self._mesh_forward is None:
            self._placed = replicate(self.loaded.params, self.mesh)
            self._mesh_forward = {
                classify: shard_map_data_parallel(
                    partial(forward, config=self.config, opts=self.opts, classify=classify),
                    self.mesh,
                )
                for classify in (False, True)
            }
        if self.mesh is None:
            self.model = DinoViT(self.loaded.params, self.config, self.opts)
        else:
            # the placed trees hold every weight the mesh runs: keeping the
            # unsharded tree too would hold all of it on the first card
            self.model = None
            self.loaded = dataclasses.replace(self.loaded, params=None)
        log_model_banner(self.config, str(model_path))
        self.last_compute_ms = 0.0
        # the host buffer of every upload (pinned on a card), and the event
        # after the last copy out of it
        self._staging: torch.Tensor | None = None
        self._staged: torch.cuda.Event | None = None

    def _tensor_parallel(self, prepare, tp: int) -> None:
        """The TP route: the loaded tree prepared for a tp-way split, placed
        on the mesh, and the TP forward. On a card, a split weight that K7
        does not take raises here (parallel/tp_fused.py::kernel_refusals)."""
        from dinov2_tpu_torch.parallel.tp_fused import kernel_refusals, make_tp_forward

        params_tp, specs = prepare(self.loaded.params, self.config, tp)
        placed = place(params_tp, self.mesh, specs)
        refused = kernel_refusals(first_local(placed))
        if refused and self.device.type == "cuda" and self.opts.quant_backend != "dequant":
            raise NotImplementedError(
                f"tp={tp}: the K7 kernel does not take the weight shards {refused} "
                "(it needs K % 64 == 0, K/2 % 64 == 0 packed)"
            )
        self._placed = placed
        self._mesh_forward = make_tp_forward(self.config, self.opts, self.mesh)

    def _forward(self, x: torch.Tensor, classify: bool) -> dict[str, torch.Tensor]:
        """The single-device forward, or the mesh's (TP or data-parallel)."""
        if self._mesh_forward is not None:
            return self._mesh_forward[classify](self._placed, x)
        return self.model(x, classify=classify)

    def _target_batch(self, n: int) -> int:
        """The bucket (a power of two), rounded up to a multiple of the mesh's
        'data' size: the batch is split on 'data' only (a pure 'model' mesh
        takes it whole)."""
        bucket = _bucket(n)
        if self.mesh is not None:
            mult = self.mesh.shape.get("data", 1)
            bucket = -(-max(bucket, mult) // mult) * mult
        return bucket

    # ------------------------------------------------------------------
    @staticmethod
    def _same_size(images) -> Sequence[np.ndarray]:
        """Same-size RGB images, (B, H, W, 3) or a list of (H, W, 3), as a
        sequence of rows; one (H, W, 3) image is a batch of one."""
        if isinstance(images, np.ndarray) and images.ndim == 3:
            images = images[None]
        shapes = {np.shape(img) for img in images}
        if len(shapes) != 1 or len(shape := shapes.pop()) != 3 or shape[-1] != 3:
            raise ValueError("expected RGB images (B, H, W, 3) of one size")
        return images

    @staticmethod
    def _group_by_shape(images) -> list[tuple[list[int], list[np.ndarray]]]:
        """Group images by (H, W): one preprocess per size group."""
        if isinstance(images, np.ndarray):
            images = [images] if images.ndim == 3 else list(images)
        groups: dict[tuple[int, int], list[int]] = {}
        for i, img in enumerate(images):
            groups.setdefault((img.shape[0], img.shape[1]), []).append(i)
        return [(idxs, [images[i] for i in idxs]) for idxs in groups.values()]

    @staticmethod
    def _pad_rows(batch: torch.Tensor, target: int) -> torch.Tensor:
        """Pad a device batch to `target` rows by repeating its last row."""
        if target == batch.shape[0]:
            return batch
        return torch.cat([batch, batch[-1:].expand(target - batch.shape[0], *batch.shape[1:])])

    def _padded(self, batch: torch.Tensor, target: int) -> torch.Tensor:
        with _stage("pad"):
            return self._pad_rows(batch, target)

    def _staging_slices(self, batches) -> list[torch.Tensor]:
        """Each batch's (B, H, W, C) slice of the staging buffer, once no copy
        out of it is in flight; the buffer grows when they need more bytes
        than it holds. Slices start at 64-byte boundaries, so that each can
        take its batch's dtype."""
        if self._staged is not None:
            self._staged.synchronize()
            self._staged = None
        layouts, end = [], 0  # (offset, bytes, dtype, shape) of each slice
        for batch in batches:
            dtype = np.result_type(*{np.asarray(img).dtype for img in batch})
            shape = (len(batch), *np.shape(batch[0]))
            nbytes = int(np.prod(shape)) * dtype.itemsize
            layouts.append((end, nbytes, torch.from_numpy(np.empty(0, dtype)).dtype, shape))
            end += -(-nbytes // 64) * 64
        if self._staging is None or self._staging.numel() < end:
            # dropped first: torch's pinned cache, which rounds blocks to powers
            # of two, hands the old block out again where it is large enough
            self._staging = None
            self._staging = torch.empty(end, dtype=torch.uint8,
                                        pin_memory=self.device.type == "cuda")
            DinoEngine.staging_allocs += 1
        return [self._staging[lo:lo + nbytes].view(dtype).view(shape)
                for lo, nbytes, dtype, shape in layouts]

    def _uploads(self, batches):
        """Same-size host batches -> their tensors on the device, one at a
        time: batch k is written into its staging slice and its copy queued
        when the caller asks for it, so the device copies and preprocesses
        batch k while the host writes batch k + 1. Each image is copied once,
        into its row; the copy does not block the host on a card."""
        with _stage("upload"):
            slices = self._staging_slices(batches)
        pinned = self._staging.is_pinned()
        for batch, rows in zip(batches, slices):
            with _stage("upload"):
                host = rows.numpy()
                for i, img in enumerate(batch):
                    host[i] = img
                x = rows.to(self.device, non_blocking=pinned, copy=True)
                if pinned:  # on the stream the copy went to: self.device's
                    self._staged = torch.cuda.Event()
                    self._staged.record(torch.cuda.current_stream(self.device))
            DinoEngine.uploaded_rows += len(batch)
            DinoEngine.pinned_rows += len(batch) if pinned else 0
            yield x

    def _upload(self, batch, rows: int) -> torch.Tensor:
        """One same-size host batch -> its device tensor padded to `rows`."""
        (x,) = self._uploads([batch])
        return self._padded(x, rows)

    def _feature_grid(self, batch) -> tuple[int, int]:
        """The quirk-Q4 patch grid of same-size (H, W, 3) images."""
        p = self.config.patch_size
        h, w, _ = np.shape(batch[0])
        th, tw = feature_target_size(h, w, p)
        return th // p, tw // p

    # ------------------------------------------------------------------
    def classify(
        self, images: Sequence[np.ndarray] | np.ndarray, topk: int = 5
    ) -> list[list[tuple[str, float]]]:
        """RGB uint8 images -> per-image top-k (label, prob)."""
        out = []
        for row in self.classify_probs(images):
            idx = np.argsort(row)[::-1][:topk]
            out.append(
                [(self.id2label.get(int(i), str(int(i))), float(row[i])) for i in idx]
            )
        return out

    def classify_probs(self, images) -> np.ndarray:
        """RGB uint8 images, (B, H, W, 3) or a list of mixed sizes ->
        (B, num_classes) f32 probabilities."""
        if not self.loaded.has_classifier:
            raise ValueError("checkpoint has no classifier head")
        with _stage("gather"):
            groups = self._group_by_shape(images)
        if not groups:
            return np.zeros((0, self.config.num_classes), dtype=np.float32)

        @torch.inference_mode()
        def run():
            with _stage("launch"):
                if len(groups) == 1:
                    idxs, batch = groups[0]
                    pre = classify_preprocess(self._upload(batch, self._target_batch(len(idxs))))
                    return self._forward(pre, classify=True), len(idxs)
                # each group preprocessed at its own rows, the merge padded
                order, parts = [], []
                for (idxs, _), x in zip(groups, self._uploads([b for _, b in groups])):
                    order.extend(idxs)
                    parts.append(classify_preprocess(x))
                inv = torch.from_numpy(np.argsort(np.asarray(order))).to(self.device)
                pre = torch.cat(parts)[inv]
                n = pre.shape[0]
                return self._forward(self._padded(pre, self._target_batch(n)), classify=True), n

        (out, n), ms = time_blocked(run, device=self.device)
        self.last_compute_ms = ms
        check_finite(out, "classify:")
        with _stage("fetch"):
            return out["probs"][:n].cpu().numpy()

    # ------------------------------------------------------------------
    def extract_features(self, images) -> dict[str, Any]:
        """Feature mode: preprocess (patch-multiple resize), forward, return
        cls_token (B, D) and patch_tokens (B, N, D) as f32 host arrays, and
        the patch grid.

        Images must share one size (the patch grid is shape-defining); use
        extract_features_mixed for a mixed-size list."""
        with _stage("gather"):
            batch = self._same_size(images)
        n = len(batch)

        @torch.inference_mode()
        def run():
            with _stage("launch"):
                x = self._upload(batch, self._target_batch(n))
                pre = feature_preprocess(x, self.config.patch_size)
                return self._forward(pre, classify=False)

        out, ms = time_blocked(run, device=self.device)
        self.last_compute_ms = ms
        check_finite(out, "features:")
        with _stage("fetch"):
            return {
                "cls_token": out["cls_token"][:n].cpu().numpy(),
                "patch_tokens": out["patch_tokens"][:n].cpu().numpy(),
                "grid": self._feature_grid(batch),
            }

    def extract_features_mixed(self, images) -> list[dict[str, Any]]:
        """Mixed-size feature extraction: one batched forward per (H, W) group;
        per-image dicts in the input order (grids differ per size)."""
        with _stage("gather"):
            groups = self._group_by_shape(images)
        results: list[dict[str, Any] | None] = [None] * sum(len(i) for i, _ in groups)
        for idxs, batch in groups:
            feats = self.extract_features(batch)
            for row, i in enumerate(idxs):
                results[i] = {
                    "cls_token": feats["cls_token"][row],
                    "patch_tokens": feats["patch_tokens"][row],
                    "grid": feats["grid"],
                }
        return results  # type: ignore[return-value]

    # ------------------------------------------------------------------
    @torch.inference_mode()
    def _pca_grid(self, x: torch.Tensor, grid: tuple[int, int]) -> torch.Tensor:
        """Device batch (B, H, W, 3) -> (B, gh, gw, 3) uint8 PCA images on the
        device: preprocess, forward, per-image PCA at the patch grid's size."""
        pre = feature_preprocess(x, self.config.patch_size)
        out = self._forward(pre, classify=False)
        return pca_visualization_batch(out["patch_tokens"], grid)

    def _pca_batch(self, batch) -> np.ndarray:
        """Same-size images (B, H, W, 3) -> (B, H, W, 3) uint8 PCA images at the
        input size: the device returns the grid (a ~p² smaller copy) and the
        host nearest-resizes it, as the reference does."""
        n = len(batch)
        h, w, _ = np.shape(batch[0])
        vis, ms = time_blocked(self._launch_pca, batch, device=self.device)
        self.last_compute_ms = ms
        with _stage("fetch"):
            return resize_nearest_host(vis[:n].cpu().numpy(), h, w)

    def _launch_pca(self, batch) -> torch.Tensor:
        """Upload a host batch and queue its PCA grid (`_pca_grid`)."""
        with _stage("launch"):
            x = self._upload(batch, self._target_batch(len(batch)))
            return self._pca_grid(x, self._feature_grid(batch))

    def pca_visualization(self, image: np.ndarray) -> np.ndarray:
        """One RGB image -> uint8 PCA visualization at the image's size."""
        return self._pca_batch(self._same_size(np.asarray(image)))[0]

    def pca_visualization_async(self, image: np.ndarray) -> torch.Tensor:
        """Queue one frame's preprocess + forward + PCA without waiting for the
        device; returns the (bucket, gh, gw, 3) uint8 tensor on the device
        (row 0 is the frame; `.cpu()` waits). The caller can decode the next
        frame meanwhile."""
        with _stage("gather"):
            batch = self._same_size(image)
        return self._launch_pca(batch)

    def pca_visualizations(self, images) -> list[np.ndarray]:
        """Mixed-size images -> per-image uint8 PCA visualizations: one
        preprocess + forward + batched PCA per (H, W) group."""
        with _stage("gather"):
            groups = self._group_by_shape(images)
        out: list[np.ndarray | None] = [None] * sum(len(i) for i, _ in groups)
        for idxs, batch in groups:
            vis = self._pca_batch(batch)
            for row, i in enumerate(idxs):
                out[i] = vis[row]
        return out  # type: ignore[return-value]

    # ------------------------------------------------------------------
    def warmup(self, image_hw: tuple[int, int], batch: int = 1, classify: bool = True):
        """Run one batch of the given input size (builds the kernel libraries
        and warms the caching allocator): classify when asked and the
        checkpoint has a head, features otherwise."""
        dummy = np.zeros((batch, *image_hw, 3), dtype=np.uint8)
        if classify and self.loaded.has_classifier:
            self.classify_probs(dummy)
        else:
            self.extract_features(dummy)
