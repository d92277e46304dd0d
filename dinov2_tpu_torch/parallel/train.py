"""The training step (fine-tune / linear-probe DINOv2 classification): port of
dinov2_tpu/parallel/train.py for one device.

    trainer = make_trainer(config, learning_rate=1e-4, weight_decay=0.05)
    params, opt_state = trainer.place(params)
    params, opt_state, metrics = trainer.step(params, opt_state, images, labels)

One step is: uint8 images (B, H, W, 3) through `classify_preprocess` (in
the step unless `preprocess_in_step=False`), `forward_features` and
`head_logits`, the mean softmax cross-entropy and the accuracy, the backward,
and AdamW; `metrics` is {"loss", "accuracy"} as f32 scalars on the device.
The signatures and defaults are the JAX package's (`parity="hf"`, f32
compute, `remat=True`) plus an explicit `device`, "cuda" unless the caller
asks for the CPU. `mesh` must be None: the multi-device step
(parallel/mesh.py in the JAX package) is not ported, and anything else
raises.

`place` makes the parameters f32 master leaves that require grad on the
device (copies: the caller's tree is left alone) and the optimizer state
beside them. `step` updates both in place (PyTorch has no donation; the JAX
step donates its arguments, which comes to the same) and returns them.

The optimizer is a functional AdamW on `torch._foreach_*` ops, not
`torch.optim.AdamW`: it computes what `optax.adamw(lr, weight_decay=wd)`
computes, b1 0.9, b2 0.999, eps 1e-8, decay on every leaf, update
`-lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)`. `torch.optim.AdamW`
multiplies p by (1 - lr * wd) first and so differs by an `lr² * wd` cross
term. The state is {"count", "mu", "nu"}, the moments in the parameters'
tree.

On a card the compute dtype is bf16 (`ModelOptions(compute_dtype=
torch.bfloat16)`) over the f32 masters: the attention kernels take bf16
only, so f32 compute on CUDA reaches their NotImplementedError unless
`flash_attention=False` (the plain route); f32 kernels are listed in
ROADMAP.md. With `flash_attention=True` the attention core is the K4
`with_lse` forward and the K6 backward; on the slab route the forward is K1
(or K2, K3, K5 by `slab_fusion` and `fuse_mlp`) and the backward recomputes
through the plain versions (ops/fused_attention.py).
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


@dataclass
class Trainer:
    """Holds the train step and the placement of its state on one device."""

    config: DinoConfig
    opts: ModelOptions
    optimizer: AdamW
    mesh: Any = None
    tensor_parallel: bool = True
    preprocess_in_step: bool = True
    device: Any = "cuda"

    def __post_init__(self):
        if self.mesh is not None:
            raise NotImplementedError(
                "the multi-device training step (a 'data'/'model' mesh) is not ported to "
                "dinov2_tpu_torch yet (see ROADMAP.md, 'Modules to port'); pass mesh=None"
            )
        self.device = torch.device(self.device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "Trainer(device='cuda'): no CUDA device is available "
                    "(use device='cpu' for the plain PyTorch path)"
                )
            set_cuda_matmul_precision()

    def loss_fn(self, params, images: torch.Tensor, labels: torch.Tensor):
        """(mean cross-entropy, accuracy) of a batch on the device."""
        x = classify_preprocess(images) if self.preprocess_in_step else images
        tokens = forward_features(params, x, self.config, self.opts)
        logits = head_logits(params, tokens, self.config, self.opts)
        loss = F.cross_entropy(logits, labels)
        accuracy = (logits.argmax(dim=-1) == labels).float().mean()
        return loss, accuracy

    # ------------------------------------------------------------------
    def place(self, params):
        """The parameters as f32 master leaves that require grad on the
        device, and the optimizer state initialized beside them."""
        params = trainable_params(params, self.device)
        return params, self.optimizer.init(params)

    def shard_batch(self, images, labels):
        """Host arrays (or tensors) -> tensors on the device; labels int64."""
        def tensor(x):
            return x if torch.is_tensor(x) else torch.from_numpy(np.asarray(x))

        return tensor(images).to(self.device), tensor(labels).to(self.device, torch.int64)

    def step(self, params, opt_state, images, labels):
        """One training step; params and opt_state are updated in place and
        returned with {"loss", "accuracy"}."""
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
