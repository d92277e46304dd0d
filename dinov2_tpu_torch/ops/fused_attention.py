"""The slab kernels K1, K2, K3 and K5 (port of
dinov2_tpu/ops/fused_attention.py).

    slab_layer_block(x, ...)      = x + ls1 * (proj(attention(qkv(LN1 x))) + b_proj)   K1
    slab_attention_block(x, qkv, ...) = x + ls1 * (attention(qkv) @ w_proj + b_proj)   K2
    slab_attention(qkv, ...)      = attention(qkv), (B, T, 3D) -> (B, T, D)            K3
    slab_mlp_block(x, ...)        = x + ls2 * (fc2(act(fc1(LN2 x) + b1)) + b2)         K5

On a CUDA tensor each launches its hand-written kernel (csrc/slab_layer.cu,
csrc/slab_attention.cu for K2 and K3, csrc/slab_mlp.cu), which replace the
Pallas TPU kernels `_slab_layer_kernel`, `_slab_proj_kernel`, `_slab_kernel`
and `_slab_mlp_kernel`/`_slab_mlp_flat_kernel` of
`dinov2_tpu/ops/fused_attention.py`. Each takes bf16 and f32 activations
(f32: the f32 entries of the same sources, f32-accurate products: the
GEMMs 3xTF32 on the tensor cores, csrc/tf32x3_gemm.cuh, on the weights'
TF32 planes split into a scratch each call, the attention 3xTF32 too,
csrc/f32_attention.cuh); anything else raises. On a CPU tensor
each runs its plain PyTorch version (`slab_layer_reference`,
`_slab_block_reference`, `_slab_reference`, `slab_mlp_reference`), which
keeps the JAX package's unfused ordering. Every wrapper counts its calls
that launch kernels in `.launches` for bf16 and `.f32_launches` for f32
(one a call, however many launches the entry makes). Each dispatches through its PyTorch operator
(`dinov2_tpu_torch::slab_layer_block`, `::slab_attention_block`,
`::slab_attention`, `::slab_mlp_block`; ops/_library.py), whose CUDA
implementation is the launch and whose CPU implementation is the plain
version, so `torch.export` traces each call as one node. What bounds K2, K3
and K5 on the card is in their sources' notes.

What bounds K1 on an H100, at the main path's shape (B=64, T=257,
D=768, H=12): ~91 GFLOP per call (58 in the QKV GEMM, 19 in proj, 13 in
attention), 1.1 of the forward's 2.9 TFLOP over 12 layers. It runs in four
launches: LN1 of every row, the QKV GEMM and the proj GEMM with the
bias/LayerScale/residual epilogue on a pipelined wgmma GEMM core
(csrc/wgmma_gemm.cuh), and between them the flash-attention tile loop on the
slab's head views (csrc/flash_forward.cuh), which is K3's kernel and K4's.
It writes and re-reads LN1's rows, the 76 MB qkv slab and the 25 MB attention
output in HBM each call, which the TPU kernel keeps on chip: later work
(ROADMAP.md). K5 is three launches on the same blocks (in f32 five, each
GEMM behind the split of its weight), the activation in fc1's epilogue:
LN2 of every row, fc1 with the activation epilogue into an (M, 4D) hidden
buffer in HBM, and fc2 with the bias/LayerScale/residual epilogue.

The kernel's softmax takes the exact running row max, so the JAX package's
CLS-shift overflow rescue has no counterpart here.

Gradients, as the JAX functions' custom_vjp: where an input requires grad,
each wrapper runs as a `torch.autograd.Function` whose forward is the same
dispatch (kernel on a card, plain version on the CPU) and which saves its
inputs. K1, K2 and K5 recompute: the backward is autograd through the plain
version under `torch.enable_grad()` (`_slab_layer_bwd`, `_slab_block_bwd`,
`_slab_mlp_bwd` there). K3's backward (`slab_attention_backward`, the JAX
`_slab_bwd_fn`) recomputes through the plain attention below
`SLAB_BWD_FLASH_MIN_T` tokens and through `flash_attention_slab` from there
on: the K4 `with_lse` forward and the K6 backward, with no (T, T) tensor in
HBM. In f32 those routes reach the f32 kernels. The kernels take weights in
x's dtype and training holds f32 masters: the wrappers cast weights to x's
dtype on the way in (no copy in f32), the plain versions cast inside the
differentiated function, so every gradient comes back in its input's own
dtype.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from dinov2_tpu_torch.ops._library import check_device, count_launch, define
from dinov2_tpu_torch.ops.attention import KERNEL_DTYPES, split_heads, vanilla_attention
from dinov2_tpu_torch.ops.qmatmul import apply_activation, needs_grad
from dinov2_tpu_torch.ops.qmatmul_kernel import ACTIVATIONS


def _slab_reference(qkv: torch.Tensor, num_heads: int, scale: float) -> torch.Tensor:
    """(B, T, 3D) qkv slab -> (B, T, D) attention output, plain."""
    b, t, three_d = qkv.shape
    q, k, v = split_heads(qkv, num_heads)
    return vanilla_attention(q, k, v, scale).reshape(b, t, three_d // 3)


def _slab_block_reference(x, qkv, w_proj, b_proj, ls1, num_heads, scale):
    """Attention core, then proj (f32 accumulate, cast), + bias, x LayerScale,
    + residual, each in x's dtype."""
    out = _slab_reference(qkv, num_heads, scale)
    y = torch.matmul(out, w_proj.to(out.dtype)).to(x.dtype) + b_proj.to(x.dtype)
    return x + y * ls1.to(x.dtype)


def slab_layer_reference(
    x, ln_scale, ln_bias, w_qkv, b_qkv, w_proj, b_proj, ls1, num_heads, scale, eps
):
    """The plain PyTorch version of K1: f32 LN statistics and affine, one cast;
    QKV matmul accumulated in f32 and cast before the bias add; then the
    attention block above."""
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(dim=-1, keepdim=True)
    h = ((x32 - mu) * torch.rsqrt(var + eps) * ln_scale + ln_bias).to(x.dtype)
    qkv = torch.matmul(h, w_qkv.to(h.dtype)).to(h.dtype) + b_qkv.to(h.dtype)
    return _slab_block_reference(x, qkv, w_proj, b_proj, ls1, num_heads, scale)


def slab_mlp_reference(x, ln_scale, ln_bias, w1, b1, w2, b2, ls2, activation, eps):
    """The plain PyTorch version of K5: f32 LN statistics and affine, one
    cast; fc1 accumulated in f32 and cast before the bias add; the activation
    in x's dtype; fc2 likewise; LayerScale and residual in x's dtype."""
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(dim=-1, keepdim=True)
    h = ((x32 - mu) * torch.rsqrt(var + eps) * ln_scale + ln_bias).to(x.dtype)
    a1 = torch.matmul(h, w1.to(h.dtype)).to(h.dtype) + b1.to(h.dtype)
    g = apply_activation(a1, activation)
    y = torch.matmul(g, w2.to(h.dtype)).to(x.dtype) + b2.to(x.dtype)
    return x + y * ls2.to(x.dtype)


class _RecomputeFunction(torch.autograd.Function):
    """forward = `launch(*tensors)` (the wrapper's own dispatch, run without
    grad), inputs saved; backward = autograd through `reference(*tensors)`,
    the plain version, recomputed under enable_grad. Runs on any device."""

    @staticmethod
    def forward(ctx, launch, reference, *tensors):
        ctx.reference = reference
        ctx.save_for_backward(*tensors)
        return launch(*tensors)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        needs = ctx.needs_input_grad[2:]
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(need) for t, need in zip(ctx.saved_tensors, needs)]
            out = ctx.reference(*inputs)
            grads = iter(torch.autograd.grad(out, [t for t in inputs if t.requires_grad], g))
        return (None, None, *(next(grads) if need else None for need in needs))


# K3's backward goes through flash attention (the K4 `with_lse` forward and
# K6) from this many tokens on, and recomputes through the plain attention
# below it. Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 (700 W),
# one backward (recompute and gradient) in bf16, in two runs: at B=32, T=257,
# H=12 plain 1.53 and 1.54 ms against flash 0.79 and 0.46 ms; at B=8, T=1370,
# H=16 plain 9.31 and 9.34 ms against flash 2.63 and 2.62 ms. The flash route
# wins at both (the JAX package's 512 was a TPU crossover), so the threshold
# sits just under the shortest sequence it was measured at; below that the
# plain recompute's (T, T) tensors are small and its gradients are those of
# the reference math, bit for bit.
SLAB_BWD_FLASH_MIN_T = 256
SLAB_BWD_ROUTES = ("auto", "plain", "flash")


def slab_attention_backward(
    qkv: torch.Tensor, g: torch.Tensor, num_heads: int, scale: float, route: str = "auto"
) -> torch.Tensor:
    """The gradient of slab_attention(qkv) for an output gradient g, as one
    (B, T, 3D) slab: "plain" recomputes through `_slab_reference`, "flash"
    through `flash_attention_slab` (K4 with lse and K6 on a card, their plain
    versions on the CPU); "auto" takes "flash" from SLAB_BWD_FLASH_MIN_T
    tokens on."""
    if route not in SLAB_BWD_ROUTES:
        raise ValueError(f"route must be one of {SLAB_BWD_ROUTES}, got {route!r}")
    if route == "auto":
        route = "flash" if qkv.shape[1] >= SLAB_BWD_FLASH_MIN_T else "plain"
    with torch.enable_grad():
        slab = qkv.detach().requires_grad_(True)
        if route == "flash":
            from dinov2_tpu_torch.ops.flash_attention import flash_attention_slab

            out = flash_attention_slab(slab, num_heads, scale)
        else:
            out = _slab_reference(slab, num_heads, scale)
        (d_qkv,) = torch.autograd.grad(out, slab, g)
    return d_qkv


class _SlabAttention(torch.autograd.Function):
    """slab_attention with the backward of `slab_attention_backward`."""

    @staticmethod
    def forward(ctx, qkv, num_heads, scale):
        ctx.save_for_backward(qkv)
        ctx.num_heads, ctx.scale = num_heads, scale
        return _slab_attention_forward(qkv, num_heads, scale)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        (qkv,) = ctx.saved_tensors
        return slab_attention_backward(qkv, g, ctx.num_heads, ctx.scale), None, None


def _check_tensors(x: torch.Tensor, expected: dict, aligned: bool = True) -> None:
    """Every named (tensor, shape, dtype) has that shape and dtype, lies on
    x's device, is contiguous and, unless `aligned` is False (a tensor with
    no storage: the operators' fake implementations), 16-byte aligned; x
    too."""
    for name, (tensor, shape, dtype) in expected.items():
        if tuple(tensor.shape) != shape or tensor.dtype != dtype:
            raise ValueError(
                f"{name}: expected {shape} {dtype}, got {tuple(tensor.shape)} {tensor.dtype}"
            )
    for name, tensor in (("x", x), *((n, v[0]) for n, v in expected.items())):
        if tensor.device != x.device:
            raise ValueError(f"{name} is on {tensor.device}, x on {x.device}")
        if not tensor.is_contiguous() or (aligned and tensor.data_ptr() % 16):
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _check_kernel_dtype_head64(x: torch.Tensor, d: int, num_heads: int, what: str) -> None:
    """The attention kernels take bf16 or f32 (B, T, .) with head_dim 64."""
    if x.dtype not in KERNEL_DTYPES:
        raise NotImplementedError(
            f"the CUDA {what} kernel takes bf16 or f32 activations, got {x.dtype}"
        )
    if x.dim() != 3:
        raise ValueError(f"{what}: expected a (B, T, .) tensor, got {tuple(x.shape)}")
    if d != 64 * num_heads:
        raise NotImplementedError(
            f"the CUDA {what} kernel needs head_dim 64, got D={d}, H={num_heads}"
        )


def f32_weight_scratch(x: torch.Tensor, floats: int) -> list:
    """What an f32 C entry that multiplies by dense weights takes last: a
    scratch of `floats` f32 for their TF32 planes (one weight's (2, N, K)
    at a time, csrc/tf32x3_gemm.cuh); nothing for bf16 x. The caller holds
    the list until its launch has been issued and passes the pointers."""
    if x.dtype != torch.float32:
        return []
    return [torch.empty((floats,), dtype=torch.float32, device=x.device)]


def check_half_layer_args(
    x, ln_scale, ln_bias, b_qkv, b_proj, ls1, num_heads, w_qkv=None, w_proj=None,
    aligned: bool = True,
):
    """What the CUDA half-layer kernels (K1, and K8 with quantized weights)
    take: bf16 or f32 x (B, T, D) with head_dim 64 and f32 rows; the dense
    (in, out) weights in x's dtype too where they are given. `aligned`: as
    `_check_tensors`."""
    _check_kernel_dtype_head64(x, x.shape[-1], num_heads, "half-layer")
    d = x.shape[-1]
    expected = {
        "ln_scale": (ln_scale, (d,), torch.float32),
        "ln_bias": (ln_bias, (d,), torch.float32),
        "b_qkv": (b_qkv, (3 * d,), torch.float32),
        "b_proj": (b_proj, (d,), torch.float32),
        "ls1": (ls1, (d,), torch.float32),
    }
    if w_qkv is not None:
        expected["w_qkv"] = (w_qkv, (d, 3 * d), x.dtype)
        expected["w_proj"] = (w_proj, (d, d), x.dtype)
    _check_tensors(x, expected, aligned)


def slab_layer_block(
    x: torch.Tensor,
    ln_scale: torch.Tensor,
    ln_bias: torch.Tensor,
    w_qkv: torch.Tensor,
    b_qkv: torch.Tensor,
    w_proj: torch.Tensor,
    b_proj: torch.Tensor,
    ls1: torch.Tensor,
    num_heads: int,
    scale: float,
    eps: float,
) -> torch.Tensor:
    """x + ls1 * proj(attention(qkv(LN(x)))): x (B, T, D); w_qkv (D, 3D) and
    w_proj (D, D) stored (in, out); ln_scale, ln_bias, b_proj, ls1 (D,) and
    b_qkv (3D,) in f32.

    CPU tensors run the plain version. CUDA tensors launch the K1 kernel
    (bf16 or f32 activations; anything else raises; weights are cast to x's
    dtype) and add one to `slab_layer_block.launches` (bf16) or
    `.f32_launches` (f32). Both go through the
    operator `dinov2_tpu_torch::slab_layer_block` (ops/_library.py). Where
    an input requires grad the result carries the recompute gradient of the
    module docstring."""
    tensors = (x, ln_scale, ln_bias, w_qkv, b_qkv, w_proj, b_proj, ls1)
    if needs_grad(*tensors):
        return _RecomputeFunction.apply(
            lambda *a: slab_layer_block(*a, num_heads, scale, eps),
            lambda *a: slab_layer_reference(*a, num_heads, scale, eps),
            *tensors,
        )
    check_device(x, "slab_layer_block")
    return _SLAB_LAYER_OP(*tensors, num_heads, scale, eps)


def _slab_layer_cuda(x, ln_scale, ln_bias, w_qkv, b_qkv, w_proj, b_proj, ls1, num_heads, scale,
                     eps):
    """The K1 launch, weights cast to x's dtype."""
    return slab_layer_buffers(
        x, ln_scale, ln_bias, w_qkv.to(x.dtype), b_qkv, w_proj.to(x.dtype), b_proj, ls1,
        num_heads, scale, eps,
    )[0]


def _slab_layer_fake(x, ln_scale, ln_bias, w_qkv, b_qkv, w_proj, b_proj, ls1, num_heads, scale,
                     eps):
    if x.device.type == "cuda":
        check_half_layer_args(x, ln_scale, ln_bias, b_qkv, b_proj, ls1, num_heads,
                              w_qkv.to(x.dtype), w_proj.to(x.dtype), aligned=False)
    return torch.empty_like(x, memory_format=torch.contiguous_format)


def slab_layer_buffers(
    x, ln_scale, ln_bias, w_qkv, b_qkv, w_proj, b_proj, ls1, num_heads, scale, eps
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The K1 launch on CUDA tensors with its two scratch buffers kept:
    (out, the (B, T, 3D) qkv slab, the (B, T, D) attention output). The
    checks that hold K2 and K3 against K1 on K1's own slab read them."""
    check_half_layer_args(x, ln_scale, ln_bias, b_qkv, b_proj, ls1, num_heads, w_qkv, w_proj)
    from dinov2_tpu_torch.ops._kernels import check_status, entry, slab_layer_lib

    lib = slab_layer_lib()
    launch = entry(lib, "dinov2_slab_layer_bf16", x.dtype == torch.float32)
    b, t, d = x.shape
    qkv = torch.empty((b, t, 3 * d), dtype=x.dtype, device=x.device)
    attn = torch.empty((b, t, d), dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    planes = f32_weight_scratch(x, 6 * d * d)
    with torch.cuda.device(x.device):  # the launches go to the current device
        code = launch(
            x.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(), w_qkv.data_ptr(),
            b_qkv.data_ptr(), w_proj.data_ptr(), b_proj.data_ptr(), ls1.data_ptr(),
            qkv.data_ptr(), attn.data_ptr(), out.data_ptr(),
            b, t, d, num_heads, scale, eps, torch.cuda.current_stream(x.device).cuda_stream,
            *(p.data_ptr() for p in planes),
        )
    check_status(lib, code, "slab_layer_block")
    count_launch(slab_layer_block, x.dtype)
    return out, qkv, attn


slab_layer_block.launches = 0  # bf16 kernel calls on CUDA tensors
slab_layer_block.f32_launches = 0  # f32 kernel calls on CUDA tensors
_SLAB_LAYER_OP = define(
    "slab_layer_block(Tensor x, Tensor ln_scale, Tensor ln_bias, Tensor w_qkv, Tensor b_qkv, "
    "Tensor w_proj, Tensor b_proj, Tensor ls1, int num_heads, float scale, float eps) -> Tensor",
    slab_layer_reference, _slab_layer_cuda, _slab_layer_fake,
)


def check_slab_attention_args(qkv, num_heads, x=None, w_proj=None, b_proj=None, ls1=None,
                              aligned: bool = True):
    """What the CUDA slab attention kernels take: a bf16 or f32 (B, T, 3D)
    slab with head_dim 64 (K3); with x given, K2's x (B, T, D) and w_proj
    (D, D) in the slab's dtype and f32 b_proj and ls1 rows too. `aligned`: as
    `_check_tensors`."""
    if qkv.dim() != 3 or qkv.shape[-1] % 3:
        raise ValueError(f"qkv must be (B, T, 3D), got {tuple(qkv.shape)}")
    b, t, three_d = qkv.shape
    d = three_d // 3
    _check_kernel_dtype_head64(qkv, d, num_heads, "slab attention")
    if x is None:
        return _check_tensors(qkv, {}, aligned)
    _check_tensors(x, {
        "x": (x, (b, t, d), qkv.dtype),
        "qkv": (qkv, (b, t, 3 * d), qkv.dtype),
        "w_proj": (w_proj, (d, d), qkv.dtype),
        "b_proj": (b_proj, (d,), torch.float32),
        "ls1": (ls1, (d,), torch.float32),
    }, aligned)


def slab_attention(qkv: torch.Tensor, num_heads: int, scale: float) -> torch.Tensor:
    """(B, T, 3D) fused qkv slab, [q | k | v] along features -> (B, T, D)
    attention output, per head softmax(q k^T * scale) v, no head transposes.

    CPU tensors run the plain version. CUDA tensors launch the K3 kernel
    (bf16 or f32, head_dim 64; anything else raises) and add one to
    `slab_attention.launches` (bf16) or `.f32_launches` (f32). Where qkv
    requires grad the result carries the gradient of
    `slab_attention_backward`."""
    if needs_grad(qkv):
        return _SlabAttention.apply(qkv, num_heads, scale)
    return _slab_attention_forward(qkv, num_heads, scale)


def _slab_attention_forward(qkv: torch.Tensor, num_heads: int, scale: float) -> torch.Tensor:
    """slab_attention's dispatch: the operator `dinov2_tpu_torch::slab_attention`,
    plain on the CPU, the K3 launch on a card."""
    check_device(qkv, "slab_attention")
    return _SLAB_ATTENTION_OP(qkv, num_heads, scale)


def _slab_attention_fake(qkv: torch.Tensor, num_heads: int, scale: float) -> torch.Tensor:
    if qkv.device.type == "cuda":
        check_slab_attention_args(qkv, num_heads, aligned=False)
    b, t, three_d = qkv.shape
    return qkv.new_empty((b, t, three_d // 3))


def _slab_attention_cuda(qkv: torch.Tensor, num_heads: int, scale: float) -> torch.Tensor:
    """The K3 launch."""
    check_slab_attention_args(qkv, num_heads)
    b, t, three_d = qkv.shape
    d = three_d // 3
    from dinov2_tpu_torch.ops._kernels import check_status, entry, slab_attention_lib

    lib = slab_attention_lib()
    launch = entry(lib, "dinov2_slab_attention_bf16", qkv.dtype == torch.float32)
    out = torch.empty((b, t, d), dtype=qkv.dtype, device=qkv.device)
    with torch.cuda.device(qkv.device):  # the launch goes to the current device
        code = launch(
            qkv.data_ptr(), out.data_ptr(), b, t, d, num_heads, scale,
            torch.cuda.current_stream(qkv.device).cuda_stream,
        )
    check_status(lib, code, "slab_attention")
    count_launch(slab_attention, qkv.dtype)
    return out


slab_attention.launches = 0  # bf16 kernel calls on CUDA tensors
slab_attention.f32_launches = 0  # f32 kernel calls on CUDA tensors
_SLAB_ATTENTION_OP = define(
    "slab_attention(Tensor qkv, int num_heads, float scale) -> Tensor",
    _slab_reference, _slab_attention_cuda, _slab_attention_fake,
)


def slab_attention_block(
    x: torch.Tensor,
    qkv: torch.Tensor,
    w_proj: torch.Tensor,
    b_proj: torch.Tensor,
    ls1: torch.Tensor,
    num_heads: int,
    scale: float,
) -> torch.Tensor:
    """x + ls1 * (slab_attention(qkv) @ w_proj + b_proj): x (B, T, D) the
    residual stream, qkv (B, T, 3D), w_proj (D, D) stored (in, out), b_proj
    and ls1 (D,) in f32.

    CPU tensors run the plain version. CUDA tensors launch the K2 kernel
    (bf16 or f32, head_dim 64; anything else raises) and add one to
    `slab_attention_block.launches` (bf16) or `.f32_launches` (f32). Both go
    through the operator `dinov2_tpu_torch::slab_attention_block`. On the
    slab K1 makes, the output is K1's bit for bit: both run the same two
    launches on it. Where
    an input requires grad the result carries the recompute gradient of the
    module docstring."""
    tensors = (x, qkv, w_proj, b_proj, ls1)
    if needs_grad(*tensors):
        return _RecomputeFunction.apply(
            lambda *a: slab_attention_block(*a, num_heads, scale),
            lambda *a: _slab_block_reference(*a, num_heads, scale),
            *tensors,
        )
    check_device(x, "slab_attention_block")
    return _SLAB_ATTENTION_BLOCK_OP(*tensors, num_heads, scale)


def _slab_attention_block_fake(x, qkv, w_proj, b_proj, ls1, num_heads, scale):
    if x.device.type == "cuda":
        check_slab_attention_args(qkv, num_heads, x, w_proj.to(x.dtype), b_proj, ls1,
                                  aligned=False)
    return torch.empty_like(x, memory_format=torch.contiguous_format)


def _slab_attention_block_cuda(x, qkv, w_proj, b_proj, ls1, num_heads, scale):
    """The K2 launch."""
    w_proj = w_proj.to(x.dtype)
    check_slab_attention_args(qkv, num_heads, x, w_proj, b_proj, ls1)
    b, t, d = x.shape
    from dinov2_tpu_torch.ops._kernels import check_status, entry, slab_attention_lib

    lib = slab_attention_lib()
    launch = entry(lib, "dinov2_slab_attention_block_bf16", x.dtype == torch.float32)
    attn = torch.empty((b, t, d), dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    planes = f32_weight_scratch(x, 2 * d * d)
    with torch.cuda.device(x.device):  # the launches go to the current device
        code = launch(
            x.data_ptr(), qkv.data_ptr(), w_proj.data_ptr(), b_proj.data_ptr(), ls1.data_ptr(),
            attn.data_ptr(), out.data_ptr(), b, t, d, num_heads, scale,
            torch.cuda.current_stream(x.device).cuda_stream, *(p.data_ptr() for p in planes),
        )
    check_status(lib, code, "slab_attention_block")
    count_launch(slab_attention_block, x.dtype)
    return out


slab_attention_block.launches = 0  # bf16 kernel calls on CUDA tensors
slab_attention_block.f32_launches = 0  # f32 kernel calls on CUDA tensors
_SLAB_ATTENTION_BLOCK_OP = define(
    "slab_attention_block(Tensor x, Tensor qkv, Tensor w_proj, Tensor b_proj, Tensor ls1, "
    "int num_heads, float scale) -> Tensor",
    _slab_block_reference, _slab_attention_block_cuda, _slab_attention_block_fake,
)

MLP_KERNEL_WIDTHS = (384, 768, 1024)  # the D the bf16 K5 kernel is built for, with DH = 4 D
MLP_F32_WIDTH_STEP = 16  # the f32 K5 kernel takes any D % 16 == 0 (its GEMMs' k-step)


def check_slab_mlp_args(x, ln_scale, ln_bias, w1, b1, w2, b2, ls2, aligned: bool = True):
    """What the CUDA MLP kernels take: bf16 x (B, T, D) with D in
    MLP_KERNEL_WIDTHS or f32 x with D % MLP_F32_WIDTH_STEP == 0, (in, out)
    weights in x's dtype with DH = 4 D, f32 rows. `aligned`: as
    `_check_tensors`."""
    if x.dtype not in KERNEL_DTYPES:
        raise NotImplementedError(
            f"the CUDA MLP kernel takes bf16 or f32 activations, got {x.dtype}")
    if x.dim() != 3:
        raise ValueError(f"x must be (B, T, D), got {tuple(x.shape)}")
    d = x.shape[-1]
    dh = w1.shape[-1]
    if x.dtype == torch.float32:
        if d % MLP_F32_WIDTH_STEP or dh != 4 * d:
            raise NotImplementedError(
                f"the CUDA f32 MLP kernel takes D % {MLP_F32_WIDTH_STEP} == 0 with DH = 4 D, "
                f"got D={d}, DH={dh}"
            )
    elif d not in MLP_KERNEL_WIDTHS or dh != 4 * d:
        raise NotImplementedError(
            f"the CUDA MLP kernel is built for D in {MLP_KERNEL_WIDTHS} with DH = 4 D, "
            f"got D={d}, DH={dh}"
        )
    _check_tensors(x, {
        "ln_scale": (ln_scale, (d,), torch.float32),
        "ln_bias": (ln_bias, (d,), torch.float32),
        "w1": (w1, (d, dh), x.dtype),
        "b1": (b1, (dh,), torch.float32),
        "w2": (w2, (dh, d), x.dtype),
        "b2": (b2, (d,), torch.float32),
        "ls2": (ls2, (d,), torch.float32),
    }, aligned)


def slab_mlp_block(
    x: torch.Tensor,
    ln_scale: torch.Tensor,
    ln_bias: torch.Tensor,
    w1: torch.Tensor,
    b1: torch.Tensor,
    w2: torch.Tensor,
    b2: torch.Tensor,
    ls2: torch.Tensor,
    activation: str,
    eps: float,
) -> torch.Tensor:
    """x + ls2 * (fc2(act(fc1(LN(x)) + b1)) + b2): x (B, T, D); w1 (D, DH)
    and w2 (DH, D) stored (in, out); ln_scale, ln_bias, b2, ls2 (D,) and b1
    (DH,) in f32; activation "gelu_tanh_f16" | "gelu_erf" | "gelu_tanh".

    CPU tensors run the plain version. CUDA tensors launch the K5 kernels
    (bf16 with D in MLP_KERNEL_WIDTHS, or f32 with D % 16 == 0; DH = 4 D,
    any T; anything else raises; weights are cast to x's dtype): LN2, fc1
    with the activation into a (B*T, DH) hidden buffer of x's dtype
    allocated in the operator for the call (it goes through device memory,
    written once and read once), fc2 with the residual; and add one to
    `slab_mlp_block.launches` (bf16) or `.f32_launches` (f32). Both go
    through the operator `dinov2_tpu_torch::slab_mlp_block`. Where an input
    requires grad the result carries the recompute gradient of the module
    docstring."""
    _check_activation(activation)
    tensors = (x, ln_scale, ln_bias, w1, b1, w2, b2, ls2)
    if needs_grad(*tensors):
        return _RecomputeFunction.apply(
            lambda *a: slab_mlp_block(*a, activation, eps),
            lambda *a: slab_mlp_reference(*a, activation, eps),
            *tensors,
        )
    check_device(x, "slab_mlp_block")
    return _SLAB_MLP_OP(*tensors, activation, eps)


def _check_activation(activation) -> None:
    if activation is None or activation not in ACTIVATIONS:
        raise ValueError(f"unknown activation {activation!r}")


def _slab_mlp_fake(x, ln_scale, ln_bias, w1, b1, w2, b2, ls2, activation, eps):
    if x.device.type == "cuda":
        _check_activation(activation)
        check_slab_mlp_args(x, ln_scale, ln_bias, w1.to(x.dtype), b1, w2.to(x.dtype), b2, ls2,
                            aligned=False)
    return torch.empty_like(x, memory_format=torch.contiguous_format)


def _slab_mlp_cuda(x, ln_scale, ln_bias, w1, b1, w2, b2, ls2, activation, eps):
    """The K5 launches."""
    _check_activation(activation)
    w1, w2 = w1.to(x.dtype), w2.to(x.dtype)
    check_slab_mlp_args(x, ln_scale, ln_bias, w1, b1, w2, b2, ls2)
    b, t, d = x.shape
    dh = 4 * d
    out = torch.empty_like(x)
    if b * t == 0:
        return out
    from dinov2_tpu_torch.ops._kernels import check_status, entry, slab_mlp_lib

    lib = slab_mlp_lib()
    launch = entry(lib, "dinov2_slab_mlp_bf16", x.dtype == torch.float32)
    hidden = torch.empty((b * t, dh), dtype=x.dtype, device=x.device)
    planes = f32_weight_scratch(x, 2 * d * dh)
    with torch.cuda.device(x.device):  # the launches go to the current device
        code = launch(
            x.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(), w1.data_ptr(), b1.data_ptr(),
            w2.data_ptr(), b2.data_ptr(), ls2.data_ptr(), out.data_ptr(), b * t, d, dh,
            ACTIVATIONS[activation], eps, torch.cuda.current_stream(x.device).cuda_stream,
            hidden.data_ptr(), *(p.data_ptr() for p in planes),
        )
    check_status(lib, code, "slab_mlp_block")
    count_launch(slab_mlp_block, x.dtype)
    return out


slab_mlp_block.launches = 0  # bf16 kernel calls on CUDA tensors
slab_mlp_block.f32_launches = 0  # f32 kernel calls on CUDA tensors
_SLAB_MLP_OP = define(
    "slab_mlp_block(Tensor x, Tensor ln_scale, Tensor ln_bias, Tensor w1, Tensor b1, Tensor w2, "
    "Tensor b2, Tensor ls2, str activation, float eps) -> Tensor",
    slab_mlp_reference, _slab_mlp_cuda, _slab_mlp_fake,
)
