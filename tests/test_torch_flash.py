"""The port's flash attention (K4's plain version and its wrappers) and the
attention routes against the JAX functions on the CPU.

The JAX kernels run as the JAX package's own tests run them: Pallas in
interpret mode. Inputs come from numpy seeds; everything is f32. On the CPU
the port's K4 wrappers run the plain version, so the 1e-5 bounds are those
of tests/test_pallas_kernels.py (the JAX kernel against vanilla attention).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (caps torch's threads under xdist)

from dinov2_tpu.ops import attention as jattn
from dinov2_tpu.ops import flash_attention as jfa
from dinov2_tpu_torch.ops import _kernels, attention, flash_attention

TOL = 1e-5


def _qkv(seed, b, t, heads, hd):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, t, heads, hd)).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("t", [1, 37, 65, 300])
def test_flash_attention_matches_jax(t):
    """One row, ragged tiles and an exact-plus-one tile, at head_dim 64."""
    q, k, v = _qkv(t, 2, t, 2, 64)
    want = np.asarray(jfa.flash_attention(*map(jnp.asarray, (q, k, v)), 0.125, 2048, True))
    got = flash_attention.flash_attention(*map(torch.from_numpy, (q, k, v)), 0.125)
    assert tuple(got.shape) == (2, t, 2, 64)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_flash_attention_multi_kv_matches_jax(monkeypatch):
    """The JAX multi-KV online-softmax kernel, forced as
    test_pallas_kernels.py::test_flash_multi_kv_block_online_softmax does."""
    monkeypatch.setattr(jfa, "_VMEM_BUDGET", 300_000)
    b, t, heads, hd = 1, 300, 2, 64
    _, bk, tp = jfa._pick_blocks(t, hd, 2048)
    assert tp // bk >= 2  # really multi-block
    q, k, v = _qkv(7, b, t, heads, hd)
    want = np.asarray(jfa.flash_attention(*map(jnp.asarray, (q, k, v)), 0.125, 2048, True))
    got = flash_attention.flash_attention(*map(torch.from_numpy, (q, k, v)), 0.125)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("t", [5, 130])
def test_flash_attention_slab_matches_jax(t):
    """The transpose-free slab entry at head_dim 64 (which the JAX package
    routes only at hd % 128, for a Mosaic rule)."""
    heads = 3
    qkv = np.random.default_rng(t).standard_normal((2, t, 3 * 64 * heads)).astype(np.float32)
    want = np.asarray(jfa.flash_attention_slab(jnp.asarray(qkv), heads, 0.125, 128, True))
    got = flash_attention.flash_attention_slab(torch.from_numpy(qkv), heads, 0.125)
    assert tuple(got.shape) == (2, t, 64 * heads)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize(
    "flash, t, route",
    [
        (True, 257, "flash"),
        (False, 1370, "vanilla"),
        ("slab", 1370, "slab"),
        ("flash", 257, "flash"),
        ("vanilla", 1370, "vanilla"),
        ("auto", 257, "slab"),  # 224 px classify
        ("auto", 1023, "slab"),
        ("auto", 1024, "flash"),
        ("auto", 1370, "flash"),  # 518 px features
        ("auto", 4226, "flash"),  # 896 px, native resolution
    ],
)
def test_resolve_attention_path(flash, t, route):
    """Explicit routes keep their JAX meanings; "auto" is the port's own rule
    (the JAX package's picks for every preset, without its TPU gates)."""
    assert attention.resolve_attention_path(flash, t) == route
    if flash != "auto":
        assert jattn.resolve_attention_path(flash, t, 64 * 16) == route


def test_resolve_attention_path_refuses_unknown_routes():
    with pytest.raises(ValueError, match="unknown attention route"):
        attention.resolve_attention_path("fast", 257)


def _block_inputs(seed, b, t, d):
    rng = np.random.default_rng(seed)
    arrays = {
        "x_res": rng.standard_normal((b, t, d)),
        "x_norm": rng.standard_normal((b, t, d)),
        "qkv_kernel": rng.standard_normal((d, 3 * d)) * 0.1,
        "qkv_bias": rng.standard_normal(3 * d) * 0.1,
        "proj_kernel": rng.standard_normal((d, d)) * 0.1,
        "proj_bias": rng.standard_normal(d) * 0.1,
        "ls1": rng.uniform(0.1, 1.0, d),
    }
    return {k: v.astype(np.float32) for k, v in arrays.items()}


def _block(lib, to, a, heads, flash):
    return lib.self_attention_block(
        to(a["x_res"]), to(a["x_norm"]),
        {"kernel": to(a["qkv_kernel"]), "bias": to(a["qkv_bias"])},
        {"kernel": to(a["proj_kernel"]), "bias": to(a["proj_bias"])},
        to(a["ls1"]), heads, flash=flash,
    )


@pytest.mark.parametrize("flash", [True, False])
def test_self_attention_block_matches_jax(flash):
    """The unfused half-layer on the flash route (K4's plain version here,
    the JAX flash kernel interpreted) and on the vanilla route."""
    a = _block_inputs(3, 2, 45, 128)
    want = np.asarray(_block(jattn, jnp.asarray, a, 2, flash))
    got = _block(attention, torch.from_numpy, a, 2, flash).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_self_attention_has_no_slab_core():
    """The slab route of the unfused half-layer once raised; with K2 and K3
    ported it runs (their plain versions here) and matches the JAX slab
    route, whose Pallas kernel is interpreted on the CPU."""
    a = _block_inputs(0, 1, 5, 64)
    want = np.asarray(_block(jattn, jnp.asarray, a, 1, "slab"))
    got = _block(attention, torch.from_numpy, a, 1, "slab").numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_flash_attention_refuses_other_devices():
    q = torch.zeros((1, 3, 1, 64), device="meta")
    with pytest.raises(ValueError, match="no flash_attention for device"):
        flash_attention.flash_attention(q, q, q, 0.125)


def _slab_views(t=5, heads=2, dtype=torch.bfloat16):
    """q/k/v views of a (B, T, 3D) slab, built on the CPU (the checks read
    metadata only)."""
    return attention.split_heads(torch.zeros((2, t, 3 * 64 * heads), dtype=dtype), heads)


@pytest.mark.parametrize(
    "case, error",
    [
        ("f16", NotImplementedError),
        ("head_dim 32", NotImplementedError),
        ("shapes differ", ValueError),
        ("strides differ", ValueError),
        ("head_dim strided", ValueError),
        ("head stride not a multiple of 8", ValueError),
    ],
)
def test_cuda_argument_checks(case, error):
    """What the CUDA path refuses, checked before any launch; the slab's
    views and contiguous tensors pass."""
    q, k, v = _slab_views()
    assert flash_attention._check_cuda_args(q, k, v) == (5 * 384, 384, 64)
    c = q.contiguous()
    assert flash_attention._check_cuda_args(c, c.clone(), c.clone()) == (5 * 128, 128, 64)
    if case == "f16":  # the kernels take bf16 and f32
        q, k, v = _slab_views(dtype=torch.float16)
    elif case == "head_dim 32":
        q, k, v = attention.split_heads(torch.zeros((2, 5, 3 * 64), dtype=torch.bfloat16), 2)
    elif case == "shapes differ":
        k = k[:, :4]
    elif case == "strides differ":
        k = k.contiguous()
    elif case == "head_dim strided":
        q, k, v = (torch.zeros((2, 5, 2, 128), dtype=torch.bfloat16)[..., ::2] for _ in range(3))
    elif case == "head stride not a multiple of 8":
        q, k, v = (torch.zeros((2, 5, 2, 68), dtype=torch.bfloat16)[..., :64] for _ in range(3))
    with pytest.raises(error):
        flash_attention._check_cuda_args(q, k, v)


def test_library_name_follows_the_headers(tmp_path, monkeypatch):
    """An edited header included by a kernel source gives the library a new
    name, so a stale build is never loaded."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in ("flash_attention.cu", "slab_layer.cu", "attention_core.cuh"):
        (csrc / name).write_bytes((_kernels.CSRC_DIR / name).read_bytes())
    monkeypatch.setattr(_kernels, "CSRC_DIR", csrc)
    before = {n: _kernels.library_path(n) for n in ("flash_attention", "slab_layer")}
    assert before == {n: _kernels.library_path(n) for n in before}  # stable
    header = csrc / "attention_core.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    for name, path in before.items():
        after = _kernels.library_path(name)
        assert after != path and after.name.startswith(f"lib{name}-")
