"""The port's multi-device inference (parallel/mesh.py, parallel/tp_fused.py,
parallel/pipeline.py, DinoEngine(mesh_axes=, data_parallel=)) against the
JAX package's on the CPU.

The JAX side runs on the eight virtual host devices of tests/conftest.py;
the port's meshes name the CPU once per position (several shards on one
device, which is how it runs a mesh on one card too). Inputs come from
numpy seeds and go through both packages in f32. Bounds:
  - placement, the TP weight rewrite and data parallelism: bit for bit;
  - dense TP, probs: rtol 1e-5, atol 1e-6 (the JAX package's own bound for
    its sharded forwards, tests/test_parallel.py, on its tiny model, which
    these tests use too): the psums add the same partials in another order;
  - the pipeline: tokens within 2e-5 (tests/test_torch_slice.py's f32 bound
    between the two packages in "hf" parity), probs as above;
  - fused-quant engines: rtol 2e-5, atol 2e-6 against JAX's engine on its
    default (XLA) quant backend. The port's K7 follows `dequant_weight`,
    not the Pallas kernel's bf16 scales (ROADMAP.md, "Known differences");
  - int8: PROB_ABS_BOUND of tests/test_torch_int8.py (5e-3), the reach of
    one activation code flip between two f32 forwards.
"""

import dataclasses
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (caps torch's threads under xdist)

from dinov2_tpu.io.synthetic import write_synthetic_gguf
from dinov2_tpu.models import params as jparams
from dinov2_tpu.models import vit as jvit
from dinov2_tpu.models.config import DinoConfig
from dinov2_tpu.parallel import mesh as jmesh
from dinov2_tpu.parallel import pipeline as jpipeline
from dinov2_tpu.parallel import tp_fused as jtp
from dinov2_tpu.quant.quantize import quantize_gguf
from dinov2_tpu.runtime.engine import DinoEngine as JaxEngine
from dinov2_tpu_torch.models import params, vit
from dinov2_tpu_torch.models.config import PRESETS
from dinov2_tpu_torch.models.params import PACKED_WEIGHTS, QuantLinear
from dinov2_tpu_torch.parallel import mesh, pipeline, tp_fused
from dinov2_tpu_torch.runtime.engine import DinoEngine

CPU = torch.device("cpu")
# the JAX package's sharded-engine configs (tests/test_parallel.py)
TINY = DinoConfig(hidden_size=64, num_hidden_layers=2, num_attention_heads=2,
                  num_classes=4, patch_size=14, img_size=70)
SWIGLU = dataclasses.replace(TINY, use_swiglu_ffn=True, swiglu_hidden=128)
ODD_HEADS = dataclasses.replace(TINY, hidden_size=96, num_attention_heads=3)
# four heads of 64, so that the weight rewrite splits 2 and 4 ways
WIDE = dataclasses.replace(TINY, hidden_size=256, num_attention_heads=4)
WIDE_SWIGLU = dataclasses.replace(WIDE, use_swiglu_ffn=True, swiglu_hidden=256)
SHARD_RTOL, SHARD_ATOL = 1e-5, 1e-6
TOKEN_ATOL = 2e-5
QUANT_RTOL, QUANT_ATOL = 2e-5, 2e-6
FEATURE_RTOL, FEATURE_ATOL = 2e-4, 2e-5  # the JAX package's bound on sharded patch tokens
INT8_PROB_ABS_BOUND = 5e-3
JOPTS = jvit.ModelOptions(parity="hf", compute_dtype=jnp.float32)
OPTS = vit.ModelOptions(parity="hf", compute_dtype=torch.float32)


def _images(n, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, 70, 70, 3), dtype=np.uint8)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """name -> GGUF path: the tiny dense file and its q4_0/q5_1 copies, a
    SwiGLU file and a three-head file in q4_0, and the WIDE files in q4_0,
    q5_1, q8_0 and (SwiGLU) q4_0."""
    d = tmp_path_factory.mktemp("parallel")
    out = {}
    for name, config, seed, formats in (("dense", TINY, 7, ("q4_0", "q5_1")),
                                        ("swiglu", SWIGLU, 17, ("q4_0",)),
                                        ("odd", ODD_HEADS, 11, ("q4_0",)),
                                        ("wide", WIDE, 7, ("q4_0", "q5_1", "q8_0")),
                                        ("wide_swiglu", WIDE_SWIGLU, 17, ("q4_0",))):
        out[name] = write_synthetic_gguf(d / f"{name}.gguf", config, seed=seed)
        for q in formats:
            out[f"{name}.{q}"] = quantize_gguf(out[name], d / f"{name}.{q}.gguf", q)
    return out


def _jax_position(jm, device) -> int:
    """The row-major position of a JAX device in its mesh."""
    return int(np.flatnonzero(jm.devices.reshape(-1) == device)[0])


def _jax_shards(arr, jm) -> dict:
    """position -> the host array a JAX array holds there."""
    return {_jax_position(jm, s.device): np.asarray(s.data) for s in arr.addressable_shards}


def _cpu_mesh(axes):
    return mesh.make_mesh(axes, devices=[CPU] * int(np.prod(list(axes.values()))))


# ---------------------------------------------------------------------------
# parallel/mesh.py
# ---------------------------------------------------------------------------


def test_make_mesh_shapes_warnings_and_repeats(caplog):
    m = mesh.make_mesh({"data": 4, "model": 2}, devices=[CPU] * 8)
    assert m.shape == {"data": 4, "model": 2} and m.axis_names == ("data", "model")
    assert m.devices.shape == (4, 2) and m.size == 8
    assert m.position({"data": 3, "model": 1}) == 7 and m.coords(5) == {"data": 2, "model": 1}
    assert m.position({"data": 1}) == 2  # an axis left out is at 0
    assert mesh.make_mesh(devices=[CPU] * 3).shape == {"data": 3}
    with pytest.raises(ValueError, match=r"mesh \{'data': 4, 'model': 2\} needs 8 devices, "
                                         r"have 4"):
        mesh.make_mesh({"data": 4, "model": 2}, devices=[CPU] * 4)
    caplog.set_level(logging.WARNING)
    mesh.make_mesh({"data": 2}, devices=[CPU] * 8)
    want = "mesh %s uses %d of %d available devices" % ({"data": 2}, 2, 8)  # JAX's message
    assert want in caplog.text
    jm = jmesh.make_mesh({"data": 2, "model": 2}, devices=jax.devices()[:4])
    assert dict(jm.shape) == mesh.make_mesh({"data": 2, "model": 2}, [CPU] * 4).shape


def test_make_mesh_default_takes_the_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    m = mesh.make_mesh()
    assert m.shape == {"data": 2}
    assert list(m.devices.flat) == [torch.device("cuda", 0), torch.device("cuda", 1)]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(ValueError, match="no CUDA device"):
        mesh.make_mesh()


def test_init_distributed(monkeypatch):
    """One process is a no-op, as in the JAX package: no arguments and no
    WORLD_SIZE, or num_processes=1. Several processes form a group
    (tests/test_torch_distributed.py)."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    mesh.init_distributed()
    mesh.init_distributed("localhost:1234", num_processes=1, process_id=0)
    assert not torch.distributed.is_initialized()
    assert mesh.process_index() == 0 and mesh.process_count() == 1


def test_collectives_on_repeated_devices():
    parts = [torch.full((2, 3), float(i + 1)) for i in range(4)]
    total = mesh.psum(parts)
    assert len(total) == 4 and all(t is total[0] for t in total)  # one device: one sum
    np.testing.assert_array_equal(total[0].numpy(), np.full((2, 3), 10.0))
    got = mesh.gather([torch.zeros(1, 2), torch.ones(2, 2)], CPU)
    np.testing.assert_array_equal(got.numpy(), [[0, 0], [1, 1], [1, 1]])


@pytest.mark.parametrize("axes", [{"data": 4, "model": 2}, {"model": 2}, {"data": 8}])
def test_shard_batch_matches_jax(axes):
    x = np.random.default_rng(1).standard_normal((8, 5, 3)).astype(np.float32)
    jm = jmesh.make_mesh(axes, devices=jax.devices()[: int(np.prod(list(axes.values())))])
    want = _jax_shards(jmesh.shard_batch(jnp.asarray(x), jm), jm)
    got = mesh.shard_batch(torch.from_numpy(x), _cpu_mesh(axes))
    assert len(got) == len(want)
    for position, arr in want.items():
        np.testing.assert_array_equal(got[position].numpy(), arr)


def _jax_leaves(tree) -> dict:
    """'a/b/c' -> leaf of a JAX tree of dicts."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(k.key) for k in path): leaf for path, leaf in flat}


def _port_leaves(tree, prefix="") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_port_leaves(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


@pytest.mark.parametrize("config", [TINY, SWIGLU], ids=["gelu", "swiglu"])
def test_shard_params_and_specs_match_jax(config):
    jp = jparams.init_params(config, seed=3, dtype=jnp.float32)
    pp = params.init_params(config, seed=3, dtype=torch.float32)
    want_specs = _jax_leaves(jmesh.param_pspecs(jp))
    got_specs = _port_leaves(mesh.param_pspecs(pp))
    assert set(got_specs) == set(want_specs)
    assert {k: tuple(v) for k, v in want_specs.items()} == got_specs
    axes = {"data": 4, "model": 2}
    jm = jmesh.make_mesh(axes)
    want = _jax_leaves(jmesh.shard_params(jp, jm, tensor_parallel=True))
    placed = mesh.shard_params(pp, _cpu_mesh(axes), tensor_parallel=True)
    for name, arr in want.items():
        for position, shard in _jax_shards(arr, jm).items():
            np.testing.assert_array_equal(_port_leaves(placed[position])[name].numpy(), shard)
    # replicated: every position holds the very tensors (one device, no copy)
    for tree in mesh.shard_params(pp, _cpu_mesh(axes)):
        assert all(a is b for a, b in zip(_port_leaves(tree).values(),
                                          _port_leaves(pp).values()))


def test_shard_map_data_parallel_is_the_forward_on_each_slice():
    pp = params.init_params(TINY, seed=4, dtype=torch.float32)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((8, 70, 70, 3)).astype(
        np.float32))
    m = _cpu_mesh({"data": 4})

    def fn(p, xs):
        return vit.forward(p, xs, TINY, OPTS, classify=True)

    got = mesh.shard_map_data_parallel(fn, m)(mesh.replicate(pp, m), x)
    for key, value in got.items():
        want = torch.cat([fn(pp, x[i: i + 2])[key] for i in range(0, 8, 2)])
        np.testing.assert_array_equal(value.numpy(), want.numpy())
    with pytest.raises(ValueError, match="does not split"):
        mesh.shard_map_data_parallel(fn, m)(mesh.replicate(pp, m), x[:6])


# ---------------------------------------------------------------------------
# parallel/tp_fused.py
# ---------------------------------------------------------------------------


def _compare_tp_trees(jtree, jspecs, ptree, pspecs):
    """Every array of the two prepared trees bit for bit, and the specs."""
    jl, jsl = _jax_leaves_quant(jtree), _jax_leaves_quant(jspecs)
    pl, psl = _port_leaves(ptree), _port_leaves(pspecs)
    assert set(jl) == set(pl)
    for name, want in jl.items():
        got = pl[name]
        if isinstance(got, QuantLinear):
            assert (got.packed, got.ggml_type, got.shape) == (want.packed, int(want.ggml_type),
                                                             tuple(want.shape))
            for field, tensor in got.tensors().items():
                np.testing.assert_array_equal(tensor.numpy(), np.asarray(getattr(want, field)))
            assert all((getattr(want, f) is None) == (f not in got.tensors())
                       for f in params.QUANT_FIELDS)
            assert psl[name] == tuple(jsl[name].codes)
        else:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
            assert psl[name] == tuple(jsl[name])


def _jax_leaves_quant(tree, prefix="") -> dict:
    """'a/b' -> leaf of a JAX tree, a QuantLinear (or its spec) as one leaf."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_jax_leaves_quant(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("name", ["wide.q4_0", "wide.q5_1", "wide.q8_0", "wide_swiglu.q4_0"])
def test_tp_prepare_params_bit_for_bit(files, name, tp):
    """Permuted qkv/fc1/win sections, int8-SoA proj/fc2/wout and the spec
    tree, as the JAX package makes them, from each package's own load."""
    jl = jparams.load_params(files[name], dtype=jnp.float32, quant_mode="fused")
    pl = params.load_params(files[name], dtype=torch.float32, quant_mode="fused")
    want = jtp.tp_prepare_params(jl.params, jl.config, tp)
    got = tp_fused.tp_prepare_params(pl.params, pl.config, tp)
    _compare_tp_trees(*want, *got)


def test_tp_prepare_params_errors_match_jax(files):
    pl = params.load_params(files["wide"], dtype=torch.float32, quant_mode="fused")
    jl = jparams.load_params(files["wide"], dtype=jnp.float32, quant_mode="fused")
    for prepare, loaded in ((tp_fused.tp_prepare_params, pl), (jtp.tp_prepare_params, jl)):
        with pytest.raises(ValueError, match="^tp_fused expects quantized qkv$"):
            prepare(loaded.params, loaded.config, 2)
    pl = params.load_params(files["wide.q4_0"], dtype=torch.float32, quant_mode="fused")
    jl = jparams.load_params(files["wide.q4_0"], dtype=jnp.float32, quant_mode="fused")
    for prepare, loaded in ((tp_fused.tp_prepare_params, pl), (jtp.tp_prepare_params, jl)):
        with pytest.raises(ValueError, match="^4 heads do not split over tp=3$"):
            prepare(loaded.params, loaded.config, 3)
        with pytest.raises(ValueError, match="^fc2 in-dim 1024 does not split at 32-block "
                                             "boundaries over tp=64$"):
            prepare(loaded.params, dataclasses.replace(loaded.config, num_attention_heads=64), 64)


def _fake_quant_params(config: DinoConfig) -> dict:
    """One layer of packed q4_0 zeros at `config`'s widths (shapes are what
    tp_prepare_params and kernel_refusals read)."""
    d = config.hidden_size
    hidden = config.swiglu_hidden_dim if config.swiglu else int(d * config.mlp_ratio)

    def ql(out_dim, in_dim):
        return QuantLinear(codes=torch.zeros((1, out_dim, in_dim // 2), dtype=torch.uint8),
                           d=torch.zeros((1, out_dim, in_dim // 32)), m=None, ggml_type=2,
                           shape=(out_dim, in_dim), packed=True)

    mlp = ({"win": {"kernel": ql(2 * hidden, d)}, "wout": {"kernel": ql(d, hidden)}}
           if config.swiglu else
           {"fc1": {"kernel": ql(hidden, d)}, "fc2": {"kernel": ql(d, hidden)}})
    return {"layers": {"qkv": {"kernel": ql(3 * d, d)}, "proj": {"kernel": ql(d, d)},
                       "mlp": mlp}}


@pytest.mark.parametrize("preset", list(PRESETS))
def test_k7_takes_every_published_shard(preset):
    """For every published width and tp in {2, 3, 4, 6, 8}: either the
    split is refused by tp_prepare_params' checks (ValueError, the engine's
    dequant fallback), or every weight shard has a K that the K7 kernel
    takes (K % 64, K/2 % 64 packed). JAX's checks split at 32-blocks only,
    so this is what keeps a published model off a refusal."""
    config = dataclasses.replace(PRESETS[preset], num_hidden_layers=1)
    taken = []
    for tp in (2, 3, 4, 6, 8):
        try:
            ptp, specs = tp_fused.tp_prepare_params(_fake_quant_params(config), config, tp)
        except ValueError:
            continue
        shard = mesh.place(ptp, _cpu_mesh({"model": tp}), specs)[tp - 1]
        assert tp_fused.kernel_refusals(shard) == [], (preset, tp)
        assert shard["layers"]["proj"]["kernel"].codes.shape[-1] == config.hidden_size // tp
        taken.append(tp)
    assert taken == {"small": [2, 3, 6], "base": [2, 3, 4, 6], "large": [2, 4, 8],
                     "giant": [2, 4, 8]}[preset]


def test_kernel_refusals_name_a_shape_jax_takes():
    """head_dim 32 (128 wide, 4 heads) at tp=4: JAX's checks pass, and K7
    takes every weight but proj's int8-SoA shard, whose K is 32."""
    config = dataclasses.replace(WIDE, hidden_size=128)
    jtp.tp_prepare_params({"layers": _jax_fake(config)}, config, 4)
    ptp, specs = tp_fused.tp_prepare_params(_fake_quant_params(config), config, 4)
    shard = mesh.place(ptp, _cpu_mesh({"model": 4}), specs)[0]
    assert tp_fused.kernel_refusals(shard) == ["proj (128, 32)"]


def _jax_fake(config):
    """_fake_quant_params as the JAX package's QuantLinear tree."""
    def conv(v):
        if isinstance(v, dict):
            return {k: conv(x) for k, x in v.items()}
        return jparams.QuantLinear(codes=jnp.asarray(v.codes.numpy()), d=jnp.asarray(v.d.numpy()),
                                   m=None, ggml_type=v.ggml_type, shape=v.shape, packed=True)
    return conv(_fake_quant_params(config)["layers"])


# ---------------------------------------------------------------------------
# DinoEngine on a mesh
# ---------------------------------------------------------------------------


def _port_engine(path, **kw):
    return DinoEngine(path, dtype=torch.float32, device="cpu", **kw)


@pytest.fixture(scope="module")
def jax_probs(files):
    """(file, quant_mode, mesh axes) -> the JAX engine's probs on _images(8)."""
    cache = {}

    def probs(name, quant_mode, axes, **kw):
        key = (name, quant_mode, tuple(sorted(axes.items())), tuple(sorted(kw.items())))
        if key not in cache:
            engine = JaxEngine(files[name], dtype=jnp.float32, quant_mode=quant_mode,
                               mesh_axes=axes, **kw)
            cache[key] = engine.classify_probs(_images(8))
        return cache[key]

    return probs


def test_dense_tp_engine_matches_jax(files, jax_probs):
    engine = _port_engine(files["dense"], mesh_axes={"data": 4, "model": 2})
    # the TP route: each position holds half of qkv's columns
    assert engine._placed[0]["layers"]["qkv"]["kernel"].shape == (2, 64, 96)
    got = engine.classify_probs(_images(8))
    np.testing.assert_allclose(got, jax_probs("dense", "dequant", {"data": 4, "model": 2}),
                               rtol=SHARD_RTOL, atol=SHARD_ATOL)


@pytest.mark.parametrize("axes", [{"data": 8}, {"data": 4, "model": 2}, {"model": 2}],
                         ids=["dp8", "dp4tp2", "tp2"])
@pytest.mark.parametrize("name", ["dense.q4_0", "dense.q5_1", "swiglu.q4_0"])
def test_fused_quant_engine_matches_jax(files, jax_probs, name, axes):
    engine = _port_engine(files[name], quant_mode="fused", mesh_axes=axes)
    assert engine.loaded.quantized  # no silent dequant fallback
    if "model" in axes:
        proj = engine._placed[0]["layers"]["proj"]["kernel"]
        assert not proj.packed and proj.codes.shape[-1] == 32  # int8-SoA row split
    got = engine.classify_probs(_images(8))
    np.testing.assert_allclose(got, jax_probs(name, "fused", axes), rtol=QUANT_RTOL,
                               atol=QUANT_ATOL)


@pytest.mark.parametrize("name,quant_mode", [("dense", "dequant"), ("dense.q4_0", "fused")])
def test_data_parallel_is_bit_for_bit_the_single_device_engine(files, name, quant_mode):
    """Each 'data' slice is the single-device engine on that slice: eight
    images over {"data": 8} equal eight calls of one image (the CPU's
    matmuls round by the batch's size, so a call of eight may differ)."""
    single = _port_engine(files[name], quant_mode=quant_mode)
    sharded = _port_engine(files[name], quant_mode=quant_mode, mesh_axes={"data": 8})
    imgs = _images(8, seed=2)
    np.testing.assert_array_equal(sharded.classify_probs(imgs),
                                  np.concatenate([single.classify_probs(im) for im in imgs]))
    feats = sharded.extract_features(imgs)
    for i, im in enumerate(imgs):
        want = single.extract_features(im)
        for key in ("cls_token", "patch_tokens"):
            np.testing.assert_array_equal(feats[key][i], want[key][0])


def test_fused_quant_model_axis_of_one_is_data_parallel(files, jax_probs):
    """A 'model' axis of size 1 is no tensor parallelism for any weight
    format: fused-quant weights stay whole and packed (the route `--mesh
    4,1` takes, which drops the axis), each slice bit for bit the {"data":
    4} engine's. JAX's engine takes its TP forward at tp=1 here; the probs
    agree within the fused-quant bound."""
    engine = _port_engine(files["dense.q4_0"], quant_mode="fused",
                          mesh_axes={"data": 4, "model": 1})
    qkv = engine._placed[0]["layers"]["qkv"]["kernel"]
    assert isinstance(qkv, QuantLinear) and qkv.packed and qkv.codes.shape[1] == 3 * 64
    got = engine.classify_probs(_images(8))
    dp = _port_engine(files["dense.q4_0"], quant_mode="fused", mesh_axes={"data": 4})
    np.testing.assert_array_equal(got, dp.classify_probs(_images(8)))
    np.testing.assert_allclose(got, jax_probs("dense.q4_0", "fused", {"data": 4, "model": 1}),
                               rtol=QUANT_RTOL, atol=QUANT_ATOL)


@pytest.mark.parametrize("name,quant_mode,axes", [
    ("dense", "dequant", {"data": 2, "model": 2}),
    ("dense.q4_0", "fused", {"model": 2}),
    ("dense.q4_0", "fused", {"data": 4}),
], ids=["dense-tp", "q4_0-tp", "q4_0-dp"])
def test_mesh_engine_keeps_only_the_placed_trees(files, name, quant_mode, axes):
    """On a mesh the engine drops the unsharded tree once the placed ones
    are made (under TP they hold a shard of each split weight on each
    position, not the whole) and builds no single-device model."""
    engine = _port_engine(files[name], quant_mode=quant_mode, mesh_axes=axes)
    assert engine.model is None and engine.loaded.params is None
    qkv = engine._placed[0]["layers"]["qkv"]["kernel"]
    columns = qkv.codes.shape[1] if isinstance(qkv, QuantLinear) else qkv.shape[-1]
    assert columns == 3 * TINY.hidden_size // axes.get("model", 1)
    assert engine.classify_probs(_images(2)).shape == (2, TINY.num_classes)


@pytest.mark.parametrize("axes", [{"data": 4}, {"data": 2, "model": 2}, {"model": 2}],
                         ids=["dp4", "dp2tp2", "tp2"])
def test_features_and_pca_on_a_mesh(files, axes):
    """The shape contract: 5 images pad to the 'data' multiple and come back
    5; features equal the single-device engine's, PCA images are u8 at the
    input size (tokens within the JAX package's bound for its sharded
    features)."""
    imgs = np.random.default_rng(5).integers(0, 256, (5, 60, 75, 3), dtype=np.uint8)
    single = _port_engine(files["dense.q4_0"], quant_mode="fused")
    engine = _port_engine(files["dense.q4_0"], quant_mode="fused", mesh_axes=axes)
    assert engine._target_batch(5) == 8 and engine._target_batch(1) == axes.get("data", 1)
    feats, want = engine.extract_features(imgs), single.extract_features(imgs)
    assert feats["patch_tokens"].shape == (5, 5 * 6, 64) and feats["grid"] == (5, 6)
    np.testing.assert_allclose(feats["patch_tokens"], want["patch_tokens"], rtol=FEATURE_RTOL,
                               atol=FEATURE_ATOL)
    vis = engine.pca_visualizations(list(imgs))
    assert len(vis) == 5 and all(v.shape == (60, 75, 3) and v.dtype == np.uint8 for v in vis)
    assert engine.pca_visualization(imgs[0]).shape == (60, 75, 3)


def test_indivisible_heads_fall_back_to_dequant_as_jax(files, jax_probs, caplog):
    """Three heads over tp=2: JAX's warning, quant_mode="dequant", and the
    dense weights replicated (the port's TP forward splits by heads), so
    each 'data' slice is the single-device dequant engine bit for bit; the
    probs within the fused-quant bound of JAX's engine, which falls back
    the same way and then splits the dense weights through GSPMD."""
    caplog.set_level(logging.WARNING)
    engine = _port_engine(files["odd.q4_0"], quant_mode="fused", mesh_axes={"data": 4, "model": 2})
    assert "3 heads do not split over tp=2; falling back to quant_mode='dequant'" in caplog.text
    assert "dense TP unavailable (3 heads do not split over tp=2)" in caplog.text
    assert not engine.loaded.quantized
    got = engine.classify_probs(_images(8))
    single = _port_engine(files["odd.q4_0"])
    np.testing.assert_array_equal(
        got, np.concatenate([single.classify_probs(_images(8)[i: i + 2]) for i in range(0, 8, 2)]))
    np.testing.assert_allclose(got, jax_probs("odd.q4_0", "fused", {"data": 4, "model": 2}),
                               rtol=QUANT_RTOL, atol=QUANT_ATOL)


def test_int8_under_model_replicates_as_jax(files, jax_probs, caplog):
    caplog.set_level(logging.WARNING)
    axes = {"data": 2, "model": 2}
    engine = _port_engine(files["dense"], quant_mode="int8", mesh_axes=axes,
                          flash_attention=False)
    assert ("int8 weights are not tensor-parallel sharded; replicating over the 2-way "
            "'model' axis") in caplog.text
    got = engine.classify_probs(_images(8))
    np.testing.assert_array_equal(
        got, _port_engine(files["dense"], quant_mode="int8",
                          flash_attention=False).classify_probs(_images(8)))
    np.testing.assert_allclose(got, jax_probs("dense", "int8", axes), atol=INT8_PROB_ABS_BOUND,
                               rtol=0)


def test_engine_builds_no_mesh_on_one_device(files):
    assert _port_engine(files["dense"], data_parallel=True).mesh is None


def test_cuda_mesh_larger_than_the_cards_raises(files, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match=r"needs 4 devices, have 1"):
        DinoEngine(files["dense"], device="cuda", mesh_axes={"data": 2, "model": 2})


# ---------------------------------------------------------------------------
# parallel/pipeline.py
# ---------------------------------------------------------------------------


def _pipeline_case(config, seed, stages, microbatches, keys):
    x = np.random.default_rng(seed).standard_normal((8, 70, 70, 3)).astype(np.float32)
    jm = jmesh.make_mesh({"stage": stages}, devices=jax.devices()[:stages])
    want = jpipeline.pipeline_forward(
        jpipeline.place_pipeline_params(jparams.init_params(config, seed=seed,
                                                            dtype=jnp.float32), jm),
        jnp.asarray(x), config, JOPTS, jm, num_microbatches=microbatches, classify=True)
    m = _cpu_mesh({"stage": stages})
    placed = pipeline.place_pipeline_params(
        params.init_params(config, seed=seed, dtype=torch.float32), m)
    assert placed[0]["layers"]["ls1"].shape[0] == config.num_hidden_layers // stages
    got = pipeline.pipeline_forward(placed, torch.from_numpy(x), config, OPTS, m,
                                    num_microbatches=microbatches, classify=True)
    for key in keys:
        tol = ({"rtol": SHARD_RTOL, "atol": SHARD_ATOL} if key == "probs"
               else {"rtol": 0, "atol": TOKEN_ATOL})
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), **tol)
    return got, placed, m, x


@pytest.mark.parametrize("stages,microbatches", [(2, 2), (4, 4)])
def test_pipeline_forward_matches_jax(stages, microbatches):
    config = DinoConfig(hidden_size=64, num_hidden_layers=8, num_attention_heads=2,
                        num_classes=8, patch_size=14, img_size=70)
    got, _, _, x = _pipeline_case(config, 4, stages, microbatches,
                                  ("cls_token", "patch_tokens", "probs"))
    # and bit for bit the port's own sequential forward
    want = vit.forward(params.init_params(config, seed=4, dtype=torch.float32),
                       torch.from_numpy(x), config, OPTS, classify=True)
    for key, value in want.items():
        np.testing.assert_array_equal(got[key].numpy(), value.numpy())


def test_pipeline_forward_vit_s_dims_matches_jax():
    """The JAX package's ViT-S-dims case: d=384, 12 layers, 6 heads, 4 stages
    x 4 microbatches."""
    config = DinoConfig(hidden_size=384, num_hidden_layers=12, num_attention_heads=6,
                        num_classes=8, patch_size=14, img_size=70)
    _pipeline_case(config, 5, 4, 4, ("cls_token", "probs"))


def test_pipeline_forward_validations():
    config = DinoConfig(hidden_size=64, num_hidden_layers=6, num_attention_heads=2,
                        num_classes=8, patch_size=14, img_size=70)
    m = _cpu_mesh({"stage": 4})
    x = torch.zeros((8, 70, 70, 3))
    placed = mesh.replicate(params.init_params(config, seed=0, dtype=torch.float32), m)
    with pytest.raises(ValueError, match="^6 layers do not split over 4 stages$"):
        pipeline.pipeline_forward(placed, x, config, OPTS, m)
    config8 = dataclasses.replace(config, num_hidden_layers=8)
    placed = pipeline.place_pipeline_params(
        params.init_params(config8, seed=0, dtype=torch.float32), m)
    with pytest.raises(ValueError, match=r"^batch 8 % microbatches 3 != 0$"):
        pipeline.pipeline_forward(placed, x, config8, OPTS, m, num_microbatches=3)


def test_layer_pspecs_match_jax():
    jp = jparams.init_params(TINY, seed=0, dtype=jnp.float32)
    want = {k: tuple(v) for k, v in _jax_leaves(jpipeline.layer_pspecs(jp)).items()}
    assert _port_leaves(pipeline.layer_pspecs(
        params.init_params(TINY, seed=0, dtype=torch.float32))) == want
    # a QuantLinear's fields split on L with the rest of its layer
    ql = _fake_quant_params(TINY)
    assert pipeline.layer_pspecs(ql)["layers"]["qkv"]["kernel"] == ("stage", None, None)
    assert isinstance(ql["layers"]["qkv"]["kernel"], PACKED_WEIGHTS)
