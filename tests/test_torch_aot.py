"""AOT deployment artifacts on the port (dinov2_tpu_torch/runtime/aot.py and
cli/aot.py): the cases of tests/test_aot.py at the same TINY config, the
port's artifact against the JAX package's on the same GGUF and inputs, the
CUDA program traced on this CPU-only box (its graph holds the kernels'
operators), and the header contract across the two packages."""

from __future__ import annotations

import json
import os
import struct
import subprocess
import sys
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (caps torch's threads under xdist)

from dinov2_tpu_torch.io.synthetic import write_synthetic_gguf
from dinov2_tpu_torch.models.config import DinoConfig
from dinov2_tpu_torch.models.params import load_params
from dinov2_tpu_torch.models.vit import ModelOptions, forward
from dinov2_tpu_torch.quant import quantize_gguf
from dinov2_tpu_torch.runtime.aot import (
    aot_info,
    export_forward,
    load_artifact,
    save_artifact,
)
from test_torch_slice import PROB_ATOL, TOKEN_ATOL

ROOT = Path(__file__).resolve().parent.parent
TINY = DinoConfig(
    hidden_size=64,
    num_hidden_layers=2,
    num_attention_heads=2,
    num_classes=4,
    patch_size=14,
    img_size=70,
)
F32 = ModelOptions(parity="reference", compute_dtype=torch.float32)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    path = tmp_path_factory.mktemp("aot") / "tiny.gguf"
    return write_synthetic_gguf(path, TINY, seed=7)


@pytest.fixture(scope="module")
def loaded(ckpt):
    return load_params(ckpt, dtype=torch.float32)


def _x(shape, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape).astype(np.float32))


def _write(path, data) -> Path:
    save_artifact(path, data)
    return path


def test_export_roundtrip_matches_live_forward(loaded, tmp_path):
    data = export_forward(loaded.params, loaded.config, F32, batch=2, height=70, width=70,
                          classify=True, platforms=("cpu",))
    art = load_artifact(_write(tmp_path / "tiny.aot", data))
    x = _x((2, 70, 70, 3))
    got = art(loaded.params, x)
    want = forward(loaded.params, x, loaded.config, F32, classify=True)
    assert set(got) == set(want) == {"cls_token", "patch_tokens", "probs"}
    for key in want:
        assert torch.equal(got[key], want[key]), key
    # weights are NOT embedded: artifact stays small
    assert len(data) < 2_000_000


def test_both_platforms_and_header(loaded, tmp_path):
    opts = ModelOptions(parity="hf", compute_dtype=torch.float32)
    path = _write(tmp_path / "mp.aot", export_forward(
        loaded.params, loaded.config, opts, batch=1, height=70, width=70, classify=False))

    meta = aot_info(path)
    assert meta["kind"] == "dinov2_tpu_torch.forward"
    assert meta["platforms"] == ["cuda", "cpu"]
    assert set(meta["programs"]) == {"cuda", "cpu"}
    assert meta["classify"] is False
    assert meta["opts"]["parity"] == "hf" and meta["opts"]["compute_dtype"] == "float32"
    assert meta["model"]["hidden_size"] == 64
    assert meta["input"] == {"batch": 1, "height": 70, "width": 70, "channels": 3}
    assert meta["torch_version"] == torch.__version__

    # the cuda+cpu artifact still executes on this cpu host, through its cpu program
    art = load_artifact(path)
    out = art(loaded.params, torch.zeros((1, 70, 70, 3)))
    assert tuple(out["patch_tokens"].shape) == (1, 25, 64)
    assert "probs" not in out


def test_artifact_shape_contract(loaded, tmp_path):
    path = _write(tmp_path / "c.aot", export_forward(
        loaded.params, loaded.config, F32, batch=2, height=70, width=70, platforms=("cpu",)))
    art = load_artifact(path)
    with pytest.raises(ValueError, match="takes a"):
        art(loaded.params, torch.zeros((3, 70, 70, 3)))  # wrong batch
    with pytest.raises(ValueError, match="takes a"):
        art(loaded.params, torch.zeros((2, 84, 84, 3)))  # wrong size
    with pytest.raises(ValueError, match="takes a"):
        art(loaded.params, torch.zeros((2, 70, 70, 3), dtype=torch.float64))  # wrong dtype
    with pytest.raises(ValueError, match="no program for meta"):
        art(loaded.params, torch.zeros((2, 70, 70, 3), device="meta"))
    # a weight of another shape fails the program's own input check: no retrace
    params = {**loaded.params, "cls_token": torch.zeros(32)}
    with pytest.raises(Exception, match="shape"):
        art(params, torch.zeros((2, 70, 70, 3)))


@pytest.mark.parametrize("fmt", ["q8_0", "q4_1", "q5_0"])
def test_fused_quant_artifact(ckpt, tmp_path, fmt):
    """QuantLinear leaves (int8 SoA, packed nibble planes with mins, with
    5th-bit planes) go through the registered pytree node; the artifact
    matches the live fused forward exactly."""
    q = quantize_gguf(ckpt, tmp_path / f"{fmt}.gguf", fmt)
    loaded = load_params(q, dtype=torch.float32, quant_mode="fused")
    path = _write(tmp_path / "q.aot", export_forward(
        loaded.params, loaded.config, F32, batch=1, height=70, width=70, platforms=("cpu",)))
    x = torch.full((1, 70, 70, 3), 0.5)
    got = load_artifact(path)(loaded.params, x)
    want = forward(loaded.params, x, loaded.config, F32, classify=True)
    assert torch.equal(got["probs"], want["probs"])


def test_bad_magic_rejected(tmp_path):
    p = tmp_path / "junk.aot"
    p.write_bytes(b"NOPE" + b"\0" * 64)
    with pytest.raises(ValueError, match="bad magic"):
        aot_info(p)
    # truncations stay typed ValueErrors too (prefix cut, then header cut)
    p.write_bytes(b"DAOT\x01")
    with pytest.raises(ValueError, match="truncated artifact"):
        aot_info(p)
    p.write_bytes(b"DAOT" + struct.pack("<BI", 1, 500) + b"{}")
    with pytest.raises(ValueError, match="truncated artifact"):
        aot_info(p)
    with pytest.raises(ValueError, match="truncated artifact"):
        load_artifact(p)


def _png(path, shape, seed=0) -> str:
    import cv2

    cv2.imwrite(str(path), np.random.default_rng(seed).integers(0, 255, shape, dtype=np.uint8))
    return str(path)


def test_cli_export_info_run(ckpt, tmp_path, capsys):
    from dinov2_tpu_torch.cli import aot as cli
    from dinov2_tpu_torch.cli import inference

    art = tmp_path / "tiny.aot"
    rc = cli.main([
        "export", "-m", str(ckpt), "--dtype", "f32", "--batch", "1",
        "--size", "224x224", "--platforms", "cpu", "-o", str(art),
    ])
    assert rc == 0 and art.exists()
    assert "platforms=cpu" in capsys.readouterr().err

    rc = cli.main(["info", str(art)])
    assert rc == 0
    meta = json.loads(capsys.readouterr().out)
    assert meta["input"]["height"] == 224 and meta["classify"] is True
    assert meta["load"] == {"dtype": "f32", "quant_mode": "dequant"}

    img = _png(tmp_path / "in.png", (60, 80, 3))
    # run reads the weight-loading recipe (dtype/quant layout) from the
    # artifact header — no flags to get wrong
    rc = cli.main(["run", str(art), "-m", str(ckpt), "-i", img, "-k", "2", "--device", "cpu"])
    assert rc == 0
    out = capsys.readouterr().out
    assert out.count(" > ") == 2  # top-k lines in the reference's print format
    # the same lines as the inference CLI's on the same image
    assert inference.main(["-m", str(ckpt), "-i", img, "-c", "-k", "2", "--device", "cpu",
                           "--dtype", "f32"]) == 0
    assert capsys.readouterr().out == out


def test_cli_run_size_mismatch_is_actionable(ckpt, tmp_path, capsys):
    from dinov2_tpu_torch.cli import aot as cli

    art = tmp_path / "feat.aot"
    assert cli.main([
        "export", "-m", str(ckpt), "--dtype", "f32", "--features",
        "--size", "84x84", "--platforms", "cpu", "-o", str(art),
    ]) == 0
    # 100x100 input -> Q4 preprocess target 112x112 != the 84x84 artifact
    img = _png(tmp_path / "big.png", (100, 100, 3))
    with pytest.raises(SystemExit, match="does not match the artifact"):
        cli.main(["run", str(art), "-m", str(ckpt), "-i", img, "--device", "cpu"])
    # matching input runs the feature tap
    img2 = _png(tmp_path / "ok.png", (70, 70, 3))
    assert cli.main(["run", str(art), "-m", str(ckpt), "-i", img2, "--device", "cpu"]) == 0
    assert "patch tokens: (36, 64)" in capsys.readouterr().out


def test_cli_run_on_cuda_without_a_card_raises(ckpt, tmp_path, monkeypatch):
    """`run` defaults to the card and never carries on on the CPU."""
    from dinov2_tpu_torch.cli import aot as cli

    art = tmp_path / "tiny.aot"
    assert cli.main(["export", "-m", str(ckpt), "--dtype", "f32", "--size", "70x70",
                     "--platforms", "cuda,cpu", "-o", str(art)]) == 0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["run", str(art), "-m", str(ckpt), "-i", _png(tmp_path / "i.png", (70, 70, 3))])


@pytest.mark.parametrize("parity", ["reference", "hf"])
def test_artifact_matches_the_jax_artifact(ckpt, tmp_path, parity):
    """The same GGUF and the same numpy inputs through the JAX package's
    export_forward/load_artifact (platform cpu) and the port's: f32 probs and
    tokens within tests/test_torch_slice.py's tolerances."""
    import jax.numpy as jnp

    from dinov2_tpu.models import params as jparams
    from dinov2_tpu.models import vit as jvit
    from dinov2_tpu.runtime import aot as jaot

    x = np.random.default_rng(3).standard_normal((2, 70, 70, 3)).astype(np.float32)
    jloaded = jparams.load_params(ckpt, dtype=jnp.float32)
    jopts = jvit.ModelOptions(parity=parity, compute_dtype=jnp.float32)
    jaot.save_artifact(tmp_path / "jax.aot", jaot.export_forward(
        jloaded.params, jloaded.config, jopts, batch=2, height=70, width=70, platforms=("cpu",)))
    want = jaot.load_artifact(tmp_path / "jax.aot")(jloaded.params, x)

    loaded = load_params(ckpt, dtype=torch.float32)
    opts = ModelOptions(parity=parity, compute_dtype=torch.float32)
    path = _write(tmp_path / "port.aot", export_forward(
        loaded.params, loaded.config, opts, batch=2, height=70, width=70, platforms=("cpu",)))
    got = load_artifact(path)(loaded.params, torch.from_numpy(x))
    for key in ("cls_token", "patch_tokens"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=TOKEN_ATOL[parity], rtol=0)
    np.testing.assert_allclose(got["probs"].numpy(), np.asarray(want["probs"]),
                               atol=PROB_ATOL, rtol=0)


# configs the CUDA kernels take: head_dim 64, bf16; K5 needs D in (384, 768, 1024)
KERNEL_CONFIG = DinoConfig(hidden_size=128, num_hidden_layers=2, num_attention_heads=2,
                           num_classes=4, patch_size=14, img_size=70)
MLP_CONFIG = DinoConfig(hidden_size=384, num_hidden_layers=2, num_attention_heads=6,
                        num_classes=4, patch_size=14, img_size=70)
OPS = ("slab_layer_block", "slab_attention_block", "slab_attention", "slab_mlp_block",
       "flash_attention", "quant_matmul", "slab_layer_block_quant")


@pytest.mark.parametrize(
    "config, quant, options, want",
    [
        (KERNEL_CONFIG, None, {}, {"slab_layer_block": 2}),
        (KERNEL_CONFIG, None, {"slab_fusion": "proj"}, {"slab_attention_block": 2}),
        (KERNEL_CONFIG, None, {"slab_fusion": "core"}, {"slab_attention": 2}),
        (KERNEL_CONFIG, None, {"flash_attention": True}, {"flash_attention": 2}),
        (MLP_CONFIG, None, {"fuse_mlp": True}, {"slab_layer_block": 2, "slab_mlp_block": 2}),
        # K8 per layer, K7 for fc1, fc2 per layer and the head
        (KERNEL_CONFIG, "q4_0", {}, {"slab_layer_block_quant": 2, "quant_matmul": 5}),
    ],
    ids=["K1", "K2", "K3", "K4", "K5", "K7+K8"],
)
def test_cuda_program_traced_on_this_box(tmp_path, config, quant, options, want):
    """The CUDA program, traced on fake CUDA tensors here, holds one
    dinov2_tpu_torch operator node per kernel call and no SDPA node; its CPU
    program holds the same nodes. The fake implementations build nothing."""
    from dinov2_tpu_torch.ops import _kernels

    path = write_synthetic_gguf(tmp_path / "k.gguf", config, seed=1)
    if quant:
        path = quantize_gguf(path, tmp_path / "q.gguf", quant)
    loaded = load_params(path, dtype=torch.bfloat16, quant_mode="fused" if quant else "dequant")
    built = [name for name in _kernels.LIBRARIES
             if getattr(_kernels, f"{name}_lib").cache_info().currsize]
    data = export_forward(loaded.params, loaded.config, ModelOptions(**options), batch=2,
                          height=70, width=70)
    art = load_artifact(_write(tmp_path / "k.aot", data))
    for platform in ("cuda", "cpu"):
        targets = [str(n.target) for n in art.program(platform).graph.nodes
                   if n.op == "call_function"]
        ops = Counter(t.split(".")[1] for t in targets if t.startswith("dinov2_tpu_torch."))
        assert ops == want, platform
        assert not any("scaled_dot_product" in t for t in targets)
    assert [name for name in _kernels.LIBRARIES
            if getattr(_kernels, f"{name}_lib").cache_info().currsize] == built


def test_fake_implementations_refuse_what_the_kernels_refuse(tmp_path):
    """A CUDA program whose kernel would refuse its arguments fails at export
    time: K5 at a width it is not built for."""
    path = write_synthetic_gguf(tmp_path / "k.gguf", KERNEL_CONFIG, seed=1)
    loaded = load_params(path, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="MLP kernel"):
        export_forward(loaded.params, loaded.config, ModelOptions(fuse_mlp=True), batch=1,
                       height=70, width=70, platforms=("cuda",))
    # the CPU program runs the plain versions, which take it
    export_forward(loaded.params, loaded.config, ModelOptions(fuse_mlp=True), batch=1,
                   height=70, width=70, platforms=("cpu",))


def test_int8_weights_do_not_export(ckpt):
    loaded = load_params(ckpt, dtype=torch.float32, quant_mode="int8")
    with pytest.raises(ValueError, match="int8"):
        export_forward(loaded.params, loaded.config, F32, batch=1, height=70, width=70)


def _fresh(code: str) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)


def test_headers_read_across_packages(loaded, tmp_path):
    """aot_info imports no torch (nor jax); each package's aot_info reads the
    other's header; the port's load_artifact refuses a JAX artifact."""
    import jax.numpy as jnp

    from dinov2_tpu.models import params as jparams
    from dinov2_tpu.models import vit as jvit
    from dinov2_tpu.runtime import aot as jaot

    port = _write(tmp_path / "port.aot", export_forward(
        loaded.params, loaded.config, F32, batch=1, height=70, width=70, platforms=("cpu",)))
    jloaded = jparams.load_params(write_synthetic_gguf(tmp_path / "j.gguf", TINY, seed=7),
                                  dtype=jnp.float32)
    jax_art = tmp_path / "jax.aot"
    jaot.save_artifact(jax_art, jaot.export_forward(
        jloaded.params, jloaded.config, jvit.ModelOptions(compute_dtype=jnp.float32), batch=1,
        height=70, width=70, platforms=("cpu",)))

    kinds = f"[aot_info({str(port)!r})['kind'], aot_info({str(jax_art)!r})['kind']]"
    proc = _fresh(
        "import sys, json\n"
        "from dinov2_tpu_torch.runtime.aot import aot_info\n"
        f"print(json.dumps({kinds}))\n"
        "assert 'torch' not in sys.modules and 'jax' not in sys.modules, 'imported'\n"
    )
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout) == ["dinov2_tpu_torch.forward", "dinov2_tpu.forward"]

    assert jaot.aot_info(port)["input"] == {"batch": 1, "height": 70, "width": 70, "channels": 3}
    assert aot_info(jax_art)["jax_version"]
    with pytest.raises(ValueError, match="JAX package artifact"):
        load_artifact(jax_art)


def test_loading_and_calling_builds_no_model(loaded, ckpt, tmp_path):
    """A fresh process that loads an artifact and calls it never imports
    models/vit.py: the operators and the pytree node are all it registers."""
    from dinov2_tpu_torch.io.synthetic import write_synthetic_gguf as write

    q = quantize_gguf(write(tmp_path / "m.gguf", TINY, seed=7), tmp_path / "q.gguf", "q4_0")
    qloaded = load_params(q, dtype=torch.float32, quant_mode="fused")
    path = _write(tmp_path / "q.aot", export_forward(
        qloaded.params, qloaded.config, F32, batch=1, height=70, width=70, platforms=("cpu",)))
    proc = _fresh(
        "import sys, torch\n"
        "from dinov2_tpu_torch.models.params import load_params\n"
        "from dinov2_tpu_torch.runtime.aot import load_artifact\n"
        f"art = load_artifact({str(path)!r})\n"
        f"p = load_params({str(q)!r}, dtype=torch.float32, quant_mode='fused').params\n"
        "out = art(p, torch.zeros((1, 70, 70, 3)))\n"
        "assert out['probs'].shape == (1, 4) and torch.isfinite(out['probs']).all()\n"
        "assert 'dinov2_tpu_torch.models.vit' not in sys.modules, 'vit imported'\n"
        "assert 'jax' not in sys.modules and 'dinov2_tpu' not in sys.modules\n"
        "print('ok')\n"
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
