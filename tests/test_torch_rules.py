"""Rules of the port: it never imports jax, it reaches the JAX package only
through its three re-export modules, and importing its kernel module builds
nothing."""

import importlib
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PACKAGE = ROOT / "dinov2_tpu_torch"


def test_no_source_file_imports_jax():
    pattern = re.compile(r"^\s*(import jax\b|from jax\b)", re.MULTILINE)
    files = [*sorted(PACKAGE.rglob("*.py")), ROOT / "chip_smoke.py"]
    assert len(files) > 10
    assert [str(p.relative_to(ROOT)) for p in files if pattern.search(p.read_text())] == []


def test_only_the_reexport_modules_name_the_jax_package():
    """chip_smoke.py and the port's modules import `dinov2_tpu_torch` only;
    the JAX package's jax-free host modules come in through models/config.py,
    io/gguf.py and io/synthetic.py."""
    pattern = re.compile(r"^\s*(import|from) dinov2_tpu(\.|\s|$)", re.MULTILINE)
    reexports = {"models/config.py", "io/gguf.py", "io/synthetic.py"}
    naming = {
        str(p.relative_to(PACKAGE)) for p in PACKAGE.rglob("*.py") if pattern.search(p.read_text())
    }
    assert naming == reexports
    assert not pattern.search((ROOT / "chip_smoke.py").read_text())


def test_forward_runs_without_jax_in_a_fresh_process():
    """With JAX_PLATFORMS unset (so dinov2_tpu/__init__.py imports no jax),
    the port loads, runs a tiny forward and leaves jax out of sys.modules."""
    code = (
        "import sys, torch\n"
        "from dinov2_tpu_torch.models.config import DinoConfig\n"
        "from dinov2_tpu_torch.models.params import init_params\n"
        "from dinov2_tpu_torch.models.vit import ModelOptions, forward\n"
        "from dinov2_tpu_torch.runtime import engine\n"
        "from dinov2_tpu_torch.ops import _kernels\n"
        "c = DinoConfig(hidden_size=64, num_hidden_layers=1, num_attention_heads=2,"
        " num_classes=3, patch_size=14, img_size=28)\n"
        "out = forward(init_params(c, dtype=torch.float32), torch.zeros(1, 28, 28, 3), c,"
        " ModelOptions(compute_dtype=torch.float32), classify=True)\n"
        "assert out['probs'].shape == (1, 3)\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_importing_the_kernel_module_runs_no_compiler(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError(f"subprocess started at import: {args}")

    monkeypatch.setattr(subprocess, "run", refuse)
    monkeypatch.setattr(subprocess, "Popen", refuse)
    from dinov2_tpu_torch.ops import _kernels

    module = importlib.reload(_kernels)
    assert module.slab_layer_lib.cache_info().currsize == 0

