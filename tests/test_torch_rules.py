"""Rules of the port: it never imports jax, optax, orbax nor the JAX package,
and importing its kernel module builds nothing."""

import importlib
import os
import re
import subprocess
import sys
from pathlib import Path
import torch_threads  # noqa: F401  (caps torch's threads under xdist)

ROOT = Path(__file__).resolve().parent.parent
PACKAGE = ROOT / "dinov2_tpu_torch"


def test_no_source_file_imports_jax():
    """Nor optax or orbax, which the JAX package's trainer and checkpoint
    module use and the card's machine does not have; nor do the rank
    processes of tests/test_torch_distributed.py and
    tests/test_torch_pipeline_ranks.py."""
    pattern = re.compile(r"^\s*(import|from) (jax|optax|orbax)\b", re.MULTILINE)
    files = [*sorted(PACKAGE.rglob("*.py")), ROOT / "chip_smoke.py",
             ROOT / "tests" / "torch_rank_worker.py",
             ROOT / "tests" / "torch_pipeline_rank_worker.py"]
    assert len(files) > 10
    assert [str(p.relative_to(ROOT)) for p in files if pattern.search(p.read_text())] == []


def test_only_the_reexport_modules_name_the_jax_package():
    """No file of the port, and not chip_smoke.py, imports the JAX package,
    not even one of its jax-free host modules: the port keeps its own copies
    (models/config.py, io/gguf.py, io/synthetic.py, quant/, utils/native.py;
    tests/test_torch_host_copies.py holds them against the originals)."""
    pattern = re.compile(r"^\s*(import|from) dinov2_tpu(\.|\s|$)", re.MULTILINE)
    files = [*sorted(PACKAGE.rglob("*.py")), ROOT / "chip_smoke.py",
             ROOT / "tests" / "torch_rank_worker.py",
             ROOT / "tests" / "torch_pipeline_rank_worker.py"]
    assert len(files) > 10
    assert [str(p.relative_to(ROOT)) for p in files if pattern.search(p.read_text())] == []


def test_forward_runs_without_jax_in_a_fresh_process():
    """With JAX_PLATFORMS=cpu set (which makes `import dinov2_tpu` import
    jax), the port writes, quantizes, loads and runs a tiny GGUF and leaves
    both jax and dinov2_tpu out of sys.modules."""
    code = (
        "import sys, tempfile, numpy as np, torch\n"
        "from pathlib import Path\n"
        "from dinov2_tpu_torch.io.synthetic import write_synthetic_gguf\n"
        "from dinov2_tpu_torch.quant import quantize_gguf\n"
        "from dinov2_tpu_torch.runtime.engine import DinoEngine\n"
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
        "with tempfile.TemporaryDirectory() as tmp:\n"
        "    c = DinoConfig(hidden_size=64, num_hidden_layers=1, num_attention_heads=1,"
        " num_classes=3, patch_size=14, img_size=28)\n"
        "    dense = write_synthetic_gguf(Path(tmp) / 'm.gguf', c, seed=1)\n"
        "    q = quantize_gguf(dense, Path(tmp) / 'q.gguf', 'q4_0')\n"
        "    e = DinoEngine(q, dtype=torch.float32, device='cpu', quant_mode='fused')\n"
        "    probs = e.classify_probs(np.zeros((1, 30, 30, 3), np.uint8))\n"
        "assert probs.shape == (1, 3) and np.isfinite(probs).all()\n"
        "from dinov2_tpu_torch.parallel.train import make_trainer\n"
        "from dinov2_tpu_torch.parallel import checkpoint\n"
        "from dinov2_tpu_torch.io import export\n"
        "from dinov2_tpu_torch.cli import train\n"
        "from dinov2_tpu_torch.cli import aot as cli_aot\n"
        "from dinov2_tpu_torch.runtime import aot\n"
        "from dinov2_tpu_torch.ops import _library\n"
        "c = DinoConfig(hidden_size=64, num_hidden_layers=1, num_attention_heads=1,"
        " num_classes=3, patch_size=14, img_size=28)\n"
        "t = make_trainer(c, device='cpu')\n"
        "p, s = t.place(init_params(c, dtype=torch.float32))\n"
        "p, s, m = t.step(p, s, np.zeros((2, 30, 30, 3), np.uint8), np.array([0, 2]))\n"
        "assert np.isfinite(float(m['loss']))\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "assert 'optax' not in sys.modules and 'orbax' not in sys.modules\n"
        "assert 'dinov2_tpu' not in sys.modules, 'the JAX package was imported'\n"
        "print('ok')\n"
    )
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
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
    for lib in ("slab_layer_lib", "slab_attention_lib", "slab_mlp_lib", "flash_attention_lib",
                "flash_backward_lib", "quant_matmul_lib", "quant_layer_lib"):
        assert getattr(module, lib).cache_info().currsize == 0, lib



def test_chip_smoke_prints_no_result_without_a_gpu(tmp_path):
    """chip_smoke.py exits non-zero and prints nothing on stdout where no
    CUDA device is available, run from the checkout or alone in a directory."""
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    alone = tmp_path / "chip_smoke.py"
    alone.write_bytes((ROOT / "chip_smoke.py").read_bytes())
    for script, cwd in ((ROOT / "chip_smoke.py", ROOT), (alone, tmp_path)):
        proc = subprocess.run(
            [sys.executable, str(script)], cwd=cwd, env=env,
            capture_output=True, text=True, timeout=120,
        )
        assert proc.returncode != 0 and proc.stdout == ""
