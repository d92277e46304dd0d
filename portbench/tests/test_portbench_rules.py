"""What the benchmark may import: nothing of jax or of the JAX package
dinov2_tpu, by whole top-level names (the port, dinov2_tpu_torch, begins
with the JAX package's name); the reference nothing of the port either."""

import ast
import subprocess
import sys

from portbench import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "dinov2_tpu"}
SOURCES = sorted(p for p in spec.HERE.rglob("*.py") if "tests" not in p.parts)


def _imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_source_imports_jax_or_the_jax_package():
    assert len(SOURCES) > 10
    assert {str(p): _imports(p) & FORBIDDEN for p in SOURCES if _imports(p) & FORBIDDEN} == {}


def test_the_reference_imports_nothing_of_the_port():
    allowed = {"__future__", "contextlib", "math", "numpy", "torch"}
    for path in sorted((spec.HERE / "reference").glob("*.py")):
        assert _imports(path) <= allowed, path


def test_a_run_loads_neither_jax_nor_the_jax_package():
    """A whole run of each cell at a tiny size on the CPU, in a fresh
    process: sys.modules then holds none of the forbidden names, and
    dinov2_tpu_torch is not taken for dinov2_tpu."""
    code = (
        "import sys\n"
        f"sys.path.insert(0, {str(spec.ROOT)!r}); sys.path.insert(0, {str(spec.HERE / 'tests')!r})\n"
        "from conftest import tiny\n"
        "from portbench import harness, spec\n"
        "for name in ['vitb14-classify-b64', 'vitl14-features-518-b8',"
        " 'vitb14-classify-q4_0-b64', 'vitb14-classify-int8-b64', 'vitb14-train-f32-b32']:\n"
        "    r = harness.run_cell(tiny(spec.load_cell(name)), 5, 0.05, False, 'cpu')\n"
        "    assert r['forbidden'] == [], r['forbidden']\n"
        "assert 'dinov2_tpu_torch' in sys.modules\n"
        "print(sorted({m.split('.')[0] for m in sys.modules} & "
        "{'jax', 'jaxlib', 'flax', 'dinov2_tpu'}))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=600, cwd=spec.ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == "[]"
