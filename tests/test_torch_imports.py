"""reed_tpu_torch and chip_smoke.py stand alone: no JAX, flax, optax, orbax
or reed_tpu import anywhere, and importing the CLI loads no JAX."""

import ast
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = re.compile(r"^(jax|jaxlib|flax|optax|orbax|reed_tpu)(\.|$)")


def _files():
    return sorted(ROOT.glob("reed_tpu_torch/**/*.py")) + [ROOT / "chip_smoke.py"]


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax_or_reed_tpu():
    files = _files()
    assert len(files) > 10
    bad = [(str(p.relative_to(ROOT)), m) for p in files for m in _imports(p)
           if FORBIDDEN.match(m)]
    assert not bad, bad


def test_forbidden_pattern():
    for name in ("jax", "jax.numpy", "flax.linen", "optax", "orbax.checkpoint",
                 "reed_tpu", "reed_tpu.ops.attention"):
        assert FORBIDDEN.match(name), name
    for name in ("reed_tpu_torch", "reed_tpu_torch.ops", "torch", "numpy"):
        assert not FORBIDDEN.match(name), name


def test_cli_import_loads_no_jax():
    code = ("import sys, reed_tpu_torch.cli, reed_tpu_torch.models.sit, "
            "reed_tpu_torch.eval.fid; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'optax', 'orbax', 'reed_tpu')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)
