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
            "reed_tpu_torch.eval.fid, reed_tpu_torch.models.pmpnn, "
            "reed_tpu_torch.ops.fused_message, reed_tpu_torch.ops.graph, "
            "reed_tpu_torch.encoders.fmif_convert, reed_tpu_torch.diffusion.discrete, "
            "reed_tpu_torch.eval.protein_metrics, reed_tpu_torch.data.protein, "
            "reed_tpu_torch.train.protein, reed_tpu_torch.core.trainer, "
            "reed_tpu_torch.core.logging, reed_tpu_torch.diffusion.protein_losses, "
            "reed_tpu_torch.data.synthetic, reed_tpu_torch.tools.convergence_protein, "
            "reed_tpu_torch.train.image, reed_tpu_torch.data.image, "
            "reed_tpu_torch.diffusion.continuous, reed_tpu_torch.tools.convergence_image, "
            "reed_tpu_torch.core.configlib, reed_tpu_torch.core.checkpoint, "
            "reed_tpu_torch.core.stats, reed_tpu_torch.encoders.flax_tree, "
            "reed_tpu_torch.encoders.vae, reed_tpu_torch.encoders.inception, "
            "reed_tpu_torch.encoders.vit, reed_tpu_torch.encoders.registry, "
            "reed_tpu_torch.eval.frechet, reed_tpu_torch.eval.visualize, "
            "reed_tpu_torch.data.preprocessing, reed_tpu_torch.tools.seeded_weights, "
            "reed_tpu_torch.models.semla, reed_tpu_torch.train.molecule_semla, "
            "reed_tpu_torch.diffusion.molecule_fm, reed_tpu_torch.data.molecule, "
            "reed_tpu_torch.eval.molecule_metrics, reed_tpu_torch.encoders.semla_convert, "
            "reed_tpu_torch.tools.convergence_semla, reed_tpu_torch.models.egnn, "
            "reed_tpu_torch.diffusion.edm, reed_tpu_torch.diffusion.efm, "
            "reed_tpu_torch.train.molecule_edm, reed_tpu_torch.encoders.edm_convert, "
            "reed_tpu_torch.eval.two_stage, reed_tpu_torch.tools.convergence_edm, "
            "reed_tpu_torch.models.rdm_mlp, reed_tpu_torch.diffusion.rdm, "
            "reed_tpu_torch.eval.rep_samplers, reed_tpu_torch.train.rdm, "
            "reed_tpu_torch.encoders.rdm_convert, reed_tpu_torch.tools.convergence_rdm, "
            "reed_tpu_torch.ops.so3, reed_tpu_torch.ops.residue_constants, "
            "reed_tpu_torch.diffusion.se3, reed_tpu_torch.models.ipa, "
            "reed_tpu_torch.encoders.multiflow_convert, reed_tpu_torch.train.multiflow, "
            "reed_tpu_torch.tools.convergence_multiflow, reed_tpu_torch.ops.torsion, "
            "reed_tpu_torch.models.property_classifier, reed_tpu_torch.train.property, "
            "reed_tpu_torch.encoders.property_convert, reed_tpu_torch.eval.chemnet, "
            "reed_tpu_torch.eval.molsets, reed_tpu_torch.eval.midi_metrics, "
            "reed_tpu_torch.eval.orca, reed_tpu_torch.eval.graph_stats; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'optax', 'orbax', 'reed_tpu')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)
