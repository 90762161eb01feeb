"""The port's MultiFlow entry points on the CPU at a tiny width:
train-multiflow with --ckpt-dir, then eval-multiflow from its EMA writing
PDB files that parse_pdb_backbone reads back; --data-dir on fabricated PDB
files (the data half against reed_tpu's); --ref-ckpt on a saved reference
torch mini (Lightning layout); the PDB / mmCIF readers, the writer and the
geometry report against reed_tpu's; FoldingModel with a fake folding
command."""

import json
import os
import sys

import numpy as np
import pytest

from reed_tpu.data import protein as jprotein
from reed_tpu.eval import protein_metrics as jpm
from reed_tpu_torch import cli
from reed_tpu_torch.data import protein
from reed_tpu_torch.eval import protein_metrics as pm
from test_multiflow_convert import TFlowModel
from test_protein_data import _write_fake_pdb

TINY = ["--device", "cpu", "--set", "c_s=32", "--set", "c_z=16", "--set", "num_blocks=2",
        "--set", "ipa_c_hidden=8", "--set", "ipa_no_heads=2", "--set", "ipa_no_qk_points=3",
        "--set", "ipa_no_v_points=4"]


def _json_tail(text):
    return json.loads(text[text.rindex("\n{\n") + 1:])


def test_train_then_eval_from_checkpoint(tmp_path, capsys):
    run, out = str(tmp_path / "run"), str(tmp_path / "pdb")
    cli.main(["train-multiflow", "--synthetic", "--steps", "2", "--batch-size", "2",
              "--log-every", "1", "--ckpt-dir", run, "--ckpt-every", "2",
              "--set", "max_len=16", *TINY])
    text = capsys.readouterr().out
    assert "residues/s" in text and "[step 2]" in text
    assert {"2.pt", "config.json", "metrics.jsonl"} <= set(os.listdir(run))
    result = cli.main(["eval-multiflow", "--ckpt-dir", run, "--num-samples", "2",
                       "--length", "10", "--num-steps", "4", "--out", out, *TINY])
    text = capsys.readouterr().out
    assert "loaded EMA weights of step 2" in text and "ms per sampler step" in text
    assert _json_tail(text)["mean"] == result["mean"]
    assert sorted(os.listdir(out)) == ["sample_0.pdb", "sample_1.pdb"]
    for i, rep in enumerate(result["samples"]):
        bb = pm.parse_pdb_backbone(rep["pdb"])
        assert bb.shape == (10, 4, 3) and np.isfinite(bb).all()
        assert len(rep["sequence"]) == 10 and np.isfinite(rep["ca_ca_dist_mean"])
        # the report is the one of the written backbone, to the PDB's 1e-3 A
        d = np.linalg.norm(np.diff(bb[:, 1], axis=0), axis=-1).mean()
        assert abs(d - rep["ca_ca_dist_mean"]) < 5e-3


def test_data_dir_matches_jax_and_trains(tmp_path, capsys):
    for i, length in enumerate((9, 14, 20)):
        _write_fake_pdb(str(tmp_path / f"chain{i}.pdb"), length=length, seed=i)
    entries = protein.load_multiflow_entries(str(tmp_path))
    want = jprotein.load_multiflow_entries(str(tmp_path))
    assert [e["name"] for e in entries] == [e["name"] for e in want]
    for a, b in zip(entries, want):
        for k in ("trans", "rotmats", "aatypes"):
            assert np.array_equal(a[k], b[k]), k
    got = list(protein.multiflow_epoch_batches(str(tmp_path), 2, np.random.default_rng(0),
                                               max_len=16, trans_batch_ot=True))
    ref = list(jprotein.multiflow_epoch_batches(str(tmp_path), 2, np.random.default_rng(0),
                                                max_len=16, trans_batch_ot=True))
    assert len(got) == len(ref) == 2
    for a, b in zip(got, ref):
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_allclose(a[k], b[k], atol=1e-5, err_msg=k)
    cli.main(["train-multiflow", "--data-dir", str(tmp_path), "--steps", "2", "--batch-size",
              "2", "--log-every", "1", "--set", "max_len=16", *TINY])
    text = capsys.readouterr().out
    assert "loaded 3 chains" in text and "[step 2]" in text


def test_ref_ckpt_loads_reference_layout(tmp_path, capsys):
    import torch

    torch.manual_seed(2)
    tmodel = TFlowModel().eval()
    path = str(tmp_path / "last.ckpt")
    torch.save({"state_dict": {f"model.{k}": v for k, v in tmodel.state_dict().items()},
                "epoch": 3}, path)
    cli.main(["train-multiflow", "--ref-ckpt", path, "--synthetic", "--steps", "1",
              "--batch-size", "2", "--set", "max_len=8", *TINY])
    assert "warm-started from reference checkpoint" in capsys.readouterr().out
    cli.main(["eval-multiflow", "--ref-ckpt", path, "--num-samples", "1", "--length", "8",
              "--num-steps", "3", "--out", str(tmp_path / "pdb"), *TINY])
    text = capsys.readouterr().out
    assert "loaded reference torch checkpoint" in text
    with pytest.raises(ValueError, match="ipa_no_v_points"):
        cli.main(["eval-multiflow", "--ref-ckpt", path, "--num-samples", "1", "--length", "8",
                  "--num-steps", "3", *TINY[:-2], "--set", "ipa_no_v_points=5"])


def test_structure_io_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    atom37 = np.zeros((6, 37, 3), np.float32)
    atom37[:, :5] = rng.standard_normal((6, 5, 3)) * 5
    aat = np.array([0, 7, 3, 19, 7, 12])
    mask = np.array([1, 1, 1, 0, 1, 1], np.float32)
    a = pm.write_pdb_backbone(str(tmp_path / "a" / "x.pdb"), atom37, aatypes=aat, res_mask=mask)
    b = jpm.write_pdb_backbone(str(tmp_path / "b" / "x.pdb"), atom37, aatypes=aat,
                               res_mask=mask)
    assert open(a).read() == open(b).read()
    bb = pm.parse_pdb_backbone(a)
    np.testing.assert_array_equal(bb, jpm.parse_pdb_backbone(a))
    assert bb.shape == (5, 4, 3)
    np.testing.assert_allclose(bb[:, :3], atom37[mask > 0, :3], atol=1e-3)
    np.testing.assert_allclose(bb[:, 3], atom37[mask > 0, 4], atol=1e-3)
    assert pm.backbone_geometry_report(atom37, mask) == jpm.backbone_geometry_report(atom37,
                                                                                     mask)
    cif = tmp_path / "x.cif"
    lines = ["data_x", "loop_", "_atom_site.group_PDB", "_atom_site.label_atom_id",
             "_atom_site.label_comp_id", "_atom_site.label_asym_id",
             "_atom_site.label_seq_id", "_atom_site.Cartn_x", "_atom_site.Cartn_y",
             "_atom_site.Cartn_z"]
    for r in range(4):
        for name in ("N", "CA", "C", "O", "CB"):
            x, y, z = rng.standard_normal(3)
            lines.append(f"ATOM {name} {'GLY' if r % 2 else 'LYS'} A {r + 1} {x:.3f} {y:.3f} "
                         f"{z:.3f}")
    cif.write_text("\n".join(lines + ["#"]) + "\n")
    got, seq = pm.parse_mmcif_backbone(str(cif))
    want, wseq = jpm.parse_mmcif_backbone(str(cif))
    np.testing.assert_array_equal(got, want)
    assert seq == wseq == "KGKG" and got.shape == (4, 4, 3)
    np.testing.assert_array_equal(protein.parse_backbone_any(str(cif))[0], got)


FAKE_FOLD = """import os, sys
fasta, out = sys.argv[1], sys.argv[2]
names = [l[1:].strip() for l in open(fasta) if l.startswith(">")]
for i, name in enumerate(names):
    with open(os.path.join(out, name + "_unrelaxed.pdb"), "w") as f:
        for r in range(3):
            f.write("ATOM  %5d  CA  ALA A%4d    %8.3f%8.3f%8.3f  1.00%6.2f           C\\n"
                    % (r + 1, r + 1, 3.8 * r, 0.0, 0.0, 50.0 + 10 * i + r))
"""


def test_folding_model_with_a_fake_command(tmp_path):
    script = tmp_path / "fake_fold.py"
    script.write_text(FAKE_FOLD)
    assert not pm.FoldingModel().available
    with pytest.raises(RuntimeError, match="no folding backend"):
        pm.FoldingModel().fold_fasta({"a": "ACD"}, str(tmp_path / "none"))
    fold = pm.FoldingModel([sys.executable, str(script)])
    assert fold.available
    out = fold.fold_fasta({"s0": "ACDE", "s1": "GGKL"}, str(tmp_path / "fold"))
    assert out["s0"]["plddt"] == pytest.approx(51.0) and out["s1"]["plddt"] == pytest.approx(
        61.0)
    assert pm.parse_pdb_backbone(out["s1"]["pdb"]).shape == (3, 4, 3)
    assert not pm.FoldingModel(["no-such-folding-binary"]).available
