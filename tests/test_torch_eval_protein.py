"""The port's eval-protein entry point on the CPU (synthetic batch, a
fabricated PDB dataset, a reference checkpoint), its refusal to fall back
to the CPU when CUDA was asked for (the default) and is missing, and its
data pipeline and metrics against reed_tpu's."""

import json

import numpy as np
import pytest
import torch

from reed_tpu.data import protein as jdata
from reed_tpu.eval import protein_metrics as jmetrics
from reed_tpu_torch import cli
from reed_tpu_torch.data import protein as tdata
from reed_tpu_torch.eval import protein_metrics as tmetrics
from test_cli_eval import _fake_pdb_dataset

torch.set_num_threads(1)

TINY = ["--set", "hidden_dim=32", "--set", "num_encoder_layers=1",
        "--set", "num_decoder_layers=1", "--set", "k_neighbors=8",
        "--set", "single_dim=16", "--set", "pair_dim=8", "--set", "structure_dim=16"]
ARGS = ["eval-protein", "--length", "32", "--batch-size", "2", "--num-steps", "4"] + TINY


def _run(capsys, argv):
    cli.main(argv)
    text = capsys.readouterr().out
    speed = [line for line in text.splitlines() if "sequences/s" in line]
    return json.loads(text[text.index("{"):]), speed


@pytest.mark.parametrize("fused", ["auto", "off"])
def test_eval_protein_on_cpu(capsys, fused):
    out, speed = _run(capsys, ARGS + ["--device", "cpu", "--fused-messages", fused])
    assert out["split"] == "synthetic"
    assert 0.0 <= out["sequence_recovery"] <= 1.0
    assert len(out["sample_0"]) == 32 and "Z" not in out["sample_0"]
    assert len(speed) == 1 and "ms per decoder step" in speed[0]
    assert f"fused={fused == 'auto'}" in speed[0]


def test_eval_protein_fused_and_unfused_agree(capsys):
    """One seed, both chains: the same sampled tokens (f32, tiny model)."""
    a, _ = _run(capsys, ARGS + ["--device", "cpu", "--fused-messages", "on"])
    b, _ = _run(capsys, ARGS + ["--device", "cpu", "--fused-messages", "off"])
    assert a == b


def test_eval_protein_valid_split_from_data_dir(tmp_path, capsys):
    _fake_pdb_dataset(str(tmp_path))
    out, _ = _run(capsys, ["eval-protein", "--device", "cpu", "--data-dir",
                           str(tmp_path), "--num-steps", "3", "--max-chains", "3"] + TINY)
    assert out["split"] == "valid" and out["num_chains"] == 3
    assert 0.0 <= out["sequence_recovery"] <= 1.0
    assert len(out["sample_0"]) == 24


def test_eval_protein_from_reference_checkpoint(tmp_path, capsys):
    from reed_tpu_torch.models.pmpnn import create_pmpnn

    model = create_pmpnn(generator=torch.Generator().manual_seed(5), hidden_dim=32,
                         edge_features=32, num_encoder_layers=1, num_decoder_layers=1,
                         k_neighbors=8, single_dim=16, pair_dim=8, structure_dim=16)
    sd = {f"module.{k}": v + 0.1 for k, v in model.state_dict().items()}
    torch.save({"model_state_dict": sd}, tmp_path / "epoch_last.pt")
    out, _ = _run(capsys, ARGS + ["--device", "cpu", "--ref-ckpt",
                                  str(tmp_path / "epoch_last.pt")])
    init, _ = _run(capsys, ARGS + ["--device", "cpu"])
    assert out["sample_0"] != init["sample_0"]  # the weights mattered


def test_eval_protein_without_device_needs_cuda(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(ARGS)
    assert "{" not in capsys.readouterr().out


def test_set_overrides_reach_nested_fields():
    """--set goes through core/configlib.py (reed_tpu's), which raises a
    KeyError on a field the config does not have."""
    from reed_tpu_torch.core import configlib
    from reed_tpu_torch.train.protein import ProteinTrainConfig

    cfg = configlib.apply_overrides(ProteinTrainConfig(), [
        "hidden_dim=64", "interpolant.temp=0.5", "compute_dtype=bfloat16"])
    assert (cfg.hidden_dim, cfg.interpolant.temp, cfg.compute_dtype) == (64, 0.5, "bfloat16")
    with pytest.raises(KeyError, match="unknown config key"):
        configlib.apply_overrides(cfg, ["hidden=3"])


def test_data_pipeline_matches_reed_tpu(tmp_path):
    entries = jdata.synthetic_entries(np.random.default_rng(0), n=5, min_len=20,
                                      max_len=150)
    entries[1]["xyz"][3, 2] = np.nan  # an unresolved residue is masked
    ref = list(jdata.token_bucket_batches(entries, token_budget=400))
    out = list(tdata.token_bucket_batches(entries, token_budget=400))
    assert len(out) == len(ref) > 1
    for o, r in zip(out, ref):
        assert set(o) == set(r)
        for k in r:
            np.testing.assert_array_equal(o[k], r[k], err_msg=k)
    dims = {"single": 4, "pair": 3, "structure": 5}
    with_repr = jdata.synthetic_entries(np.random.default_rng(1), n=2, max_len=30,
                                        repr_dims=dims)
    pool = tdata.BufferPool(depth=2)
    for _ in range(3):
        o = tdata.featurize(with_repr, 64, dims, pool=pool)
    r = jdata.featurize(with_repr, 64, dims)
    for k in r:
        np.testing.assert_array_equal(o[k], r[k], err_msg=k)
    assert tdata.bucket_for_length(65) == jdata.bucket_for_length(65) == 128

    _fake_pdb_dataset(str(tmp_path))
    tp, jp = tdata.PDBParams(str(tmp_path)), jdata.PDBParams(str(tmp_path))
    assert tdata.build_training_clusters(tp) == jdata.build_training_clusters(jp)
    _, valid, _ = tdata.build_training_clusters(tp)
    a = tdata.sample_cluster_chains(np.random.default_rng(2), valid, tp, limit=2)
    b = jdata.sample_cluster_chains(np.random.default_rng(2), valid, jp, limit=2)
    assert [e["name"] for e in a] == [e["name"] for e in b] and len(a) == 2
    np.testing.assert_array_equal(a[0]["xyz"], b[0]["xyz"])


def test_protein_metrics_match_reed_tpu():
    rng = np.random.default_rng(0)
    pred, true = rng.integers(0, 22, (3, 20)), rng.integers(0, 22, (3, 20))
    mask = rng.random((3, 20)) < 0.7
    assert tmetrics.sequence_recovery(pred, true, mask) == \
        jmetrics.sequence_recovery(pred, true, mask)
    assert tmetrics.tokens_to_sequence(pred[0], mask[0]) == \
        jmetrics.tokens_to_sequence(pred[0], mask[0])
    x = rng.standard_normal((20, 4, 3))
    q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
    rot = q * np.sign(np.linalg.det(q))
    y = x @ rot.T + 1.5 + 0.01 * rng.standard_normal(x.shape)
    assert tmetrics.backbone_rmsd(x, y, mask[0]) == pytest.approx(
        jmetrics.backbone_rmsd(x, y, mask[0]), rel=1e-12)
    assert tmetrics.kabsch_rmsd(x[:, 1], x[:, 1] @ rot.T) < 1e-9


@pytest.mark.parametrize("hidden", [100, 256])
def test_eval_protein_auto_runs_widths_the_kernels_refuse(capsys, hidden):
    """'auto' resolves to the unfused chain at widths the kernels refuse
    (hidden 100: D % 16; 256: D > 128), so eval-protein runs them; 'on'
    refuses them."""
    argv = ARGS + ["--device", "cpu", "--set", f"hidden_dim={hidden}"]
    out, speed = _run(capsys, argv)
    assert "fused=False" in speed[0] and len(out["sample_0"]) == 32
    with pytest.raises(ValueError, match="fused message kernel"):
        cli.main(argv + ["--fused-messages", "on"])
