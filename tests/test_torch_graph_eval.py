"""reed_tpu_torch's ORCA (eval/orca: built by g++ into the port's _build/),
graph statistics (eval/graph_stats.py), ChemNet/FCD (eval/chemnet.py) and
3D molecule renders (eval/visualize.plot_molecule_3d) on the CPU.

ORCA's sources are reed_tpu's, byte for byte; the counts are held to the
Przulj atlas on small graphs (node 4 and node 5), the binary to the
library, and reed_tpu's graph statistics are run over the port's counts
(its own ORCA build writes inside reed_tpu/ and is left to its own tests)
against the port's, to equality. ChemNet's forward is held to reed_tpu's
JAX forward and to torch.nn.LSTM at 1e-5 of the max."""

import filecmp
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as tnn

from reed_tpu.eval import chemnet as jchemnet
from reed_tpu.eval import graph_stats as jgraph_stats
from reed_tpu_torch._build import BUILD_DIR
from reed_tpu_torch.eval import chemnet, graph_stats, orca, visualize

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _random_graphs(k, seed, n_max=9):
    rng = np.random.default_rng(seed)
    graphs = []
    for _ in range(k):
        n = int(rng.integers(3, n_max + 1))
        pairs = [(i, j) for i in range(n) for j in range(i + 1, n)]
        keep = rng.random(len(pairs)) < 0.35
        edges = np.array([p for p, kp in zip(pairs, keep) if kp] or [(0, 1)], np.int64)
        graphs.append((n, edges))
    return graphs


def test_sources_are_reed_tpus_and_build_lands_in_the_port():
    for name in ("orca.cpp", "orbit5_table.h"):
        assert filecmp.cmp(os.path.join(REPO, "reed_tpu_torch", "eval", "orca", name),
                           os.path.join(REPO, "reed_tpu", "eval", "orca", name),
                           shallow=False), name
    path = orca.orca_binary_path()
    assert os.path.dirname(path) == str(BUILD_DIR) and os.access(path, os.X_OK)
    assert orca._build("lib").startswith(str(BUILD_DIR))


@pytest.mark.parametrize("graph,orbits", [
    ([[0, 1], [1, 2], [2, 3]], {4: [1, 0, 0, 1], 5: [0, 1, 1, 0]}),         # P4
    ([[0, 1], [0, 2], [0, 3]], {7: [1, 0, 0, 0], 6: [0, 1, 1, 1]}),         # claw
    ([[0, 1], [1, 2], [2, 3], [3, 0]], {8: [1, 1, 1, 1]}),                  # C4
    ([[0, 1], [1, 2], [0, 2], [2, 3]], {9: [0, 0, 0, 1], 11: [0, 0, 1, 0]}),  # paw
    ([[i, j] for i in range(4) for j in range(i + 1, 4)], {14: [1] * 4, 3: [3] * 4}),
])
def test_node4_orbits(graph, orbits):
    out = orca.count_node_orbits4(4, graph)
    assert out.shape == (4, 15) and out.dtype == np.int64
    for orbit, want in orbits.items():
        assert out[:, orbit].tolist() == want, orbit


@pytest.mark.parametrize("graph,orbits", [
    ([[0, 1], [1, 2], [2, 3], [3, 4]], [15, 16, 17, 16, 15]),               # P5
    ([[0, i] for i in range(1, 5)], [23, 22, 22, 22, 22]),                  # star
    ([[i, (i + 1) % 5] for i in range(5)], [34] * 5),                       # C5
    ([[i, j] for i in range(5) for j in range(i + 1, 5)], [72] * 5),        # K5
])
def test_node5_orbits(graph, orbits):
    out = orca.count_node_orbits5(5, graph)
    assert out.shape == (5, 73)
    np.testing.assert_array_equal(out[:, :15], orca.count_node_orbits4(5, graph))
    for node, orbit in enumerate(orbits):
        assert list(np.nonzero(out[node, 15:])[0] + 15) == [orbit], node


@pytest.mark.parametrize("k", [4, 5])
def test_binary_matches_library(tmp_path, k):
    for i, (n, edges) in enumerate(_random_graphs(4, seed=k)):
        inp = tmp_path / f"g{i}.txt"
        inp.write_text(f"{n} {len(edges)}\n" + "\n".join(f"{u} {v}" for u, v in edges)
                       + "\n")
        res = subprocess.run([orca.orca_binary_path(), "node", str(k), str(inp), "std"],
                             capture_output=True, text=True, check=True)
        header = "orbit counts: \n"
        body = res.stdout[res.stdout.find(header) + len(header):]
        cli = np.array([[int(x) for x in line.split()] for line in body.strip().split("\n")])
        lib = (orca.count_node_orbits4 if k == 4 else orca.count_node_orbits5)(n, edges)
        np.testing.assert_array_equal(cli, lib)
    with pytest.raises(ValueError, match="code 2"):
        orca.count_node_orbits4(3, [[0, 3]])


def test_graph_stats_match_reed_tpu(monkeypatch):
    import reed_tpu.eval.orca as jorca

    # reed_tpu's statistics over the port's counts (the same C++ source)
    monkeypatch.setattr(jorca, "count_node_orbits4", orca.count_node_orbits4)
    ref, pred = _random_graphs(12, seed=1), _random_graphs(10, seed=2)
    got = graph_stats.all_graph_stats(ref, pred)
    want = jgraph_stats.all_graph_stats(ref, pred)
    assert set(got) == {"degree_mmd", "clustering_mmd", "orbit_mmd", "spectral_mmd",
                        "nspdk_mmd", "connected_frac"}
    assert got == want and all(np.isfinite(v) for v in got.values())
    same = graph_stats.all_graph_stats(ref, ref)
    assert same["degree_mmd"] == pytest.approx(0.0, abs=1e-12)
    assert same["orbit_mmd"] == pytest.approx(0.0, abs=1e-12)
    ref_labels = [[i % 3 for i in range(n)] for n, _ in ref]
    pred_labels = [[i % 2 for i in range(n)] for n, _ in pred]
    assert graph_stats.nspdk_stats(ref, pred, ref_labels, pred_labels) == \
        jgraph_stats.nspdk_stats(ref, pred, ref_labels, pred_labels)


class TChemNet(tnn.Module):
    def __init__(self, d_in, hidden, layers, d_out):
        super().__init__()
        self.lstm = tnn.LSTM(d_in, hidden, num_layers=layers, batch_first=True)
        self.dense = tnn.Linear(hidden, d_out)

    def forward(self, x):
        hs, _ = self.lstm(x)
        return torch.tanh(self.dense(hs[:, -1]))


SMILES = ["CCO", "c1ccccc1", "CC(=O)N", "ClCBr", "C[Si](C)C", "N#Cc1ccncc1", "O=C=O",
          "CC(C)(C)[NH3+]"]


def test_tokenizer_and_one_hot_match_reed_tpu():
    assert chemnet.FCD_TOKENS == jchemnet.FCD_TOKENS and chemnet.VOCAB_SIZE == 36
    for smi in SMILES + ["Zz%"]:
        assert chemnet.tokenize_smiles(smi) == jchemnet.tokenize_smiles(smi), smi
    assert chemnet.tokenize_smiles("CCl") == [0, 5]
    np.testing.assert_array_equal(chemnet.one_hot_smiles(SMILES, max_len=9),
                                  jchemnet.one_hot_smiles(SMILES, max_len=9))
    assert chemnet.one_hot_smiles(SMILES).shape == (8, chemnet.MAX_LEN, 36)


def test_chemnet_activations_match_reed_tpu_and_lstm():
    torch.manual_seed(0)
    tmodel = TChemNet(chemnet.VOCAB_SIZE, 24, 2, 16).eval()
    with torch.no_grad():
        for p in tmodel.parameters():
            p.normal_(0, 0.3)
    oh = chemnet.one_hot_smiles(SMILES, max_len=14)
    with torch.no_grad():
        lstm = tmodel(torch.from_numpy(oh))
    sd = tmodel.state_dict()
    params = chemnet.convert_torch_chemnet(sd)
    got = chemnet.chemnet_activations(params, oh)
    jparams = jchemnet.convert_torch_chemnet(sd)
    want = np.asarray(jchemnet.chemnet_activations(jax.tree.map(jnp.asarray, jparams),
                                                   jnp.asarray(oh)))
    scale = np.abs(want).max()
    assert np.abs(got.numpy() - want).max() <= 1e-5 * scale
    assert (got - lstm).abs().max().item() <= 1e-5 * scale
    # without the dense head: the last hidden state itself
    del params["dense"]
    h = chemnet.chemnet_activations(params, torch.from_numpy(oh))
    assert h.shape == (8, 24) and (h.abs() < 1).all()
    with pytest.raises(KeyError):
        chemnet.convert_torch_chemnet({"dense.weight": sd["dense.weight"]})


def test_fcd_score_matches_reed_tpu():
    torch.manual_seed(1)
    tmodel = TChemNet(chemnet.VOCAB_SIZE, 16, 1, 4).eval()
    with torch.no_grad():
        for p in tmodel.parameters():
            p.normal_(0, 0.8)
    params = chemnet.convert_torch_chemnet(tmodel.state_dict())
    a, b = SMILES + ["CCC", "CN"], ["C" * k for k in range(2, 12)]
    got = chemnet.fcd_score(params, a, b, batch_size=4, max_len=16, device="cpu")
    want = jchemnet.fcd_score(jchemnet.convert_torch_chemnet(tmodel.state_dict()), a, b,
                              batch_size=4, max_len=16)
    assert got == pytest.approx(want, rel=1e-4) and got > 0
    assert abs(chemnet.fcd_score(params, a, list(a), max_len=16, device="cpu")) < 1e-6


def test_plot_molecule_3d_writes_png(tmp_path):
    pos = np.array([[0.0, 0, 0], [1.09, 0, 0], [-0.36, 1.03, 0], [-0.36, -0.51, 0.89],
                    [-0.36, -0.51, -0.89]])
    path = visualize.plot_molecule_3d(str(tmp_path / "sub" / "ch4.png"), pos,
                                      [1, 0, 0, 0, 0], title="methane")
    with open(path, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    assert visualize.have_matplotlib()


def test_cli_skips_pngs_without_matplotlib(tmp_path, monkeypatch, capsys):
    """eval-molecule --out with matplotlib hidden: the .xyz files, one line
    saying the PNGs were skipped, and plot_molecule_3d raising ImportError."""
    from reed_tpu_torch import cli

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    assert not visualize.have_matplotlib()
    with pytest.raises(ImportError):
        visualize.plot_molecule_3d(str(tmp_path / "x.png"), np.zeros((2, 3)), [0, 1])
    out = str(tmp_path / "mols")
    cli.main(["eval-molecule", "--batch-size", "2", "--n-replicates", "1", "--num-steps",
              "3", "--out", out, "--set", "hidden_nf=16", "--set", "n_layers=1",
              "--set", "rep_nf=null", "--set", "max_nodes=6", "--device", "cpu"])
    text = capsys.readouterr().out
    assert "3D PNG renders skipped: matplotlib is not installed" in text
    assert sorted(os.listdir(out)) == ["mol_000.xyz", "mol_001.xyz"]
