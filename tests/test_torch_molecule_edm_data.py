"""The EDM half of the port's molecule data and evaluation against
reed_tpu's on the CPU: edm_epoch_batches on a fabricated QM9 EDM npz (with
and without one_hot, molecules longer than max_nodes, reps) read by
load_qm9_edm_npz, bitwise; MoleculeMetrics and check_stability on the
same molecules (stable templates, their perturbations and random clouds),
equal; DistributionNodes; GtSampler's reps (1e-6); and the two-stage
helpers (masks, molecules_from_samples, evaluate_replicates)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reed_tpu.data import molecule as jdata
from reed_tpu.eval import molecule_metrics as jmetrics
from reed_tpu.eval import rep_samplers as jrep
from reed_tpu.eval import two_stage as jtwo
from reed_tpu_torch.data import molecule as data
from reed_tpu_torch.data.synthetic import chain_templates
from reed_tpu_torch.eval import molecule_metrics as metrics
from reed_tpu_torch.eval import rep_samplers, two_stage

torch.set_num_threads(1)


def _npz(path, m=23, n=31, one_hot=True, seed=0):
    rng = np.random.default_rng(seed)
    num_atoms = rng.integers(3, n + 1, size=m)
    mask = np.arange(n)[None] < num_atoms[:, None]
    pos = rng.standard_normal((m, n, 3)).astype(np.float32) * mask[..., None]
    charges = rng.choice([1, 6, 7, 8, 9], size=(m, n)) * mask
    out = {"positions": pos, "charges": charges, "num_atoms": num_atoms}
    if one_hot:
        out["one_hot"] = (charges[..., None] == np.array([1, 6, 7, 8, 9])).astype(np.float32)
    np.savez(path, **out)
    return out


@pytest.mark.parametrize("one_hot", [True, False], ids=["one_hot", "from_charges"])
def test_edm_epoch_batches_match(tmp_path, one_hot):
    path = str(tmp_path / "train.npz")
    _npz(path, one_hot=one_hot)
    got_data, want_data = data.load_qm9_edm_npz(path), jdata.load_qm9_edm_npz(path)
    assert set(got_data) == set(want_data)
    reps = np.random.default_rng(1).standard_normal((23, 4)).astype(np.float32)
    got = list(data.edm_epoch_batches(got_data, 5, np.random.default_rng(3), reps=reps))
    want = list(jdata.edm_epoch_batches(want_data, 5, np.random.default_rng(3), reps=reps))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in g:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    assert got[0]["positions"].shape == (5, 29, 3)


def test_load_counts_atoms_without_num_atoms(tmp_path):
    path = str(tmp_path / "x.npz")
    full = _npz(path)
    np.savez(path, positions=full["positions"], charges=full["charges"])
    got = data.load_qm9_edm_npz(path)
    np.testing.assert_array_equal(got["num_atoms"],
                                  jdata.load_qm9_edm_npz(path)["num_atoms"])


def _molecules():
    """Stable chain templates, the same jittered and squeezed, and random
    clouds, in QM9 decoder indices."""
    rng = np.random.default_rng(0)
    family = chain_templates()
    mols = []
    for i in rng.choice(len(family), size=8, replace=False):
        t = family[i]
        pos = t["coords"] - t["coords"].mean(0)
        mols.append((pos, np.asarray(t["types"])))
        mols.append((pos + 0.15 * rng.standard_normal(pos.shape), np.asarray(t["types"])))
        mols.append((0.6 * pos, np.asarray(t["types"])))
    for n in (3, 7, 12):
        mols.append((rng.standard_normal((n, 3)) * 1.2, rng.integers(0, 5, size=n)))
    mols.append(mols[0])   # a duplicate for uniqueness
    return mols


def test_molecule_metrics_match():
    mols = _molecules()
    got = metrics.MoleculeMetrics(train_smiles=set()).evaluate(mols)
    want = jmetrics.MoleculeMetrics(train_smiles=set()).evaluate(mols)
    assert got == want
    assert 0 < got["validity"] < 1 and got["uniqueness"] < 1
    for pos, types in mols:
        assert metrics.check_stability(pos, types) == jmetrics.check_stability(pos, types)


def test_distribution_nodes_match():
    hist = {5: 2.0, 9: 5.0, 13: 1.0}
    got, want = metrics.DistributionNodes(hist), jmetrics.DistributionNodes(hist)
    np.testing.assert_array_equal(got.sample(np.random.default_rng(4), 50),
                                  want.sample(np.random.default_rng(4), 50))
    sizes = np.array([5, 6, 9, 13, 20])
    np.testing.assert_array_equal(got.log_prob(sizes), want.log_prob(sizes))


def test_gt_sampler_matches():
    rng = np.random.default_rng(2)
    reps = rng.standard_normal((40, 6)).astype(np.float32)
    sizes = rng.integers(5, 12, size=40)
    nodes = np.array([5, 7, 11, 30, 1])   # 30 and 1 take the nearest count
    got = rep_samplers.GtSampler(reps, sizes).sample(np.random.default_rng(9), nodes)
    want = jrep.GtSampler(reps, sizes).sample(np.random.default_rng(9), nodes)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_two_stage_helpers_match():
    nodes = np.array([4, 6, 2])
    node_mask, edge_mask = two_stage.molecule_masks(nodes, 6)
    seen = {}

    def mol_sampler(nm, em, rep):
        seen["rep"] = rep
        x = torch.arange(3 * 6 * 3, dtype=torch.float32).reshape(3, 6, 3) * nm
        cat = torch.nn.functional.one_hot(torch.arange(18).reshape(3, 6) % 5, 5).float() * nm
        return x, cat, nm

    sampler = two_stage.TwoStageSampler(rep_samplers.GtSampler(
        np.eye(4, dtype=np.float32), np.array([2, 4, 6, 6])), mol_sampler)
    x, cat, _, nm = sampler.sample(np.random.default_rng(0), nodes, 6)
    assert torch.equal(nm, node_mask) and seen["rep"].shape == (3, 4)
    assert torch.equal(edge_mask.sum((1, 2, 3)), torch.tensor([12.0, 30.0, 2.0]))
    got = two_stage.molecules_from_samples(x, cat, nm)
    want = jtwo.molecules_from_samples(np.asarray(x), jnp.asarray(cat.numpy()),
                                       np.asarray(nm))
    for (gp, gt), (wp, wt) in zip(got, want):
        np.testing.assert_array_equal(gp, wp)
        np.testing.assert_array_equal(gt, wt)
    mols = _molecules()
    out = two_stage.evaluate_replicates(lambda r: mols[r::2], metrics.MoleculeMetrics(), 2)
    ref = jtwo.evaluate_replicates(lambda r: mols[r::2], jmetrics.MoleculeMetrics(), 2)
    assert out == ref
