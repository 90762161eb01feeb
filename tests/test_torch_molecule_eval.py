"""reed_tpu_torch's molecule eval stack against reed_tpu's on the CPU:
ops/torsion.py (ring perception, rotatable bonds, dihedrals, bond lengths
and angles, and the GeoRCG noise under one numpy seed), eval/molsets.py
(fingerprints bitwise, the Tanimoto product to 1e-6, fragment and scaffold
counts, the whole MOSES dict), eval/midi_metrics.py, and the molecule_metrics
additions (DistributionProperty's draws, mmff_energies without rdkit). The
numpy code is the same on both sides, so its results must be equal; the
Tanimoto product is f32 in both and is held to 1e-6."""

import numpy as np
import pytest
import torch

from reed_tpu.data.molecule import GeometricMol as JaxMol
from reed_tpu.eval import midi_metrics as jmidi
from reed_tpu.eval import molecule_metrics as jmm
from reed_tpu.eval import molsets as jmolsets
from reed_tpu.ops import torsion as jtorsion
from reed_tpu_torch.data.molecule import GeometricMol
from reed_tpu_torch.eval import midi_metrics, molecule_metrics, molsets
from reed_tpu_torch.ops import torsion

torch.set_num_threads(1)
QM9 = ["H", "C", "N", "O", "F"]


def _samples(n_mols, seed, n_min=4, n_max=12):
    """Random-walk heavy-atom chains with branches at bond-like distances and
    random QM9 types: (positions, types) pairs as the samplers return them."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_mols):
        n = int(rng.integers(n_min, n_max + 1))
        pos = np.zeros((n, 3))
        for i in range(1, n):
            parent = int(rng.integers(max(0, i - 2), i))
            step = rng.standard_normal(3)
            pos[i] = pos[parent] + 1.45 * step / np.linalg.norm(step)
        types = rng.choice([1, 1, 1, 2, 3, 0], size=n)
        out.append((pos.astype(np.float32), types.astype(np.int64)))
    return out


def _both(samples):
    """The same molecules as the port's and as reed_tpu's GeometricMol, with
    bonds inferred from distances by each package's own build_bond_graph."""
    ours = molsets.geometric_mols_from_samples(samples, QM9)
    theirs = jmolsets.geometric_mols_from_samples(samples, QM9)
    for a, b in zip(ours, theirs):
        assert isinstance(a, GeometricMol) and isinstance(b, JaxMol)
        for k in ("coords", "atomics", "bond_indices", "bond_types", "charges"):
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k), err_msg=k)
    return ours, theirs


def _ring_mol(cls):
    """A 6-ring with a 3-atom tail and a triple bond at its end."""
    theta = 2 * np.pi * np.arange(6) / 6
    ring = np.stack([np.cos(theta) * 1.4, np.sin(theta) * 1.4, 0.1 * np.sin(3 * theta)], -1)
    tail = np.array([[2.9, 0.2, 0.3], [3.9, 1.2, 0.1], [5.0, 1.4, 0.9]])
    coords = np.concatenate([ring, tail]).astype(np.float32)
    bonds = [[i, (i + 1) % 6] for i in range(6)] + [[0, 6], [6, 7], [7, 8]]
    types = [1, 1, 1, 1, 1, 1, 1, 1, 2]
    return cls(coords, np.array(types, np.int32), np.array(bonds, np.int32),
               np.array([1] * 8 + [3], np.int32), np.zeros(9, np.int32))


def _chain_mol(cls, seed=3, n=9):
    rng = np.random.default_rng(seed)
    coords = np.cumsum(rng.standard_normal((n, 3)) * 0.6 + [1.2, 0, 0], 0).astype(np.float32)
    bonds = [[i, i + 1] for i in range(n - 1)]
    return cls(coords, np.full(n, 1, np.int32), np.array(bonds, np.int32),
               np.ones(n - 1, np.int32), np.zeros(n, np.int32))


@pytest.mark.parametrize("make", [_ring_mol, _chain_mol])
def test_torsion_matches_reed_tpu(make):
    ours, theirs = make(GeometricMol), make(JaxMol)
    assert torsion.ring_bonds(ours) == jtorsion.ring_bonds(theirs)
    assert torsion.ring_atoms(ours) == jtorsion.ring_atoms(theirs)
    assert torsion.get_rotatable_bonds(ours) == jtorsion.get_rotatable_bonds(theirs)
    tors = torsion.get_torsions([ours, ours])
    assert tors == jtorsion.get_torsions([theirs, theirs]) and tors
    idx = tors[0]
    assert torsion.get_dihedral(ours.coords, idx) == jtorsion.get_dihedral(theirs.coords, idx)
    for fn, args in (("set_dihedral", (idx, 75.0)), ("set_bond_length", ((6, 7), 1.7)),
                     ("set_angle", ((0, 6, 7), 100.0))):
        a = getattr(torsion, fn)(ours, *args)
        b = getattr(jtorsion, fn)(theirs, *args)
        assert isinstance(a, GeometricMol)
        np.testing.assert_array_equal(a.coords, b.coords, err_msg=fn)
    assert torsion.get_dihedral(torsion.set_dihedral(ours, idx, 75.0).coords,
                                idx) == pytest.approx(75.0, abs=1e-3)
    assert torsion.get_angle(ours.coords, (0, 6, 7)) == jtorsion.get_angle(theirs.coords,
                                                                           (0, 6, 7))
    assert torsion.bond_side(ours, 6, 7).tolist() == jtorsion.bond_side(theirs, 6, 7).tolist()
    noised, labels = torsion.add_equi_noise(ours, np.random.default_rng(11))
    jnoised, jlabels = jtorsion.add_equi_noise(theirs, np.random.default_rng(11))
    np.testing.assert_array_equal(noised.coords, jnoised.coords)
    assert labels == jlabels and labels["bond"] and labels["angle"]
    assert not np.array_equal(noised.coords, ours.coords)


def test_fingerprints_tanimoto_and_counts_match_reed_tpu():
    ours, theirs = _both(_samples(24, seed=0))
    fp = molsets.fingerprints(ours)
    np.testing.assert_array_equal(fp, jmolsets.fingerprints(theirs))
    assert fp.shape == (24, 1024) and fp.any(1).all()
    ref_fp = molsets.fingerprints(ours[:10], n_bits=512, radius=3)
    np.testing.assert_array_equal(ref_fp, jmolsets.fingerprints(theirs[:10], n_bits=512,
                                                                radius=3))
    rng = np.random.default_rng(1)
    ref = (rng.random((40, 1024)) < 0.05).astype(np.float32)
    ref[3] = 0.0   # an empty fingerprint: its union with an empty one is 0
    for agg, p in (("max", 1.0), ("mean", 1.0), ("max", 2.0)):
        got = molsets.average_agg_tanimoto(ref, fp, agg=agg, p=p, device="cpu")
        want = jmolsets.average_agg_tanimoto(ref, fp, agg=agg, p=p)
        assert got == pytest.approx(want, rel=1e-6, abs=1e-7), (agg, p)
    assert molsets.average_agg_tanimoto(fp, fp, device="cpu") == pytest.approx(1.0)
    assert molsets.fragment_counts(ours) == jmolsets.fragment_counts(theirs)
    assert molsets.scaffold_counts(ours) == jmolsets.scaffold_counts(theirs)
    assert [molsets.mol_hash(m) for m in ours] == [jmolsets.mol_hash(m) for m in theirs]
    a, b = rng.standard_normal(50), rng.standard_normal(70) + 1
    assert molsets.wasserstein_1d(a, b) == jmolsets.wasserstein_1d(a, b)


def test_moses_metrics_match_reed_tpu():
    gen, jgen = _both(_samples(20, seed=2))
    test, jtest = _both(_samples(30, seed=3))
    train, jtrain = _both(_samples(25, seed=2)[:10] + _samples(15, seed=4))
    got = molsets.moses_metrics(gen, test, train, vocab_tokens=QM9, device="cpu")
    want = jmolsets.moses_metrics(jgen, jtest, jtrain, vocab_tokens=QM9)
    assert set(got) == set(want) == {"SNN/Test", "Frag/Test", "Scaf/Test", "weight",
                                     "unique", "Novelty", "FCD/Test"}
    assert got.pop("SNN/Test") == pytest.approx(want.pop("SNN/Test"), rel=1e-6)
    assert got == want
    assert got["FCD/Test"] is None and got["Novelty"] < 1.0


def test_midi_metrics_match_reed_tpu():
    gen, jgen = _both(_samples(20, seed=5))
    ref, jref = _both(_samples(30, seed=6))
    got = midi_metrics.midi_sampling_metrics(gen, ref, num_atom_types=5)
    want = jmidi.midi_sampling_metrics(jgen, jref, num_atom_types=5)
    assert got == want and all(np.isfinite(v) for v in got.values())
    same = midi_metrics.midi_sampling_metrics(ref, ref, num_atom_types=5)
    assert same["AtomTypesTV"] == 0.0 and same["BondLengthsW1"] == pytest.approx(0.0)


def test_distribution_property_draws_match_reed_tpu():
    rng = np.random.default_rng(0)
    sizes = rng.integers(5, 12, 200)
    values = sizes * 2.0 + rng.standard_normal(200)
    ours = molecule_metrics.DistributionProperty(sizes, values)
    theirs = jmm.DistributionProperty(sizes, values)
    ask = np.array([5, 7, 11, 3, 20, 8])   # 3 and 20 take the nearest size present
    np.testing.assert_array_equal(ours.sample(np.random.default_rng(4), ask),
                                  theirs.sample(np.random.default_rng(4), ask))
    draws = ours.sample(np.random.default_rng(5), np.full(50, 7))
    assert set(draws) <= set(values[sizes == 7])


def test_mmff_energies_needs_rdkit(monkeypatch):
    """Without rdkit mmff_energies raises reed_tpu's RuntimeError."""
    assert molecule_metrics.HAVE_RDKIT == jmm.HAVE_RDKIT
    monkeypatch.setattr(molecule_metrics, "HAVE_RDKIT", False)
    monkeypatch.setattr(jmm, "HAVE_RDKIT", False)
    for fn in (molecule_metrics.mmff_energies, jmm.mmff_energies):
        with pytest.raises(RuntimeError, match="rdkit is not available"):
            fn(["CCO"])
