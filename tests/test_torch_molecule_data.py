"""The port's host-side molecule code against reed_tpu's on the CPU, all
exact: the synthetic families (same numpy seed, same arrays), the `.rsmol`
container both ways, dense collation and the bucketed epoch iterators,
GraphMoleculeMetrics (same dicts), and the .xyz / .sdf writers (same
bytes)."""

import numpy as np
import pytest

from reed_tpu.data import molecule as jmol
from reed_tpu.data import synthetic as jsyn
from reed_tpu.diffusion.molecule_fm import MoleculeInterpolantConfig as JaxInterp
from reed_tpu.eval import molecule_metrics as jmet
from reed_tpu.eval import visualize as jvis
from reed_tpu_torch.data import molecule as tmol
from reed_tpu_torch.data import synthetic as tsyn
from reed_tpu_torch.diffusion.molecule_fm import MoleculeInterpolantConfig
from reed_tpu_torch.eval import molecule_metrics as tmet
from reed_tpu_torch.eval import visualize as tvis


def _same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    else:
        assert a == b


def test_synthetic_families_bitwise():
    assert (tsyn.TEMPLATE_MAX_ATOMS, tsyn.TEMPLATE_NUM_TYPES, tsyn.CHAIN_MAX_ATOMS) == (
        jsyn.TEMPLATE_MAX_ATOMS, jsyn.TEMPLATE_NUM_TYPES, jsyn.CHAIN_MAX_ATOMS)
    assert tsyn.chain_classes() == jsyn.chain_classes()
    assert len(tsyn.chain_classes()) == 1089
    _same(tsyn.chain_templates(), jsyn.chain_templates())
    _same(tsyn.MOLECULE_TEMPLATES, jsyn.MOLECULE_TEMPLATES)
    assert tsyn.template_size_histogram() == jsyn.template_size_histogram()
    assert tsyn.chain_size_histogram() == jsyn.chain_size_histogram()
    for seed in (0, 7):
        _same(tsyn.template_molecule_batch(np.random.default_rng(seed), 6),
              jsyn.template_molecule_batch(np.random.default_rng(seed), 6))
        _same(tsyn.chain_molecule_batch(np.random.default_rng(seed), 6),
              jsyn.chain_molecule_batch(np.random.default_rng(seed), 6))


def _mols(mod, rng, n_mols=7):
    out = []
    for n in rng.integers(3, 14, size=n_mols):
        bonds = np.array([[i, i + 1] for i in range(n - 1)], np.int32)
        out.append(mod.GeometricMol(
            coords=rng.standard_normal((n, 3)).astype(np.float32),
            atomics=rng.integers(2, 10, n).astype(np.int32), bond_indices=bonds,
            bond_types=rng.integers(1, 4, len(bonds)).astype(np.int32),
            charges=rng.integers(-1, 2, n).astype(np.int32), str_id=f"mol{n}"))
    return out


def _fields(m):
    return [m.coords, m.atomics, m.bond_indices, m.bond_types, m.charges, m.str_id]


def test_rsmol_round_trip_both_ways(tmp_path):
    mols = _mols(tmol, np.random.default_rng(0))
    tmol.save_dataset(str(tmp_path / "a.rsmol"), mols)
    jmol.save_dataset(str(tmp_path / "b.rsmol"),
                      [jmol.GeometricMol(*_fields(m)) for m in mols])
    for name in ("a.rsmol.npz", "b.rsmol.npz"):
        ours = tmol.load_dataset(str(tmp_path / name))
        ref = jmol.load_dataset(str(tmp_path / name))
        assert len(ours) == len(ref) == len(mols)
        for a, b, m in zip(ours, ref, mols):
            _same(_fields(a), _fields(b))
            _same(_fields(a), _fields(m))
    for a, b in zip(tmol.load_dataset(str(tmp_path / "a.rsmol.npz")),
                    jmol.load_dataset(str(tmp_path / "b.rsmol.npz"))):
        _same(_fields(a), _fields(b))


def test_vocab_transform_and_batches_match():
    assert tmol.build_vocab().tokens == jmol.build_vocab().tokens
    assert tmol.build_vocab().mask_index == jmol.build_vocab().mask_index
    assert (tmol.QM9_COORDS_STD_DEV, tmol.GEOM_COORDS_STD_DEV) == (
        jmol.QM9_COORDS_STD_DEV, jmol.GEOM_COORDS_STD_DEV)
    mols_t = [tmol.mol_transform(m, 1.7) for m in _mols(tmol, np.random.default_rng(1), 11)]
    mols_j = [jmol.mol_transform(jmol.GeometricMol(*_fields(m)), 1.7)
              for m in _mols(tmol, np.random.default_rng(1), 11)]
    for a, b in zip(mols_t, mols_j):
        _same(_fields(a), _fields(b))
    _same(tmol.collate_dense(mols_t[:3], 16, 18, 5, 7),
          jmol.collate_dense(mols_j[:3], 16, 18, 5, 7))
    _same(list(tmol.bucket_batches(mols_t, batch_cost=40, bucket_limits=(8, 16),
                                   shuffle_rng=np.random.default_rng(2))),
          list(jmol.bucket_batches(mols_j, batch_cost=40, bucket_limits=(8, 16),
                                   shuffle_rng=np.random.default_rng(2))))
    reps = np.random.default_rng(3).standard_normal((11, 4)).astype(np.float32)
    _same(list(tmol.semla_epoch_batches(mols_t, MoleculeInterpolantConfig(),
                                        np.random.default_rng(4), reps=reps,
                                        batch_cost=48, bucket_limits=(8, 16))),
          list(jmol.semla_epoch_batches(mols_j, JaxInterp(), np.random.default_rng(4),
                                        reps=reps, batch_cost=48, bucket_limits=(8, 16))))


def _scored_molecules():
    """Chain-family molecules with their true graphs (valid), the same with
    one bond dropped, charged or aromatic variants, a disconnected pair and
    random graphs on random coordinates."""
    rng = np.random.default_rng(5)
    mols = []
    for t in jsyn.chain_templates()[::97]:
        n = len(t["types"])
        orders = np.zeros((n, n), np.int64)
        for i, j, o in t["bonds"]:
            orders[i, j] = orders[j, i] = o
        mols.append((t["coords"], t["types"], orders, np.zeros(n, np.int64)))
        broken = orders.copy()
        i, j, _ = t["bonds"][-1]
        broken[i, j] = broken[j, i] = 0
        mols.append((t["coords"] * 1.3, t["types"], broken, None))
        charged = rng.integers(-1, 2, n)
        mols.append((t["coords"], t["types"], orders, charged))
    for n in (2, 5, 9):
        idx = np.triu(rng.integers(0, 5, (n, n)), 1)
        mols.append((rng.standard_normal((n, 3)) * 1.5, rng.integers(0, 5, n),
                     idx + idx.T, rng.integers(-1, 2, n)))
    return mols


@pytest.mark.parametrize("dataset", ["qm9", "geom"])
def test_graph_metrics_equal(dataset):
    mols = _scored_molecules()
    decoder = tuple(tmet.QM9_ATOM_DECODER) if dataset == "qm9" else ("H", "C", "N", "O", "F")
    ours = tmet.GraphMoleculeMetrics(atom_decoder=decoder, dataset=dataset,
                                     train_keys={"x"}).evaluate(mols)
    ref = jmet.GraphMoleculeMetrics(atom_decoder=decoder, dataset=dataset,
                                    train_keys={"x"}).evaluate(mols)
    assert ours == ref
    assert 0 < ours["validity"] < 1 and ours["rdkit"] == jmet.HAVE_RDKIT
    coords_mols = [(p, t) for p, t, _, _ in mols]
    assert tmet.compute_relaxed_validity(coords_mols, decoder, dataset) == \
        jmet.compute_relaxed_validity(coords_mols, decoder, dataset)
    assert tmet.posebusters_checks(coords_mols, decoder, dataset) == \
        jmet.posebusters_checks(coords_mols, decoder, dataset)


def test_molecule_files_same_bytes(tmp_path):
    mols = _scored_molecules()
    decoder = ["H", "C", "N", "O", "F"]
    for i, (pos, types, orders, _) in enumerate(mols[:6]):
        for mod, tag in ((tvis, "t"), (jvis, "j")):
            mod.save_xyz_file(str(tmp_path / tag / f"{i}.xyz"), pos, types, decoder,
                              comment="c")
            mod.save_sdf_file(str(tmp_path / tag / f"{i}.sdf"), pos, types, orders,
                              decoder, name=f"mol_{i}")
        for ext in ("xyz", "sdf"):
            assert (tmp_path / "t" / f"{i}.{ext}").read_bytes() == \
                (tmp_path / "j" / f"{i}.{ext}").read_bytes()
    pairs = [(p, t) for p, t, _, _ in mols[:3]]
    tvis.save_molecules_xyz(str(tmp_path / "tm"), pairs)
    jvis.save_molecules_xyz(str(tmp_path / "jm"), pairs)
    names = sorted(p.name for p in (tmp_path / "tm").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "jm").iterdir()) and len(names) == 3
    for name in names:
        assert (tmp_path / "tm" / name).read_bytes() == (tmp_path / "jm" / name).read_bytes()
