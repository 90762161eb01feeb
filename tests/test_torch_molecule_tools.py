"""The port's data tools, monitor and --profile-dir on the CPU:
build_geom_dataset on a fabricated GEOM msgpack file against reed_tpu's
(the same .rsmol records); captioning with the stub backend, read back
through data/image.CachedLatentDataset; the monitor relaunching a command
that fails once, and latest_checkpoint_step on the port's `{step}.pt`
names; precompute_mol_reps writing reps.npy (and sizes.npy) from reed_tpu's
npz layout and from reference torch checkpoints, its UniMol and Frad reps
against reed_tpu's tool on the same weights (1e-5 of the max), and
train-molecule-semla reading them; `--profile-dir` writing a Chrome trace
of the steps reed_tpu traces."""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reed_tpu.data import molecule as jmol
from reed_tpu.encoders.torchmd_et import FradEncoder as JaxFrad
from reed_tpu.encoders.unimol import UniMolGlobal as JaxUniMol
from reed_tpu_torch import cli, monitor
from reed_tpu_torch.data import captioning
from reed_tpu_torch.data import molecule as tmol
from reed_tpu_torch.data.image import CachedLatentDataset, ImageDatasetConfig
from reed_tpu_torch.encoders.flax_tree import save_npz
from reed_tpu_torch.encoders import torchmd_et, unimol_convert
from reed_tpu_torch.tools import precompute_mol_reps as prep

torch.set_num_threads(1)
UNIMOL_SMALL = dict(vocab_size=32, embed_dim=32, ffn_dim=64, heads=4, layers=2,
                    gaussian_k=8, rep_dim=32)


# -- GEOM msgpack -> .rsmol --

def _write_geom_msgpack(path, rng):
    """Two msgpack batches of {smiles: {'conformers': [{'xyz', 'totalenergy'}]}}:
    several conformers a molecule, one molecule with no conformer (skipped)
    and one with an element outside the table (read as C, reed_tpu's rule)."""
    import msgpack

    def conformer(n):
        z = rng.choice([1, 6, 7, 8, 9, 16, 35], n)
        xyz = np.concatenate([z[:, None], rng.standard_normal((n, 3)) * 2], 1)
        return {"xyz": xyz.tolist(), "totalenergy": float(rng.normal())}

    batches = [{f"C{i}CO": {"conformers": [conformer(5 + i) for _ in range(3)]}
                for i in range(4)},
               {"empty": {"conformers": []},
                "uranium": {"conformers": [{"xyz": [[92, 0, 0, 0], [6, 1, 0, 0]],
                                            "totalenergy": 0.0}]},
                "NCC": {"conformers": [conformer(7), conformer(7)]}}]
    with open(path, "wb") as f:
        for b in batches:
            f.write(msgpack.packb(b, use_bin_type=True))


@pytest.mark.parametrize("limit", [None, 3])
def test_build_geom_dataset_matches_jax(tmp_path, limit):
    pytest.importorskip("msgpack")
    src = str(tmp_path / "drugs.msgpack")
    _write_geom_msgpack(src, np.random.default_rng(0))
    n = tmol.build_geom_dataset(src, str(tmp_path / "port.rsmol"), limit=limit)
    n_ref = jmol.build_geom_dataset(src, str(tmp_path / "ref.rsmol"), limit=limit)
    assert n == n_ref == (limit or 6)
    ours = tmol.load_dataset(str(tmp_path / "port.rsmol.npz"))
    ref = jmol.load_dataset(str(tmp_path / "ref.rsmol.npz"))
    assert [m.str_id for m in ours] == [m.str_id for m in ref]
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a.atomics, b.atomics)
        np.testing.assert_array_equal(a.coords, b.coords)
    # the lowest-energy conformer, atoms encoded in the vocabulary
    vocab = tmol.build_vocab()
    assert vocab.decode(ours[0].atomics)[0] in vocab.tokens[2:]


# -- captioning --

def _fake_image_dataset(data_dir, n=3):
    from PIL import Image

    os.makedirs(os.path.join(data_dir, "images"))
    os.makedirs(os.path.join(data_dir, "vae-sd"))
    labels = []
    for i in range(n):
        fname = f"img_{i:03d}.png"
        Image.new("RGB", (8, 8), (i * 40, 0, 0)).save(os.path.join(data_dir, "images", fname))
        np.save(os.path.join(data_dir, "vae-sd", f"img_{i:03d}.npy"),
                np.zeros((8, 4, 4), np.float32))
        labels.append([fname, i % 2])
    with open(os.path.join(data_dir, "dataset.json"), "w") as f:
        json.dump({"labels": labels}, f)


def test_captioning_roundtrip_through_image_data(tmp_path):
    data_dir = str(tmp_path)
    _fake_image_dataset(data_dir)
    backend = captioning.StubBackend()
    captioning.caption(data_dir, backend=backend)
    assert sorted(os.listdir(tmp_path / "captions")) == [f"img_{i:03d}.txt" for i in range(3)]
    captioning.embed(data_dir, layers=[0, 15, -1], backend=backend)
    for k in (0, 15, -1):
        assert len(os.listdir(tmp_path / captioning.layer_dir_name("text_embeds_qwen7b", k))) == 3
    ds = CachedLatentDataset(ImageDatasetConfig(data_dir=data_dir,
                                                text_embeds_subdir="text_embeds_qwen7b_l15"))
    assert len(ds) == 3 and ds[1]["z_text"].shape == (16,)
    assert ds[1]["z_text"][0] == pytest.approx(215.0)  # caption 2, layer 15
    ds2 = CachedLatentDataset(ImageDatasetConfig(data_dir=data_dir,
                                                 text_embeds_subdir="text_embeds_qwen2b_last"))
    assert ds2[2]["z_text"][0] == pytest.approx(3.0)
    backend = captioning.StubBackend()
    captioning.caption(str(tmp_path), out_subdir="c2", backend=backend, limit=2)
    assert len(os.listdir(tmp_path / "c2")) == 2


def test_captioning_helpers():
    h = np.arange(12, dtype=np.float32).reshape(3, 4)
    np.testing.assert_allclose(captioning.mean_pool(h), h.mean(0))
    with pytest.raises(ValueError):
        captioning.mean_pool(h[None])
    msgs = captioning.build_messages(captioning.PROMPT)
    assert [c["type"] for c in msgs[0]["content"]] == ["image", "text"]
    assert captioning.layer_dir_name("text_embeds_qwen7b", -1) == "text_embeds_qwen7b_llast"
    assert captioning.TEXT_Z_DIMS == {"qwen2b": 1536, "qwen7b": 3584}


# -- monitor --

def test_monitor_relaunches_a_command_that_fails_once(tmp_path, capsys):
    """The command fails on its first launch (after writing a checkpoint) and
    succeeds on the second; the monitor relaunches it once and returns 0."""
    ckpt = tmp_path / "run"
    script = ("import os, sys; d = sys.argv[1]; os.makedirs(d, exist_ok=True); "
              "n = len([f for f in os.listdir(d) if f.endswith('.pt')]); "
              "open(os.path.join(d, f'{(n + 1) * 5}.pt'), 'w').close(); "
              "sys.exit(1 if n == 0 else 0)")
    code = monitor.monitor([sys.executable, "-c", script, str(ckpt)], interval=0.05,
                           ckpt_dir=str(ckpt))
    out = capsys.readouterr().out
    assert code == 0
    assert "restart 1, latest checkpoint step: 5" in out
    assert "progress since launch: True (checkpoint step 5)" in out
    assert monitor.latest_checkpoint_step(str(ckpt)) == 10
    # gives up after max_restarts with the last exit code
    assert monitor.monitor([sys.executable, "-c", "import sys; sys.exit(3)"], interval=0.01,
                           max_restarts=1) == 3


def test_latest_checkpoint_step_reads_the_ports_names(tmp_path):
    assert monitor.latest_checkpoint_step(str(tmp_path / "none")) is None
    for name in ("100.pt", "20.pt", "300.pt.tmp", "config.json", "400"):
        (tmp_path / name).write_text("")
    assert monitor.latest_checkpoint_step(str(tmp_path)) == 100
    with pytest.raises(SystemExit):
        monitor.main(["--interval", "0"])


# -- precompute_mol_reps --

def _molecules(n_mols=7, seed=0):
    rng = np.random.default_rng(seed)
    mols = []
    for n in rng.integers(4, 10, size=n_mols):
        mols.append(tmol.GeometricMol(
            (rng.standard_normal((n, 3)) * 1.5).astype(np.float32),
            rng.integers(2, 18, n).astype(np.int32), np.zeros((0, 2), np.int32),
            np.zeros((0,), np.int32), np.zeros(n, np.int32)))
    return mols


def _seeded_tree(model, args, std=0.1, seed=0):
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), *args))
    rng = np.random.default_rng(seed)

    def draw(path, s):
        x = (rng.standard_normal(s.shape) * std).astype(np.float32)
        key = jax.tree_util.keystr(path)
        if key.endswith("['scale']") or "['mul']" in key:
            return x + 1.0
        if "['means']" in key or "['stds']" in key:
            return np.abs(x) * 10 + 0.5
        if "['betas']" in key:
            return np.abs(x) * 50 + 5.0
        return x

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _jax_tool():
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from tools import precompute_mol_reps as jtool

    return jtool


@pytest.mark.parametrize("encoder", ["unimol", "frad"])
def test_precompute_writes_reps_matching_jax_tool(tmp_path, encoder):
    mols = _molecules()
    data = str(tmp_path / "train.rsmol")
    tmol.save_dataset(data, mols)
    if encoder == "unimol":
        jmodel = JaxUniMol(**UNIMOL_SMALL)
        t, d, e = prep.unimol_inputs(mols[:2], 9)
        args = (jnp.asarray(t), jnp.asarray(d), jnp.asarray(e))
    else:
        jmodel = JaxFrad()
        z, pos, mask = prep.frad_inputs(mols[:2], 9, tmol.build_vocab().tokens)
        args = (jnp.asarray(z), jnp.asarray(pos), jnp.asarray(mask))
    tree = _seeded_tree(jmodel, args)
    weights = str(tmp_path / f"{encoder}.npz")
    save_npz(weights, tree)
    reps = prep.main(["--data", data + ".npz", "--weights", weights, "--encoder", encoder,
                      "--batch-size", "3", "--device", "cpu"])
    saved = np.load(tmp_path / "reps.npy")
    np.testing.assert_array_equal(saved, reps)
    np.testing.assert_array_equal(np.load(tmp_path / "sizes.npy"),
                                  [m.seq_length for m in mols])
    jtool = _jax_tool()
    params = jax.tree.map(jnp.asarray, tree)
    jmols = jmol.load_dataset(data + ".npz")
    if encoder == "unimol":
        ref = jtool.encode_unimol(jmols, params, 3, UNIMOL_SMALL["rep_dim"])
    else:
        ref = jtool.encode_frad(jmols, params, 3, jmol.build_vocab().tokens)
    assert saved.shape == ref.shape == (len(mols), 32 if encoder == "unimol" else 128)
    assert np.abs(saved - ref).max() <= 1e-5 * np.abs(ref).max()


def test_precompute_from_reference_checkpoints_feeds_semla_training(tmp_path, capsys):
    """Reference-layout torch checkpoints of seeded weights (UniMol's state
    dict; Frad's TorchMD-ET under 'representation_model.'), then one
    train-molecule-semla step that reads the reps."""
    mols = _molecules(6, seed=1)
    data = tmp_path / "geom"
    data.mkdir()
    tmol.save_dataset(str(data / "train.rsmol"), mols)
    gen = torch.Generator().manual_seed(0)
    from reed_tpu_torch.encoders.unimol import UniMolGlobal

    model = UniMolGlobal(**UNIMOL_SMALL).initialize_weights(gen)
    torch.save({"model": model.state_dict()}, str(tmp_path / "unimol.pt"))
    out = str(tmp_path / "unimol_reps.npy")
    reps = prep.main(["--data", str(data / "train.rsmol.npz"), "--weights",
                      str(tmp_path / "unimol.pt"), "--out", out, "--device", "cpu"])
    assert reps.shape == (6, 32) and np.isfinite(reps).all()
    frad = torchmd_et.FradEncoder(torchmd_et.TorchMDET(hidden=16, num_layers=1, num_rbf=8,
                                                       num_heads=8)).initialize_weights(gen)
    torch.save({"state_dict": {f"representation_model.{k}": v
                               for k, v in frad.et.state_dict().items()}},
               str(tmp_path / "frad.ckpt"))
    reps_f = prep.main(["--data", str(data / "train.rsmol.npz"), "--weights",
                        str(tmp_path / "frad.ckpt"), "--encoder", "frad",
                        "--out", str(data / "reps.npy"), "--device", "cpu"])
    assert reps_f.shape == (6, 16)
    loaded = prep.load_encoder("unimol", str(tmp_path / "unimol.pt"), torch.device("cpu"))
    assert unimol_convert.widths(loaded.state_dict())["layers"] == 2
    capsys.readouterr()
    state = cli.main(["train-molecule-semla", "--data-dir", str(data), "--batch-cost", "40",
                      "--steps", "1", "--set", "d_model=16", "--set", "n_layers=2",
                      "--set", "arch=egnn", "--set", "d_edge=8", "--set", "d_rep=16",
                      "--set", "align_depth=[1]", "--device", "cpu"])
    text = capsys.readouterr().out
    assert state.step == 1 and "loaded 6 molecules" in text and "no reps.npy" not in text


# -- --profile-dir --

@pytest.mark.parametrize("steps,first,last", [(10, 2, 7), (2, 0, 1)])
def test_profile_dir_writes_a_trace(tmp_path, steps, first, last):
    prof = tmp_path / "prof"
    cli.main(["train-rdm", "--device", "cpu", "--steps", str(steps), "--batch-size", "4",
              "--log-every", "100", "--profile-dir", str(prof), "--set", "channels=16",
              "--set", "model_channels=32", "--set", "bottleneck_channels=32",
              "--set", "num_res_blocks=2", "--set", "time_embed_dim=16",
              "--set", "max_nodes=16"])
    files = os.listdir(prof)
    assert files == [f"steps_{first}-{last}.pt.trace.json"]
    with open(prof / files[0]) as f:
        events = json.load(f)["traceEvents"]
    steps_traced = sum(e.get("name") == "reed::train_step" for e in events)
    assert steps_traced == last - first + 1
