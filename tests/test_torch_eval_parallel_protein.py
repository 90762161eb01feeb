"""eval-protein's sampler and CLI in reed_tpu_torch over gloo ranks on the
CPU (tests/torch_eval_dp.py: one spawn of two ranks and one of four),
against one process and against reed_tpu's sampler on the same mesh.

- Euler unmasking of ProteinMPNN-FMIF (hidden 32, H = 16 a rank at
  tensor=2 through the fused chain's plain version, 2 + 2 layers, K 6, 5
  steps, 16 residues) at data=2, tensor=2 and data=2 x tensor=2, on 4
  rows (even), 5 rows (3 + 2) and 1 row (one batch index holds none):
  the predicted and final tokens equal one process's on every rank; the
  encoder state every tensor rank reuses through the decoder loop is whole
  (within REL of one process's).
- reed_tpu's ProteinTrainer.sample on MeshConfig(tensor=2) (the conftest's
  8 CPU devices) from the same weights, with its uniforms handed to the
  port at the global shape: the tokens equal at tensor=2 and at data=2 x
  tensor=2.
- eval-protein --distributed (synthetic batch from a checkpoint, 3 rows
  over 2 batch indices; the valid split of a fabricated PDB set) at --dp 2,
  --tp 2 and --dp 2 --tp 2: the JSON rank 0 returns equals one process's
  (floats within te.JSON_REL of max(1, |value|), everything else equal), and
  every other rank prints nothing but the `distributed:` line.
- The rows that need not divide: split_rows, global_rows(dp, n) draws at
  the global shape along axis 0 and axis 1, and keep.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dp
import torch_eval_dp as te
from reed_tpu.core.config import MeshConfig as JaxMesh
from reed_tpu.diffusion.discrete import MaskingInterpolantConfig as JaxInterp
from reed_tpu.train.protein import ProteinTrainConfig as JaxConfig
from reed_tpu.train.protein import ProteinTrainer as JaxTrainer
from reed_tpu_torch.encoders.fmif_convert import state_dict_from_flax
from reed_tpu_torch.parallel import draws
from test_cli_eval import _fake_pdb_dataset
from torch_parity import fmif_batch, fmif_random_params

torch.set_num_threads(1)

# the encoder state of a split model against one process's: the sums over
# the hidden units run in another order
REL = 1e-5
MESHES = [("data", 2), ("tensor", 2), ("data_tensor", 4)]
TENSOR_MESHES = [m for m in MESHES if "tensor" in m[0]]
CLI_CASES = ["synthetic", "data_dir"]


def _jax_inputs():
    """reed_tpu's sampler on MeshConfig(tensor=2), its weights sharded by
    its trainer: 5 chains of 16 residues (3 padded), seeded-normal weights;
    the inputs the ranks take (weights in the port's layout, the batch, its
    uniforms at the global shape) and its tokens."""
    n = te.ROWS["uneven"]
    cfg = JaxConfig(**te.PROTEIN, dropout=0.0, mesh=JaxMesh(tensor=2),
                    interpolant=JaxInterp(num_timesteps=te.PROTEIN_STEPS))
    trainer = JaxTrainer(cfg)
    batch = fmif_batch(batch=n, length=te.PROTEIN_LENGTH, pad=3, seed=5)
    params = fmif_random_params(trainer.model, batch, std=0.1, seed=0)["params"]
    rng = jax.random.PRNGKey(11)
    with trainer.mesh:
        sharded = jax.device_put(jax.tree.map(jnp.asarray, params),
                                 trainer.state_shardings.params)
        pred, tokens = trainer.sample(sharded, {k: jnp.asarray(v) for k, v in batch.items()},
                                      rng)
    # the draws reed_tpu's sampler makes: uniform(fold_in(rng, i), shape)
    shape = batch["S"].shape + (22,)
    uniforms = np.stack([np.asarray(jax.random.uniform(jax.random.fold_in(rng, i), shape))
                         for i in range(te.PROTEIN_STEPS - 1)])
    inputs = {"protein": {"n": n, "params": state_dict_from_flax({"params": params}),
                          "batch": batch, "uniforms": uniforms}}
    return inputs, {"pred": np.asarray(pred), "tokens": np.asarray(tokens)}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The ranks' results, one process's and reed_tpu's."""
    out = tmp_path_factory.mktemp("eval_parallel_protein")
    te.prepare_cli(out, ("protein",))
    _fake_pdb_dataset(str(out / "pdb"))
    inputs, want = _jax_inputs()
    torch.save(inputs, out / "eval_protein_jax_inputs.pt")
    one = te.one_process(out, "protein", inputs)
    return types.SimpleNamespace(out=out, one=one, ranks=te.spawn_ranks(out, "protein"),
                                 want=want)


@pytest.mark.parametrize("case", list(te.ROWS))
@pytest.mark.parametrize("mesh,world", MESHES)
def test_sampler_matches_one_process(run, mesh, world, case):
    want = run.one["samplers"]["protein", case]
    for r in run.ranks[world]:
        got = r[mesh]["protein", case]
        assert got["pred"].shape == (te.ROWS[case], te.PROTEIN_LENGTH)
        assert torch.equal(got["pred"], want["pred"])
        assert torch.equal(got["tokens"], want["tokens"])


@pytest.mark.parametrize("mesh,world", TENSOR_MESHES)
def test_encoder_state_is_whole_on_every_tensor_rank(run, mesh, world):
    """sample() hoists the encoder and the decoder loop reuses its state: a
    split model's (h_v, h_e) is whole on every tensor rank."""
    want = run.one["samplers"]["protein", "uneven"]["enc"]
    for r in run.ranks[world]:
        for got, ref in zip(r[mesh]["protein", "uneven"]["enc"], want):
            assert got.shape == ref.shape
            assert (got - ref).abs().max() <= REL * ref.abs().max()


@pytest.mark.parametrize("mesh,world", TENSOR_MESHES)
def test_sampler_matches_reed_tpu_on_a_tensor_mesh(run, mesh, world):
    for got in [run.one["jax"]["protein"]] + [r[mesh, "jax"]["protein"]
                                              for r in run.ranks[world]]:
        np.testing.assert_array_equal(got["pred"].numpy(), run.want["pred"])
        np.testing.assert_array_equal(got["tokens"].numpy(), run.want["tokens"])


@pytest.mark.parametrize("case", CLI_CASES)
@pytest.mark.parametrize("mesh,world", MESHES)
def test_cli_matches_one_process(run, mesh, world, case):
    key = (mesh, "cli", "protein", case)
    want = run.one["cli"]["protein", case]["json"]
    te.assert_json_close(run.ranks[world][0][key]["json"], want)
    te.assert_only_rank_0_reports(run.ranks[world], key)
    if case == "data_dir":
        assert want["split"] == "valid" and want["num_chains"] == 3


class _Rank:
    def __init__(self, rank, world):
        self.rank, self.world = rank, world


@pytest.mark.parametrize("n,world", [(5, 2), (1, 2), (8, 4), (6, 4)])
def test_rows_that_need_not_divide(n, world):
    """split_rows is np.array_split's split; inside global_rows(dp, n) a draw
    of this rank's rows along axis 0 or 1 is its rows of one process's
    global draw, the generator advancing as that process's; keep takes a
    rank's rows of a global tensor; a draw of the wrong row count raises."""
    starts, counts = draws.split_rows(n, world)
    parts = np.array_split(np.arange(n), world)
    assert [len(p) for p in parts] == counts.tolist()
    assert [p[0] if len(p) else n for p in parts][:world] == [
        s if c else n for s, c in zip(starts.tolist(), counts.tolist())]
    g = torch.Generator().manual_seed(0)
    want0, want1 = torch.rand((n, 3), generator=g), torch.randn((2, n, 4), generator=g)
    after = torch.rand(1, generator=g)
    got0, got1 = [], []
    for rank in range(world):
        g, c = torch.Generator().manual_seed(0), int(counts[rank])
        with draws.global_rows(_Rank(rank, world), n):
            got0.append(draws.rand((c, 3), generator=g))
            got1.append(draws.randn((2, c, 4), axis=1, generator=g))
            assert torch.equal(draws.keep(want1, axis=1), got1[-1])
            assert draws.splitting()
            with pytest.raises(ValueError, match="batch index"):
                draws.rand((c + 1, 3), generator=g)
        assert torch.equal(torch.rand(1, generator=g), after)
    assert torch.equal(torch.cat(got0), want0)
    assert torch.equal(torch.cat(got1, dim=1), want1)
    assert draws.keep(want0) is want0 and not draws.splitting()
