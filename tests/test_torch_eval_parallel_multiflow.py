"""eval-multiflow's sampler and CLI in reed_tpu_torch over gloo ranks on
the CPU (tests/torch_eval_dp.py: one spawn of two ranks and one of four),
against one process and against reed_tpu's sampler on the same mesh.

- se3_sample of the FlowModel (c_s 32, c_z 16, 2 blocks, 4 IPA heads: 2 a
  rank at tensor=2, with the sequence transformer's heads and feed-forward
  split; seeded-normal weights, 4 steps, 12 residues) at data=2, tensor=2
  and data=2 x tensor=2 on 4, 5 (3 + 2) and 1 row (one batch index holds
  none): the tokens equal one process's on every rank, trans and rotmats
  within REL of their largest magnitude.
- reed_tpu's MultiflowTrainer.sample on MeshConfig(tensor=2) (the
  conftest's 8 CPU devices) from the same weights, with its draws handed
  to the port at the global shape: trans and rotmats within JAX_REL of
  their largest magnitude, the tokens equal, at tensor=2 and data=2 x
  tensor=2.
- eval-multiflow --distributed (3 samples over 2 batch indices, a 1-sample
  warm-up) at --dp 2, --tp 2 and --dp 2 --tp 2: the JSON rank 0 returns
  equals one process's (te.assert_json_close; the PDB paths name each run's
  --out), rank 0 alone writes the PDB files and they equal one process's
  (numbers within te.JSON_REL), and every other rank prints nothing but
  the `distributed:` line.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_eval_dp as te
from reed_tpu.core.config import MeshConfig as JaxMesh
from reed_tpu.train import multiflow as jmf
from reed_tpu_torch.encoders.multiflow_convert import state_dict_from_flax
from test_torch_multiflow_train import _seeded, sample_draws

torch.set_num_threads(1)

# a split model, or a batch of other rows, against one process: the sums
# run in another order
REL = 1e-5
# against reed_tpu (tests/test_torch_multiflow_train.py's sampler bound)
JAX_REL = 1e-4
MESHES = [("data", 2), ("tensor", 2), ("data_tensor", 4)]
TENSOR_MESHES = [m for m in MESHES if "tensor" in m[0]]


def _jax_inputs():
    """reed_tpu's sampler on MeshConfig(tensor=2), its weights sharded by
    its trainer: 5 samples from seeded-normal weights; the inputs the ranks
    take (weights in the port's layout, reed_tpu's draws at the global
    shape) and its samples."""
    n, length, steps = te.ROWS["uneven"], te.MULTIFLOW_LENGTH, te.MULTIFLOW_STEPS
    jcfg = jmf.MultiflowTrainConfig(**te.MULTIFLOW, batch_size=3, max_len=length,
                                    mesh=JaxMesh(tensor=2))
    _, params = _seeded(jcfg, seed=3, scale=0.15)
    trainer = jmf.MultiflowTrainer(jcfg)
    key = jax.random.PRNGKey(7)
    with trainer.mesh:
        want = trainer.sample(jax.device_put(params, trainer.state_shardings.params), key, n,
                              length, num_timesteps=steps)
    interp = jcfg.interpolant
    draws = sample_draws(key, n, length, steps,
                         interp.aatypes_interpolant == "masking" and interp.aatypes_do_purity)
    inputs = {"multiflow": {"n": n, "params": state_dict_from_flax(
        jax.tree.map(np.array, params)), "draws": {
            k: v for k, v in vars(draws).items() if v is not None}}}
    return inputs, {k: np.asarray(v) for k, v in want.items()}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The ranks' results, one process's and reed_tpu's."""
    out = tmp_path_factory.mktemp("eval_parallel_multiflow")
    inputs, want = _jax_inputs()
    torch.save(inputs, out / "eval_multiflow_jax_inputs.pt")
    one = te.one_process(out, "multiflow", inputs)
    return types.SimpleNamespace(out=out, one=one, ranks=te.spawn_ranks(out, "multiflow"),
                                 want=want)


def _close(got, want, rel):
    for k in ("trans", "rotmats"):
        scale = np.abs(np.asarray(want[k])).max()
        err = np.abs(np.asarray(got[k]) - np.asarray(want[k])).max()
        assert err <= rel * scale, (k, err / scale)
    np.testing.assert_array_equal(np.asarray(got["aatypes"]), np.asarray(want["aatypes"]))


@pytest.mark.parametrize("case", list(te.ROWS))
@pytest.mark.parametrize("mesh,world", MESHES)
def test_sampler_matches_one_process(run, mesh, world, case):
    want = run.one["samplers"]["multiflow", case]
    assert want["trans"].shape == (te.ROWS[case], te.MULTIFLOW_LENGTH, 3)
    for r in run.ranks[world]:
        _close(r[mesh]["multiflow", case], want, REL)


@pytest.mark.parametrize("mesh,world", TENSOR_MESHES)
def test_sampler_matches_reed_tpu_on_a_tensor_mesh(run, mesh, world):
    _close(run.one["jax"]["multiflow"], run.want, JAX_REL)
    for r in run.ranks[world]:
        _close(r[mesh, "jax"]["multiflow"], run.want, JAX_REL)


def _without_paths(result):
    """The JSON with each sample's PDB path cut to its file name."""
    return dict(result, samples=[dict(s, pdb=s["pdb"].rsplit("/", 1)[-1])
                                 for s in result["samples"]])


@pytest.mark.parametrize("mesh,world", MESHES)
def test_cli_matches_one_process_and_rank_0_alone_writes(run, mesh, world):
    key = (mesh, "cli", "multiflow", "seeded")
    want = run.one["cli"]["multiflow", "seeded"]["json"]
    te.assert_json_close(_without_paths(run.ranks[world][0][key]["json"]),
                         _without_paths(want))
    te.assert_only_rank_0_reports(run.ranks[world], key)
    one = te.files_under(run.out / "multiflow_seeded_one")
    assert len(one) == 3
    te.assert_files_close(te.files_under(run.out / f"multiflow_seeded_{mesh}_rank0"), one)
    for r in range(1, world):
        assert not te.files_under(run.out / f"multiflow_seeded_{mesh}_rank{r}")
