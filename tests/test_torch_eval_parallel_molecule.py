"""eval-semla, eval-molecule and eval-conditional in reed_tpu_torch over
gloo ranks on the CPU (tests/torch_eval_dp.py: one spawn of two ranks and
one of four), against one process and against reed_tpu on the same mesh.

- The samplers at data=2, tensor=2 and data=2 x tensor=2 on 4, 5 (3 + 2)
  and 1 row (one batch index holds none): SemlaFlow's integrator (d_model
  32, 3 layers, 4 heads: 2 a rank; adaLN reps; 4 steps; and arch egnn,
  whole on every tensor rank), the EDM's ancestral loop (EGNN hidden 32 x 2
  blocks with rep conditioning, T = 5, and CFG at 1.5) and the EFM decode
  (3 Euler steps). Their discrete outputs (the EDM's one-hot types, Semla's
  argmax types and bonds) equal one process's on every rank; each
  continuous one lies within REL of its largest magnitude, or within
  WITNESS_FACTOR x the witness where that is larger: the witness is how far
  one process's own output moves when its weights are scaled by 1 + 1e-7
  N(0, 1), about one f32 rounding (at these random inits a rounding in a
  step moves the 4-5-step outputs by 1e-6..2e-5 of their largest). At
  data=2 every output equals, bit for bit, the split witness: one process
  running each batch index's rows apart with the same global draws.
- reed_tpu's samplers on MeshConfig(tensor=2) (the conftest's 8 CPU
  devices) from the same weights, with their draws handed to the port at
  the global shape: SemlaTrainer.generate, MoleculeEDMTrainer.sample (EDM,
  with and without CFG, and EFM) and PropertyTrainer.predict (the
  classifier eval-conditional scores with, hidden 16 x 2 layers), within
  JAX_REL of each output's largest magnitude, the discrete outputs equal,
  at tensor=2 and data=2 x tensor=2.
- eval-semla (5 molecules in batches of 3 + 2; arch egnn), eval-molecule
  (a checkpoint with the DDIM rep sampler of a seeded reference RDM, whole
  on every rank; the EFM with a GtSampler over reps.npy), eval-conditional
  (the EDM's and the classifier's checkpoints; the sweep) through the CLI
  at --dp 2, --tp 2 and --dp 2 --tp 2: the JSON rank 0 returns equals one
  process's (te.assert_json_close), rank 0 alone writes --out and its
  files equal one process's, every other rank prints nothing but the
  `distributed:` line.
- The dirichlet strategy refuses to run over several batch indices.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_eval_dp as te
from reed_tpu.core.config import MeshConfig as JaxMesh
from reed_tpu.diffusion.edm import (sample_center_gravity_zero_gaussian_with_mask,
                                    sample_gaussian_with_mask)
from reed_tpu.diffusion.molecule_fm import IntegratorConfig as JaxIntegrator
from reed_tpu.diffusion.molecule_fm import MoleculeInterpolantConfig as JaxInterp
from reed_tpu.diffusion.molecule_fm import MoleculePriorConfig as JaxPrior
from reed_tpu.encoders.edm_convert import convert_torch_egnn_dynamics
from reed_tpu.train import molecule_edm as jme
from reed_tpu.train import property as jprop
from reed_tpu.train.molecule_semla import SemlaTrainConfig as JaxSemlaConfig
from reed_tpu.train.molecule_semla import SemlaTrainer as JaxSemlaTrainer
from reed_tpu_torch.diffusion import molecule_fm
from reed_tpu_torch.encoders import property_convert, semla_convert
from reed_tpu_torch.parallel import draws as global_draws
from reed_tpu_torch.train import molecule_edm as me
from test_torch_property import _inputs, _random_params
from torch_parity import semla_inputs, semla_random_params

torch.set_num_threads(1)

# a split model, or a batch of other rows, against one process
REL = 1e-5
WITNESS_FACTOR = 10
# against reed_tpu (the one-process parity tests' sampler bound)
JAX_REL = 1e-4
MESHES = [("data", 2), ("tensor", 2), ("data_tensor", 4)]
TENSOR_MESHES = [m for m in MESHES if "tensor" in m[0]]
# (sampler, case) of the rank jobs: every row count, CFG and arch egnn
SAMPLER_CASES = te.sampler_cases("molecule")
CLI_CASES = [key for key in te.cli_cases(".") if key[0] in te.FAMILIES["molecule"]]


def _semla_jax():
    """reed_tpu's SemlaTrainer.generate on MeshConfig(tensor=2) from
    seeded-normal weights on a prior of 5 molecules, and its draws."""
    cfg = te.semla_config()
    jcfg = JaxSemlaConfig(**te.SEMLA, mesh=JaxMesh(tensor=2),
                          integrator=JaxIntegrator(steps=te.SEMLA_STEPS, cat_noise_level=1.0),
                          interpolant=JaxInterp(prior=JaxPrior(vocab_size=6)))
    trainer = JaxSemlaTrainer(jcfg)
    params = semla_random_params(trainer.model, semla_inputs(dict(
        vocab_size=cfg.vocab_size, n_edge_types=cfg.n_bond_types, d_edge=cfg.d_edge,
        self_cond=cfg.self_cond, d_rep=cfg.d_rep), batch=2, n=8), std=0.1)
    prior, rep = te.semla_prior(cfg, te.ROWS["uneven"])
    prior = {k: v.numpy() for k, v in prior.items()}
    key = jax.random.PRNGKey(7)
    with trainer.mesh:
        want = trainer.generate(jax.device_put(jax.tree.map(jnp.asarray, params),
                                               trainer.state_shardings.params), key,
                                {k: jnp.asarray(v) for k, v in prior.items()},
                                rep=jnp.asarray(rep.numpy()))
    b, n = prior["mask"].shape
    steps = []
    for i in range(te.SEMLA_STEPS):
        _, r_type, r_bond = jax.random.split(jax.random.fold_in(key, i), 3)
        steps.append([np.array(jax.random.uniform(r_type, (b, n, cfg.vocab_size))),
                      np.array(jax.random.uniform(r_bond, (b, n, n, cfg.n_bond_types)))])
    inputs = {"n": b, "params": semla_convert.state_dict_from_flax(params), "prior": prior,
              "rep": rep.numpy(), "draws": steps}
    return inputs, {k: np.asarray(v) for k, v in want.items()}


def _combined_noise(rng, b, n, node_mask, nf):
    """reed_tpu's sample_combined_noise at `rng`."""
    r1, r2 = jax.random.split(rng)
    return np.array(jnp.concatenate([
        sample_center_gravity_zero_gaussian_with_mask(r1, (b, n, 3), node_mask),
        sample_gaussian_with_mask(r2, (b, n, nf), node_mask)], axis=-1))


def _edm_jax(model_kind, cfg_scale=None):
    """reed_tpu's MoleculeEDMTrainer.sample on MeshConfig(tensor=2) from
    seeded-normal weights for 5 molecules, and its draws (the EDM's init,
    step and final noise, or the EFM's z)."""
    cfg = te.edm_config(probabilistic_model=model_kind)
    jcfg = jme.MoleculeEDMConfig(**te.EDM, probabilistic_model=model_kind,
                                 mesh=JaxMesh(tensor=2))
    jcfg = dataclasses.replace(
        jcfg, edm=dataclasses.replace(jcfg.edm, timesteps=cfg.edm.timesteps),
        efm=dataclasses.replace(jcfg.efm, ode_steps=cfg.efm.ode_steps))
    trainer = jme.MoleculeEDMTrainer(jcfg)
    gen = torch.Generator().manual_seed(1)
    sd = {k: torch.randn(v.shape, generator=gen) * 0.1
          for k, v in me.build_dynamics(te.edm_config()).state_dict().items()}
    params = jax.tree.map(jnp.asarray, convert_torch_egnn_dynamics(
        {k: v.numpy() for k, v in sd.items()}))
    node_mask, edge_mask, rep = (t.numpy() for t in te.edm_masks(cfg, te.ROWS["uneven"]))
    rng = jax.random.PRNGKey(11)
    with trainer.mesh:
        want = trainer.sample(jax.device_put(params, trainer.state_shardings.params), rng,
                              node_mask.shape[0], jnp.asarray(node_mask),
                              jnp.asarray(edge_mask), rep=jnp.asarray(rep),
                              cfg_scale=cfg_scale)
    b, n = node_mask.shape[:2]
    nf = cfg.num_atom_types + int(cfg.include_charges)
    inputs = {"n": b, "params": sd, "node_mask": node_mask, "edge_mask": edge_mask,
              "rep": rep, "cfg_scale": cfg_scale}
    if model_kind == "fm":
        inputs["z"] = _combined_noise(jax.random.split(rng)[0], b, n, node_mask, nf)
    else:
        r_init, r_scan, r_final = jax.random.split(rng, 3)
        inputs.update(init=_combined_noise(r_init, b, n, node_mask, nf),
                      steps=[_combined_noise(jax.random.fold_in(r_scan, s), b, n, node_mask, nf)
                             for s in range(cfg.edm.timesteps)],
                      final=_combined_noise(r_final, b, n, node_mask, nf))
    return inputs, tuple(np.asarray(v) for v in want)


def _classifier_jax():
    """reed_tpu's PropertyTrainer.predict on MeshConfig(tensor=2) from
    seeded-normal weights on 5 molecules."""
    trainer = jprop.PropertyTrainer(jprop.PropertyTrainConfig(**te.CLASSIFIER,
                                                              mesh=JaxMesh(tensor=2)))
    batch = _inputs(b=5, n=te.CLASSIFIER["max_nodes"], types=te.CLASSIFIER["num_atom_types"])
    params = _random_params(trainer.model, batch)
    with trainer.mesh:
        want = trainer.predict(jax.device_put(jax.tree.map(jnp.asarray, params),
                                              trainer.state_shardings.params),
                               batch["one_hot"], batch["positions"], batch["node_mask"],
                               batch["edge_mask"])
    inputs = dict(batch, params=property_convert.state_dict_from_flax(params))
    return inputs, np.asarray(want)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The ranks' results, one process's, the witnesses and reed_tpu's."""
    out = tmp_path_factory.mktemp("eval_parallel_molecule")
    te.prepare_cli(out, te.FAMILIES["molecule"])
    inputs, want = {}, {}
    inputs["semla"], want["semla"] = _semla_jax()
    inputs["edm"], want["edm"] = _edm_jax("diffusion")
    inputs["edm_cfg"], want["edm_cfg"] = _edm_jax("diffusion", cfg_scale=1.5)
    inputs["efm"], want["efm"] = _edm_jax("fm")
    inputs["classifier"], want["classifier"] = _classifier_jax()
    torch.save(inputs, out / "eval_molecule_jax_inputs.pt")
    one = te.one_process(out, "molecule", inputs)
    witness = {}
    for name, case in SAMPLER_CASES:
        witness[name, case] = _outputs(te.run_sampler(name, case, None, jitter=0))
        with te.split_witness():
            witness[name, case, "split"] = _outputs(te.run_sampler(name, case, None))
    return types.SimpleNamespace(out=out, one=one, ranks=te.spawn_ranks(out, "molecule"),
                                 want=want, witness=witness)


def _outputs(out):
    """{name: array} of a sampler's output (Semla's dict, the EDM's tuple)."""
    if isinstance(out, dict):
        return {k: v.numpy() for k, v in out.items()}
    return {k: v.numpy() for k, v in zip(("x", "h_cat", "h_int"), out)}


def _discrete(outputs):
    """The discrete outputs: Semla's argmax types and bonds (its charges
    too), the EDM's one-hot types."""
    if "atomics" in outputs:
        return {k: outputs[k].argmax(-1) for k in ("atomics", "bonds", "charges")}
    return {"h_cat": outputs["h_cat"]}


def _check(got, want, rel, witness=None):
    """`got` against `want`: discrete outputs equal, each output within rel
    of its largest magnitude (or WITNESS_FACTOR x the witness's distance
    from `want`, where larger)."""
    for k, v in _discrete(want).items():
        np.testing.assert_array_equal(_discrete(got)[k], v, err_msg=k)
    for k, v in want.items():
        scale = max(np.abs(v).max(), 1e-30)
        bound = rel
        if witness is not None:
            bound = max(rel, WITNESS_FACTOR * np.abs(witness[k] - v).max() / scale)
        err = np.abs(got[k] - v).max() / scale
        assert got[k].shape == v.shape and err <= bound, (k, err, bound)


@pytest.mark.parametrize("name,case", SAMPLER_CASES)
@pytest.mark.parametrize("mesh,world", MESHES)
def test_sampler_matches_one_process(run, mesh, world, name, case):
    want = _outputs(run.one["samplers"][name, case])
    for r in run.ranks[world]:
        _check(_outputs(r[mesh][name, case]), want, REL, run.witness[name, case])


@pytest.mark.parametrize("name,case", SAMPLER_CASES)
def test_data_ranks_equal_the_split_witness(run, name, case):
    """At data=2 each rank runs its rows as one process runs the same rows
    with the same global draws (the split witness): bitwise equal outputs,
    where one process at the global batch differs by the batch's rounding."""
    want = run.witness[name, case, "split"]
    for r in run.ranks[2]:
        got = _outputs(r["data"][name, case])
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)


@pytest.mark.parametrize("name", ["semla", "edm", "edm_cfg", "efm", "classifier"])
@pytest.mark.parametrize("mesh,world", TENSOR_MESHES)
def test_sampler_matches_reed_tpu_on_a_tensor_mesh(run, mesh, world, name):
    want = run.want[name]
    if name == "classifier":
        for got in [run.one["jax"][name]] + [r[mesh, "jax"][name] for r in run.ranks[world]]:
            err = np.abs(got.numpy() - want).max() / np.abs(want).max()
            assert err <= JAX_REL, err
        return
    want = (dict(want) if isinstance(want, dict)
            else dict(zip(("x", "h_cat", "h_int"), want)))
    for got in [run.one["jax"][name]] + [r[mesh, "jax"][name] for r in run.ranks[world]]:
        got = _outputs(got)
        if name == "semla":
            got = {k: got[k] for k in want}
        elif "h_int" in want:
            # the charges are round(10 z): held like x, plus one for the rounding
            h_int = got.pop("h_int")
            ref = want.pop("h_int")
            assert np.abs(h_int - ref).max() <= 1.0 + JAX_REL * np.abs(ref).max()
        _check(got, want, JAX_REL)


@pytest.mark.parametrize("family,case", CLI_CASES)
@pytest.mark.parametrize("mesh,world", MESHES)
def test_cli_matches_one_process_and_rank_0_alone_writes(run, mesh, world, family, case):
    key = (mesh, "cli", family, case)
    te.assert_json_close(run.ranks[world][0][key]["json"],
                         run.one["cli"][family, case]["json"])
    te.assert_only_rank_0_reports(run.ranks[world], key)
    one = te.files_under(run.out / f"{family}_{case}_one")
    if te.cli_cases(run.out)[family, case][1]:
        assert one
    te.assert_files_close(te.files_under(run.out / f"{family}_{case}_{mesh}_rank0"), one)
    for r in range(1, world):
        assert not te.files_under(run.out / f"{family}_{case}_{mesh}_rank{r}")


def test_dirichlet_refuses_several_batch_indices():
    """The gamma draws of the dirichlet strategy depend on every row's
    alpha: over several batch indices it raises, naming why; on one it
    draws, and injected gammas are kept by rows anywhere."""
    cfg = molecule_fm.IntegratorConfig(type_strategy="dirichlet", bond_strategy="linear")
    b, n = 2, 4
    probs = torch.softmax(torch.randn(b, n, 6, generator=torch.Generator().manual_seed(0)), -1)
    bonds = torch.softmax(torch.randn(b, n, n, 5), -1)
    state = {"coords": torch.zeros(b, n, 3), "atomics": probs, "bonds": bonds,
             "mask": torch.ones(b, n)}
    t = torch.full((b,), 0.3)

    class Rank:
        rank, world = 0, 2

    with global_draws.global_rows(Rank(), 2 * b):
        with pytest.raises(NotImplementedError, match="dirichlet.*alpha"):
            molecule_fm.integrator_step(cfg, state, state, state, t, 0.1,
                                        generator=torch.Generator())
        given = torch.rand(2 * b, n, 6)
        out = molecule_fm.integrator_step(cfg, state, state, state, t, 0.1, draws=[given])
    want = state["atomics"] + 0.1 * given[:b] / given[:b].sum(-1, keepdim=True)
    torch.testing.assert_close(out["atomics"], want)
    molecule_fm.integrator_step(cfg, state, state, state, t, 0.1, generator=torch.Generator())
