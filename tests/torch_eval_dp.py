"""Sharded evaluation and sampling of reed_tpu_torch for the tests: the
five eval families' samplers at tiny widths on a mesh (None: one
process), the eval subcommands through the CLI, and the rank jobs of
tests/test_torch_eval_parallel_{protein,multiflow,molecule}.py, which
tests/torch_dp.py runs as gloo ranks (`torch_dp.spawn(out, 'eval_protein')`
and so on). Every sampler draws its batch at the global size from seeded
generators, runs this rank's rows (parallel.mesh.run_rows) and returns the
gathered global rows; `inputs` (whole weights, a batch and reed_tpu's
draws at the global shape) replace the seeded ones for the parity against
reed_tpu. This module imports no JAX: the ranks import it."""

import contextlib
import io
import pathlib

import numpy as np
import torch

# the meshes of the two-rank and the four-rank spawns, and their CLI flags
EVAL_MESHES = {"data": dict(data=2), "tensor": dict(tensor=2)}
EVAL_MESHES_4 = {"data_tensor": dict(data=2, tensor=2)}
MESH_FLAGS = {"data": ["--dp", "2"], "tensor": ["--tp", "2"],
              "data_tensor": ["--dp", "2", "--tp", "2"]}
# the global rows of each case: split evenly, 5 over 2 batch indices (3 +
# 2), and 1 over 2 (one index holds none)
ROWS = {"even": 4, "uneven": 5, "one": 1}


def mesh_config(name=None):
    from reed_tpu_torch.core.config import MeshConfig

    if name is None:
        return MeshConfig()
    return MeshConfig(**{**EVAL_MESHES, **EVAL_MESHES_4}[name])


def _dp(mesh, axes):
    from reed_tpu_torch.parallel.mesh import data_parallel

    return data_parallel(mesh, axes=axes)


# where set (a count W) and there is no process group, _rows runs each of W
# batch indices' rows apart in this process (parallel.mesh.rows_apart): what
# W data ranks compute, without their collectives (split_witness)
_SPLIT = None


@contextlib.contextmanager
def split_witness(world=2):
    """The samplers inside the block run as `world` data ranks would, in
    this process (_SPLIT)."""
    global _SPLIT
    _SPLIT = world
    try:
        yield
    finally:
        _SPLIT = None


def _rows(dp, n, batch, fn):
    from reed_tpu_torch.parallel.mesh import rows_apart, run_rows

    if dp is not None or _SPLIT is None:
        return run_rows(dp, n, batch, fn)
    return rows_apart(_SPLIT, n, batch, fn)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def jittered(model, seed):
    """`model` with every parameter scaled by 1 + 1e-7 N(0, 1) (about one
    f32 rounding), drawn from `seed`, where a seed is given: a one-process
    run of it measures how far the sampler's own rounding moves its
    output, the yardstick a split model's run is held to."""
    if seed is not None:
        gen = _gen(seed)
        with torch.no_grad():
            for p in model.parameters():
                p.mul_(1 + 1e-7 * torch.randn(p.shape, generator=gen))
    return model


# --- ProteinMPNN-FMIF (eval-protein, through K2a's plain version) -----------

PROTEIN = dict(hidden_dim=32, num_encoder_layers=2, num_decoder_layers=2, k_neighbors=6,
               single_dim=8, pair_dim=4, structure_dim=8)
PROTEIN_STEPS = 5
PROTEIN_LENGTH = 16


def protein_config(mesh=None, **fields):
    from reed_tpu_torch.diffusion.discrete import MaskingInterpolantConfig
    from reed_tpu_torch.train.protein import ProteinTrainConfig

    return ProteinTrainConfig(**PROTEIN, **fields, mesh=mesh or mesh_config(),
                              interpolant=MaskingInterpolantConfig(num_timesteps=PROTEIN_STEPS))


@torch.no_grad()
def protein_sample(mesh, n, inputs=None):
    """eval-protein's sampler on `mesh`: the seeded model (or inputs'
    weights), n seeded synthetic backbones (or inputs' batch), Euler
    unmasking from a seeded generator (or inputs' uniforms): the gathered
    {'pred', 'tokens'} and the encoder state (h_v, h_e) each rank holds
    for the whole batch."""
    from reed_tpu_torch.parallel.mesh import PMPNN_AXES, PMPNN_TP_RULES, shard_state_dict
    from reed_tpu_torch.train.protein import build_model, sample, synthetic_protein_batch

    cfg = protein_config(mesh)
    dp = _dp(cfg.mesh, PMPNN_AXES)
    model = build_model(cfg, device="cpu", generator=_gen(0), parallel=dp)
    uniforms = None
    if inputs is None:
        batch = synthetic_protein_batch(_gen(3), n, PROTEIN_LENGTH)
    else:
        model.load_state_dict(shard_state_dict(inputs["params"], dp, PMPNN_TP_RULES))
        batch = {k: torch.as_tensor(v) for k, v in inputs["batch"].items()}
        uniforms = torch.as_tensor(inputs["uniforms"])
    enc = model(batch["X"], batch["S"], batch["mask"], batch["chain_M"],
                batch["residue_idx"], batch["chain_encoding_all"], return_enc=True)
    pred, tokens = _rows(dp, n, batch, lambda rows: sample(
        model, rows, _gen(4), cfg.interpolant, uniforms=uniforms))
    return {"pred": pred, "tokens": tokens, "enc": [e.clone() for e in enc[:2]]}


# --- MultiFlow (eval-multiflow) ----------------------------------------------

MULTIFLOW = dict(c_s=32, c_z=16, num_blocks=2, ipa_c_hidden=8, ipa_no_heads=4,
                 ipa_no_qk_points=4, ipa_no_v_points=4)
MULTIFLOW_LENGTH = 12
MULTIFLOW_STEPS = 4


@torch.no_grad()
def multiflow_sample(mesh, n, inputs=None):
    """eval-multiflow's sampler on `mesh`: the FlowModel with seeded-normal
    weights (or inputs'), n samples of MULTIFLOW_LENGTH residues from a seeded
    generator (or inputs' draws, SE3SampleDraws' fields at the global
    shape): the gathered {'trans', 'rotmats', 'aatypes'}."""
    from reed_tpu_torch.diffusion.se3 import SE3SampleDraws
    from reed_tpu_torch.parallel.mesh import IPA_AXES, shard_state_dict
    from reed_tpu_torch.train.multiflow import (MultiflowTrainConfig, build_model, sample,
                                                tp_rules)

    cfg = MultiflowTrainConfig(**MULTIFLOW, mesh=mesh or mesh_config())
    dp = _dp(cfg.mesh, IPA_AXES)
    model = build_model(cfg, device="cpu", parallel=dp)
    draws = None
    if inputs is None:
        # seeded-normal weights: the init's zero output layers would leave
        # the split heads nothing to do
        params = {k: torch.randn(v.shape, generator=_gen(i)) * (0.02 if "bb_update" in k
                                                                else 0.1)
                  for i, (k, v) in enumerate(build_model(
                      MultiflowTrainConfig(**MULTIFLOW)).state_dict().items())}
    else:
        params = inputs["params"]
        draws = SE3SampleDraws(**{k: torch.as_tensor(v) for k, v in inputs["draws"].items()})
    model.load_state_dict(shard_state_dict(params, dp, tp_rules(cfg)))
    model.eval()
    return _rows(dp, n, torch.ones(n, MULTIFLOW_LENGTH), lambda res_mask: sample(
        cfg, model, res_mask, num_timesteps=MULTIFLOW_STEPS, generator=_gen(5), draws=draws))


# --- SemlaFlow (eval-semla) ----------------------------------------------------

SEMLA = dict(vocab_size=6, n_bond_types=5, n_charge_types=7, max_atoms=9, d_model=32,
             d_message=16, n_layers=3, n_coord_sets=4, d_message_hidden=16, d_edge=8,
             n_attn_heads=4, size_emb=8, d_rep=16, cond_type="adaLN")
SEMLA_STEPS = 4


def semla_config(mesh=None, **fields):
    from reed_tpu_torch.diffusion.molecule_fm import (IntegratorConfig,
                                                      MoleculeInterpolantConfig,
                                                      MoleculePriorConfig)
    from reed_tpu_torch.train.molecule_semla import SemlaTrainConfig

    return SemlaTrainConfig(**{**SEMLA, **fields}, mesh=mesh or mesh_config(),
                            integrator=IntegratorConfig(steps=SEMLA_STEPS, cat_noise_level=1.0),
                            interpolant=MoleculeInterpolantConfig(
                                prior=MoleculePriorConfig(vocab_size=6)))


def semla_prior(cfg, n):
    """The prior and reps of n molecules of 5-9 atoms, drawn on the host for
    the whole batch (numpy seed 2)."""
    from reed_tpu_torch.train.molecule_semla import sample_prior

    rng = np.random.default_rng(2)
    sizes = rng.integers(5, cfg.max_atoms + 1, size=n)
    mask = (np.arange(cfg.max_atoms)[None, :] < sizes[:, None]).astype(np.float32)
    prior = sample_prior(cfg, rng, mask, "cpu")
    rep = torch.from_numpy(rng.standard_normal((n, cfg.d_rep)).astype(np.float32))
    return prior, rep


@torch.no_grad()
def semla_sample(mesh, n, inputs=None, arch="semla", jitter=None):
    """eval-semla's integrator on `mesh` with arch `arch` (egnn and eqgat
    whole on every tensor rank): the seeded model (or inputs' weights), the
    host prior of n molecules (or inputs' prior and rep), the draws from a
    seeded generator (or inputs' per-step draws at the global shape): the
    gathered final {'coords', 'atomics', 'bonds', 'charges', 'mask'};
    `jitter` as in jittered."""
    from reed_tpu_torch.encoders.semla_convert import load_into
    from reed_tpu_torch.parallel.mesh import SEMLA_AXES, SEMLA_TP_RULES, shard_state_dict
    from reed_tpu_torch.train.molecule_semla import build_model, generate

    cfg = semla_config(mesh, arch=arch)
    dp = _dp(cfg.mesh, SEMLA_AXES)
    model = build_model(cfg, device="cpu", generator=_gen(0), parallel=dp)
    draws = None
    if inputs is None:
        prior, rep = semla_prior(cfg, n)
    else:
        load_into(model, shard_state_dict(inputs["params"], dp, SEMLA_TP_RULES))
        prior = {k: torch.as_tensor(v) for k, v in inputs["prior"].items()}
        rep = torch.as_tensor(inputs["rep"])
        draws = [[torch.as_tensor(d) for d in step] for step in inputs["draws"]]
    jittered(model, jitter).eval()
    return _rows(dp, n, {"prior": prior, "rep": rep}, lambda rows: generate(
        model, cfg, rows["prior"], rep=rows["rep"], generator=_gen(6), draws=draws))


# --- the EDM / EFM (eval-molecule) and the property classifier ---------------

EDM = dict(hidden_nf=32, n_layers=2, inv_sublayers=2, max_nodes=9, rep_nf=16)
EDM_STEPS = 5


def edm_config(mesh=None, **fields):
    from dataclasses import replace

    from reed_tpu_torch.train.molecule_edm import MoleculeEDMConfig

    cfg = MoleculeEDMConfig(**{**EDM, **fields}, mesh=mesh or mesh_config())
    return replace(cfg, edm=replace(cfg.edm, timesteps=EDM_STEPS),
                   efm=replace(cfg.efm, ode_steps=3))


def edm_masks(cfg, n):
    """(node_mask, edge_mask, rep) of n molecules of 4-9 atoms and their
    reps, drawn on the host for the whole batch (numpy seed 2)."""
    from reed_tpu_torch.eval.two_stage import molecule_masks

    rng = np.random.default_rng(2)
    node_mask, edge_mask = molecule_masks(rng.integers(4, cfg.max_nodes + 1, n), cfg.max_nodes)
    return node_mask, edge_mask, torch.from_numpy(
        rng.standard_normal((n, cfg.rep_nf)).astype(np.float32))


@torch.no_grad()
def edm_sample(mesh, n, inputs=None, model_kind="diffusion", cfg_scale=None, jitter=None):
    """eval-molecule's sampler on `mesh`: the seeded EGNN (or inputs'
    weights), the masks and reps of n molecules (or inputs'), the EDM's
    ancestral loop (with CFG at cfg_scale) or the EFM decode (model_kind
    'fm') from a seeded generator (or inputs' draws at the global shape:
    SampleDraws' fields, or the EFM's z): the gathered (x, h_cat, h_int);
    `jitter` as in jittered."""
    from reed_tpu_torch.diffusion.edm import SampleDraws
    from reed_tpu_torch.diffusion.efm import EquivariantCNF
    from reed_tpu_torch.encoders.edm_convert import load_into
    from reed_tpu_torch.parallel.mesh import EGNN_AXES, EGNN_TP_RULES, shard_state_dict
    from reed_tpu_torch.train import molecule_edm as me

    cfg = edm_config(mesh, probabilistic_model=model_kind)
    dp = _dp(cfg.mesh, EGNN_AXES)
    model = jittered(me.build_dynamics(cfg, device="cpu", generator=_gen(0), parallel=dp),
                     jitter).eval()
    if inputs is None:
        node_mask, edge_mask, rep = edm_masks(cfg, n)
        return _rows(dp, n, (node_mask, edge_mask, rep), lambda rows: me.sample(
            cfg, model, rows[0], rows[1], rep=rows[2], cfg_scale=cfg_scale, generator=_gen(7)))
    load_into(model, shard_state_dict(inputs["params"], dp, EGNN_TP_RULES))
    rows = tuple(torch.as_tensor(inputs[k]) for k in ("node_mask", "edge_mask", "rep"))
    if model_kind == "fm":
        cnf = EquivariantCNF(me.efm_config(cfg), me.dynamics_fn(model))
        return _rows(dp, n, rows, lambda r: cnf.sample(
            r[0].shape[0], r[0].shape[1], r[0], r[1], rep=r[2],
            z=torch.as_tensor(inputs["z"])))
    draws = SampleDraws(torch.as_tensor(inputs["init"]),
                        [torch.as_tensor(d) for d in inputs["steps"]],
                        torch.as_tensor(inputs["final"]))
    edm = me.build_edm(cfg, model, cfg_scale=cfg_scale)
    return _rows(dp, n, rows, lambda r: edm.sample(r[0].shape[0], r[0].shape[1], r[0], r[1],
                                                   rep=r[2], draws=draws))


CLASSIFIER = dict(hidden_nf=16, n_layers=2, max_nodes=8, num_atom_types=4, mean=3.0, mad=2.0)


@torch.no_grad()
def classifier_predict(mesh, inputs):
    """eval-conditional's scoring on `mesh`: the property classifier
    (CLASSIFIER's widths, inputs' whole weights) on this rank's rows of
    inputs' molecules, gathered."""
    from reed_tpu_torch.parallel.mesh import EGNN_AXES, EGNN_TP_RULES, shard_state_dict
    from reed_tpu_torch.train import property as prop

    cfg = prop.PropertyTrainConfig(**CLASSIFIER, mesh=mesh or mesh_config())
    dp = _dp(cfg.mesh, EGNN_AXES)
    model = prop.build_model(cfg, device="cpu", generator=_gen(0), parallel=dp)
    model.load_state_dict(shard_state_dict(inputs["params"], dp, EGNN_TP_RULES))
    model.eval()
    batch = tuple(torch.as_tensor(inputs[k])
                  for k in ("one_hot", "positions", "node_mask", "edge_mask"))
    return _rows(dp, batch[0].shape[0], batch,
                 lambda rows: prop.predict(cfg, model, *rows, device="cpu"))


SAMPLERS = {"protein": protein_sample, "multiflow": multiflow_sample,
            "semla": semla_sample, "edm": edm_sample}


# --- the eval subcommands through the CLI -------------------------------------

PROTEIN_SETS = [a for k, v in PROTEIN.items() for a in ("--set", f"{k}={v}")]
MULTIFLOW_SETS = [a for k, v in MULTIFLOW.items() for a in ("--set", f"{k}={v}")]
SEMLA_SETS = ["--set", "d_model=32", "--set", "n_layers=2", "--set", "n_coord_sets=4",
              "--set", "d_message=16", "--set", "d_message_hidden=16", "--set", "d_edge=8",
              "--set", "n_attn_heads=4", "--set", "d_rep=16", "--set", "max_atoms=12"]
EDM_SETS = ["--set", "hidden_nf=32", "--set", "n_layers=2", "--set", "rep_nf=16",
            "--set", "max_nodes=9"]
CLASSIFIER_SETS = ["--set", "hidden_nf=16", "--set", "n_layers=2", "--set", "max_nodes=9"]


def cli_cases(out):
    """{(family, case): (argv, writes files)} of the eval subcommands at tiny
    widths on the files prepare_cli wrote under `out`; the argv of a case
    that writes takes --out where it runs."""
    out = pathlib.Path(out)
    return {
        ("protein", "synthetic"): (["eval-protein", "--length", "16", "--batch-size", "3",
                                    "--num-steps", "4", "--ckpt-dir", str(out / "protein_run"),
                                    *PROTEIN_SETS], False),
        ("protein", "data_dir"): (["eval-protein", "--data-dir", str(out / "pdb"),
                                   "--max-chains", "3", "--num-steps", "3", *PROTEIN_SETS],
                                  False),
        ("multiflow", "seeded"): (["eval-multiflow", "--num-samples", "3", "--length", "12",
                                   "--num-steps", "3", *MULTIFLOW_SETS], True),
        ("semla", "semla"): (["eval-semla", "--n-samples", "5", "--batch-size", "3",
                              "--n-replicates", "2", "--num-steps", "3", *SEMLA_SETS], True),
        ("semla", "egnn"): (["eval-semla", "--n-samples", "3", "--n-replicates", "1",
                             "--num-steps", "3", *SEMLA_SETS, "--set", "arch=egnn"], False),
        ("molecule", "rdm"): (["eval-molecule", "--ckpt-dir", str(out / "edm_run"),
                               "--rdm-ref-ckpt", str(out / "rdm.ckpt"), "--num-steps", "3",
                               "--batch-size", "3", "--n-replicates", "2", *EDM_SETS], False),
        ("molecule", "gt_fm"): (["eval-molecule", "--data-dir", str(out / "reps"),
                                 "--num-steps", "3", "--batch-size", "5", "--n-replicates", "1",
                                 *EDM_SETS, "--set", "probabilistic_model=fm",
                                 "--set", "efm.ode_steps=3"], True),
        ("conditional", "sampled"): (["eval-conditional", "--ckpt-dir", str(out / "cond_run"),
                                      "--classifier-ckpt", str(out / "clf_run"),
                                      "--n-samples", "3", "--n-replicates", "2",
                                      "--num-steps", "3", *EDM_SETS], False),
        ("conditional", "sweep"): (["eval-conditional", "--sweep", "--n-samples", "5",
                                    "--n-replicates", "1", "--num-steps", "3", *EDM_SETS,
                                    "--set", "rep_nf=null"], True),
    }


def prepare_cli(out, families):
    """The files the CLI cases of `families` read, written under `out` by
    the test process before the ranks start: checkpoints of one-step
    training runs, stand-in reps and sizes, and a reference-layout RDM
    checkpoint (the protein test writes the fabricated PDB split itself,
    with reed_tpu's test fixture)."""
    from reed_tpu_torch import cli
    from reed_tpu_torch.models.rdm_mlp import SimpleMLP

    out = pathlib.Path(out)
    with contextlib.redirect_stdout(io.StringIO()):
        if "protein" in families:
            cli.main(["train-protein", "--device", "cpu", "--synthetic", "--steps", "1",
                      "--batch-size", "2", "--set", "max_len=16", "--ckpt-dir",
                      str(out / "protein_run"), "--ckpt-every", "1", *PROTEIN_SETS])
        if "molecule" in families:
            cli.main(["train-molecule-edm", "--device", "cpu", "--synthetic", "--steps", "1",
                      "--batch-size", "2", "--ckpt-dir", str(out / "edm_run"),
                      "--ckpt-every", "1", *EDM_SETS])
            rng = np.random.default_rng(0)
            (out / "reps").mkdir(exist_ok=True)
            np.save(out / "reps" / "reps.npy", rng.standard_normal((20, 16)).astype(np.float32))
            np.save(out / "reps" / "sizes.npy", rng.integers(4, 10, 20))
            model = SimpleMLP(in_channels=16, out_channels=16, model_channels=24,
                              bottleneck_channels=24, time_embed_dim=8, num_res_blocks=2,
                              num_classes=9, context_channels=16)
            model.initialize_weights(_gen(0))
            sd = {f"model.diffusion_model.{k}": v + 0.05 for k, v in model.state_dict().items()
                  if not k.startswith("cond_stage_model.")}
            sd["cond_stage_model.embedding.weight"] = model.state_dict()[
                "cond_stage_model.embedding.weight"][:9]
            torch.save({"state_dict": sd}, out / "rdm.ckpt")
        if "conditional" in families:
            cli.main(["train-molecule-edm", "--device", "cpu", "--synthetic", "--steps", "1",
                      "--batch-size", "2", "--ckpt-dir", str(out / "cond_run"),
                      "--ckpt-every", "1", *EDM_SETS, "--set", "context_node_nf=1"])
            cli.main(["train-property", "--device", "cpu", "--synthetic", "--steps", "1",
                      "--batch-size", "2", "--ckpt-dir", str(out / "clf_run"),
                      "--ckpt-every", "1", *CLASSIFIER_SETS])


def run_cli(out, family, case, flags, tag):
    """One CLI case with the mesh `flags` (none: one process), its --out
    (where it writes) under out/{family}_{case}_{tag}: {'json': what it
    returned, 'stdout': what it printed}."""
    from reed_tpu_torch import cli

    argv, writes = cli_cases(out)[family, case]
    argv = [argv[0], "--device", "cpu", *flags, *argv[1:]]
    if writes:
        argv += ["--out", str(pathlib.Path(out) / f"{family}_{case}_{tag}")]
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        result = cli.main(argv)
    return {"json": result, "stdout": text.getvalue()}


# --- the rank jobs --------------------------------------------------------------

FAMILIES = {"protein": ("protein",), "multiflow": ("multiflow",),
            "molecule": ("semla", "edm", "efm", "classifier", "molecule", "conditional")}


# the cases beyond ROWS' row counts (at ROWS['uneven']): CFG, arch egnn
EXTRA_CASES = {("edm", "cfg"): dict(cfg_scale=1.5), ("semla", "egnn"): dict(arch="egnn")}


def sampler_cases(family):
    """The (sampler, case) pairs the jobs of `family` run ('efm': the EDM's
    fm decode)."""
    names = [n for n in FAMILIES[family] if n in SAMPLERS or n == "efm"]
    return [(n, case) for n in names for case in ROWS] + [
        key for key in EXTRA_CASES if key[0] in names]


def run_sampler(name, case, mesh, **kw):
    """Sampler `name` at `case` (a ROWS key, or an EXTRA_CASES one at
    ROWS['uneven'] rows) on `mesh`; `kw` go to it (jitter=...)."""
    extra = dict(EXTRA_CASES.get((name, case), {}), **kw)
    if name == "efm":
        name, extra = "edm", dict(extra, model_kind="fm")
    return SAMPLERS[name](mesh, ROWS.get(case, ROWS["uneven"]), **extra)


def _samplers(family, mesh):
    """Every case of the samplers of `family` on `mesh` (a MeshConfig)."""
    return {key: run_sampler(*key, mesh) for key in sampler_cases(family)}


def _parity(mesh, inputs):
    """The samplers from reed_tpu's weights, inputs and draws (`inputs`:
    {name: its inputs}; 'efm' the EDM's fm decode, 'edm_cfg' the EDM with
    CFG, 'classifier' the property classifier's predictions)."""
    out = {}
    for name, case in inputs.items():
        if name == "classifier":
            out[name] = classifier_predict(mesh, case)
        elif name in ("efm", "edm_cfg"):
            out[name] = edm_sample(mesh, case["n"], inputs=case, cfg_scale=case["cfg_scale"],
                                   model_kind="fm" if name == "efm" else "diffusion")
        else:
            out[name] = SAMPLERS[name](mesh, case["n"], inputs=case)
    return out


def _job_eval(out, dp, family, meshes):
    """The samplers of `family` at every case of ROWS, the parity inputs
    from reed_tpu (tensor meshes), and the family's CLI cases with each
    mesh's flags; written per rank to out/eval_{family}_rank{r}.pt."""
    results = {}
    parity = out / f"eval_{family}_jax_inputs.pt"
    inputs = torch.load(parity, weights_only=False) if parity.exists() else None
    for name in meshes:
        mesh = mesh_config(name)
        results[name] = _samplers(family, mesh)
        if inputs is not None and mesh.tensor == 2:
            results[name, "jax"] = _parity(mesh, inputs)
        flags = ["--distributed", *MESH_FLAGS[name]]
        for (fam, case) in cli_cases(out):
            if fam in FAMILIES[family] or fam == family:
                results[name, "cli", fam, case] = run_cli(
                    out, fam, case, flags, f"{name}_rank{dp.process_rank}")
    torch.save(results, out / f"eval_{family}_rank{dp.process_rank}.pt")


JOBS = {f"eval_{family}{suffix}": (
    lambda out, dp, family=family, meshes=tuple(meshes): _job_eval(out, dp, family, meshes))
    for family in FAMILIES for suffix, meshes in (("", EVAL_MESHES), ("_4", EVAL_MESHES_4))}


def one_process(out, family, inputs=None):
    """What the ranks compute, in this process: the samplers, the parity
    samplers and the CLI cases."""
    results = {"samplers": _samplers(family, None)}
    if inputs is not None:
        results["jax"] = _parity(None, inputs)
    results["cli"] = {key: run_cli(out, *key, [], "one") for key in cli_cases(out)
                      if key[0] in FAMILIES[family] or key[0] == family}
    return results


def spawn_ranks(out, family):
    """The two-rank and the four-rank jobs of `family` under `out`: {world:
    each rank's results}."""
    import torch_dp

    ranks = {}
    for world, suffix in ((2, ""), (4, "_4")):
        torch_dp.spawn(out, f"eval_{family}{suffix}", world=world)
        ranks[world] = [torch.load(pathlib.Path(out) / f"eval_{family}_rank{r}.pt",
                                   weights_only=False) for r in range(world)]
    return ranks


# the CLI's JSON against one process's: floats within JSON_REL of max(1,
# |value|) (a split sum, or a batch of other rows, rounds in another
# order), everything else equal
JSON_REL = 1e-4


def assert_json_close(got, want, where=""):
    """`got` equals `want` but for floats, each within JSON_REL of max(1,
    |want|)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (where, got, want)
        for k in want:
            assert_json_close(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want), where
        for i, (a, b) in enumerate(zip(got, want)):
            assert_json_close(a, b, f"{where}[{i}]")
    elif isinstance(want, float):
        assert abs(got - want) <= JSON_REL * max(1.0, abs(want)), (where, got, want)
    else:
        assert got == want, (where, got, want)


def assert_only_rank_0_reports(ranks, key):
    """Rank 0 returned the JSON and printed it; every other rank returned
    None and printed nothing but the `distributed:` line."""
    assert ranks[0][key]["json"] is not None and "{" in ranks[0][key]["stdout"]
    for r in ranks[1:]:
        assert r[key]["json"] is None
        lines = r[key]["stdout"].splitlines()
        assert len(lines) == 1 and lines[0].startswith("distributed: "), lines


def _number(word):
    try:
        return float(word)
    except ValueError:
        return None


def assert_files_close(got, want):
    """The files `got` ({name: bytes}) are `want`'s: the same names, and in
    each the same words, but for numbers, each within JSON_REL of max(1,
    the file's largest |number|) (the sampled coordinates a split model
    writes differ from one process's by the sampler's rounding);
    renders (.png) by name alone."""
    assert sorted(got) == sorted(want)
    for name, data in want.items():
        if name.endswith(".png"):
            continue
        a, b = got[name].decode().split(), data.decode().split()
        assert len(a) == len(b), name
        numbers = [abs(v) for v in map(_number, b) if v is not None]
        tol = JSON_REL * max([1.0] + numbers)
        for x, y in zip(a, b):
            fx, fy = _number(x), _number(y)
            if fy is None:
                assert x == y, (name, x, y)
            else:
                assert fx is not None and abs(fx - fy) <= tol, (name, x, y)


def files_under(path):
    """{relative name: bytes} of the files under `path` ({} where it does
    not exist)."""
    path = pathlib.Path(path)
    if not path.exists():
        return {}
    return {str(p.relative_to(path)): p.read_bytes()
            for p in sorted(path.rglob("*")) if p.is_file()}


if __name__ == "__main__":
    raise SystemExit("run through tests/torch_dp.py (torch_dp.spawn)")
