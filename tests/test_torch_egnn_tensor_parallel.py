"""reed_tpu_torch's tensor mesh axis on the EGNN family (the EDM / EFM
dynamics of train-molecule-edm and the property classifier of
train-property) over gloo ranks on the CPU (tests/torch_dp.py: one spawn of
two ranks and one of four for the file), against one process and against
reed_tpu's steps on the same mesh.

A rank holds T-th shards of the Megatron pairs of
parallel/mesh.EGNN_TP_RULES: each GCL's edge and node MLPs, each
EquivariantUpdate's first two coordinate products (the first factored over
the rank's hidden columns) and each rep block's GEGLU feed-forward (its
proj in two groups, the same columns of both halves [a, g]); the second
products' f32 partials are summed once over the tensor group before their
biases; the rest is whole on every rank.

- The EDM case (hidden 32, 2 blocks, rep 16, rotation on) and the EFM case
  in f32 and bf16, and the property case (hidden 16, 2 layers) in f32, at
  tensor=2; the three in f32 at data=2 x tensor=2 and fsdp=2 x tensor=2 on
  four ranks; step by step from the same state (the second
  step against one process's from the checkpoint the ranks wrote after
  the first). f32: every metric within REL of the step's largest, every
  gradient within REL of its own largest magnitude, the parameters after
  the steps within REL of the largest parameter (2 lr where the gradient
  is at rounding level). bf16: the whole gradient, the metrics and the
  parameters within 2x one process's own bf16 distance from its f32 step
  from the same state. The tensor ranks' whole parameters bitwise equal.
- Checkpoints (EDM and property): one written at tensor=2 restores in one
  process bit for bit, and one written in one process restores at
  tensor=2 bit for bit; the resumed steps match the uninterrupted run.
- reed_tpu's MoleculeEDMTrainer and PropertyTrainer on MeshConfig(tensor=2)
  (the conftest's 8 CPU devices: data 4 absorbs the rest) from the same
  seeded-normal weights with reed_tpu's draws handed over: the port's
  steps at tensor=2 within tests/test_torch_edm_train.py's and
  tests/test_torch_property.py's bounds.
- train-molecule-edm (EDM and EFM) and train-property --distributed --tp 2,
  and train-molecule-edm --fsdp 2 --tp 2, through the CLI against one
  process; train-property --linear-probe at --tp 2 runs the probe whole on
  every tensor rank and matches one process.
- Without ranks: the leaves the port's rules split against those reed_tpu's
  EGNN_TP_RULES match (EDM and classifier); the GEGLU split over both
  halves against the whole feed-forward; the split and join of whole
  state_dicts; sizes that do not divide.
"""

import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.sharding import PartitionSpec as P

import torch_dp
from reed_tpu.core.config import MeshConfig as JaxMesh
from reed_tpu.core.config import OptimConfig as JaxOptim
from reed_tpu.core.trainer import combine_losses as jax_combine_losses
from reed_tpu.encoders.edm_convert import convert_torch_egnn_dynamics
from reed_tpu.parallel import mesh as jax_mesh
from reed_tpu.train import molecule_edm as jme
from reed_tpu.train import property as jprop
from reed_tpu_torch.core import checkpoint
from reed_tpu_torch.core.config import MeshConfig
from reed_tpu_torch.encoders import edm_convert, property_convert
from reed_tpu_torch.models.egnn import EGNNDynamics, RepCrossAttention
from reed_tpu_torch.models.property_classifier import PropertyClassifier
from reed_tpu_torch.parallel import mesh
from reed_tpu_torch.train import molecule_edm as me
from reed_tpu_torch.train import property as prop
from test_torch_edm_train import _batch, _key_with_drop
from test_torch_property import _inputs, _random_params

torch.set_num_threads(1)

# a tensor=2 f32 run against one process: each quantity within REL of that
# tensor's largest magnitude (the sums over the split hidden units run in
# another order: read up to 1.4e-6)
REL = 1e-5
# against reed_tpu: tests/test_torch_edm_train.py's and
# tests/test_torch_property.py's f32 bounds
METRIC_TOL = 1e-5
EDM_GRAD_TOL = 5e-4
PROPERTY_GRAD_RTOL = 1e-5
# a bf16 run: within BF16_FACTOR times one process's own bf16 distance from
# its f32 step from the same state
BF16_FACTOR = 2.0
LOSSES = ("denoising_loss", "loss")
F32 = [k for k in torch_dp.ETP_VARIANTS if k[1] == "float32"]
BF16 = [k for k in torch_dp.ETP_VARIANTS if k[1] == "bfloat16"]
FOUR_RANK = [(name, case) for name in torch_dp.ETP_MESHES_4 for case in torch_dp.ETP_CASES_4]


def _jax_edm_step():
    """reed_tpu's EDM step (ETP_EDM_PARITY) on MeshConfig(tensor=2) from
    seeded-normal weights (every leaf, from the port's side): the inputs
    the ranks take (weights, host batch, reed_tpu's draws: t, eps, the
    rotation and the rep-dropout mask) and its gradients, metrics, and
    parameters and EMA after it, by port name."""
    jcfg = jme.MoleculeEDMConfig(**torch_dp.ETP_EDM_PARITY, mesh=JaxMesh(tensor=2))
    jtrainer = jme.MoleculeEDMTrainer(jcfg)
    gen = torch.Generator().manual_seed(0)
    whole = me.build_dynamics(me.MoleculeEDMConfig(**torch_dp.ETP_EDM_PARITY))
    sd = {k: torch.randn(v.shape, generator=gen) * 0.1 for k, v in whole.state_dict().items()}
    params = convert_torch_egnn_dynamics({k: v.numpy() for k, v in sd.items()})
    jparams = jax.tree.map(jnp.asarray, params)
    batch = _batch(jcfg.rep_nf, batch=jcfg.batch_size)
    jbatch = jax.tree.map(jnp.asarray, batch)
    key, draws = _key_with_drop(jcfg, jbatch, jparams, jtrainer.model)
    loss_fn = jme.make_loss_fn(jtrainer.model, jcfg)
    grads = jax.jit(jax.grad(lambda p: jax_combine_losses(
        loss_fn(p, jbatch, jax.random.fold_in(key, 0), 0), 0, jcfg.curriculum)[0]))(jparams)
    state = jtrainer.init_state()
    state = state.replace(params=jparams, ema_params=jax.tree.map(jnp.copy, jparams),
                          opt_state=jtrainer.optimizer.init(jparams))
    with jtrainer.mesh:
        state, metrics = jtrainer.train_step(state, jbatch, key)
    to_port = lambda tree: edm_convert.state_dict_from_flax(jax.tree.map(np.array, tree))
    inputs = {"params": sd, "batch": batch, "draws": draws}
    return inputs, {"grads": to_port(grads), "params": to_port(state.params),
                    "ema": to_port(state.ema_params), "before": sd, "lr": jcfg.optim.lr,
                    "metrics": [{k: float(v) for k, v in metrics.items()}]}


def _jax_property_steps():
    """reed_tpu's two property steps (ETP_PROPERTY_PARITY, the two-step
    cosine) on MeshConfig(tensor=2) from seeded-normal weights: the inputs
    the ranks take, its first gradient, each step's metrics, and the
    parameters and EMA after them, by port name."""
    jtrainer = jprop.PropertyTrainer(jprop.PropertyTrainConfig(
        **torch_dp.ETP_PROPERTY_PARITY, optim=JaxOptim(**torch_dp.ETP_PROPERTY_OPTIM),
        mesh=JaxMesh(tensor=2)))
    inputs = _inputs(b=4)
    params = _random_params(jtrainer.model, inputs)
    jparams = jax.tree.map(jnp.asarray, params)
    jb = {k: jnp.asarray(v) for k, v in inputs.items()}
    mean, mad = torch_dp.ETP_PROPERTY_PARITY["mean"], torch_dp.ETP_PROPERTY_PARITY["mad"]

    def jloss(p):
        pred = jtrainer.model.apply({"params": p}, jb["one_hot"], jb["positions"],
                                    jb["node_mask"], jb["edge_mask"])
        return jnp.abs(pred - (jb["label"] - mean) / mad).mean()

    grads = jax.grad(jloss)(jparams)
    state = jtrainer.init_state()
    state = state.replace(params=jparams, ema_params=jax.tree.map(jnp.copy, jparams),
                          opt_state=jtrainer.optimizer.init(jparams))
    metrics = []
    with jtrainer.mesh:
        for i in range(2):
            state, m = jtrainer.train_step(state, jax.device_put(jb, jtrainer.batch_sharding),
                                           jax.random.PRNGKey(i))
            metrics.append({k: float(v) for k, v in m.items()})
    to_port = lambda tree: property_convert.state_dict_from_flax(jax.tree.map(np.array, tree))
    sd = to_port(params)
    return {"params": sd, "batch": inputs}, {
        "grads": to_port(grads), "params": to_port(state.params),
        "ema": to_port(state.ema_params), "before": sd,
        "lr": torch_dp.ETP_PROPERTY_OPTIM["lr"], "metrics": metrics}


def _one_process(out):
    """Each variant's two steps in one process, the EDM and property states
    at step 2 (saved under out/ckpt_one_{case}) and after 4 steps, and the
    CLI runs."""
    one = {}
    for key, fields in torch_dp.ETP_VARIANTS.items():
        with torch_dp.settings(fields=fields):
            one[key] = torch_dp.run_case(key[0])
    for case in ("edm", "property"):
        trainer, batches = torch_dp.CASES[case]()
        batches += torch_dp.more_batches(case, trainer)
        state = trainer.init_state()
        mgr = checkpoint.CheckpointManager(out / f"ckpt_one_{case}", save_interval_steps=2)
        for batch in batches[:2]:
            state, _ = trainer.train_step(state, batch)
        mgr.save(state, trainer.generator)
        one["saved", case] = torch_dp.state_tensors(state)
        for batch in batches[2:]:
            state, _ = trainer.train_step(state, batch)
        one["straight", case] = torch_dp.state_tensors(state)
        one["lr", case] = trainer.cfg.optim.lr
    for name, (cmd, args) in torch_dp.ETP_CLI.items():
        one["cli", name] = torch_dp.mesh_cli(out, cmd, args, [], f"etp_cli_{name}_one")
    one["cli", "probe"] = torch_dp.mesh_cli(out, "train-property", torch_dp.ETP_PROBE_CLI, [],
                                            "etp_cli_probe_one")
    return one


@pytest.fixture(scope="module")
def etp_run(tmp_path_factory):
    """The two-rank and four-rank results, the one-process references and
    reed_tpu's steps, computed before the ranks start."""
    out = tmp_path_factory.mktemp("egnn_tensor_parallel")
    edm_inputs_, edm_want = _jax_edm_step()
    prop_inputs, prop_want = _jax_property_steps()
    one = _one_process(out)
    torch.save({"edm": edm_inputs_, "property": prop_inputs}, out / "jax_egnn_inputs.pt")
    torch_dp.spawn(out, "egnn_tensor_parallel")
    torch_dp.spawn(out, "egnn_tensor_parallel_mesh", world=4)
    two = [torch.load(out / f"etp_rank{r}.pt", weights_only=False) for r in range(2)]
    four = [torch.load(out / f"etp_mesh_rank{r}.pt", weights_only=False) for r in range(4)]
    return out, two, four, one, {"edm": edm_want, "property": prop_want}


def _first(run):
    return {"metrics": [run["metrics"][0]], "grads": [run["grads"][0]]}


# --- against one process ----------------------------------------------------


@pytest.mark.parametrize("variant", F32, ids=[c for c, _ in F32])
def test_f32_step_at_tensor_2_matches_one_process(etp_run, variant):
    """Two f32 steps at tensor=2 (EDM, EFM, property), on every rank,
    against one process, step by step."""
    out, two, _, one, _ = etp_run
    cont = torch_dp.continued(out, torch_dp.first_ckpt("etp_first_", variant), variant[0],
                              torch_dp.ETP_VARIANTS[variant])
    for r in two:
        torch_dp.check_f32_run(r[variant], one[variant], cont, REL)


@pytest.mark.parametrize("variant", BF16, ids=[c for c, _ in BF16])
def test_bf16_step_at_tensor_2_is_as_close_as_one_process(etp_run, variant):
    """Two bf16 steps at tensor=2 (EDM, EFM) against one process's, step by
    step: each within 2x one process's bf16 distance from its f32 step from
    the same state; the parameters after them too."""
    out, two, _, one, _ = etp_run
    case = variant[0]
    ckpt = torch_dp.first_ckpt("etp_first_", variant)
    cont = torch_dp.continued(out, ckpt, case, torch_dp.ETP_VARIANTS[variant])
    cont32 = torch_dp.continued(out, ckpt, case, {})
    names = list(one[variant]["params"])
    for r in two:
        got = r[variant]
        assert all(g.dtype == torch.float32 for g in got["grads"][0])
        torch_dp.check_bf16_step(0, got, _first(one[variant]), _first(one[case, "float32"]),
                                 BF16_FACTOR, LOSSES)
        torch_dp.check_bf16_step(1, got, cont, cont32, BF16_FACTOR, LOSSES)
        p, w, w32 = (torch_dp.flat([d[n] for n in names])
                     for d in (got["params"], cont["params"], cont32["params"]))
        assert float((p - w).norm()) <= BF16_FACTOR * float((w - w32).norm())


@pytest.mark.parametrize("mesh_name,case", FOUR_RANK)
def test_step_on_four_ranks_matches_one_process(etp_run, mesh_name, case):
    """data=2 x tensor=2 and fsdp=2 x tensor=2 (EDM, EFM and property, f32),
    on every rank, against one process, step by step."""
    out, _, four, one, _ = etp_run
    cont = torch_dp.continued(out, torch_dp.first_ckpt("etp_first_", (mesh_name, case)),
                              case, {})
    want = one[case, "float32"]
    for r in four:
        torch_dp.check_f32_run(r[mesh_name, case], want, cont, REL)


def test_tensor_ranks_hold_the_same_whole_parameters(etp_run):
    """Joined over the tensor group, every rank's parameters after the steps
    are bitwise the same: the replicated leaves' gradients are averaged
    over the tensor group."""
    _, two, four, _, _ = etp_run
    for key in torch_dp.ETP_VARIANTS:
        a, b = two[0][key]["params"], two[1][key]["params"]
        assert all(torch.equal(a[k], b[k]) for k in a), key
    for key in FOUR_RANK:
        ref = four[0][key]["params"]
        for r in four[1:]:
            assert all(torch.equal(r[key]["params"][k], v) for k, v in ref.items()), key


def test_rank_layout(etp_run):
    """Two ranks at tensor=2: one batch index (both take the whole batch),
    tensor indices 0 and 1."""
    _, two, _, _, _ = etp_run
    assert [r["axes"] for r in two] == [(0, 0, 1, 0), (1, 0, 1, 1)]


@pytest.mark.parametrize("case", ["edm", "property"])
def test_checkpoint_written_at_tensor_2_resumes_in_one_process(etp_run, case):
    """The file rank 0 wrote holds the ranks' whole state (parameters
    joined over the tensor group); one process restores it bit for bit."""
    out, two, _, one, _ = etp_run
    saved = two[0]["resume", case]["saved"]
    assert all(torch.equal(saved[k], two[1]["resume", case]["saved"][k]) for k in saved)
    trainer, _ = torch_dp.CASES[case]()
    state = trainer.init_state()
    checkpoint.CheckpointManager(out / f"ckpt_etp_{case}", save_interval_steps=2).restore(
        state, trainer.generator)
    assert state.step == 2 and state.opt.count == 2
    restored = torch_dp.state_tensors(state)
    assert set(restored) == set(saved)
    assert all(torch.equal(restored[k], saved[k]) for k in saved)
    assert not torch_dp.within(saved, one["saved", case], one["lr", case], REL)


@pytest.mark.parametrize("case", ["edm", "property"])
def test_one_process_checkpoint_resumes_at_tensor_2(etp_run, case):
    """Each rank restores the one-process checkpoint into its shards: joined
    back, the state is the one saved, bit for bit, and 2 more steps match
    the uninterrupted one-process run."""
    _, two, _, one, _ = etp_run
    for r in two:
        res = r["resume", case]
        assert res["step"] == 4
        assert all(torch.equal(res["restored"][k], one["saved", case][k])
                   for k in one["saved", case])
        assert not torch_dp.within(res["resumed"], one["straight", case], one["lr", case], REL)


@pytest.mark.parametrize("name", ["edm", "efm", "property", "edm_fsdp_tp"])
def test_cli_on_the_mesh_matches_one_process(etp_run, name):
    """train-molecule-edm (EDM and EFM) and train-property --distributed
    --tp 2 on two ranks, and train-molecule-edm --fsdp 2 --tp 2 on four (two
    steps, a checkpoint at step 2) against the same command in one
    process: every rank's whole state, and the files."""
    out, two, four, one, _ = etp_run
    base = name.split("_")[0]
    step, want = one["cli", base]
    runs = ([r["cli", name] for r in two] if name != "edm_fsdp_tp"
            else [r["cli"] for r in four])
    tag = f"etp_cli_{name}_tp" if name != "edm_fsdp_tp" else "etp_cli_fsdp_tp"
    assert sorted(p.name for p in (out / tag).iterdir()) == sorted(
        p.name for p in (out / f"etp_cli_{base}_one").iterdir())
    lr = one["lr", "property" if base == "property" else "edm"]
    for got_step, got in runs:
        assert got_step == step == 2
        assert set(got) == set(want)
        assert not torch_dp.within(got, want, lr, REL)
        assert all(torch.equal(got[k], runs[0][1][k]) for k in got if k.startswith("param/"))


def test_linear_probe_refuses_the_tensor_axis(etp_run):
    """train-property --linear-probe (a frozen encoder's Linear(rep_dim, 1):
    nothing to split) no longer refuses the tensor axis: at --tp 2 it runs
    whole on every tensor rank, as reed_tpu does, and each rank's whole
    state after two steps (a checkpoint at step 2), and the files, match
    the same command in one process, the ranks' parameters bitwise equal;
    its trainer asked for tensor=2 in one process raises with the torchrun
    line."""
    out, two, _, one, _ = etp_run
    step, want = one["cli", "probe"]
    assert sorted(p.name for p in (out / "etp_cli_probe_tp").iterdir()) == sorted(
        p.name for p in (out / "etp_cli_probe_one").iterdir())
    runs = [r["probe"] for r in two]
    for got_step, got in runs:
        assert got_step == step == 2
        assert set(got) == set(want)
        assert not torch_dp.within(got, want, prop.LinearProbeConfig().optim.lr, REL)
        assert all(torch.equal(got[k], runs[0][1][k]) for k in got if k.startswith("param/"))
    with pytest.raises(ValueError, match="tensor=2 does not divide the 1 process.*torchrun"):
        prop.LinearProbeTrainer(prop.LinearProbeConfig(rep_dim=12,
                                                       mesh=MeshConfig(tensor=2)),
                                device="cpu")


# --- against reed_tpu on the same mesh --------------------------------------


def _check_parity(got, want, grad_tol, moved_at):
    """The port's steps at tensor=2 against reed_tpu's: each step's metrics
    to 1e-5; every first-step gradient within grad_tol of its largest; the
    parameters after the steps to 2e-6 where reed_tpu's updates moved them
    by more than moved_at x lr, to 2 lr elsewhere; the EMA to 1e-6."""
    for gm, wm in zip(got["metrics"], want["metrics"]):
        for k, v in wm.items():
            if k in gm:
                np.testing.assert_allclose(gm[k], v, rtol=METRIC_TOL, atol=METRIC_TOL,
                                           err_msg=k)
    assert {"denoising_loss", "loss", "grad_norm"} <= set(got["metrics"][0])
    assert set(got["grads"]) == set(want["grads"])
    for n, g in got["grads"].items():
        err = float((g - want["grads"][n]).abs().max())
        assert err <= grad_tol * float(want["grads"][n].abs().max()), n
    lr = want["lr"]
    for n, p in got["params"].items():
        moved = (want["params"][n] - want["before"][n]).abs() > moved_at * lr
        diff = (p - want["params"][n]).abs()
        if moved.any():
            assert diff[moved].max().item() <= 2e-6, n
        assert diff.max().item() <= 2 * lr, n
        np.testing.assert_allclose(got["ema"][n].numpy(), want["ema"][n].numpy(), rtol=0,
                                   atol=1e-6, err_msg=n)


def test_edm_step_matches_reed_tpu_on_the_same_mesh(etp_run):
    """tests/test_torch_edm_train.py's bounds: metrics to 1e-5, gradients to
    5e-4 of their max, the parameters to 2e-6 where moved by more than 0.99
    lr, the EMA to 1e-6."""
    _, two, _, _, want = etp_run
    for r in two:
        _check_parity(r["jax", "edm"], want["edm"], EDM_GRAD_TOL, 0.99)


def test_property_steps_match_reed_tpu_on_the_same_mesh(etp_run):
    """tests/test_torch_property.py's bounds over two steps: metrics to
    1e-5, gradients to 1e-5 of their max, the parameters to 2e-6 where moved
    by more than 0.5 lr, the EMA to 1e-6."""
    _, two, _, _, want = etp_run
    for r in two:
        _check_parity(r["jax", "property"], want["property"], PROPERTY_GRAD_RTOL, 0.5)


# --- without ranks -----------------------------------------------------------


def _flags(flax_params, flag_of, convert):
    """{port name: whether flag_of(flax path) holds} through a converter (a
    leaf filled with 1.0 or 0.0)."""
    marked = jax.tree_util.tree_map_with_path(
        lambda path, leaf: np.full(np.shape(leaf), float(flag_of(
            "/".join(str(k.key) for k in path))), np.float32), flax_params)
    return {k: bool(np.asarray(v).reshape(-1)[0]) for k, v in convert(marked).items()}


def _rule_of(path):
    for pattern, spec in jax_mesh.EGNN_TP_RULES:
        if re.search(pattern, path):
            return spec
    return None


@pytest.mark.parametrize("family", ["edm", "property"])
def test_tensor_rules_against_reed_tpus_egnn_rules(family):
    """The weights the port's EGNN_TP_RULES split are exactly those whose
    flax kernels reed_tpu's EGNN_TP_RULES match, on the dimension its spec
    names (column rules on the torch weight's dimension 0, row rules on 1;
    the GEGLU's proj in its two halves); beyond them only the
    column-parallel products' biases, which split with their columns."""
    if family == "edm":
        cfg = me.MoleculeEDMConfig(**torch_dp.ETP_EDM_PARITY)
        sd = me.build_dynamics(cfg).state_dict()
        params = convert_torch_egnn_dynamics({k: v.numpy() for k, v in sd.items()})
        convert = edm_convert.state_dict_from_flax
        # per block: 2 GCLs' edge and node pairs, the coordinate pair; per
        # rep block: the feed-forward pair
        n_pairs = cfg.n_layers * (2 * cfg.inv_sublayers + 1) + cfg.n_layers
    else:
        model = prop.build_model(prop.PropertyTrainConfig(**{
            k: v for k, v in torch_dp.ETP_PROPERTY_PARITY.items() if k in (
                "hidden_nf", "n_layers", "max_nodes", "num_atom_types")}))
        params = property_convert.flax_from_state_dict(model.state_dict())
        convert = property_convert.state_dict_from_flax
        n_pairs = 2 * torch_dp.ETP_PROPERTY_PARITY["n_layers"]
    matched = _flags(params, lambda path: _rule_of(path) is not None, convert)
    column = _flags(params, lambda path: _rule_of(path) == P(None, jax_mesh.TENSOR_AXIS),
                    convert)
    port = {n: mesh.tensor_rule(n, mesh.EGNN_TP_RULES) for n in matched}
    for name, hit in matched.items():
        if name.endswith(".weight"):
            assert (port[name] is not None) == hit, name
            if hit:
                groups = 2 if name.endswith("ff.net.0.proj.weight") else 1
                assert port[name] == (0 if column[name] else 1, groups), name
    assert sum(hit for n, hit in matched.items() if n.endswith(".weight")) == 2 * n_pairs
    biases = {n: rule for n, rule in port.items() if rule is not None and n.endswith(".bias")}
    assert len(biases) == n_pairs
    for n, rule in biases.items():
        assert port[n[:-len("bias")] + "weight"] == rule and rule[0] == 0, n


def test_geglu_split_over_both_halves_is_the_whole_feed_forward():
    """A rep block's GEGLU feed-forward ff(x) = W2 (a * gelu(g)) + b2 with
    [a, g] = W1 x + b1: the tensor ranks' shards (rank t: the same columns
    c_t of both halves of W1 and b1, W2's matching rows) give partials whose
    sum plus b2 is the whole; a contiguous split of W1's rows (half a and
    half g on different ranks) is not."""
    torch.manual_seed(0)
    whole = RepCrossAttention(32, 16)
    with torch.no_grad():
        for p in whole.parameters():
            p.normal_(0, 0.3)
    x = torch.randn(3, 5, 32)
    want = whole.ff(x)
    pre = "egnn.attns.0.0."   # the block's place in EGNNDynamics
    sd = {pre + k: v for k, v in whole.state_dict().items()}
    parts, wrong = [], []
    for t in range(2):
        parallel = types.SimpleNamespace(tensor=2, tensor_index=t)
        shard = mesh.shard_state_dict(sd, parallel, mesh.EGNN_TP_RULES)
        w1, b1 = shard[pre + "ff.net.0.proj.weight"], shard[pre + "ff.net.0.proj.bias"]
        w2 = shard[pre + "ff.net.2.weight"]
        assert w1.shape == (128, 32) and w2.shape == (32, 64)
        a, g = F.linear(x, w1, b1).chunk(2, dim=-1)
        parts.append(F.linear(a * F.gelu(g), w2))
        rows = slice(128 * t, 128 * (t + 1))
        a, g = F.linear(x, sd[pre + "ff.net.0.proj.weight"][rows],
                        sd[pre + "ff.net.0.proj.bias"][rows]).chunk(2, dim=-1)
        wrong.append(F.linear(a * F.gelu(g), w2))
    got = sum(parts) + sd[pre + "ff.net.2.bias"]
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    bad = sum(wrong) + sd[pre + "ff.net.2.bias"]
    assert float((bad - want).abs().max()) > 1e-2 * float(want.abs().max())


def test_whole_state_dict_splits_and_joins():
    """shard_state_dict with EGNN_TP_RULES gives each tensor rank a
    state_dict of its model's shapes (the sharded EDM dynamics and property
    classifier load it strictly); tensor_join of every rank's shards gives
    the whole one back, bit for bit."""
    cfg = me.MoleculeEDMConfig(**torch_dp.ETP_EDM_PARITY)
    pcfg = prop.PropertyTrainConfig(hidden_nf=16, n_layers=2, max_nodes=8, num_atom_types=4)
    wholes = [me.build_dynamics(cfg, generator=torch.Generator().manual_seed(0)),
              prop.build_model(pcfg, generator=torch.Generator().manual_seed(0))]
    for whole in wholes:
        sd = whole.state_dict()
        shards = []
        for t in range(2):
            parallel = types.SimpleNamespace(tensor=2, tensor_index=t)
            model = (me.build_dynamics(cfg, parallel=parallel) if isinstance(whole, EGNNDynamics)
                     else prop.build_model(pcfg, parallel=parallel))
            shards.append(mesh.shard_state_dict(sd, parallel, mesh.EGNN_TP_RULES))
            model.load_state_dict(shards[-1])
        rules = [mesh.tensor_rule(n, mesh.EGNN_TP_RULES) for n in sd]
        joined = {n: v if rule is None else mesh.tensor_join([s[n] for s in shards], rule)
                  for (n, v), rule in zip(sd.items(), rules)}
        assert all(torch.equal(joined[n], v) for n, v in sd.items())
    # the GEGLU's proj: rank 1 holds rows 64:128 of half a and of half g
    sd = wholes[0].state_dict()
    proj = "egnn.attns.0.0.ff.net.0.proj.weight"
    shard = mesh.shard_state_dict(sd, types.SimpleNamespace(tensor=2, tensor_index=1),
                                  mesh.EGNN_TP_RULES)
    assert torch.equal(shard[proj], torch.cat([sd[proj][64:128], sd[proj][192:]]))


def test_sizes_that_do_not_divide_raise():
    """A tensor size that does not divide the hidden width raises ValueError
    naming the MLP."""
    parallel = types.SimpleNamespace(tensor=3, tensor_index=0)
    with pytest.raises(ValueError, match="tensor=3 does not divide the edge MLP's 32 units"):
        EGNNDynamics(in_node_nf=6, hidden_nf=32, n_layers=1, parallel=parallel)
    with pytest.raises(ValueError, match="tensor=3 does not divide the edge MLP's 16 units"):
        PropertyClassifier(4, hidden_nf=16, n_layers=1, parallel=parallel)
