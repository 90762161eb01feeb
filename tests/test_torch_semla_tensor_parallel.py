"""reed_tpu_torch's tensor mesh axis on SemlaFlow (arch semla) over gloo
ranks on the CPU (tests/torch_dp.py: one spawn of two ranks and one of four
for the file), against one process and against reed_tpu's step on the same
mesh.

A rank holds T-th shards of the four Megatron pairs of
parallel/mesh.SEMLA_TP_RULES: the edge-message MLPs (each layer's and
BondRefine's, the first product factored over the rank's hidden columns,
f32 partial messages summed once over the tensor group), the node
attention by heads, the invariant node feed-forwards and the input feature
projection; the coordinate paths, the rep conditioning, the norms, the
edge projections and the heads are whole on every rank.

- The semla case (d_model 32, 3 layers, 4 heads, 4 coordinate sets,
  message hidden 16, edge 8, batch 4 x 8 atoms, cross-attention rep
  conditioning and
  a REPA projector after layer 1) at tensor=2, in f32 and in mixed bf16,
  with the self-conditioning pass taken on both steps and on neither; and
  in f32 at data=2 x tensor=2 and fsdp=2 x tensor=2 on four ranks; step by
  step from the same state (the second step against one process's from
  the checkpoint the ranks wrote after the first). f32: the whole gradient
  within 2x one process's own f32 distance from the same step computed in
  f64, each gradient tensor within GRAD_TOP of the step's largest, every
  metric within REL of the largest, the parameters after the steps within
  REL of the largest parameter (2 lr where the gradient is at rounding
  level). bf16: the whole gradient, the metrics and the
  parameters within 2x one process's own bf16 distance from its f32 step
  from the same state. The tensor ranks' whole parameters bitwise equal.
- Checkpoints: one written at tensor=2 restores in one process bit for
  bit, and one written in one process restores at tensor=2 bit for bit;
  the resumed steps match the uninterrupted run.
- reed_tpu's SemlaTrainer on MeshConfig(tensor=2) (the conftest's 8 CPU
  devices: data 4 absorbs the rest) from the same seeded-normal weights
  (zero-init layers included), batch and self-conditioning coin: the
  port's step at tensor=2 within tests/test_torch_semla_train.py's bounds.
- train-molecule-semla --distributed --tp 2 and --dp 2 --tp 2 through the
  CLI against one process; arch egnn and eqgat at --tp 2 raise
  NotImplementedError naming ROADMAP.md's item.
- Without ranks: the leaves the port's rules split against those reed_tpu's
  SEMLA_TP_RULES match; the split and join of whole state_dicts; sizes that
  do not divide; what a rank holds at the recipe's width.
"""

import copy
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_dp
from reed_tpu.core.config import CurriculumConfig as JaxCurriculum
from reed_tpu.core.config import MeshConfig as JaxMesh
from reed_tpu.core.trainer import combine_losses as jax_combine_losses
from reed_tpu.diffusion.molecule_fm import IntegratorConfig as JaxIntegrator
from reed_tpu.diffusion.molecule_fm import MoleculeInterpolantConfig as JaxInterp
from reed_tpu.diffusion.molecule_fm import MoleculePriorConfig as JaxPrior
from reed_tpu.parallel import mesh as jax_mesh
from reed_tpu.train.molecule_semla import SemlaTrainConfig as JaxConfig
from reed_tpu.train.molecule_semla import SemlaTrainer as JaxTrainer
from reed_tpu.train.molecule_semla import make_loss_fn as jax_make_loss_fn
from reed_tpu_torch.core import checkpoint
from reed_tpu_torch.core.config import MeshConfig
from reed_tpu_torch.core.trainer import capture_gradients, combine_losses
from reed_tpu_torch.encoders.semla_convert import state_dict_from_flax
from reed_tpu_torch.models.semla import SemlaGenerator
from reed_tpu_torch.parallel import mesh
from reed_tpu_torch.train import molecule_semla as ms
from test_torch_semla_train import _grad_scale, _key_with_coin, _params

torch.set_num_threads(1)

# a tensor=2 f32 run against one process. The sums over the split hidden
# units and heads run in another order, and this model's f32 gradients
# carry such noise far: one process's own f32 gradient sits up to 1.7e-4 of
# the step's largest from the same step with the model and batch promoted
# to f64, the tensor=2 step up to 2.2e-4, so the two are up to 3.9e-4 apart
# (self-conditioning on, the second step). Held: the whole gradient within
# F64_FACTOR x one process's f32 distance from the f64 step (L2; 1.5x
# read), each gradient tensor within GRAD_TOP of the step's largest, each
# metric within REL of the largest (4.0e-5 read) and the parameters within
# REL of the largest parameter.
F64_FACTOR = 2.0
GRAD_TOP = 1e-3
REL = 1e-4
# against reed_tpu (tests/test_torch_semla_train.py's f32 bounds)
METRIC_TOL = 1e-5
GRAD_TOL = 5e-4
# a bf16 run: within BF16_FACTOR times one process's own bf16 distance from
# its f32 step from the same state
BF16_FACTOR = 2.0
F32 = [k for k in torch_dp.STP_VARIANTS if k[0] == "float32"]
BF16 = [k for k in torch_dp.STP_VARIANTS if k[0] == "bfloat16"]
FOUR_RANK = tuple(torch_dp.STP_MESHES_4)


def _jax_config(**mesh):
    """reed_tpu's SemlaTrainConfig of STP_PARITY on MeshConfig(**mesh)."""
    return JaxConfig(**torch_dp.STP_PARITY,
                     integrator=JaxIntegrator(cat_noise_level=1.0,
                                              bond_mask_index=torch_dp.STP_BOND_MASK_INDEX),
                     interpolant=JaxInterp(prior=JaxPrior(vocab_size=6), coord_noise_std=0.2),
                     mesh=JaxMesh(**mesh),
                     curriculum=JaxCurriculum(proj_coeff=0.2, diffusion_warmup_steps=0))


def _jax_step():
    """reed_tpu's semla step (STP_PARITY, the coin taken) on
    MeshConfig(tensor=2) from seeded-normal weights: the inputs the ranks
    take (weights in the port's layout, the host batch, the coin) and its
    gradients, metrics, and parameters and EMA after it, by port name."""
    jcfg = _jax_config(tensor=2)
    jtrainer = JaxTrainer(jcfg)
    params = _params(jtrainer, jcfg)
    jparams = jax.tree.map(jnp.asarray, params)
    batch = ms.example_batch(torch_dp.semla_parity_config(), 4, max_n=10, seed=1)
    jbatch = jax.tree.map(jnp.asarray, batch)
    key = _key_with_coin(True)
    curriculum = JaxCurriculum(**{**jcfg.curriculum.__dict__,
                                  "proj_coeff": jcfg.repa_loss_weight})
    loss_fn = jax_make_loss_fn(jtrainer.model, jcfg)
    grads = jax.jit(jax.grad(lambda p: jax_combine_losses(
        loss_fn(p, jbatch, jax.random.fold_in(key, 0), 0), 0, curriculum)[0]))(jparams)
    state = jtrainer.init_state()
    state = state.replace(params=jparams, ema_params=jax.tree.map(jnp.copy, jparams),
                          opt_state=jtrainer.optimizer.init(jparams))
    with jtrainer.mesh:
        state, metrics = jtrainer.train_step(state, jbatch, key)
    to_port = lambda tree: state_dict_from_flax(jax.tree.map(np.array, tree))
    inputs = {"params": to_port(params), "batch": batch, "use_sc": True}
    return inputs, {"grads": to_port(grads), "params": to_port(state.params),
                    "ema": to_port(state.ema_params), "lr": jcfg.optim.lr,
                    "before": inputs["params"],
                    "metrics": {k: float(v) for k, v in metrics.items()}}


def _one_process(out):
    """The semla case in one process: each variant's two steps, the state at
    step 2 (saved under out/ckpt_one_semla) and after 4 steps, and
    train-molecule-semla through the CLI."""
    one = {}
    for (dtype, sc), fields in torch_dp.STP_VARIANTS.items():
        with torch_dp.settings(fields=fields):
            one[dtype, sc] = torch_dp.run_case("semla", use_sc=sc)
    with torch_dp.settings(fields=torch_dp.STP_FIELDS):
        trainer, batches = torch_dp._semla()
    batches += torch_dp.more_batches("semla", trainer)
    state = trainer.init_state()
    mgr = checkpoint.CheckpointManager(out / "ckpt_one_semla", save_interval_steps=2)
    for batch in batches[:2]:
        state, _ = trainer.train_step(state, batch)
    mgr.save(state, trainer.generator)
    one["saved"] = torch_dp.state_tensors(state)
    for batch in batches[2:]:
        state, _ = trainer.train_step(state, batch)
    one["straight"] = torch_dp.state_tensors(state)
    one["lr"] = trainer.cfg.optim.lr
    one["cli"] = torch_dp.mesh_cli(out, "train-molecule-semla", torch_dp.STP_CLI, [],
                                   "stp_cli_one")
    return one


@pytest.fixture(scope="module")
def stp_run(tmp_path_factory):
    """The two-rank and four-rank results, the one-process references and
    reed_tpu's step, computed before the ranks start."""
    out = tmp_path_factory.mktemp("semla_tensor_parallel")
    inputs, jax_want = _jax_step()
    one = _one_process(out)
    torch.save(inputs, out / "jax_semla_inputs.pt")
    torch_dp.spawn(out, "semla_tensor_parallel")
    torch_dp.spawn(out, "semla_tensor_parallel_mesh", world=4)
    two = [torch.load(out / f"stp_rank{r}.pt", weights_only=False) for r in range(2)]
    four = [torch.load(out / f"stp_mesh_rank{r}.pt", weights_only=False) for r in range(4)]
    return out, two, four, one, jax_want


def _promoted(x):
    """A device batch with its float tensors in f64."""
    if isinstance(x, dict):
        return {k: _promoted(v) for k, v in x.items()}
    return x.double() if x.is_floating_point() else x


def _grads64(trainer, state, batch, step, use_sc):
    """One process's gradient of the step at `state` on `batch` with the
    model and the batch promoted to f64 (its LayerNorms keep their f32
    statistics), in parameter order: the reference the f32 noise is
    measured against."""
    model = copy.deepcopy(state.model).double()
    for m in model.modules():
        if hasattr(m, "compute_dtype"):
            m.compute_dtype = torch.float64
    metrics = ms.make_loss_fn(trainer.cfg)(model, _promoted(batch), step, use_sc=use_sc)
    total, _ = combine_losses(metrics, step, trainer.curriculum)
    leaves = list(model.parameters())
    grads = torch.autograd.grad(total, leaves, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g for g, p in zip(grads, leaves)]


def _start64(fields, use_sc):
    """_grads64 of one process's first step of the semla case."""
    with torch_dp.settings(fields=fields):
        trainer, batches = torch_dp._semla()
    return _grads64(trainer, trainer.init_state(), batches[0], 0, use_sc)


def _continued(out, key, fields, use_sc):
    """One process's second step from the checkpoint the mesh run `key`
    wrote after its first step (the whole state and the trainer's
    generator), with `fields` (its compute dtype): its metrics, gradients
    (parameter order), whole parameters after it and, in f32, the step's
    _grads64."""
    with torch_dp.settings(fields=fields):
        trainer, batches = torch_dp._semla()
    state = trainer.init_state()
    checkpoint.CheckpointManager(out / torch_dp.first_ckpt("stp_first_", key)).restore(
        state, trainer.generator)
    assert state.step == 1
    g64 = (_grads64(trainer, state, batches[1], 1, use_sc)
           if trainer.cfg.compute_dtype == "float32" else None)
    with capture_gradients() as grads:
        state, metrics = trainer.train_step(state, batches[1], use_sc=use_sc)
    return {"metrics": [{k: float(v) for k, v in metrics.items()}], "grads": grads,
            "params": torch_dp.whole_params(state), "grads64": g64}


def _norm(tensors):
    return sum(float(t.double().norm()) ** 2 for t in tensors) ** 0.5


def _check_step(step, got_metrics, got_grads, want_metrics, want_grads, want64, names):
    """One f32 step against one process's from the same state: metrics
    within REL of the largest, each gradient within GRAD_TOP of the step's
    largest, the whole gradient within F64_FACTOR x one process's distance
    from the f64 step `want64`."""
    assert set(got_metrics) == set(want_metrics)
    top = max(abs(v) for v in want_metrics.values())
    bad = {k: (got_metrics[k], v) for k, v in want_metrics.items()
           if abs(got_metrics[k] - v) > REL * top}
    assert not bad, (step, bad)
    assert len(got_grads) == len(want_grads) == len(names)
    top = max(float(g.abs().max()) for g in want_grads)
    for n, a, b in zip(names, got_grads, want_grads):
        assert a.shape == b.shape, n
        assert float((a - b).abs().max()) <= GRAD_TOP * top, (step, n)
    noise = _norm([b.double() - w for b, w in zip(want_grads, want64)])
    assert _norm([a.double() - w for a, w in zip(got_grads, want64)]) <= F64_FACTOR * noise, step


def _check_params(got, cont, lr):
    """The whole parameters after the second step against one process's
    continued step: within REL of the largest parameter, 2 lr where the
    step's gradient is at rounding level (below 1e-6 of its largest)."""
    names = list(cont["params"])
    grads = cont["grads"][0]
    top_grad = max(float(g.abs().max()) for g in grads)
    top = max(float(w.abs().max()) for w in cont["params"].values())
    for n, g in zip(names, grads):
        diff = (got[n] - cont["params"][n]).abs()
        bound = torch.where(g.abs() < 1e-6 * top_grad, 2 * lr, REL * top)
        assert bool((diff <= bound).all()), (n, float(diff.max()))


def _check_f32_run(got, want, start64, cont):
    """Two f32 steps, step by step, and the parameters after them."""
    names = list(want["params"])
    _check_step(0, got["metrics"][0], got["grads"][0], want["metrics"][0], want["grads"][0],
                start64, names)
    _check_step(1, got["metrics"][1], got["grads"][1], cont["metrics"][0], cont["grads"][0],
                cont["grads64"], names)
    _check_params(got["params"], cont, want["lr"])


def _keep(names):
    """The gradients a bf16 distance is taken over: all but the
    shift-invariant logit biases (tests/test_torch_semla_train.py)."""
    return [i for i, n in enumerate(names) if not n.endswith("message_ff.message_mlp.2.bias")]


def _flat(grads, keep):
    return torch.cat([grads[i].flatten().double() for i in keep])


def _check_bf16_step(step, got, want, want32, names):
    """One bf16 step against one process's bf16 step (`want`) from the same
    state: the whole gradient (L2) and each loss within BF16_FACTOR x its
    distance from one process's f32 step (`want32`)."""
    keep = _keep(names)
    g, w, w32 = (_flat(x["grads"][step if x is got else 0], keep)
                 for x in (got, want, want32))
    assert float((g - w).norm()) <= BF16_FACTOR * float((w - w32).norm()), step
    gm, wm, wm32 = got["metrics"][step], want["metrics"][0], want32["metrics"][0]
    for k in ("coord_loss", "type_loss", "bond_loss", "charge_loss", "proj_loss", "loss"):
        assert abs(gm[k] - wm[k]) <= BF16_FACTOR * abs(wm[k] - wm32[k]) + 1e-6, (step, k)


def _first(run, step=0):
    """Step `step` of a run_case result as a one-step result."""
    return {"metrics": [run["metrics"][step]], "grads": [run["grads"][step]]}


# --- against one process ----------------------------------------------------


@pytest.mark.parametrize("variant", F32, ids=[f"sc{sc}" for _, sc in F32])
def test_f32_step_at_tensor_2_matches_one_process(stp_run, variant):
    """Two f32 semla steps at tensor=2, on every rank, against one process,
    step by step."""
    out, two, _, one, _ = stp_run
    fields, sc = torch_dp.STP_VARIANTS[variant], variant[1]
    start64 = _start64(fields, sc)
    cont = _continued(out, variant, fields, sc)
    for r in two:
        _check_f32_run(r[variant], one[variant], start64, cont)


@pytest.mark.parametrize("variant", BF16, ids=[f"sc{sc}" for _, sc in BF16])
def test_bf16_step_at_tensor_2_is_as_close_as_one_process(stp_run, variant):
    """Two mixed-bf16 steps at tensor=2 against one process's, step by step:
    each within 2x one process's bf16 distance from its f32 step from the
    same state; the parameters after them too."""
    out, two, _, one, _ = stp_run
    dtype, sc = variant
    f32 = dict(torch_dp.STP_VARIANTS[variant], compute_dtype="float32")
    names = list(one[variant]["params"])
    cont = _continued(out, variant, torch_dp.STP_VARIANTS[variant], sc)
    cont32 = _continued(out, variant, f32, sc)
    for r in two:
        got = r[variant]
        assert all(g.dtype == torch.float32 for g in got["grads"][0])
        _check_bf16_step(0, got, _first(one[variant]), _first(one["float32", sc]), names)
        _check_bf16_step(1, got, cont, cont32, names)
        p, w, w32 = (torch.cat([d[n].flatten().double() for n in names])
                     for d in (got["params"], cont["params"], cont32["params"]))
        assert float((p - w).norm()) <= BF16_FACTOR * float((w - w32).norm())


@pytest.mark.parametrize("mesh_name", FOUR_RANK)
def test_step_on_four_ranks_matches_one_process(stp_run, mesh_name):
    """data=2 x tensor=2 and fsdp=2 x tensor=2 (f32, self-conditioning on),
    on every rank, against one process, step by step."""
    out, _, four, one, _ = stp_run
    start64 = _start64(torch_dp.STP_FIELDS, True)
    cont = _continued(out, mesh_name, torch_dp.STP_FIELDS, True)
    for r in four:
        _check_f32_run(r[mesh_name], one["float32", True], start64, cont)


def test_tensor_ranks_hold_the_same_whole_parameters(stp_run):
    """Joined over the tensor group, every rank's parameters after the steps
    are bitwise the same: the replicated leaves' gradients are averaged
    over the tensor group."""
    _, two, four, _, _ = stp_run
    for key in torch_dp.STP_VARIANTS:
        a, b = two[0][key]["params"], two[1][key]["params"]
        assert all(torch.equal(a[k], b[k]) for k in a), key
    for name in FOUR_RANK:
        ref = four[0][name]["params"]
        for r in four[1:]:
            assert all(torch.equal(r[name]["params"][k], v) for k, v in ref.items()), name


def test_rank_layout(stp_run):
    """Two ranks at tensor=2: one batch index (both take the whole batch),
    tensor indices 0 and 1."""
    _, two, _, _, _ = stp_run
    assert [r["axes"] for r in two] == [(0, 0, 1, 0), (1, 0, 1, 1)]


def _within(a, b, lr):
    """State tensors a against b: the entries off by more than REL of the
    largest of b (4 lr for a parameter, whose elements Adam's first
    updates move by up to lr whatever their gradient's digits)."""
    top = max(float(v.abs().max()) for v in b.values())
    return {k: float((a[k] - w).abs().max()) for k, w in b.items()
            if float((a[k] - w).abs().max()) > max(REL * top, 4 * lr if
                                                    k.startswith("param/") else 0.0)}


def test_checkpoint_written_at_tensor_2_resumes_in_one_process(stp_run):
    """The file rank 0 wrote holds the ranks' whole state (parameters
    joined over the tensor group); one process restores it bit for bit."""
    out, two, _, one, _ = stp_run
    saved = two[0]["resume"]["saved"]
    assert all(torch.equal(saved[k], two[1]["resume"]["saved"][k]) for k in saved)
    with torch_dp.settings(fields=torch_dp.STP_FIELDS):
        trainer, _ = torch_dp._semla()
    state = trainer.init_state()
    checkpoint.CheckpointManager(out / "ckpt_stp", save_interval_steps=2).restore(
        state, trainer.generator)
    assert state.step == 2 and state.opt.count == 2
    restored = torch_dp.state_tensors(state)
    assert set(restored) == set(saved)
    assert all(torch.equal(restored[k], saved[k]) for k in saved)
    assert not _within(saved, one["saved"], one["lr"])


def test_one_process_checkpoint_resumes_at_tensor_2(stp_run):
    """Each rank restores the one-process checkpoint into its shards: joined
    back, the state is the one saved, bit for bit, and 2 more steps match
    the uninterrupted one-process run."""
    _, two, _, one, _ = stp_run
    for r in two:
        res = r["resume"]
        assert res["step"] == 4
        assert all(torch.equal(res["restored"][k], one["saved"][k]) for k in one["saved"])
        assert not _within(res["resumed"], one["straight"], one["lr"])


@pytest.mark.parametrize("ranks", ["tp2", "dp2_tp2"])
def test_cli_train_molecule_semla_on_the_mesh_matches_one_process(stp_run, ranks):
    """train-molecule-semla --distributed --tp 2 (two ranks) and --dp 2 --tp
    2 (four), two steps and a checkpoint at step 2, against the same command
    in one process."""
    out, two, four, one, _ = stp_run
    step, want = one["cli"]
    runs = [r["cli"] for r in (two if ranks == "tp2" else four)]
    tag = "stp_cli_tp" if ranks == "tp2" else "stp_cli_dp_tp"
    assert sorted(p.name for p in (out / tag).iterdir()) == sorted(
        p.name for p in (out / "stp_cli_one").iterdir())
    for got_step, got in runs:
        assert got_step == step == 2
        assert set(got) == set(want)
        assert not _within(got, want, one["lr"])
        assert all(torch.equal(got[k], runs[0][1][k]) for k in got)


def test_other_archs_refuse_the_tensor_axis(stp_run):
    """arch egnn and eqgat (models/semla_alt.py, whose leaves no Semla rule
    names) at --tp 2 raise NotImplementedError naming ROADMAP.md's item, on
    both ranks; so does the trainer."""
    _, two, _, _, _ = stp_run
    for r in two:
        for arch, (kind, msg) in r["refused"].items():
            assert kind == "NotImplementedError", arch
            assert "ROADMAP.md Queue 1 item 8b" in msg and "egnn and eqgat" in msg, arch
    for arch in ("egnn", "eqgat"):
        with pytest.raises(NotImplementedError, match="item 8b .*egnn and eqgat archs"):
            ms.SemlaTrainer(ms.SemlaTrainConfig(arch=arch, mesh=MeshConfig(tensor=2)),
                            device="cpu")


# --- against reed_tpu on the same mesh --------------------------------------


def test_step_matches_reed_tpu_on_the_same_mesh(stp_run):
    """Metrics to 1e-5; every gradient to 5e-4 of its scale; the parameters
    after the step to 2e-6 where reed_tpu's first update moved them by more
    than 0.99 lr and to 2 lr elsewhere; the EMA to 1e-6
    (tests/test_torch_semla_train.py)."""
    _, two, _, _, want = stp_run
    lr = want["lr"]
    top = max(float(g.abs().max()) for g in want["grads"].values())
    for r in two:
        got = r["jax"]
        assert set(got["metrics"][0]) == set(want["metrics"])
        for k, v in want["metrics"].items():
            np.testing.assert_allclose(got["metrics"][0][k], v, rtol=METRIC_TOL,
                                       atol=METRIC_TOL, err_msg=k)
        assert set(got["grads"]) == set(want["grads"])
        for n, g in got["grads"].items():
            err = float((g - want["grads"][n]).abs().max())
            assert err <= GRAD_TOL * _grad_scale(n, want["grads"][n], top), n
        for n, p in got["params"].items():
            moved = (want["params"][n] - want["before"][n]).abs() > 0.99 * lr
            diff = (p - want["params"][n]).abs()
            if moved.any():
                assert diff[moved].max().item() <= 2e-6, n
            assert diff.max().item() <= 2 * lr, n
            np.testing.assert_allclose(got["ema"][n].numpy(), want["ema"][n].numpy(),
                                       rtol=0, atol=1e-6, err_msg=n)


# --- without ranks -----------------------------------------------------------


def _flags(flax_params, flag_of):
    """{port name: whether flag_of(flax path) holds} through the semla
    converter (a leaf filled with 1.0 or 0.0)."""
    marked = jax.tree_util.tree_map_with_path(
        lambda path, leaf: np.full(np.shape(leaf), float(flag_of(
            "/".join(str(k.key) for k in path))), np.float32), flax_params)
    return {k: bool(v.reshape(-1)[0]) for k, v in state_dict_from_flax(marked).items()}


def test_tensor_rules_against_reed_tpus_semla_rules():
    """The weights the port's SEMLA_TP_RULES split are exactly those whose
    flax kernels reed_tpu's SEMLA_TP_RULES match (every NodeFeedForward's
    invariant MLP, the layers' and BondRefine's message MLPs, the node
    attention, the feature projection), on the dimension its spec names
    (column rules on the torch weight's dimension 0, row rules on 1); beyond
    them only the column-parallel products' biases, which split with their
    columns (reed_tpu leaves every bias replicated)."""
    jcfg = _jax_config(data=1)
    params = _params(JaxTrainer(jcfg), jcfg)

    def rule_of(path):
        for pattern, spec in jax_mesh.SEMLA_TP_RULES:
            if re.search(pattern, path):
                return spec
        return None

    matched = _flags(params, lambda path: rule_of(path) is not None)
    column = _flags(params, lambda path: rule_of(path) == P(None, jax_mesh.TENSOR_AXIS))
    port = {n: mesh.tensor_rule(n, mesh.SEMLA_TP_RULES) for n in matched}
    for name, hit in matched.items():
        if name.endswith(".weight"):
            assert (port[name] is not None) == hit, name
            if hit:
                assert port[name] == (0 if column[name] else 1, 1), name
    biases = sorted(n for n, rule in port.items() if rule is not None and n.endswith(".bias"))
    n_layers = jcfg.n_layers
    want = (["feat_proj.0.bias", "dynamics.refine_layer.message_mlp.0.bias",
             "dynamics.final_ff_block.invariant_mlp.node_ff.0.bias"]
            + [f"dynamics.layers.{i}.{m}.bias" for i in range(n_layers)
               for m in ("node_ff.invariant_mlp.node_ff.0", "message_ff.message_mlp.0",
                         "node_attn.in_proj")])
    assert biases == sorted(want)
    assert all(port[n] == (0, 1) for n in biases)
    # three pairs in every layer (feed-forward, messages, attention), and the
    # final feed-forward's, BondRefine's and the feature projection's
    assert sum(hit for n, hit in matched.items() if n.endswith(".weight")) == 6 * n_layers + 6


def test_whole_state_dict_splits_and_joins():
    """shard_state_dict with SEMLA_TP_RULES gives each tensor rank a
    state_dict of its model's shapes (the sharded generator loads it
    strictly: in_proj's columns are its heads); tensor_join of every rank's
    shards gives the whole one back, bit for bit."""
    cfg = torch_dp.semla_parity_config()
    whole = ms.build_model(cfg, generator=torch.Generator().manual_seed(0)).state_dict()
    shards = []
    for t in range(2):
        parallel = types.SimpleNamespace(tensor=2, tensor_index=t)
        model = ms.build_model(cfg, parallel=parallel)
        shards.append(mesh.shard_state_dict(whole, parallel, mesh.SEMLA_TP_RULES))
        model.load_state_dict(shards[-1])
    attn = "dynamics.layers.1.node_attn"
    assert torch.equal(shards[1][f"{attn}.in_proj.weight"], whole[f"{attn}.in_proj.weight"][16:])
    assert torch.equal(shards[1][f"{attn}.out_proj.weight"],
                       whole[f"{attn}.out_proj.weight"][:, 16:])
    assert torch.equal(shards[0][f"{attn}.out_proj.bias"], whole[f"{attn}.out_proj.bias"])
    msg = "dynamics.layers.1.message_ff.message_mlp"
    assert torch.equal(shards[0][f"{msg}.0.weight"], whole[f"{msg}.0.weight"][:8])
    assert torch.equal(shards[0][f"{msg}.2.weight"], whole[f"{msg}.2.weight"][:, :8])
    rules = [mesh.tensor_rule(n, mesh.SEMLA_TP_RULES) for n in whole]
    joined = {n: v if rule is None else mesh.tensor_join([s[n] for s in shards], rule)
              for (n, v), rule in zip(whole.items(), rules)}
    assert all(torch.equal(joined[n], v) for n, v in whole.items())


@pytest.mark.parametrize("change,what", [
    (dict(n_attn_heads=3, n_coord_sets=5), "the node attention heads's 3"),
    (dict(d_message_hidden=9), "the message MLP's 9"),
    (dict(n_coord_sets=5), "the message MLP's 9"),
    (dict(d_model=18, n_attn_heads=2, tensor=4), "the feature projection's 18"),
])
def test_sizes_that_do_not_divide_raise(change, what):
    """A tensor size that does not divide the attention heads, a message
    MLP's hidden units (d_message_hidden, or heads + coordinate sets where a
    layer has no hidden width of its own) or the feature projection's
    d_model (which divides the feed-forwards' 4 d_model) raises ValueError
    naming them."""
    kw = dict(d_model=24, vocab_size=6, n_atom_feats=6, d_edge=8, n_edge_types=5,
              n_charge_types=7, d_message=16, n_coord_sets=4, n_layers=3, n_attn_heads=4,
              d_message_hidden=16, max_atoms=12, size_emb=8)
    kw.update(change)
    tensor = kw.pop("tensor", 2)
    parallel = types.SimpleNamespace(tensor=tensor, tensor_index=0)
    with pytest.raises(ValueError,
                       match=f"tensor={tensor} does not divide {re.escape(what)} units"):
        SemlaGenerator(**kw, parallel=parallel)


def test_what_a_rank_holds_at_the_recipes_width():
    """recipes/molecule_semla_reed.json's generator (d_model 384, 12 layers,
    64 coordinate sets, 32 heads, message and edge width 128, d_rep 512):
    24.32 M parameters, 21.14 M of them in the leaves the rules split, so a
    rank holds 13.75 M at tensor=2."""
    kw = dict(d_model=384, vocab_size=18, n_atom_feats=18, d_edge=128, n_edge_types=5,
              n_charge_types=7, self_cond=True, d_message=128, n_coord_sets=64, n_layers=12,
              n_attn_heads=32, d_message_hidden=128, d_rep=512, rep_alignment=True,
              align_depth=(4,), size_emb=64, max_atoms=256)
    with torch.device("meta"):
        whole = SemlaGenerator(**kw)
        half = SemlaGenerator(**kw, parallel=types.SimpleNamespace(tensor=2, tensor_index=0))
    total = sum(p.numel() for p in whole.parameters())
    split = sum(p.numel() for n, p in whole.named_parameters()
                if mesh.tensor_rule(n, mesh.SEMLA_TP_RULES) is not None)
    held = sum(p.numel() for p in half.parameters())
    assert held == total - split // 2
    assert (round(total / 1e6, 2), round(split / 1e6, 2), round(held / 1e6, 2)) == (
        24.32, 21.14, 13.75)
