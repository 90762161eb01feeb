"""reed_tpu_torch's tensor mesh axis on ProteinMPNN-FMIF over gloo ranks on
the CPU (tests/torch_dp.py: one spawn of two ranks and one of four for the
file), against one process and against reed_tpu's step on the same mesh.

Each message chain W3(gelu(W2(gelu(W1 [h_i, e_ik, h_j])))) is split over
its hidden width: a rank holds W2's output columns and W3's input rows of
H = D / T hidden units, runs the whole first product and its share of the
rest, and the tensor group sums the partial messages (and, backward, the
partial gradients of the chain's inputs) once; the feed-forwards, the
decoder's edge update and the projectors are Megatron column/row pairs
(parallel/mesh.PMPNN_TP_RULES).

- The protein case (hidden 32, H = 16 a rank at tensor=2, 2 + 2 layers, K
  6, projector widths 8/4/8, batch 4 x 16, f32, coordinate noise 0.02),
  two steps at tensor=2 on the fused chain (its plain version on the CPU,
  through the same autograd.Function as the kernels on the card) and the
  unfused one, with dropout 0 and 0.1; and at data=2 x tensor=2 and fsdp=2
  x tensor=2 on four ranks, step by step from the same state (the second
  step against one process's from the checkpoint the ranks wrote after
  the first): every metric and every whole gradient the update saw within
  REL of that tensor's largest magnitude, every whole parameter after the
  steps within REL of the largest, on every rank; the ranks' whole
  parameters bitwise equal.
- Checkpoints: one written at tensor=2 restores in one process bit for
  bit, and one written in one process restores at tensor=2 bit for bit;
  the resumed steps match the uninterrupted run.
- reed_tpu's ProteinTrainer on MeshConfig(tensor=2) (the conftest's 8 CPU
  devices: data 4 absorbs the rest) from the same weights, with its
  corrupted tokens, t and target noise handed over: the port's step at
  tensor=2, fused and unfused, within the protein parity tolerances
  (tests/test_torch_protein_train.py). reed_tpu runs its chain unfused
  here: its fused and unfused chains compute one function
  (tests/test_fused_message.py), and the unfused step compiles in seconds.
- train-protein --tp 2 through the CLI against one process.
- Without ranks: the plain chain and its plain backward summed over rank
  slices of the hidden units against the whole chain; the leaves the
  port's rules split against those reed_tpu's rules match; the split and
  join of whole state_dicts; tensor sizes that leave H off the kernels'
  grid; what a rank holds at ProteinTrainConfig()'s width.
"""

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
from reed_tpu.diffusion.discrete import corrupt_batch as jax_corrupt_batch
from reed_tpu.parallel import mesh as jax_mesh
from reed_tpu.train.protein import ProteinTrainConfig as JaxConfig
from reed_tpu.train.protein import ProteinTrainer as JaxTrainer
from reed_tpu.train.protein import make_loss_fn as jax_make_loss_fn
from reed_tpu_torch.core import checkpoint
from reed_tpu_torch.core.config import MeshConfig
from reed_tpu_torch.encoders.fmif_convert import state_dict_from_flax
from reed_tpu_torch.models.pmpnn import ProteinMPNNFMIF
from reed_tpu_torch.ops import fused_message as fm
from reed_tpu_torch.parallel import mesh
from reed_tpu_torch.train.protein import ProteinTrainConfig, build_model, resolve_fused
from torch_parity import FMIF_TINY, JaxFMIF, fmif_batch, fmif_random_params

torch.set_num_threads(1)

# a parallel run against one process: each quantity within REL of that
# tensor's largest magnitude (the sums over the hidden units run in
# another order)
REL = 1e-5
# against reed_tpu (tests/test_torch_protein_train.py's f32 bounds)
METRIC_TOL = 1e-5
GRAD_TOL = 5e-4
# the plain chain summed over rank slices against the whole chain: a sum
# in another order, relative to each output's largest magnitude
SPLIT_REL = 1e-6
VARIANTS = tuple(torch_dp.PTP_VARIANTS)
FOUR_RANK = tuple(torch_dp.PTP_MESHES_4)


def _jax_step():
    """reed_tpu's protein step (TRAP_TINY with target noise 0.3, unfused) on
    MeshConfig(tensor=2) from seeded weights: the inputs the ranks take
    (weights in the port's layout, the batch, the step's S_t and t and the
    target noise) and its gradients, metrics, and parameters and EMA after
    it, by port name."""
    kw = dict(torch_dp.TRAP_TINY, **torch_dp.PTP_JAX_FIELDS)
    cfg = JaxConfig(**kw, mesh=JaxMesh(tensor=2),
                    curriculum=JaxCurriculum(proj_coeff=0.2, diffusion_warmup_steps=0))
    trainer = JaxTrainer(cfg)
    b, l = cfg.batch_size, cfg.max_len
    batch = fmif_batch(batch=b, length=l, pad=3, seed=1)
    rng = np.random.default_rng(11)
    for key, shape in (("repr_single", (l, cfg.single_dim)),
                       ("repr_pair", (l, l, cfg.pair_dim)),
                       ("repr_structure", (l, cfg.structure_dim))):
        batch[key] = rng.standard_normal((b,) + shape).astype(np.float32)
    params = fmif_random_params(trainer.model, batch, std=0.1, seed=0)["params"]
    jparams = jax.tree.map(jnp.asarray, params)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    # the draws of the train step at step 0 (trainer.py:54, protein.py:113,
    # protein_losses.py:89)
    step_rng = jax.random.fold_in(trainer.train_rng, 0)
    rng_corrupt, _, rng_noise, _ = jax.random.split(step_rng, 4)
    noisy = jax_corrupt_batch(rng_corrupt, jbatch, cfg.interpolant)
    shapes = [batch["repr_single"].shape, (b, l, cfg.k_neighbors, cfg.pair_dim),
              batch["repr_structure"].shape]
    noise = [np.asarray(jax.random.normal(r, s))
             for r, s in zip(jax.random.split(rng_noise, 3), shapes)]
    curriculum = JaxCurriculum(**{**cfg.curriculum.__dict__, "proj_coeff": cfg.repr_weight})
    loss_fn = jax_make_loss_fn(trainer.model, cfg)
    grads = jax.jit(jax.grad(lambda p: jax_combine_losses(
        loss_fn(p, jbatch, step_rng, 0), 0, curriculum)[0]))(jparams)
    state = trainer.init_state()
    state = state.replace(params=jparams, ema_params=jax.tree.map(jnp.copy, jparams),
                          opt_state=trainer.optimizer.init(jparams))
    with trainer.mesh:
        state, metrics = trainer.train_step(state, jbatch, trainer.train_rng)
    to_port = lambda tree: state_dict_from_flax(jax.tree.map(np.asarray, tree))
    inputs = {"params": to_port(params), "batch": batch, "repr_noise": noise,
              "noisy": (np.asarray(noisy["S_t"]), np.asarray(noisy["t"]))}
    return inputs, {"grads": to_port(grads), "params": to_port(state.params),
                    "ema": to_port(state.ema_params), "lr": cfg.optim.lr,
                    "metrics": {k: float(v) for k, v in metrics.items()}}


def _one_process(out):
    """The protein case in one process: each variant's two steps, its state
    at step 2 (saved under out/ckpt_one_protein) and after 4 steps, and
    train-protein through the CLI."""
    one = {}
    for key, fields in torch_dp.PTP_VARIANTS.items():
        with torch_dp.settings(fields=fields):
            one[key] = torch_dp.run_case("protein")
    trainer, batches = torch_dp._protein()
    batches += [trainer.synthetic_batch(torch.Generator().manual_seed(12 + i))
                for i in range(2)]
    state = trainer.init_state()
    mgr = checkpoint.CheckpointManager(out / "ckpt_one_protein", save_interval_steps=2)
    for batch in batches[:2]:
        state, _ = trainer.train_step(state, batch)
    mgr.save(state, trainer.generator)
    one["saved"] = torch_dp.state_tensors(state)
    for batch in batches[2:]:
        state, _ = trainer.train_step(state, batch)
    one["straight"] = torch_dp.state_tensors(state)
    one["lr"] = trainer.cfg.optim.lr
    one["cli"] = torch_dp.mesh_cli(out, "train-protein", torch_dp.PTP_CLI, [], "ptp_cli_one")
    return one


@pytest.fixture(scope="module")
def ptp_run(tmp_path_factory):
    """The two-rank and four-rank results, the one-process references and
    reed_tpu's step, computed before the ranks start."""
    out = tmp_path_factory.mktemp("protein_tensor_parallel")
    inputs, jax_want = _jax_step()
    one = _one_process(out)
    torch.save(inputs, out / "jax_protein_inputs.pt")
    torch_dp.spawn(out, "protein_tensor_parallel")
    torch_dp.spawn(out, "protein_tensor_parallel_mesh", world=4)
    two = [torch.load(out / f"ptp_rank{r}.pt", weights_only=False) for r in range(2)]
    four = [torch.load(out / f"ptp_mesh_rank{r}.pt", weights_only=False) for r in range(4)]
    return out, two, four, one, jax_want


def _continued(out, key, fields):
    """One process's second step from the checkpoint the mesh run `key`
    wrote after its first step (the whole state and the trainer's
    generator): its metrics, gradients (parameter order) and whole
    parameters after it."""
    from reed_tpu_torch.core.trainer import capture_gradients

    with torch_dp.settings(fields=fields):
        trainer, batches = torch_dp._protein()
    state = trainer.init_state()
    checkpoint.CheckpointManager(out / torch_dp.first_ckpt("ptp_first_", key)).restore(
        state, trainer.generator)
    assert state.step == 1
    with capture_gradients() as grads:
        state, metrics = trainer.train_step(state, batches[1])
    return {"metrics": {k: float(v) for k, v in metrics.items()}, "grads": grads[0],
            "params": torch_dp.whole_params(state)}


def _check_step(step, got_metrics, got_grads, want_metrics, want_grads, names):
    """One step's metrics within REL of the step's largest, each gradient
    within REL of that tensor's largest magnitude."""
    assert set(got_metrics) == set(want_metrics)
    top = max(abs(v) for v in want_metrics.values())
    bad = {k: (got_metrics[k], v) for k, v in want_metrics.items()
           if abs(got_metrics[k] - v) > REL * top}
    assert not bad, (step, bad)
    assert len(got_grads) == len(want_grads) == len(names)
    for n, a, b in zip(names, got_grads, want_grads):
        assert a.shape == b.shape, n
        assert float((a - b).abs().max()) <= REL * float(b.abs().max()), (step, n)


def _check_run(got, one, cont):
    """A mesh run of two steps, step by step from the same state: the first
    against one process's first step (`one`, run_case's), the second
    against one process's second step taken from the checkpoint the mesh
    run wrote after its first (`cont`, _continued's); then the whole
    parameters after it against that step's, within REL of the largest
    parameter, and within 2 lr where the step's gradient is at rounding
    level (below 1e-6 of its largest: Adam's update, lr * m / (sqrt(v) +
    eps), moves such an element by up to lr whatever the gradient's
    digits). Comparing the second step with one process's from scratch
    would compare Adam's first updates of such elements instead."""
    names = list(one["params"])
    _check_step(0, got["metrics"][0], got["grads"][0], one["metrics"][0], one["grads"][0],
                names)
    _check_step(1, got["metrics"][1], got["grads"][1], cont["metrics"], cont["grads"], names)
    top_grad = max(float(g.abs().max()) for g in cont["grads"])
    top = max(float(w.abs().max()) for w in cont["params"].values())
    for n, g in zip(names, cont["grads"]):
        diff = (got["params"][n] - cont["params"][n]).abs()
        bound = torch.where(g.abs() < 1e-6 * top_grad, 2 * one["lr"], REL * top)
        assert bool((diff <= bound).all()), (n, float(diff.max()))


def _within(a, b, lr):
    """State tensors a against b: the entries off by more than REL of the
    largest of b (4 lr for a parameter, whose elements Adam's first
    updates move by up to lr whatever their gradient's digits)."""
    top = max(float(v.abs().max()) for v in b.values())
    return {k: float((a[k] - w).abs().max()) for k, w in b.items()
            if float((a[k] - w).abs().max()) > max(REL * top, 4 * lr if
                                                    k.startswith("param/") else 0.0)}


# --- against one process ----------------------------------------------------


@pytest.mark.parametrize("variant", VARIANTS, ids=[f"{p}-dropout{d}" for p, d in VARIANTS])
def test_step_at_tensor_2_matches_one_process(ptp_run, variant):
    """Two protein steps at tensor=2, on every rank, against one process,
    step by step."""
    out, two, _, one, _ = ptp_run
    cont = _continued(out, variant, torch_dp.PTP_VARIANTS[variant])
    for r in two:
        _check_run(r[variant], one[variant], cont)


@pytest.mark.parametrize("mesh_name", FOUR_RANK)
def test_step_on_four_ranks_matches_one_process(ptp_run, mesh_name):
    """data=2 x tensor=2 and fsdp=2 x tensor=2 (dropout 0.1, the fused
    chain), on every rank, against one process, step by step."""
    out, _, four, one, _ = ptp_run
    cont = _continued(out, mesh_name, {})
    for r in four:
        _check_run(r[mesh_name], one["fused", 0.1], cont)


def test_tensor_ranks_hold_the_same_whole_parameters(ptp_run):
    """Joined over the tensor group, every rank's parameters after the steps
    are bitwise the same: the replicated leaves got the same gradient on
    every tensor rank."""
    _, two, four, _, _ = ptp_run
    for key in VARIANTS:
        a, b = two[0][key]["params"], two[1][key]["params"]
        assert all(torch.equal(a[k], b[k]) for k in a), key
    for name in FOUR_RANK:
        ref = four[0][name]["params"]
        for r in four[1:]:
            assert all(torch.equal(r[name]["params"][k], v) for k, v in ref.items()), name


def test_rank_layout(ptp_run):
    """Two ranks at tensor=2: one batch index (both take the whole batch),
    tensor indices 0 and 1."""
    _, two, _, _, _ = ptp_run
    assert [r["axes"] for r in two] == [(0, 0, 1, 0), (1, 0, 1, 1)]


def test_checkpoint_written_at_tensor_2_resumes_in_one_process(ptp_run):
    """The file rank 0 wrote holds the ranks' whole state (parameters
    joined over the tensor group); one process restores it bit for bit."""
    out, two, _, one, _ = ptp_run
    saved = two[0]["resume"]["saved"]
    assert all(torch.equal(saved[k], two[1]["resume"]["saved"][k]) for k in saved)
    trainer, _ = torch_dp._protein()
    state = trainer.init_state()
    checkpoint.CheckpointManager(out / "ckpt_ptp", save_interval_steps=2).restore(
        state, trainer.generator)
    assert state.step == 2 and state.opt.count == 2
    restored = torch_dp.state_tensors(state)
    assert set(restored) == set(saved)
    assert all(torch.equal(restored[k], saved[k]) for k in saved)
    assert not _within(saved, one["saved"], one["lr"])


def test_one_process_checkpoint_resumes_at_tensor_2(ptp_run):
    """Each rank restores the one-process checkpoint into its shards: joined
    back, the state is the one saved, bit for bit, and 2 more steps match
    the uninterrupted one-process run."""
    _, two, _, one, _ = ptp_run
    for r in two:
        res = r["resume"]
        assert res["step"] == 4
        assert all(torch.equal(res["restored"][k], one["saved"][k]) for k in one["saved"])
        assert not _within(res["resumed"], one["straight"], one["lr"])


def test_cli_train_protein_tp2_matches_one_process(ptp_run):
    """train-protein --distributed --tp 2 (two steps, a checkpoint at step
    2) against the same command in one process."""
    out, two, _, one, _ = ptp_run
    step, want = one["cli"]
    assert sorted(p.name for p in (out / "ptp_cli_tp").iterdir()) == sorted(
        p.name for p in (out / "ptp_cli_one").iterdir())
    for r in two:
        got_step, got = r["cli"]
        assert got_step == step == 2
        assert set(got) == set(want)
        assert not _within(got, want, one["lr"])


# --- against reed_tpu on the same mesh --------------------------------------


@pytest.mark.parametrize("path", ["fused", "off"])
def test_step_matches_reed_tpu_on_the_same_mesh(ptp_run, path):
    """Metrics to 1e-5; every gradient to 5e-4; the parameters after the
    step to 2e-6 where reed_tpu's gradient exceeds 1e-6 and to 2 lr
    elsewhere; the EMA to 1e-6 (tests/test_torch_protein_train.py)."""
    _, two, _, _, want = ptp_run
    for r in two:
        got = r["jax", path]
        assert set(got["metrics"]) == set(want["metrics"])
        for k, v in want["metrics"].items():
            np.testing.assert_allclose(got["metrics"][k], v, rtol=METRIC_TOL,
                                       atol=METRIC_TOL, err_msg=k)
        assert set(got["grads"]) == set(want["grads"])
        for n, g in got["grads"].items():
            np.testing.assert_allclose(g.numpy(), want["grads"][n].numpy(), rtol=GRAD_TOL,
                                       atol=GRAD_TOL, err_msg=n)
        for n, p in got["params"].items():
            big = want["grads"][n].abs() > 1e-6
            diff = (p - want["params"][n]).abs()
            if big.any():
                assert diff[big].max().item() <= 2e-6, n
            assert diff.max().item() <= 2 * want["lr"], n
            np.testing.assert_allclose(got["ema"][n].numpy(), want["ema"][n].numpy(),
                                       rtol=0, atol=1e-6, err_msg=n)


# --- without ranks -----------------------------------------------------------


def _chain(d=32, ce=48, k=6, seed=0):
    """Inputs of one message chain at width D, edge width Ce and K
    neighbours (every weight ~ N(0, 0.25)), a mask with zeros, and
    cotangents of both outputs."""
    rng = np.random.default_rng(seed)
    b, l = 2, 10

    def f(*shape):
        return torch.tensor(rng.standard_normal(shape).astype(np.float32) * 0.5)

    args = dict(pre_self=f(b, l, d), e_feat=f(b, l, k, ce), nbr_src=f(b, l, d),
                e_idx=torch.tensor(rng.integers(0, l, (b, l, k))), w_e=f(ce, d),
                w2=f(d, d), b2=f(d), w3=f(d, d), b3=f(d))
    mask = torch.tensor((rng.random((b, l, k)) > 0.3).astype(np.float32))
    return args, mask, f(b, l, d), f(b, l, k, d)


def _rank_slice(args, t, tensor):
    """Rank t's chain: W2's columns, b2's entries and W3's rows of its H =
    D / T hidden units (tensor_split of the torch weights by
    PMPNN_TP_RULES), b3 left out (added once after the sum)."""
    h = args["w2"].shape[1] // tensor
    cols = slice(t * h, (t + 1) * h)
    return dict(args, w2=args["w2"][:, cols], b2=args["b2"][cols], w3=args["w3"][cols],
                b3=torch.zeros_like(args["b3"]))


@pytest.mark.parametrize("tensor", [2, 4])
@pytest.mark.parametrize("mode", ["post", "pre", "none"])
def test_chain_summed_over_rank_slices_is_the_whole_chain(mode, tensor):
    """At H = D / T, the f32 partial dh and msg of fused_message_reference on
    each rank's slices, summed over the ranks, plus b3 once (masked as the
    chain masks it: sum_k mask b3 / scale in dh under 'post', K b3 / scale
    otherwise), are the whole chain's."""
    args, mask, _, _ = _chain()
    m = None if mode == "none" else mask
    dh, msg = fm.fused_message_reference(**args, mask=m, mask_mode=mode, want_msg=True)
    parts = [fm.fused_message_reference(**_rank_slice(args, t, tensor), mask=m,
                                        mask_mode=mode, want_msg=True, out_f32=True)
             for t in range(tensor)]
    assert all(p.dtype == torch.float32 for part in parts for p in part)
    k = mask.shape[-1]
    count = mask.sum(-1, keepdim=True) if mode == "post" else k
    got_dh = sum(p[0] for p in parts) + args["b3"] * count / 30.0
    got_msg = sum(p[1] for p in parts) + args["b3"] * (mask[..., None] if mode == "post"
                                                        else 1.0)
    for got, want in ((got_dh, dh), (got_msg, msg)):
        assert float((got - want).abs().max()) <= SPLIT_REL * float(want.abs().max())


@pytest.mark.parametrize("tensor", [2, 4])
@pytest.mark.parametrize("mode", ["post", "pre", "none"])
def test_chain_backward_over_rank_slices_is_the_whole_backward(mode, tensor):
    """fused_message_backward_reference on each rank's slices with the whole
    cotangents: the f32 partial gradients of pre_self, e_feat, nbr_src and
    w_e summed over the ranks, W2's and b2's joined by columns and W3's by
    rows, and any rank's b3 gradient, are the whole chain's gradients."""
    args, mask, gdh, gmsg = _chain(seed=1)
    m = None if mode == "none" else mask
    want = fm.fused_message_backward_reference(**args, gdh=gdh, gmsg=gmsg, mask=m,
                                               mask_mode=mode)
    parts = [fm.fused_message_backward_reference(**_rank_slice(args, t, tensor), gdh=gdh,
                                                 gmsg=gmsg, mask=m, mask_mode=mode,
                                                 out_f32=True)
             for t in range(tensor)]
    got = ([sum(p[i] for p in parts) for i in range(4)]
           + [torch.cat([p[4] for p in parts], dim=1), torch.cat([p[5] for p in parts]),
              torch.cat([p[6] for p in parts], dim=0)] + [parts[-1][7]])
    names = ("pre_self", "e_feat", "nbr_src", "w_e", "w2", "b2", "w3", "b3")
    for name, g, w in zip(names, got, want):
        assert g.shape == w.shape, name
        assert float((g - w).abs().max()) <= SPLIT_REL * float(w.abs().max()), name


def _flags(flax_params, flag_of):
    """{port name: whether flag_of(flax path) holds} through the fmif
    converter (a leaf filled with 1.0 or 0.0)."""
    marked = jax.tree_util.tree_map_with_path(
        lambda path, leaf: np.full(np.shape(leaf), float(flag_of(
            "/".join(str(k.key) for k in path))), np.float32), flax_params)
    return {k: bool(v.reshape(-1)[0]) for k, v in state_dict_from_flax(marked).items()}


def test_tensor_rules_against_reed_tpus_pmpnn_rules():
    """The leaves the port's PMPNN_TP_RULES split, against the leaves
    reed_tpu's PMPNN_TP_RULES match (column rules on the torch weight's
    dimension 0, row rules on 1). The departures are exactly those named
    beside the rules: W1 and W11 stay whole where reed_tpu shards their
    columns, W2 and W12 (weight and bias) split by their output columns
    where reed_tpu keeps them whole, the feed-forwards split as a
    column/row pair where reed_tpu's dense/fc1 and dense/fc2 patterns match
    no leaf of its model, the projectors' second products split by rows
    where its projectors_*/Dense_2 pattern matches none either, and the
    column-parallel products' biases (dense.W_in, W_edge.1, projectors_*.0)
    split with their columns."""
    batch = fmif_batch(batch=1, length=12)
    params = fmif_random_params(JaxFMIF(**FMIF_TINY), batch)["params"]

    def rule_of(path):
        for pattern, spec in jax_mesh.PMPNN_TP_RULES:
            if re.search(pattern, path):
                return spec
        return None

    matched = _flags(params, lambda path: rule_of(path) is not None)
    column = _flags(params, lambda path: rule_of(path) == P(None, jax_mesh.TENSOR_AXIS))
    port = {n: mesh.tensor_rule(n, mesh.PMPNN_TP_RULES) for n in matched}
    # reed_tpu's hint, kept
    for name, hit in matched.items():
        if hit and not re.search(r"\.W1?1\.weight$", name):
            assert port[name] == (0 if column[name] else 1, 1), name
    dropped = sorted(n for n, hit in matched.items() if hit and port[n] is None)
    added = sorted(n for n, hit in matched.items() if not hit and port[n] is not None)
    n_enc, n_dec = FMIF_TINY["num_encoder_layers"], FMIF_TINY["num_decoder_layers"]
    assert dropped == sorted([f"encoder_layers.{i}.{w}.weight" for i in range(n_enc)
                              for w in ("W1", "W11")]
                             + [f"decoder_layers.{i}.W1.weight" for i in range(n_dec)])
    dense = ("dense.W_in.weight", "dense.W_in.bias", "dense.W_out.weight")
    want_added = ([f"encoder_layers.{i}.{w}" for i in range(n_enc)
                   for w in ("W2.weight", "W2.bias", "W12.weight", "W12.bias") + dense]
                  + [f"decoder_layers.{i}.{w}" for i in range(n_dec)
                     for w in ("W2.weight", "W2.bias", "W_edge.1.bias") + dense]
                  + [f"projectors_{p}.{w}" for p in ("single", "pair", "structure")
                     for w in ("0.bias", "2.weight")])
    assert added == sorted(want_added)
    for name in added:
        row = name.endswith(("W_out.weight", ".2.weight"))
        assert port[name] == ((1, 1) if row else (0, 1)), name


def test_whole_state_dict_splits_and_joins():
    """shard_state_dict with PMPNN_TP_RULES gives each tensor rank a
    state_dict of its model's shapes (the sharded model loads it strictly);
    tensor_join of every rank's shards (ShardPlan.join_state_dict's) gives
    the whole one back, bit for bit."""
    cfg = ProteinTrainConfig(hidden_dim=32, num_encoder_layers=1, num_decoder_layers=1,
                             k_neighbors=6, single_dim=8, pair_dim=4, structure_dim=8)
    whole = build_model(cfg, generator=torch.Generator().manual_seed(0)).state_dict()
    shards = []
    for t in range(2):
        parallel = types.SimpleNamespace(tensor=2, tensor_index=t)
        model = ProteinMPNNFMIF(hidden_dim=32, edge_features=32, num_encoder_layers=1,
                                num_decoder_layers=1, k_neighbors=6, single_dim=8,
                                pair_dim=4, structure_dim=8, parallel=parallel)
        shards.append(mesh.shard_state_dict(whole, parallel, mesh.PMPNN_TP_RULES))
        model.load_state_dict(shards[-1])
    assert torch.equal(shards[1]["encoder_layers.0.W2.weight"],
                       whole["encoder_layers.0.W2.weight"][16:])
    assert torch.equal(shards[1]["encoder_layers.0.W3.weight"],
                       whole["encoder_layers.0.W3.weight"][:, 16:])
    assert torch.equal(shards[0]["encoder_layers.0.W1.weight"],
                       whole["encoder_layers.0.W1.weight"])
    rules = [mesh.tensor_rule(n, mesh.PMPNN_TP_RULES) for n in whole]
    joined = {n: v if rule is None else mesh.tensor_join([s[n] for s in shards], rule)
              for (n, v), rule in zip(whole.items(), rules)}
    assert all(torch.equal(joined[n], v) for n, v in whole.items())


def test_tensor_sizes_off_the_kernel_grid_raise():
    """H = hidden / T must be a multiple of 16 on the fused chain (the
    kernels' product width): tensor=16 at hidden 128 (H = 8) raises naming
    H, tensor=3 does not split the hidden units; 'off' runs H = 8 unfused;
    the kernels' shape check names H."""
    base = ProteinTrainConfig()
    assert resolve_fused(base) is True
    assert resolve_fused(ProteinTrainConfig(mesh=MeshConfig(tensor=2))) is True
    for mode in ("auto", "on"):
        with pytest.raises(ValueError, match="tensor=16 leaves each message chain 8 .*"
                                             "H = 8 .*multiple of 16"):
            resolve_fused(ProteinTrainConfig(mesh=MeshConfig(tensor=16), fused_messages=mode))
    assert resolve_fused(ProteinTrainConfig(mesh=MeshConfig(tensor=16),
                                            fused_messages="off")) is False
    with pytest.raises(ValueError, match="tensor=3 does not divide .*128 hidden units"):
        resolve_fused(ProteinTrainConfig(mesh=MeshConfig(tensor=3)))
    for h in (8, 24, 256):
        with pytest.raises(ValueError, match=f"H = {h} "):
            fm.check_engine_shape(30, 128, 128, h)
    fm.check_engine_shape(30, 128, 256, 64)


def test_what_a_rank_holds_at_full_width():
    """ProteinTrainConfig()'s model (hidden 128, 3 + 3 layers, projectors
    384/128/768): 4.28 M parameters, 3.69 M of them in the leaves the rules
    split, so a rank holds 2.43 M at tensor=2."""
    whole = ProteinMPNNFMIF(hidden_dim=128, edge_features=128)
    half = ProteinMPNNFMIF(hidden_dim=128, edge_features=128,
                           parallel=types.SimpleNamespace(tensor=2, tensor_index=0))
    total = sum(p.numel() for p in whole.parameters())
    split = sum(p.numel() for n, p in whole.named_parameters()
                if mesh.tensor_rule(n, mesh.PMPNN_TP_RULES) is not None)
    held = sum(p.numel() for p in half.parameters())
    assert round(total / 1e6, 2) == 4.28 and round(split / 1e6, 2) == 3.69
    assert held == total - split // 2 and round(held / 1e6, 2) == 2.43
