"""reed_tpu_torch's tensor mesh axis on MultiFlow's IPA trunk (train-multiflow's
FlowModel) over gloo ranks on the CPU (tests/torch_dp.py: one spawn of two
ranks and one of four for the file), against one process and against
reed_tpu's step on the same mesh.

A rank holds T-th shards of parallel/mesh.ipa_tp_rules: each IPA's heads
(its rows of linear_q and linear_kv, its heads out of each xyz block of the
point projections, and linear_out's matching input rows out of each of its
unequal blocks) and each sequence-transformer layer's heads and
feed-forward columns; the row-parallel products' f32 partials are summed
once over the tensor group before their biases. linear_b, down_z and
head_weights are whole on every rank: their outputs enter the split
attention through copy_to_tensor, as do the node embedding and the rigids.

- The multiflow case (c_s 32, c_z 16, 2 blocks, 4 IPA heads of 8 channels,
  4 query / key and 4 value points, 4 sequence heads) in f32 and bf16 at
  tensor=2, and in f32 at data=2 x tensor=2 and fsdp=2 x tensor=2 on four
  ranks: two steps, step by step, against one process (the second step
  against one process's from the checkpoint the ranks wrote after the
  first). f32: every metric within REL of the step's largest, every
  gradient within REL of its own largest magnitude, the parameters after
  the steps within REL of the largest parameter (2 lr where the gradient is
  at rounding level). bf16: the whole gradient, the losses and the
  parameters within 2x one process's own bf16 distance from its f32 step
  from the same state. The tensor ranks' whole parameters bitwise equal.
- The trainers (reed_tpu's and the port's) take no self-conditioning pass
  (they feed zero trans_sc and the one-hot aatypes_t); the model's
  forward and backward with and without self-conditioning inputs
  (trans_sc, aatypes_sc), in f32 and bf16, at tensor=2 against one
  process: outputs and gradients to REL (f32), within 2x one process's bf16
  distance from f32 (bf16).
- Checkpoints: one written at tensor=2 restores in one process bit for
  bit, and one written in one process restores at tensor=2 bit for bit;
  the resumed steps match the uninterrupted run.
- reed_tpu's MultiflowTrainer on MeshConfig(tensor=2) (the conftest's 8 CPU
  devices: data 4 absorbs the rest) from the same seeded-normal weights on
  every leaf (linear_out, post_tfmr, linear_3 and bb_update included) with
  reed_tpu's draws handed over: tests/test_torch_multiflow_train.py's
  bounds.
- train-multiflow --distributed --tp 2 on two ranks and --fsdp 2 --tp 2 on
  four through the CLI against one process.
- Without ranks: the leaves the port's rules split against those reed_tpu's
  IPA_TP_RULES match; the unequal-block split of linear_out and the
  groups-3 split of the point projections against a whole IPA whose
  shards' outputs are summed, and in_proj's against a whole attention; the
  split and join of whole state_dicts (linear_out's blocks bitwise); sizes
  that do not divide.
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
from reed_tpu.diffusion import se3 as jse3
from reed_tpu.parallel import mesh as jax_mesh
from reed_tpu.train import multiflow as jmf
from reed_tpu_torch.core import checkpoint
from reed_tpu_torch.core.config import MeshConfig
from reed_tpu_torch.diffusion import se3
from reed_tpu_torch.encoders.multiflow_convert import state_dict_from_flax
from reed_tpu_torch.models.ipa import FlowModel, InvariantPointAttention
from reed_tpu_torch.nn import layers
from reed_tpu_torch.ops.so3 import quat_to_rotmat
from reed_tpu_torch.parallel import mesh
from reed_tpu_torch.train import multiflow as mf
from test_torch_multiflow_train import _host_batch, _jax_total, _jbatch, _key
from test_torch_so3_se3 import corrupt_draws

torch.set_num_threads(1)

# a tensor=2 f32 run against one process: each quantity within REL of that
# tensor's largest magnitude (the split sums run in another order), a
# gradient's floored at GRAD_FLOOR of the step's largest: linear_b's bias
# moves each head's logits of a row by one constant, which the softmax
# ignores, so its gradient is rounding noise (~1e-12 against ~1e-1)
REL = 1e-5
GRAD_FLOOR = 1e-4
# against reed_tpu: tests/test_torch_multiflow_train.py's f32 bounds
METRIC_TOL = 1e-5
GRAD_TOL = 1e-4
# a bf16 run: within BF16_FACTOR times one process's own bf16 distance from
# its f32 step (or call) from the same state
BF16_FACTOR = 2.0
LOSSES = ("denoising_loss", "loss", "trans_loss", "rots_vf_loss", "aatypes_loss")
FOUR_RANK = list(torch_dp.MTP_MESHES_4)
MODEL_CASES = [(sc, dtype) for sc in ("no_sc", "sc") for dtype in torch_dp.MTP_VARIANTS]


def _seeded(jcfg, seed=0, scale=0.1, bb_scale=0.02):
    """reed_tpu's FlowModel and params with every leaf from a seeded normal,
    the backbone updates small (tests/test_torch_multiflow_train.py's
    _seeded, the shapes from jax.eval_shape rather than an eager init)."""
    jmodel = jmf.build_model(jcfg)
    noisy = jse3.corrupt_batch(jax.random.PRNGKey(0), jcfg.interpolant,
                               _jbatch(_host_batch(jcfg)))
    noisy["trans_sc"] = jnp.zeros_like(noisy["trans_t"])
    noisy["aatypes_sc"] = jax.nn.one_hot(noisy["aatypes_t"], 21)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), noisy)["params"]
    leaves, tree = jax.tree_util.tree_flatten_with_path(shapes)
    rng = np.random.default_rng(seed)
    return jmodel, jax.tree_util.tree_unflatten(tree, [jnp.asarray(
        (rng.standard_normal(x.shape) * (bb_scale if "bb_update" in jax.tree_util.keystr(p)
                                         else scale)).astype(np.float32)) for p, x in leaves])


def _jax_step():
    """reed_tpu's MultiFlow step (MTP_PARITY) on MeshConfig(tensor=2) from
    seeded-normal weights (every leaf): the inputs the ranks take (weights,
    host batch with the coupled prior, reed_tpu's draws) and its gradient,
    metrics, and parameters and EMA after it, by port name."""
    jcfg = jmf.MultiflowTrainConfig(**torch_dp.MTP_PARITY, mesh=JaxMesh(tensor=2))
    tcfg = mf.MultiflowTrainConfig(**torch_dp.MTP_PARITY)
    jmodel, params = _seeded(jcfg)
    batch = _host_batch(jcfg)
    jbatch = _jbatch(batch)
    b, n = batch["res_mask"].shape
    key = _key(jcfg, b)
    step_rng = jax.random.fold_in(key, 0)
    grads = jax.jit(jax.grad(lambda p: _jax_total(jcfg, jmodel, jbatch, step_rng)(p)[0]))(
        params)
    to_port = lambda tree: state_dict_from_flax(jax.tree.map(np.array, tree))
    sd = to_port(params)   # before the step, which donates its state's buffers
    jtrainer = jmf.MultiflowTrainer(jcfg)
    state = jtrainer.init_state()
    state = state.replace(params=params, ema_params=jax.tree.map(jnp.copy, params),
                          opt_state=jtrainer.optimizer.init(params))
    with jtrainer.mesh:
        state, metrics = jtrainer.train_step(state, jbatch, key)
    draws = corrupt_draws(step_rng, tcfg.interpolant, b, n, with_trans_noise=False)
    inputs = {"params": sd, "batch": batch, "draws": draws}
    return inputs, {"grads": to_port(grads), "params": to_port(state.params),
                    "ema": to_port(state.ema_params), "before": sd, "lr": jcfg.optim.lr,
                    "metrics": {k: float(v) for k, v in metrics.items()}}


def _model_inputs(params):
    """The model calls' inputs: the weights, a corrupted batch of the parity
    configuration with zero self-conditioning inputs (as the trainer feeds
    them) and with seeded ones, and the outputs' weights."""
    cfg = mf.MultiflowTrainConfig(**torch_dp.MTP_PARITY)
    gen = torch.Generator().manual_seed(5)
    noisy = se3.corrupt_batch(cfg.interpolant,
                              mf.batch_to_device(_host_batch(cfg, seed=4), "cpu"),
                              generator=gen)
    b, n = noisy["res_mask"].shape
    plain = dict(noisy, trans_sc=torch.zeros_like(noisy["trans_t"]),
                 aatypes_sc=F.one_hot(noisy["aatypes_t"], se3.NUM_TOKENS).float())
    sc = dict(noisy, trans_sc=noisy["trans_t"] + torch.randn(b, n, 3, generator=gen),
              aatypes_sc=torch.softmax(torch.randn(b, n, se3.NUM_TOKENS, generator=gen), -1))
    weights = {"pred_trans": torch.randn(b, n, 3, generator=gen),
               "pred_rotmats": torch.randn(b, n, 3, 3, generator=gen),
               "pred_logits": torch.randn(b, n, se3.NUM_TOKENS, generator=gen)}
    return {key: {"params": params, "batch": batch, "weights": weights}
            for key, batch in (("no_sc", plain), ("sc", sc))}


def _one_process(out, model_inputs):
    """Each variant's two steps in one process, the state at step 2 (saved
    under out/ckpt_one_multiflow) and after 4 steps, the model calls and
    the CLI run."""
    one = {}
    for dtype, fields in torch_dp.MTP_VARIANTS.items():
        with torch_dp.settings(fields=fields):
            one[dtype] = torch_dp.run_case("multiflow")
    one["resume"] = torch_dp.one_process_resume(out, "multiflow",
                                                torch_dp.MTP_VARIANTS["float32"],
                                                "ckpt_one_multiflow")
    for key, inputs in model_inputs.items():
        for dtype in torch_dp.MTP_VARIANTS:
            one["model", key, dtype] = torch_dp.multiflow_model_run(inputs, dtype)
    one["cli"] = torch_dp.mesh_cli(out, "train-multiflow", torch_dp.MTP_CLI, [], "mtp_cli_one")
    return one


@pytest.fixture(scope="module")
def mtp_run(tmp_path_factory):
    """The two-rank and four-rank results, the one-process references and
    reed_tpu's step, computed before the ranks start."""
    out = tmp_path_factory.mktemp("ipa_tensor_parallel")
    inputs, want = _jax_step()
    model_inputs = _model_inputs(inputs["params"])
    one = _one_process(out, model_inputs)
    torch.save({"step": inputs, "model": model_inputs}, out / "jax_multiflow_inputs.pt")
    torch_dp.spawn(out, "ipa_tensor_parallel")
    torch_dp.spawn(out, "ipa_tensor_parallel_mesh", world=4)
    two = [torch.load(out / f"mtp_rank{r}.pt", weights_only=False) for r in range(2)]
    four = [torch.load(out / f"mtp_mesh_rank{r}.pt", weights_only=False) for r in range(4)]
    return out, two, four, one, want


def _first(run):
    return {"metrics": [run["metrics"][0]], "grads": [run["grads"][0]]}


# --- against one process ----------------------------------------------------


def test_f32_step_at_tensor_2_matches_one_process(mtp_run):
    """Two f32 steps at tensor=2, on every rank, against one process, step
    by step."""
    out, two, _, one, _ = mtp_run
    cont = torch_dp.continued(out, torch_dp.first_ckpt("mtp_first_", "float32"), "multiflow",
                              torch_dp.MTP_VARIANTS["float32"])
    for r in two:
        torch_dp.check_f32_run(r["float32"], one["float32"], cont, REL, GRAD_FLOOR)


def test_bf16_step_at_tensor_2_is_as_close_as_one_process(mtp_run):
    """Two bf16 steps at tensor=2 against one process's, step by step: each
    within 2x one process's bf16 distance from its f32 step from the same
    state; the parameters after them too."""
    out, two, _, one, _ = mtp_run
    ckpt = torch_dp.first_ckpt("mtp_first_", "bfloat16")
    cont = torch_dp.continued(out, ckpt, "multiflow", torch_dp.MTP_VARIANTS["bfloat16"])
    cont32 = torch_dp.continued(out, ckpt, "multiflow", torch_dp.MTP_VARIANTS["float32"])
    names = list(one["bfloat16"]["params"])
    for r in two:
        got = r["bfloat16"]
        assert all(g.dtype == torch.float32 for g in got["grads"][0])
        torch_dp.check_bf16_step(0, got, _first(one["bfloat16"]), _first(one["float32"]),
                                 BF16_FACTOR, LOSSES)
        torch_dp.check_bf16_step(1, got, cont, cont32, BF16_FACTOR, LOSSES)
        p, w, w32 = (torch_dp.flat([d[n] for n in names])
                     for d in (got["params"], cont["params"], cont32["params"]))
        assert float((p - w).norm()) <= BF16_FACTOR * float((w - w32).norm())


@pytest.mark.parametrize("mesh_name", FOUR_RANK)
def test_step_on_four_ranks_matches_one_process(mtp_run, mesh_name):
    """data=2 x tensor=2 and fsdp=2 x tensor=2 (f32), on every rank, against
    one process, step by step."""
    out, _, four, one, _ = mtp_run
    cont = torch_dp.continued(out, torch_dp.first_ckpt("mtp_first_", mesh_name), "multiflow",
                              torch_dp.MTP_VARIANTS["float32"])
    for r in four:
        torch_dp.check_f32_run(r[mesh_name], one["float32"], cont, REL, GRAD_FLOOR)


@pytest.mark.parametrize("sc,dtype", MODEL_CASES)
def test_model_with_and_without_self_conditioning_matches_one_process(mtp_run, sc, dtype):
    """The FlowModel's outputs and the whole gradients of their weighted sum
    at tensor=2, with zero self-conditioning inputs and with seeded ones
    (trans_sc through the edge features' distogram, aatypes_sc through the
    node features), against one process. f32: each within REL of its
    largest magnitude (a gradient's floored at GRAD_FLOOR of the largest);
    bf16: the outputs and the whole gradient within 2x one process's bf16
    distance from its f32 call."""
    _, two, _, one, _ = mtp_run
    want, want32 = one["model", sc, dtype], one["model", sc, "float32"]
    names = list(want["grads"])
    least = GRAD_FLOOR * max(float(w.abs().max()) for w in want["grads"].values())
    for r in two:
        got = r["model", sc, dtype]
        assert list(got["grads"]) == names
        if dtype == "float32":
            for k, w in want["out"].items():
                assert float((got["out"][k] - w).abs().max()) <= REL * float(w.abs().max()), k
            for k, w in want["grads"].items():
                err = float((got["grads"][k] - w).abs().max())
                assert err <= REL * max(float(w.abs().max()), least), k
            continue
        for part in ("out", "grads"):
            g, w, w32 = (torch_dp.flat(d[part].values()) for d in (got, want, want32))
            assert float((g - w).norm()) <= BF16_FACTOR * float((w - w32).norm()), part


def test_tensor_ranks_hold_the_same_whole_parameters(mtp_run):
    """Joined over the tensor group, every rank's parameters after the steps
    are bitwise the same: the replicated leaves' gradients are averaged
    over the tensor group."""
    _, two, four, _, _ = mtp_run
    for key in torch_dp.MTP_VARIANTS:
        a, b = two[0][key]["params"], two[1][key]["params"]
        assert all(torch.equal(a[k], b[k]) for k in a), key
    for key in FOUR_RANK:
        ref = four[0][key]["params"]
        for r in four[1:]:
            assert all(torch.equal(r[key]["params"][k], v) for k, v in ref.items()), key


def test_rank_layout_and_shards(mtp_run):
    """Two ranks at tensor=2: one batch index (both take the whole batch),
    tensor indices 0 and 1; a rank keeps the state of its shards (the plan's
    reckoning, below the whole model's)."""
    _, two, _, _, _ = mtp_run
    assert [r["axes"] for r in two] == [(0, 0, 1, 0), (1, 0, 1, 1)]
    for r in two:
        res = r["float32"]["resident"]
        whole = sum(v.numel() for v in r["float32"]["params"].values())
        assert res["bytes"] == res["expected"] < 12 * whole


def test_checkpoint_written_at_tensor_2_resumes_in_one_process(mtp_run):
    """The file rank 0 wrote holds the ranks' whole state (parameters
    joined over the tensor group); one process restores it bit for bit."""
    out, two, _, one, _ = mtp_run
    saved = two[0]["resume"]["saved"]
    assert all(torch.equal(saved[k], two[1]["resume"]["saved"][k]) for k in saved)
    with torch_dp.settings(fields=torch_dp.MTP_VARIANTS["float32"]):
        trainer, _ = torch_dp.CASES["multiflow"]()
    state = trainer.init_state()
    checkpoint.CheckpointManager(out / "ckpt_mtp", save_interval_steps=2).restore(
        state, trainer.generator)
    assert state.step == 2 and state.opt.count == 2
    restored = torch_dp.state_tensors(state)
    assert set(restored) == set(saved)
    assert all(torch.equal(restored[k], saved[k]) for k in saved)
    assert not torch_dp.within(saved, one["resume"]["saved"], one["resume"]["lr"], REL)


def test_one_process_checkpoint_resumes_at_tensor_2(mtp_run):
    """Each rank restores the one-process checkpoint into its shards: joined
    back, the state is the one saved, bit for bit, and 2 more steps match
    the uninterrupted one-process run."""
    _, two, _, one, _ = mtp_run
    want = one["resume"]
    for r in two:
        res = r["resume"]
        assert res["step"] == 4
        assert all(torch.equal(res["restored"][k], want["saved"][k]) for k in want["saved"])
        assert not torch_dp.within(res["resumed"], want["straight"], want["lr"], REL)


@pytest.mark.parametrize("name", ["tp", "fsdp_tp"])
def test_cli_on_the_mesh_matches_one_process(mtp_run, name):
    """train-multiflow --distributed --tp 2 on two ranks and --fsdp 2 --tp 2
    on four (two steps, a checkpoint at step 2) against the same command in
    one process: every rank's whole state, and the files."""
    out, two, four, one, _ = mtp_run
    step, want = one["cli"]
    assert sorted(p.name for p in (out / f"mtp_cli_{name}").iterdir()) == sorted(
        p.name for p in (out / "mtp_cli_one").iterdir())
    runs = [r["cli"] for r in (two if name == "tp" else four)]
    for got_step, got in runs:
        assert got_step == step == 2
        assert set(got) == set(want)
        assert not torch_dp.within(got, want, one["float32"]["lr"], REL)
        assert all(torch.equal(got[k], runs[0][1][k]) for k in got if k.startswith("param/"))


# --- against reed_tpu on the same mesh --------------------------------------


def test_step_matches_reed_tpu_on_the_same_mesh(mtp_run):
    """tests/test_torch_multiflow_train.py's bounds: metrics to 1e-5; every
    gradient to 1e-4 of its largest (floored at 1e-4 of the step's largest:
    linear_b's bias moves each head's logits of a row by one constant,
    which the softmax ignores, so its gradient is rounding noise); the
    parameters to 2e-6 where reed_tpu's update moved them by more than 0.99
    lr, to 2 lr elsewhere; the EMA to 1e-6."""
    _, two, _, _, want = mtp_run
    floor = 1e-4 * max(float(w.abs().max()) for w in want["grads"].values())
    for r in two:
        got = r["jax"]
        assert set(got["metrics"][0]) == set(want["metrics"])
        for k, v in want["metrics"].items():
            np.testing.assert_allclose(got["metrics"][0][k], v, rtol=METRIC_TOL,
                                       atol=METRIC_TOL, err_msg=k)
        assert set(got["grads"]) == set(want["grads"])
        for n, g in got["grads"].items():
            w = want["grads"][n]
            assert float((g - w).abs().max()) <= GRAD_TOL * max(float(w.abs().max()), floor), n
        lr = want["lr"]
        for n, p in got["params"].items():
            moved = (want["params"][n] - want["before"][n]).abs() > 0.99 * lr
            diff = (p - want["params"][n]).abs()
            if moved.any():
                assert diff[moved].max().item() <= 2e-6, n
            assert diff.max().item() <= 2 * lr, n
            np.testing.assert_allclose(got["ema"][n].numpy(), want["ema"][n].numpy(), rtol=0,
                                       atol=1e-6, err_msg=n)


# --- without ranks -----------------------------------------------------------


def _flags(flax_params, flag_of):
    """{port name: whether flag_of(flax path) holds} through
    state_dict_from_flax (a leaf filled with 1.0 or 0.0)."""
    marked = jax.tree_util.tree_map_with_path(
        lambda path, leaf: np.full(np.shape(leaf), float(flag_of(
            "/".join(str(k.key) for k in path))), np.float32), flax_params)
    return {k: bool(np.asarray(v).reshape(-1)[0]) for k, v in state_dict_from_flax(marked).items()}


def _rule_of(path):
    for pattern, spec in jax_mesh.IPA_TP_RULES:
        if re.search(pattern, path):
            return spec
    return None


# replicated over the tensor axis in both packages, each for its reason
WHOLE = {
    "linear_b": "the pair bias [B,N,N,H] is made whole and a rank takes its heads",
    "down_z": "the pair features feed every head",
    "head_weights": "copied whole into the split attention, then sliced",
}


def test_tensor_rules_against_reed_tpus_ipa_rules():
    """The weights the port's ipa_tp_rules split are exactly those whose flax
    kernels reed_tpu's IPA_TP_RULES match, on the dimension its spec names
    (column rules on the torch weight's dimension 0, row rules on 1), in
    the port's groups (the point projections and in_proj in 3, linear_out
    in its blocks); beyond them only the column-parallel products' biases,
    which split with their columns. linear_b, down_z and head_weights are
    whole in both (WHOLE)."""
    jcfg = jmf.MultiflowTrainConfig(**torch_dp.MTP_PARITY)
    cfg = mf.MultiflowTrainConfig(**torch_dp.MTP_PARITY)
    _, params = _seeded(jcfg)
    rules = mf.tp_rules(cfg)
    matched = _flags(params, lambda path: _rule_of(path) is not None)
    column = _flags(params, lambda path: _rule_of(path) == P(None, jax_mesh.TENSOR_AXIS))
    port = {n: mesh.tensor_rule(n, rules) for n in matched}
    h, c, pv, cz = (cfg.ipa_no_heads, cfg.ipa_c_hidden, cfg.ipa_no_v_points, cfg.c_z)
    groups = {"linear_q_points": 3, "linear_kv_points": 3, "in_proj_weight": 3,
              "linear_out": (h * c,) + (h * pv,) * 4 + (h * cz // 4,)}
    n_weights = 0
    for name, hit in matched.items():
        leaf = name.rsplit(".", 2)[-2] if name.endswith(("weight", "bias")) else name
        if name.endswith("weight"):
            assert (port[name] is not None) == hit, name
            if hit:
                n_weights += 1
                key = "in_proj_weight" if name.endswith("in_proj_weight") else leaf
                assert port[name] == (0 if column[name] else 1, groups.get(key, 1)), name
        if any(f".{w}" in name for w in WHOLE):
            assert port[name] is None and not hit, name
    assert mesh.IPA_TP_RULES == mf.tp_rules(mf.MultiflowTrainConfig())
    # per block: the IPA's five, and four per sequence-transformer layer
    assert n_weights == cfg.num_blocks * (5 + 4 * cfg.seq_tfmr_num_layers)
    biases = {n: rule for n, rule in port.items() if rule is not None and n.endswith("bias")}
    assert len(biases) == cfg.num_blocks * (4 + 2 * cfg.seq_tfmr_num_layers)
    for n, rule in biases.items():
        assert port[n[:-len("bias")] + "weight"] == rule and rule[0] == 0, n


def _seeded_ipa(**widths):
    """A whole InvariantPointAttention with every parameter from a seeded
    normal, and its inputs."""
    ipa = InvariantPointAttention(**widths)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in ipa.parameters():
            p.copy_(0.3 * torch.randn(p.shape, generator=gen))
    b, n, c_s, c_z = 2, 7, widths["c_s"], widths["c_z"]
    quat = F.normalize(torch.randn(b, n, 4, generator=gen), dim=-1)
    args = (torch.randn(b, n, c_s, generator=gen), torch.randn(b, n, n, c_z, generator=gen),
            quat_to_rotmat(quat), torch.randn(b, n, 3, generator=gen),
            torch.ones(b, n))
    return ipa, args


@torch.no_grad()
def test_ipa_shards_summed_are_the_whole_ipa(monkeypatch):
    """Two tensor ranks' IPAs (each its heads out of linear_q, linear_kv and
    each xyz block of the point projections, and linear_out's rows out of
    each of its unequal blocks) return partials whose sum, with linear_out's
    bias once, is the whole IPA's output; with the point projections or
    linear_out split contiguously (groups 1) it is not."""
    widths = dict(c_s=24, c_z=16, c_hidden=8, no_heads=4, no_qk_points=3, no_v_points=5)
    whole, args = _seeded_ipa(**widths)
    want = whole(*args)
    rules = mesh.ipa_tp_rules(widths["no_heads"], widths["c_hidden"], widths["no_v_points"],
                              widths["c_z"])
    # one process plays both ranks: the row-parallel sum leaves each rank's
    # partial (plus the bias), and copy_to_tensor's forward is the identity
    monkeypatch.setattr(layers, "reduce_from_tensor", lambda x, dp: x)
    sd = {"trunk.ipa_0." + k: v for k, v in whole.state_dict().items()}
    bias = whole.linear_out.bias

    def summed(rules):
        total = -bias
        for t in range(2):
            parallel = types.SimpleNamespace(tensor=2, tensor_index=t, tensor_group=None)
            shard = InvariantPointAttention(**widths, parallel=parallel)
            shard.load_state_dict({k[len("trunk.ipa_0."):]: v for k, v in
                                   mesh.shard_state_dict(sd, parallel, rules).items()})
            total = total + shard(*args)
        return total

    assert float((summed(rules) - want).abs().max()) <= 1e-5 * float(want.abs().max())
    for wrong in ("linear_q_points", "linear_out"):
        name = f"trunk.ipa_0.{wrong}.weight"
        contiguous = tuple((p, d, 1) if re.search(p, name) else (p, d, g) for p, d, g in rules)
        bad = summed(contiguous)
        assert float((bad - want).abs().max()) > 1e-2 * float(want.abs().max()), wrong


def _attention(x, w_in, b_in, heads, w_out):
    """softmax(q kᵀ / √d) v through torch's packed [q; k; v] projection, and
    the output product without its bias."""
    b, n, _ = x.shape
    q, k, v = F.linear(x, w_in, b_in).view(b, n, 3 * heads, -1).transpose(1, 2).split(heads, 1)
    o = F.scaled_dot_product_attention(q, k, v).transpose(1, 2).reshape(b, n, -1)
    return o @ w_out.t()


@torch.no_grad()
def test_in_proj_split_in_three_groups_is_the_whole_attention():
    """The sequence transformer's attention: each rank its heads out of each
    of in_proj's q, k and v blocks (groups 3) and out_proj's matching
    input rows; the sum of the ranks' outputs is the whole attention's, and
    a contiguous split of in_proj is not."""
    gen = torch.Generator().manual_seed(1)
    d, heads = 32, 4
    w_in, b_in = torch.randn(3 * d, d, generator=gen) / d ** 0.5, torch.randn(3 * d, generator=gen)
    w_out = torch.randn(d, d, generator=gen) / d ** 0.5
    x = torch.randn(2, 9, d, generator=gen)
    want = _attention(x, w_in, b_in, heads, w_out)
    for groups, right in ((3, True), (1, False)):
        got = sum(_attention(x, mesh.tensor_split(w_in, (0, groups), 2, t),
                             mesh.tensor_split(b_in, (0, groups), 2, t), heads // 2,
                             mesh.tensor_split(w_out, (1, 1), 2, t)) for t in range(2))
        err = float((got - want).abs().max()) / float(want.abs().max())
        assert (err <= 1e-5) if right else (err > 1e-2), (groups, err)


def test_whole_state_dict_splits_and_joins():
    """shard_state_dict with the configuration's rules gives each tensor
    rank a state_dict of its model's shapes (the sharded FlowModel loads it
    strictly); tensor_join of every rank's shards gives the whole one back,
    bit for bit; rank 1's linear_out rows are its heads out of each block."""
    cfg = mf.MultiflowTrainConfig(**torch_dp.MTP_PARITY)
    rules = mf.tp_rules(cfg)
    sd = mf.build_model(cfg, generator=torch.Generator().manual_seed(0)).state_dict()
    shards = []
    for t in range(2):
        parallel = types.SimpleNamespace(tensor=2, tensor_index=t)
        shards.append(mesh.shard_state_dict(sd, parallel, rules))
        mf.build_model(cfg, parallel=parallel).load_state_dict(shards[-1])
    joined = {n: v if rule is None else mesh.tensor_join([s[n] for s in shards], rule)
              for n, v in sd.items() for rule in [mesh.tensor_rule(n, rules)]}
    assert all(torch.equal(joined[n], v) for n, v in sd.items())
    w = sd["trunk.ipa_0.linear_out.weight"]
    blocks = (32, 16, 16, 16, 16, 16)   # o, the point outputs' x, y, z and norms, o_pair
    mine = torch.cat([blk[:, blk.shape[1] // 2:] for blk in w.split(blocks, 1)], 1)
    assert torch.equal(shards[1]["trunk.ipa_0.linear_out.weight"], mine)
    # and the points: rank 1's heads of the x block are rows 8:16 of 16
    qp = sd["trunk.ipa_0.linear_q_points.weight"]
    assert torch.equal(shards[1]["trunk.ipa_0.linear_q_points.weight"][:8], qp[8:16])


def test_split_and_join_of_unequal_blocks_are_bitwise():
    """tensor_split and tensor_join with a rule of block widths: the whole
    back bit for bit at tensor 1, 2 and 4; blocks that do not make the
    dimension, or do not split, raise."""
    gen = torch.Generator().manual_seed(2)
    w = torch.randn(5, 128 + 4 * 96 + 256, generator=gen)
    rule = (1, (128, 96, 96, 96, 96, 256))
    for t in (1, 2, 4):
        shards = [mesh.tensor_split(w, rule, t, i) for i in range(t)]
        assert all(s.shape == (5, w.shape[1] // t) for s in shards)
        assert torch.equal(mesh.tensor_join(shards, rule), w)
    with pytest.raises(ValueError, match="do not make a dimension of"):
        mesh.tensor_split(w, (1, (128, 96)), 2, 0)
    with pytest.raises(ValueError, match="do not split over tensor=3"):
        mesh.tensor_split(w, rule, 3, 0)


def test_sizes_that_do_not_divide_raise():
    """IPA heads or sequence heads (and so c_s) that the tensor size does
    not divide raise ValueError naming them; the trainer runs the tensor
    axis (one process asked for tensor=2 raises with the torchrun line)."""
    parallel = types.SimpleNamespace(tensor=2, tensor_index=0)
    with pytest.raises(ValueError, match="tensor=2 does not divide the IPA's 3 units"):
        FlowModel(c_s=32, c_z=16, num_blocks=1, ipa_no_heads=3, parallel=parallel)
    with pytest.raises(ValueError, match="tensor=2 does not divide the sequence attention's "
                                         "3 units"):
        FlowModel(c_s=30, c_z=16, num_blocks=1, ipa_no_heads=4, seq_tfmr_num_heads=3,
                  parallel=parallel)
    with pytest.raises(ValueError, match="tensor=2 does not divide the 1 process.*torchrun"):
        mf.MultiflowTrainer(mf.MultiflowTrainConfig(mesh=MeshConfig(tensor=2)), device="cpu")
