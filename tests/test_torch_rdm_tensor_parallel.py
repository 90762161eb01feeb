"""reed_tpu_torch's tensor mesh axis on the RDM (train-rdm's SimpleMLP) over
gloo ranks on the CPU (tests/torch_dp.py: one spawn of two ranks and one of
four for the file), against one process and against reed_tpu's step on the
same mesh.

A rank holds T-th shards of each residual block (parallel/mesh.RDM_TP_RULES):
the columns of in_fc, emb_fc and context_fc with their biases, of out_norm's
scale and bias, and out_fc's matching rows, whose f32 partials the tensor
group sums once before the bias. out_norm normalises the rank's columns
with statistics summed over the group (nn/layers.split_layer_norm).

- The rdm case (channels 16, 64 wide x 3 blocks) without and with dropout
  at tensor=2, and with dropout at data=2 x tensor=2 and fsdp=2 x tensor=2
  on four ranks: two f32 steps, step by step, against one process (the
  second step against one process's from the checkpoint the ranks wrote
  after the first): every metric within REL of the step's largest, every
  gradient within REL of its own largest magnitude, the parameters after
  the steps within REL of the largest parameter (2 lr where the gradient
  is at rounding level). The tensor ranks' whole parameters bitwise equal.
- Checkpoints: one written at tensor=2 restores in one process bit for
  bit, and one written in one process restores at tensor=2 bit for bit;
  the resumed steps match the uninterrupted run.
- reed_tpu's RDMTrainer on MeshConfig(tensor=2) (the conftest's 8 CPU
  devices: data 4 absorbs the rest) from the same seeded-normal weights
  (out_fc included) with reed_tpu's t and noise handed over: the loss to
  1e-5, the parameters and the EMA after the step to 1e-6 of each one's
  size (tests/test_torch_rdm.py's bounds), every gradient to GRAD_RTOL of
  its largest.
- The split LayerNorm on two ranks against the whole one: the output and
  the input, scale and bias gradients within REL.
- train-rdm --distributed --tp 2 through the CLI against one process.
- Without ranks: the leaves the port's rules split against those reed_tpu's
  RDM_TP_RULES match; the split LayerNorm over stacked shards against the
  whole one; the split and join of whole state_dicts; sizes that do not
  divide.
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
from reed_tpu.diffusion.rdm import RDMDiffusion as JaxRDMDiffusion
from reed_tpu.encoders.rdm_convert import convert_torch_rdm
from reed_tpu.parallel import mesh as jax_mesh
from reed_tpu.train import rdm as jrdm
from reed_tpu_torch.core import checkpoint
from reed_tpu_torch.core.config import MeshConfig
from reed_tpu_torch.nn.layers import split_layer_norm
from reed_tpu_torch.parallel import mesh
from reed_tpu_torch.train import rdm as rt

torch.set_num_threads(1)

# a tensor=2 f32 run against one process: each quantity within REL of that
# tensor's largest magnitude (the split sums and statistics run in another
# order)
REL = 1e-5
# against reed_tpu: tests/test_torch_rdm.py's train step bounds, and each
# gradient within GRAD_RTOL of its largest
LOSS_RTOL = 1e-5
PARAM_RTOL = 1e-6
GRAD_RTOL = 1e-5
FOUR_RANK = list(torch_dp.RTP_MESHES_4)


def _seeded_weights():
    """The port's whole RDM of RTP_PARITY with every weight drawn from
    N(0, 0.2^2), the LayerNorm scales around 1 (tests/test_torch_rdm.py's
    _pair), out_fc included."""
    whole = rt.build_model(rt.RDMTrainConfig(**torch_dp.RTP_PARITY))
    gen = torch.Generator().manual_seed(0)
    return {k: (1.0 if "layers.0.weight" in k or k == "out.0.weight" else 0.0)
            + 0.2 * torch.randn(v.shape, generator=gen) for k, v in whole.state_dict().items()}


def _jax_step():
    """reed_tpu's RDM step (RTP_PARITY) on MeshConfig(tensor=2) from the
    seeded weights: the inputs the ranks take (weights, host batch, t and
    noise) and its gradient, loss, and parameters and EMA after the step, in
    reed_tpu's tree."""
    jcfg = jrdm.RDMTrainConfig(**torch_dp.RTP_PARITY, optim=JaxOptim(**torch_dp.RTP_OPTIM),
                               mesh=JaxMesh(tensor=2))
    jtrainer = jrdm.RDMTrainer(jcfg)
    sd = _seeded_weights()
    params = jax.tree.map(jnp.asarray, convert_torch_rdm(sd))
    r = np.random.default_rng(12)
    b, c = jcfg.batch_size, jcfg.channels
    batch = {"rep": r.standard_normal((b, c)).astype(np.float32),
             "num_atoms": r.integers(5, jcfg.max_nodes, size=b).astype(np.int32)}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    rng = jax.random.PRNGKey(13)
    step_rng = jax.random.fold_in(rng, 0)

    def loss(p):
        def model_fn(x_t, t, n):
            return jtrainer.model.apply({"params": p}, x_t, t, n, deterministic=False,
                                        rngs={"dropout": step_rng})
        return JaxRDMDiffusion(jtrainer.rdm_cfg, model_fn).training_loss(
            step_rng, jbatch["rep"], jbatch["num_atoms"]).mean()

    grads = jax.jit(jax.grad(loss))(params)
    state = jtrainer.init_state()
    state = state.replace(params=params, ema_params=jax.tree.map(jnp.copy, params),
                          opt_state=jtrainer.optimizer.init(params))
    with jtrainer.mesh:
        state, metrics = jtrainer.train_step(state, jbatch, rng)
    rng_t, rng_n = jax.random.split(step_rng)
    t = torch.from_numpy(np.array(jax.random.randint(rng_t, (b,), 0, jcfg.rdm.timesteps)))
    noise = torch.from_numpy(np.array(jax.random.normal(rng_n, (b, c))))
    inputs = {"params": sd, "batch": batch, "t": t, "noise": noise}
    return inputs, {"grads": grads, "params": state.params, "ema": state.ema_params,
                    "loss": float(metrics["denoising_loss"])}


def _layer_norm_inputs():
    """A [5, 64] input, a LayerNorm scale and bias and the output's weights,
    from a seeded normal (the input off zero mean, as a block's sum is)."""
    gen = torch.Generator().manual_seed(3)
    return {"x": 2.0 + torch.randn(5, 64, generator=gen),
            "weight": 1.0 + 0.3 * torch.randn(64, generator=gen),
            "bias": 0.3 * torch.randn(64, generator=gen),
            "weights": torch.randn(5, 64, generator=gen), "eps": 1e-5}


def _whole_layer_norm(inputs):
    """F.layer_norm's output and its input, scale and bias gradients."""
    x, w, b = (inputs[k].clone().requires_grad_(True) for k in ("x", "weight", "bias"))
    y = F.layer_norm(x, (x.shape[-1],), w, b, inputs["eps"])
    gx, gw, gb = torch.autograd.grad((y * inputs["weights"]).sum(), (x, w, b))
    return {"y": y.detach(), "x": gx, "weight": gw, "bias": gb}


def _one_process(out):
    """Each variant's two steps in one process, the state at step 2 (saved
    under out/ckpt_one_rdm) and after 4 steps, and the CLI run."""
    one = {}
    for p, fields in torch_dp.RTP_VARIANTS.items():
        with torch_dp.settings(fields=fields):
            one[p] = torch_dp.run_case("rdm")
    one["resume"] = torch_dp.one_process_resume(out, "rdm", torch_dp.RTP_VARIANTS[0.1],
                                                "ckpt_one_rdm")
    one["cli"] = torch_dp.mesh_cli(out, "train-rdm", torch_dp.RTP_CLI, [], "rtp_cli_one")
    return one


@pytest.fixture(scope="module")
def rtp_run(tmp_path_factory):
    """The two-rank and four-rank results, the one-process references and
    reed_tpu's step, computed before the ranks start."""
    out = tmp_path_factory.mktemp("rdm_tensor_parallel")
    inputs, want = _jax_step()
    one = _one_process(out)
    ln = _layer_norm_inputs()
    torch.save({"step": inputs, "layer_norm": ln}, out / "jax_rdm_inputs.pt")
    torch_dp.spawn(out, "rdm_tensor_parallel")
    torch_dp.spawn(out, "rdm_tensor_parallel_mesh", world=4)
    two = [torch.load(out / f"rtp_rank{r}.pt", weights_only=False) for r in range(2)]
    four = [torch.load(out / f"rtp_mesh_rank{r}.pt", weights_only=False) for r in range(4)]
    return out, two, four, one, dict(want, layer_norm=_whole_layer_norm(ln))


# --- against one process ----------------------------------------------------


@pytest.mark.parametrize("dropout", list(torch_dp.RTP_VARIANTS))
def test_step_at_tensor_2_matches_one_process(rtp_run, dropout):
    """Two f32 steps at tensor=2, without and with dropout (the mask drawn
    at the whole mid width, a rank's columns kept), on every rank, against
    one process, step by step."""
    out, two, _, one, _ = rtp_run
    cont = torch_dp.continued(out, torch_dp.first_ckpt("rtp_first_", str(dropout)), "rdm",
                              torch_dp.RTP_VARIANTS[dropout])
    for r in two:
        torch_dp.check_f32_run(r[dropout], one[dropout], cont, REL)


@pytest.mark.parametrize("mesh_name", FOUR_RANK)
def test_step_on_four_ranks_matches_one_process(rtp_run, mesh_name):
    """data=2 x tensor=2 and fsdp=2 x tensor=2 (dropout on), on every rank,
    against one process, step by step."""
    out, _, four, one, _ = rtp_run
    cont = torch_dp.continued(out, torch_dp.first_ckpt("rtp_first_", mesh_name), "rdm",
                              torch_dp.RTP_VARIANTS[0.1])
    for r in four:
        torch_dp.check_f32_run(r[mesh_name], one[0.1], cont, REL)


def test_tensor_ranks_hold_the_same_whole_parameters(rtp_run):
    """Joined over the tensor group, every rank's parameters after the steps
    are bitwise the same: the replicated leaves' gradients are averaged
    over the tensor group."""
    _, two, four, _, _ = rtp_run
    for key in torch_dp.RTP_VARIANTS:
        a, b = two[0][key]["params"], two[1][key]["params"]
        assert all(torch.equal(a[k], b[k]) for k in a), key
    for key in FOUR_RANK:
        ref = four[0][key]["params"]
        for r in four[1:]:
            assert all(torch.equal(r[key]["params"][k], v) for k, v in ref.items()), key


def test_rank_layout_and_shards(rtp_run):
    """Two ranks at tensor=2: one batch index (both take the whole batch),
    tensor indices 0 and 1; a rank holds its shards of the split leaves
    (the state it keeps is the plan's reckoning, below the whole model's)."""
    _, two, _, _, _ = rtp_run
    assert [r["axes"] for r in two] == [(0, 0, 1, 0), (1, 0, 1, 1)]
    for r in two:
        res = r[0.0]["resident"]
        whole = sum(v.numel() for v in r[0.0]["params"].values())
        assert res["bytes"] == res["expected"] < 12 * whole


def test_checkpoint_written_at_tensor_2_resumes_in_one_process(rtp_run):
    """The file rank 0 wrote holds the ranks' whole state (parameters
    joined over the tensor group); one process restores it bit for bit."""
    out, two, _, one, _ = rtp_run
    saved = two[0]["resume"]["saved"]
    assert all(torch.equal(saved[k], two[1]["resume"]["saved"][k]) for k in saved)
    with torch_dp.settings(fields=torch_dp.RTP_VARIANTS[0.1]):
        trainer, _ = torch_dp.CASES["rdm"]()
    state = trainer.init_state()
    checkpoint.CheckpointManager(out / "ckpt_rtp", save_interval_steps=2).restore(
        state, trainer.generator)
    assert state.step == 2 and state.opt.count == 2
    restored = torch_dp.state_tensors(state)
    assert set(restored) == set(saved)
    assert all(torch.equal(restored[k], saved[k]) for k in saved)
    assert not torch_dp.within(saved, one["resume"]["saved"], one["resume"]["lr"], REL)


def test_one_process_checkpoint_resumes_at_tensor_2(rtp_run):
    """Each rank restores the one-process checkpoint into its shards: joined
    back, the state is the one saved, bit for bit, and 2 more steps match
    the uninterrupted one-process run."""
    _, two, _, one, _ = rtp_run
    want = one["resume"]
    for r in two:
        res = r["resume"]
        assert res["step"] == 4
        assert all(torch.equal(res["restored"][k], want["saved"][k]) for k in want["saved"])
        assert not torch_dp.within(res["resumed"], want["straight"], want["lr"], REL)


def test_cli_on_the_mesh_matches_one_process(rtp_run):
    """train-rdm --distributed --tp 2 on two ranks (two steps, a checkpoint
    at step 2, the DDIM smoke sample from the joined EMA) against the same
    command in one process: every rank's whole state, and the files."""
    out, two, _, one, _ = rtp_run
    step, want = one["cli"]
    assert sorted(p.name for p in (out / "rtp_cli_tp").iterdir()) == sorted(
        p.name for p in (out / "rtp_cli_one").iterdir())
    runs = [r["cli"] for r in two]
    for got_step, got in runs:
        assert got_step == step == 2
        assert set(got) == set(want)
        assert not torch_dp.within(got, want, one[0.0]["lr"], REL)
        assert all(torch.equal(got[k], runs[0][1][k]) for k in got if k.startswith("param/"))


def test_split_layer_norm_on_two_ranks_is_the_whole_one(rtp_run):
    """out_norm split over two ranks (each its 32 of 64 columns, the
    statistics summed over the group, their gradients too): the output and
    the input, scale and bias gradients within REL of the whole
    LayerNorm's, on both ranks."""
    _, two, _, _, want = rtp_run
    for r in two:
        got = r["layer_norm"]
        for k, w in want["layer_norm"].items():
            err = float((got[k] - w).abs().max())
            assert err <= REL * float(w.abs().max()), (k, err)


# --- against reed_tpu on the same mesh --------------------------------------


def _close(name, ours, ref, rtol):
    ours, ref = np.asarray(torch.as_tensor(ours).detach()), np.asarray(ref)
    assert ours.shape == ref.shape, (name, ours.shape, ref.shape)
    err, scale = np.abs(ours - ref).max(), np.abs(ref).max()
    assert np.isfinite(ours).all() and err <= rtol * scale, (name, err, scale)


def test_step_matches_reed_tpu_on_the_same_mesh(rtp_run):
    """tests/test_torch_rdm.py's bounds: the loss to 1e-5; the parameters
    and the EMA after the step to 1e-6 of each one's size; every first-step
    gradient to GRAD_RTOL of its largest."""
    _, two, _, _, want = rtp_run
    for r in two:
        got = r["jax"]
        _close("loss", got["metrics"][0]["denoising_loss"], want["loss"], LOSS_RTOL)
        for key, rtol in (("grads", GRAD_RTOL), ("params", PARAM_RTOL), ("ema", PARAM_RTOL)):
            ours = convert_torch_rdm(got[key])
            leaves = jax.tree_util.tree_leaves_with_path(want[key])
            assert len(leaves) == len(got[key])
            for path, leaf in leaves:
                mine = ours
                for k in path:
                    mine = mine[k.key]
                _close(f"{key} {jax.tree_util.keystr(path)}", mine, leaf, rtol)


# --- without ranks -----------------------------------------------------------


def _rule_of(path):
    for pattern, spec in jax_mesh.RDM_TP_RULES:
        if re.search(pattern, path):
            return spec
    return None


def test_tensor_rules_against_reed_tpus_rdm_rules():
    """The weights the port's RDM_TP_RULES split are exactly those whose
    flax kernels reed_tpu's RDM_TP_RULES match, on the dimension its spec
    names (column rules on the torch weight's dimension 0, row rules on 1);
    beyond them only the column-parallel products' biases and out_norm's
    scale and bias, which split with the columns (the listed departures)."""
    cfg = rt.RDMTrainConfig(**torch_dp.RTP_PARITY)
    sd = rt.build_model(cfg).state_dict()
    # each port tensor filled with its index: the flax leaf it becomes says
    # which port name a flax path is
    ids = {name: torch.full(v.shape, float(i)) for i, (name, v) in enumerate(sd.items())}
    names = list(sd)
    tree = convert_torch_rdm(ids)
    port_of = {"/".join(str(k.key) for k in path): names[int(np.asarray(leaf).reshape(-1)[0])]
               for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}
    assert len(port_of) == len(sd)
    departures = {"in_layers.2.bias", "emb_layers.1.bias", "context_layers.1.bias",
                  "out_layers.0.weight", "out_layers.0.bias"}
    matched = 0
    for path, name in port_of.items():
        spec, rule = _rule_of(path), mesh.tensor_rule(name, mesh.RDM_TP_RULES)
        if spec is not None:
            matched += 1
            assert rule == (0 if spec == P(None, jax_mesh.TENSOR_AXIS) else 1, 1), (path, name)
        elif rule is not None:
            assert name.split(".", 2)[2] in departures, (path, name)
            assert rule == (0, 1), name
    assert matched == 4 * cfg.num_res_blocks


def test_split_layer_norm_over_stacked_shards_is_the_whole_one():
    """split_layer_norm over two shards stacked in one process, `total`
    summing over the stack (the all-reduce's forward, whose backward sums
    too): the output and every gradient within REL of the whole LayerNorm;
    with the gradients of the statistics left per shard (a sum whose
    backward is the identity, reduce_from_tensor's) the input gradient is
    wrong."""
    inputs = _layer_norm_inputs()
    want = _whole_layer_norm(inputs)

    def split(v):
        return torch.stack(v.chunk(2, dim=-1))

    def run(total):
        x, w, b = (inputs[k].clone().requires_grad_(True) for k in ("x", "weight", "bias"))
        y = split_layer_norm(split(x), split(w)[:, None], split(b)[:, None], inputs["eps"],
                             64, total)
        grads = torch.autograd.grad((y * split(inputs["weights"])).sum(), (x, w, b))
        return torch.cat(y.detach().unbind(), dim=-1), grads

    y, (gx, gw, gb) = run(lambda s: s.sum(0, keepdim=True).expand_as(s))
    for k, got in (("y", y), ("x", gx), ("weight", gw), ("bias", gb)):
        err = float((got - want[k]).abs().max())
        assert err <= REL * float(want[k].abs().max()), (k, err)

    class IdentityBackward(torch.autograd.Function):
        @staticmethod
        def forward(ctx, s):
            return s.sum(0, keepdim=True).expand_as(s).clone()

        @staticmethod
        def backward(ctx, g):
            return g

    _, (gx, _, _) = run(IdentityBackward.apply)
    assert float((gx - want["x"]).abs().max()) > 1e-2 * float(want["x"].abs().max())


def test_whole_state_dict_splits_and_joins():
    """shard_state_dict with RDM_TP_RULES gives each tensor rank a state_dict
    of its model's shapes (the sharded SimpleMLP loads it strictly: 32 of
    64 mid columns); tensor_join of every rank's shards gives the whole one
    back, bit for bit."""
    cfg = rt.RDMTrainConfig(**torch_dp.RTP_PARITY)
    sd = rt.build_model(cfg, generator=torch.Generator().manual_seed(0)).state_dict()
    shards = []
    for t in range(2):
        parallel = types.SimpleNamespace(tensor=2, tensor_index=t)
        shards.append(mesh.shard_state_dict(sd, parallel, mesh.RDM_TP_RULES))
        rt.build_model(cfg, parallel=parallel).load_state_dict(shards[-1])
    assert shards[1]["res_blocks.0.out_layers.0.weight"].shape == (32,)
    assert shards[1]["res_blocks.0.out_layers.3.weight"].shape == (64, 32)
    rules = [mesh.tensor_rule(n, mesh.RDM_TP_RULES) for n in sd]
    joined = {n: v if rule is None else mesh.tensor_join([s[n] for s in shards], rule)
              for (n, v), rule in zip(sd.items(), rules)}
    assert all(torch.equal(joined[n], v) for n, v in sd.items())


def test_sizes_that_do_not_divide_raise():
    """A tensor size that does not divide the mid width raises ValueError
    naming it; no trainer refuses the tensor axis."""
    parallel = types.SimpleNamespace(tensor=3, tensor_index=0)
    with pytest.raises(ValueError, match="tensor=3 does not divide the RDM block's mid "
                                         "width's 64 units"):
        rt.build_model(rt.RDMTrainConfig(**torch_dp.RTP_PARITY), parallel=parallel)
    with pytest.raises(ValueError, match="tensor=2 does not divide the 1 process.*torchrun"):
        rt.RDMTrainer(rt.RDMTrainConfig(mesh=MeshConfig(tensor=2)), device="cpu")
