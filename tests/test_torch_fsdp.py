"""reed_tpu_torch's fsdp mesh axis over gloo ranks on the CPU
(tests/torch_dp.py: one spawn of two ranks, and one of four for fsdp x
tensor): parameters sharded at rest, sharded gradients, Adam state,
accumulation buffer and EMA.

- The sharding plan shards exactly the leaves reed_tpu's fsdp_spec shards,
  leaf for leaf through each model's converter names, on the seven models
  at test width, for fsdp 2 and 4 at reed_tpu's min size and lowered ones.
- fsdp=2 equals data=2 bitwise on every trainer case when the clip is off:
  the metrics, every gradient the update saw, the parameters, the EMA, mu
  and nu (gathered), but grad_norm, whose squares the fsdp step sums in
  another order (chunks, then over the group): within GRAD_NORM_REL of it.
- With the clip acting, the clip's scale takes that norm, and everything
  after it is within CLIP_REL of the data=2 run's largest of its kind.
- The fsdp collectives (reduce_scatter_tensor and all_gather_into_tensor
  over the fsdp group) give the exact sum and the rows, in f32 and bf16.
- Each rank holds the plan's share of mu, nu, the EMA and acc, exactly,
  and of the parameters: on every trainer each sharded parameter is its
  chunk, in a storage of the chunk's size.
- _GatherChunks' backward hands each chunk what reduce_grads' sharded arm
  gave before the parameters were sharded at rest, bit for bit, in f32 and
  with a bf16 gather; its forward is the whole parameter cast.
- fsdp=2 under SiT remat equals data=2 under remat, as above.
- On four ranks, fsdp=2 x tensor=2 equals data=2 x tensor=2 as above (the
  image and protein cases), and both match reed_tpu's step on
  MeshConfig(fsdp=2, tensor=2) within the tensor-parallel tests' bounds.
- Checkpoints resume across fsdp sizes in both directions; every train-*
  subcommand and generate-image run with --fsdp 2 through the CLI.
"""

import types

import jax
import numpy as np
import pytest
import torch

import test_torch_protein_tensor_parallel as protein_tp
import test_torch_tensor_parallel as image_tp
import torch_dp
from reed_tpu.models import sit as jax_sit
from reed_tpu.parallel import mesh as jax_mesh
from reed_tpu_torch.core import checkpoint
from reed_tpu_torch.models import sit as port_sit
from reed_tpu_torch.parallel import mesh

torch.set_num_threads(1)

# fsdp=2 against data=2: grad_norm sums its squares in another order. The
# largest relative difference read on the seven cases was 1.03e-7 (the
# protein case, a few f32 ulps); the bound is 10x that
GRAD_NORM_REL = 1e-6
# with the clip acting the norm's last bits scale every gradient; read:
# 1.9e-7 (parameters), 1.1e-6 (mu), 2.5e-6 of a metric against its own
# size (the protein case's loss_pair, a sum of O(1) terms near 0) and
# 1.2e-7 against the largest metric; the bound is the 2-rank tolerance of
# tests/test_torch_data_parallel.py
CLIP_REL = 1e-5


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both ranks' results; the one-process protein run of 4 steps with its
    checkpoint at step 2 under ckpt_one, written before the ranks start."""
    out = tmp_path_factory.mktemp("fsdp")
    one = _one_process_protein(out / "ckpt_one")
    torch_dp.spawn(out, "fsdp")
    return out, [torch.load(out / f"fsdp_rank{r}.pt", weights_only=False)
                 for r in range(torch_dp.WORLD)], one


def _one_process_protein(ckpt_dir):
    """The protein case in one process: its state at step 2 (saved) and
    after 4 steps."""
    trainer, batches = torch_dp._protein()
    batches += [trainer.synthetic_batch(torch.Generator().manual_seed(12 + i))
                for i in range(2)]
    state = trainer.init_state()
    mgr = checkpoint.CheckpointManager(ckpt_dir, save_interval_steps=2)
    for batch in batches[:2]:
        state, _ = trainer.train_step(state, batch)
    mgr.save(state, trainer.generator)
    saved = torch_dp.state_tensors(state)
    for batch in batches[2:]:
        state, _ = trainer.train_step(state, batch)
    return {"saved": saved, "straight": torch_dp.state_tensors(state),
            "lr": trainer.cfg.optim.lr}


# --- the sharding rule, leaf for leaf -------------------------------------


def _id_tree(tree):
    """`tree` with leaf i filled with i + 1, and the leaves' shapes."""
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    shapes = [tuple(np.shape(x)) for x in leaves]
    return treedef.unflatten([np.full(s, i + 1, np.float32) for i, s in enumerate(shapes)]), shapes


def _from_flax(flax_tree, to_port):
    """{port name: flax leaf shape} through a flax -> port converter."""
    ided, shapes = _id_tree(flax_tree)
    out = {}
    for name, t in to_port(ided).items():
        ids = torch.unique(torch.as_tensor(t))
        assert len(ids) == 1, (name, ids)
        out[name] = shapes[int(ids[0]) - 1]
    return out


def _to_flax(model, to_flax):
    """{port name: flax leaf shape} through a port -> flax converter."""
    sd = {n: torch.full(p.shape, float(i + 1)) for i, (n, p) in
          enumerate(model.named_parameters())}
    names = list(sd)
    out = {}
    for leaf in jax.tree_util.tree_leaves(to_flax({k: v.numpy() for k, v in sd.items()})):
        ids = np.unique(np.asarray(leaf))
        assert len(ids) == 1, ids
        out[names[int(ids[0]) - 1]] = tuple(np.shape(leaf))
    return out


def _sit():
    from reed_tpu_torch.encoders.sit_convert import state_dict_from_flax
    from torch_parity import tiny_pair

    _, variables, model = tiny_pair()
    return model, _from_flax(variables, lambda v: state_dict_from_flax(v, 2))


def _protein():
    from reed_tpu_torch.encoders.fmif_convert import state_dict_from_flax
    from torch_parity import fmif_batch, tiny_fmif_pair

    _, variables, model = tiny_fmif_pair(fmif_batch())
    return model, _from_flax(variables, state_dict_from_flax)


def _semla():
    from reed_tpu_torch.encoders.semla_convert import state_dict_from_flax
    from torch_parity import semla_pair

    _, params, model, _ = semla_pair()
    return model, _from_flax(params, state_dict_from_flax)


def _edm():
    from reed_tpu_torch.encoders.edm_convert import state_dict_from_flax
    from torch_parity import edm_pair

    _, params, model = edm_pair()
    return model, _from_flax(params, state_dict_from_flax)


def _multiflow():
    from reed_tpu_torch.encoders.multiflow_convert import state_dict_from_flax
    from reed_tpu_torch.train import multiflow as mf
    from test_torch_multiflow_train import _configs, _seeded

    jcfg, tcfg = _configs()
    _, params = _seeded(jcfg)
    model = mf.MultiflowTrainer(tcfg, device="cpu").init_state().model
    return model, _from_flax(jax.tree.map(np.asarray, params), state_dict_from_flax)


def _rdm():
    from reed_tpu.encoders.rdm_convert import convert_torch_rdm
    from test_torch_rdm import _pair

    _, _, model = _pair()
    return model, _to_flax(model, convert_torch_rdm)


def _property():
    from reed_tpu.models.property_classifier import PropertyClassifier as JaxClassifier
    from reed_tpu_torch.encoders import property_convert
    from reed_tpu_torch.models.property_classifier import PropertyClassifier
    from test_torch_property import _inputs, _random_params

    params = _random_params(JaxClassifier(hidden_nf=16, n_layers=2), _inputs())
    model = PropertyClassifier(4, hidden_nf=16, n_layers=2)
    return model, _from_flax(params, property_convert.state_dict_from_flax)


MODELS = {"sit": _sit, "protein": _protein, "semla": _semla, "edm": _edm,
          "multiflow": _multiflow, "rdm": _rdm, "property": _property}


@pytest.mark.parametrize("model_name", sorted(MODELS))
def test_plan_shards_what_reed_tpus_fsdp_spec_shards(model_name):
    """For fsdp 2 and 4 and min sizes 65536 (reed_tpu's), 256 and 16: the
    plan shards a port parameter exactly when fsdp_spec shards its flax
    leaf, and the port's dimension rule says the same on the torch shape."""
    model, flax_shapes = MODELS[model_name]()
    named = list(model.named_parameters())
    assert set(flax_shapes) == {n for n, _ in named}
    counts = {}
    for fsdp in (2, 4):
        for min_size in (mesh.FSDP_MIN_SIZE, 256, 16):
            dp = types.SimpleNamespace(fsdp=fsdp, fsdp_min_size=min_size, fsdp_index=0)
            plan = mesh.ShardPlan(dp, named)
            for (name, p), sharded in zip(named, plan.sharded):
                shape = flax_shapes[name]
                assert p.numel() == int(np.prod(shape)), name
                spec = jax_mesh.fsdp_spec(shape, fsdp, min_size=min_size)
                want = any(ax is not None for ax in spec)
                assert sharded == want, (name, tuple(p.shape), shape, fsdp, min_size)
            counts[fsdp, min_size] = sum(plan.sharded)
    # the lowered sizes shard some of each model and keep some replicated
    assert counts[2, 16] > 0 and counts[2, 16] < len(named), counts


def test_fsdp_spec_matches_reed_tpu_on_shapes():
    """The port's copy of fsdp_spec names reed_tpu's dimension (the rule's
    order of preference), on shapes that exercise each clause."""
    shapes = [(8,), (4, 4), (256, 256), (3, 512, 129), (7, 65536), (65536, 3), (6, 3, 8192),
              (1152, 4608), (2, 2, 65536), (5, 5, 5, 1000)]
    for shape in shapes:
        for fsdp in (1, 2, 3, 4):
            for min_size in (mesh.FSDP_MIN_SIZE, 1):
                spec = jax_mesh.fsdp_spec(shape, fsdp, min_size=min_size)
                want = [i for i, ax in enumerate(spec) if ax is not None]
                got = mesh.fsdp_spec(shape, fsdp, min_size)
                assert ([] if got is None else [got]) == want, (shape, fsdp, min_size)


# --- fsdp=2 against data=2 -------------------------------------------------


def _bitwise_differences(a, b, skip=("grad_norm",)):
    """The quantities of two run_case results that are not bitwise equal."""
    out = []
    for step, (ma, mb) in enumerate(zip(a["metrics"], b["metrics"])):
        assert set(ma) == set(mb)
        out += [f"step {step} metric {k}" for k in mb if k not in skip and ma[k] != mb[k]]
    for step, (ga, gb) in enumerate(zip(a["grads"], b["grads"])):
        assert len(ga) == len(gb)
        out += [f"step {step} grad {i}" for i, (x, y) in enumerate(zip(ga, gb))
                if not torch.equal(x, y)]
    out += [f"param {k}" for k in b["params"] if not torch.equal(a["params"][k], b["params"][k])]
    sa, sb = a["state"], b["state"]
    out += [f"ema {k}" for k in sb["ema"] if not torch.equal(sa["ema"][k], sb["ema"][k])]
    for key in ("mu", "nu", "acc"):
        if sb[key] is not None:
            out += [f"{key} {i}" for i, (x, y) in enumerate(zip(sa[key], sb[key]))
                    if not (x.dtype == y.dtype and torch.equal(x, y))]
    return out


def _norm_rel(a, b):
    return max(abs(ma["grad_norm"] - mb["grad_norm"]) / mb["grad_norm"]
               for ma, mb in zip(a["metrics"], b["metrics"]))


@pytest.mark.parametrize("case", sorted(torch_dp.CASES))
def test_fsdp2_is_data2_bitwise_without_the_clip(ranks, case):
    _, results, _ = ranks
    for rank, r in enumerate(results):
        fsdp, data = r["fsdp", case], r["data", case]
        assert not _bitwise_differences(fsdp, data), (rank, _bitwise_differences(fsdp, data))
        assert _norm_rel(fsdp, data) <= GRAD_NORM_REL
    # both ranks hold the same whole state
    a, b = (r["fsdp", case] for r in results)
    assert not _bitwise_differences(a, b, skip=())


def test_cases_shard_and_the_rest_is_replicated(ranks):
    """At the tests' min size every case but the linear probe (12 x 1) holds
    less than the whole state; the linear probe holds it all."""
    _, results, _ = ranks
    for case in torch_dp.CASES:
        res = results[0]["fsdp", case]["resident"]
        if case == "linear_probe":
            assert res["bytes"] == res["whole"]
        else:
            assert res["bytes"] < 0.6 * res["whole"], (case, res)


@pytest.mark.parametrize("case", sorted(torch_dp.CLIPPED))
def test_fsdp2_with_the_clip_acting(ranks, case):
    """Each quantity within CLIP_REL of the largest of its kind in the data=2
    run (a metric against the step's largest metric)."""
    _, results, _ = ranks
    for r in results:
        fsdp, data = r["fsdp_clip", case], r["data_clip", case]
        clip = torch_dp.CLIPPED[case]
        assert data["metrics"][0]["grad_norm"] > clip, "the clip does not act"
        assert _norm_rel(fsdp, data) <= GRAD_NORM_REL
        for ma, mb in zip(fsdp["metrics"], data["metrics"]):
            top = max(abs(v) for v in mb.values())
            assert all(abs(ma[k] - mb[k]) <= CLIP_REL * top for k in mb), (ma, mb)
        groups = [(fsdp["grads"][s], data["grads"][s]) for s in range(2)]
        groups.append((list(fsdp["params"].values()), list(data["params"].values())))
        groups.append((list(fsdp["state"]["ema"].values()), list(data["state"]["ema"].values())))
        groups += [(fsdp["state"][k], data["state"][k]) for k in ("mu", "nu")]
        for got, want in groups:
            top = max(float(w.abs().max()) for w in want)
            err = max(float((g.double() - w.double()).abs().max()) for g, w in zip(got, want))
            assert err <= CLIP_REL * top, (case, err, top)


def test_reduce_scatter_and_all_gather_are_exact(ranks):
    """Rank f's reduce-scatter is row f of the sum of the two ranks'
    buffers (a sum of two numbers is exact whatever the order), and every
    rank's all-gather is the ranks' rows in rank order, bit for bit."""
    _, results, _ = ranks
    for dtype in (torch.float32, torch.bfloat16):
        got = [r["collectives"][dtype] for r in results]
        total = got[0]["buf"] + got[1]["buf"]
        rows = torch.stack([g["row"] for g in got])
        for f, g in enumerate(got):
            assert g["mine"].dtype == dtype and torch.equal(g["mine"], total[f])
            assert torch.equal(g["rows"], rows)


@pytest.mark.parametrize("key", [("fsdp", "protein"), ("fsdp", "image"), ("fsdp", "semla"),
                                 ("fsdp", "multiflow"), ("fsdp_accum", "image")])
def test_resident_state_is_the_plans_share(ranks, key):
    """mu (bf16 in the accumulation case), nu, the EMA and acc hold the
    plan's elements: 1/F of the sharded leaves and all of the replicated
    ones, byte for byte."""
    _, results, _ = ranks
    for r in results:
        res = r[key]["resident"]
        assert res["bytes"] == res["expected"], res
        assert res["bytes"] < res["whole"]
    if key[0] == "fsdp_accum":
        acc = results[0][key]["state"]
        assert acc["acc"] is not None and acc["mu"][0].dtype == torch.bfloat16


def _within(a, b, lr, noise=None):
    """a against b: each tensor within 1e-5 of the largest of b, elements
    marked `noise` within 2 lr a step (as the data-parallel tests)."""
    top = max(float(v.abs().max()) for v in b.values())
    bad = {}
    for k, w in b.items():
        diff = (a[k].double() - w.double()).abs()
        bound = torch.full_like(diff, 1e-5 * top)
        if noise is not None and k.startswith("param/"):
            bound = torch.where(noise[k], 2 * 2 * lr, bound)
        if not bool((diff <= bound).all()):
            bad[k] = float(diff.max())
    return bad


def test_checkpoint_written_at_fsdp2_resumes_in_one_process(ranks):
    """The file rank 0 wrote holds the ranks' whole state; one process
    restores it bit for bit and its 2 more steps match the uninterrupted
    one-process run."""
    out, results, one = ranks
    saved = results[0]["resume"]["saved"]
    assert all(torch.equal(saved[k], results[1]["resume"]["saved"][k]) for k in saved)
    trainer, batches = torch_dp._protein()
    batches += [trainer.synthetic_batch(torch.Generator().manual_seed(12 + i))
                for i in range(2)]
    state = trainer.init_state()
    checkpoint.CheckpointManager(out / "ckpt_here", save_interval_steps=2).restore(
        state, trainer.generator)
    assert state.step == 2 and state.opt.count == 2
    restored = torch_dp.state_tensors(state)
    assert set(restored) == set(saved)
    assert all(torch.equal(restored[k], saved[k]) for k in saved)
    for batch in batches[2:]:
        state, _ = trainer.train_step(state, batch)
    assert not _within(torch_dp.state_tensors(state), one["straight"], one["lr"])


def test_one_process_checkpoint_resumes_at_fsdp2(ranks):
    """Each fsdp=2 rank restores the one-process checkpoint into its chunks:
    gathered back, the state is the one saved, bit for bit, and 2 more
    steps match the uninterrupted one-process run."""
    _, results, one = ranks
    for r in results:
        res = r["resume"]
        assert res["sharded"] > 0 and res["step"] == 4
        assert all(torch.equal(res["restored"][k], one["saved"][k]) for k in one["saved"])
        assert not _within(res["resumed"], one["straight"], one["lr"])


def test_cli_train_protein_fsdp2(ranks):
    """train-protein --distributed --fsdp 2: rank 0 alone writes, both ranks
    end with the same whole state, and the checkpoint loads in one
    process."""
    out, results, _ = ranks
    assert sorted(p.name for p in (out / "cli").iterdir()) == [
        "2.pt", "config.json", "metrics.jsonl"]
    assert results[0]["cli_sharded"] > 0
    a, b = results[0]["cli"], results[1]["cli"]
    assert all(torch.equal(a[k], b[k]) for k in a)
    ckpt = torch.load(out / "cli" / "2.pt", weights_only=False)
    assert all(torch.equal(ckpt["ema"][k[4:]], v) for k, v in a.items() if k.startswith("ema/"))


@pytest.mark.parametrize("cmd", sorted(torch_dp.CLI_TINY))
def test_every_subcommand_runs_with_fsdp2(ranks, cmd, monkeypatch):
    """Each train-* subcommand takes 2 steps on two ranks at --fsdp 2 with
    its leaves sharded, both ranks ending with the same parameters;
    generate-image writes its npz."""
    monkeypatch.setitem(port_sit._SIZES, "SiT-T", torch_dp.TINY_SIT)
    out, results, _ = ranks
    a, b = (r["cli_all"][cmd] for r in results)
    if cmd == "generate-image":
        assert a is None and b is None
        with np.load(out / "gen_cli.npz") as f:
            assert f["arr_0"].shape[0] == 4 and np.isfinite(f["arr_0"]).all()
        return
    assert a[0] == b[0] == 2 and a[1] == b[1] > 0
    assert all(torch.equal(a[2][k], b[2][k]) for k in a[2])


# --- the parameters sharded at rest -----------------------------------------

# the seven trainers' cases
TRAINERS = ("image", "protein", "semla", "edm", "multiflow", "rdm", "property")


@pytest.mark.parametrize("case", TRAINERS)
def test_resident_parameters_are_the_plans_share(ranks, case):
    """On each rank every sharded parameter is a storage of exactly its
    chunk's elements, and the model's parameters hold the plan's resident
    elements: less than the whole model."""
    _, results, _ = ranks
    for r in results:
        res = r["fsdp", case]["resident"]
        assert res["chunk_storage"], "nothing is sharded"
        assert all(held == chunk for held, chunk in res["chunk_storage"]), res
        assert res["params"] == res["params_expected"] < res["params_whole"], res


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gather_backward_is_reduce_grads_old_sharded_arm(ranks, dtype):
    """The gathered tensors are the whole parameters cast to the gather
    dtype; the chunk gradients are f32 and bitwise the old arm's."""
    _, results, _ = ranks
    for r in results:
        res = r["gather_unit"]
        assert res["sharded"] == [True, False, True]
        got = res[dtype]
        assert all(g.dtype == dtype and torch.equal(g, w)
                   for g, w in zip(got["gathered"], got["whole"]))
        assert all(g.dtype == torch.float32 and torch.equal(g, w)
                   for g, w in zip(got["got"], got["old"]))
    # each rank holds its own chunk of the same sum
    a, b = (r["gather_unit"][dtype]["got"] for r in results)
    assert not any(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fsdp2_with_remat_is_data2_with_remat(ranks, dtype):
    """SiT remat=True: the blocks gather again in their recompute."""
    _, results, _ = ranks
    for r in results:
        fsdp, data = r["fsdp_remat", dtype], r["data_remat", dtype]
        assert not _bitwise_differences(fsdp, data), _bitwise_differences(fsdp, data)
        assert _norm_rel(fsdp, data) <= GRAD_NORM_REL
        res = fsdp["resident"]
        assert res["params"] == res["params_expected"] < res["params_whole"]


@pytest.fixture(scope="module")
def fsdp_tensor(tmp_path_factory):
    """The four ranks' results, and reed_tpu's image and protein steps on
    MeshConfig(fsdp=2, tensor=2) (the conftest's 8 CPU devices: data 2),
    computed before the ranks start."""
    out = tmp_path_factory.mktemp("fsdp_tensor")
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jax_sit._SIZES, "SiT-T", torch_dp.TINY_SIT)
        mp.setitem(port_sit._SIZES, "SiT-T", torch_dp.TINY_SIT)
        image_inputs, image_want = image_tp._jax_step(torch_dp.FT_JAX_AXES)
    protein_inputs, protein_want = protein_tp._jax_step(torch_dp.FT_JAX_AXES)
    torch.save({"image": image_inputs, "protein": protein_inputs}, out / "ft_inputs.pt")
    torch_dp.spawn(out, "fsdp_tensor", world=4)
    image_want["lr"] = 1e-3  # torch_dp._image's
    return ([torch.load(out / f"ft_rank{r}.pt", weights_only=False) for r in range(4)],
            {"image": image_want, "protein": protein_want})


@pytest.mark.parametrize("case", ["image", "protein"])
def test_fsdp2_x_tensor2_is_data2_x_tensor2(fsdp_tensor, case):
    """As fsdp=2 against data=2, on each of four ranks; each holds the chunk
    of its tensor shard of every sharded parameter."""
    results, _ = fsdp_tensor
    for r in results:
        fsdp, data = r["fsdp_tensor", case], r["data_tensor", case]
        assert not _bitwise_differences(fsdp, data), _bitwise_differences(fsdp, data)
        assert _norm_rel(fsdp, data) <= GRAD_NORM_REL
        res = fsdp["resident"]
        assert res["chunk_storage"] and all(a == b for a, b in res["chunk_storage"])
        assert res["params"] == res["params_expected"] < res["params_whole"]


@pytest.mark.parametrize("mesh_name", sorted(torch_dp.FT_MESHES))
@pytest.mark.parametrize("case", ["image", "protein"])
def test_fsdp2_x_tensor2_matches_reed_tpu(fsdp_tensor, case, mesh_name):
    """The port's step from reed_tpu's weights, batch and draws against
    reed_tpu's step on MeshConfig(fsdp=2, tensor=2): metrics to 1e-5, every
    gradient to 5e-4, the parameters after the step to 2e-6 where reed_tpu's
    gradient exceeds 1e-6 and to 2 lr elsewhere, the EMA to 1e-6
    (tests/test_torch_tensor_parallel.py, tests/test_torch_protein_tensor_parallel.py)."""
    results, wants = fsdp_tensor
    want = wants[case]
    for r in results:
        got = r[mesh_name, f"{case}_jax"]
        assert set(got["metrics"]) == set(want["metrics"])
        for k, v in want["metrics"].items():
            np.testing.assert_allclose(got["metrics"][k], v, rtol=image_tp.METRIC_TOL,
                                       atol=image_tp.METRIC_TOL, err_msg=k)
        assert set(got["grads"]) == set(want["grads"])
        for n, g in got["grads"].items():
            np.testing.assert_allclose(g.numpy(), want["grads"][n].numpy(),
                                       rtol=image_tp.GRAD_TOL, atol=image_tp.GRAD_TOL, err_msg=n)
        for n, p in got["params"].items():
            big = want["grads"][n].abs() > 1e-6
            diff = (p - want["params"][n]).abs()
            if big.any():
                assert diff[big].max().item() <= 2e-6, n
            assert diff.max().item() <= 2 * want["lr"], n
            np.testing.assert_allclose(got["ema"][n].numpy(), want["ema"][n].numpy(),
                                       rtol=0, atol=1e-6, err_msg=n)
