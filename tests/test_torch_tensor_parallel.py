"""reed_tpu_torch's tensor and seq mesh axes on SiT (Megatron tensor
parallelism and token-sharded sequence parallelism) over gloo ranks on the
CPU (tests/torch_dp.py: one spawn of two ranks and one of four for the
file), against one process and against reed_tpu's step on the same mesh.

- The image case at 64 tokens (tiny SiT: depth 2, hidden 64, 4 heads,
  input 16, patch 2; an 'i' projector at depth 1 and a 't' projector at
  depth 2), two f32 steps at tensor=2, seq=2, data=2 x tensor=2, seq=2 x
  tensor=2 and fsdp=2 x tensor=2: every metric and every whole gradient
  the update saw within REL of that tensor's largest magnitude, every whole
  parameter after the steps within REL of the largest, on every rank. The 't' projector runs after
  the seq all-reduce on every rank: a gradient counted once per seq rank
  would be S times too large.
- The clip acting (grad_clip 0.5) at tensor=2 and seq=2: the norm sums
  the shards' squares over the tensor group.
- remat True and 'dots' at tensor=2 and seq=2, bitwise the step without:
  the recompute runs the blocks' collectives again, in one order.
- Checkpoints: one written at tensor=2 (or seq=2) restores in one process
  bit for bit, and one written in one process restores at tensor=2 (or
  seq=2) bit for bit; the resumed steps match the uninterrupted run.
- Sharded generation at tensor=2 and seq=2 equals one process's.
- reed_tpu's ImageTrainer on MeshConfig(tensor=2) and MeshConfig(seq=2)
  (the conftest's 8 CPU devices: data 4 absorbs the rest) from the same
  weights, with its t, eps and label drops handed over: the port's step
  at the same mesh within the image parity tolerances
  (tests/test_torch_image_train.py).
- train-image and generate-image through the CLI at --tp 2, --sp 2, --dp
  2 --tp 2 and --fsdp 2 --sp 2 against one process; each rank's groups.
- Without ranks: the rank layout against make_mesh, the tensor rule
  against reed_tpu's SIT_TP_RULES, fsdp_spec with a tensor dimension
  taken against reed_tpu's, the split and join of whole state_dicts, a
  tensor size that does not divide the heads, and K1's plain versions with
  queries of one length against keys of another against sdpa_xla.
"""

import itertools
import re
import types

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_dp
from reed_tpu.core.config import CurriculumConfig as JaxCurriculum
from reed_tpu.core.config import MeshConfig as JaxMesh
from reed_tpu.core.config import OptimConfig as JaxOptim
from reed_tpu.core.trainer import combine_losses as jax_combine_losses
from reed_tpu.diffusion.continuous import FlowMatchingLossConfig as JaxLoss
from reed_tpu.diffusion.paths import sample_time as jax_sample_time
from reed_tpu.models import sit as jax_sit
from reed_tpu.ops.attention import sdpa_xla
from reed_tpu.parallel import mesh as jax_mesh
from reed_tpu.train.image import ImageTrainConfig as JaxConfig
from reed_tpu.train.image import ImageTrainer as JaxTrainer
from reed_tpu.train.image import make_loss_fn as jax_make_loss_fn
from reed_tpu_torch import cli
from reed_tpu_torch.core import checkpoint
from reed_tpu_torch.encoders.sit_convert import state_dict_from_flax
from reed_tpu_torch.eval.fid import generate_samples
from reed_tpu_torch.models import sit as port_sit
from reed_tpu_torch.ops import flash_attention as fa
from reed_tpu_torch.parallel import mesh
from torch_parity import random_params

torch.set_num_threads(1)

# a parallel run against one process: each quantity within REL of that
# tensor's largest magnitude (the sums run in another order: read up to
# 6.2e-6 on the embedders' small second-step gradients at seq=2)
REL = 1e-5
GEN_REL = 1e-5
# against reed_tpu (tests/test_torch_image_train.py's f32 bounds)
METRIC_TOL = 1e-5
GRAD_TOL = 5e-4
TWO_RANK = ("tensor", "seq")
FOUR_RANK = tuple(torch_dp.TP_MESHES_4)
# the image case's config in reed_tpu's names (torch_dp._image at TP_FIELDS)
JAX_KW = dict(model="SiT-T/2", input_size=16, in_channels=4, num_classes=10,
              encoder_depth=1, encoder_depth_text=2, z_dims=(8, 6), z_types=("i", "t"),
              projector_dim=32, class_dropout_prob=0.5, batch_size=4,
              compute_dtype="float32")


@pytest.fixture(autouse=True)
def tiny_size(monkeypatch):
    monkeypatch.setitem(jax_sit._SIZES, "SiT-T", torch_dp.TINY_SIT)
    monkeypatch.setitem(port_sit._SIZES, "SiT-T", torch_dp.TINY_SIT)


def _jax_step(axes):
    """reed_tpu's image step on MeshConfig(**axes) from seeded weights:
    the inputs the ranks take (weights and batch in the port's layout, the
    step's t, eps and label drops) and its gradients (by port name),
    metrics, and parameters and EMA after it."""
    cfg = JaxConfig(**JAX_KW, loss=JaxLoss(enc_names=("dinov2", "qwen"),
                                           loss_weights=(1.0, 0.5)),
                    optim=JaxOptim(lr=1e-3, grad_clip=1.0),
                    curriculum=JaxCurriculum(proj_coeff=0.5, diffusion_warmup_steps=0),
                    mesh=JaxMesh(**axes))
    trainer = JaxTrainer(cfg)
    params = random_params(trainer.model, std=0.1, seed=0)["params"]
    jparams = jax.tree.map(jnp.asarray, params)
    rng = np.random.default_rng(1)
    b, tokens = cfg.batch_size, (cfg.input_size // 2) ** 2
    batch = {"x": rng.standard_normal((b, 16, 16, 4)).astype(np.float32),
             "y": rng.integers(0, cfg.num_classes, b).astype(np.int32),
             "zs": [rng.standard_normal((b, tokens, 8)).astype(np.float32),
                    rng.standard_normal((b, 6)).astype(np.float32)]}
    jbatch = jax.tree.map(jnp.asarray, batch)
    step_rng = jax.random.fold_in(trainer.train_rng, 0)
    rng_t, rng_eps, rng_model = jax.random.split(step_rng, 3)
    t = jax_sample_time(rng_t, b, cfg.loss.weighting, cfg.loss.path_type)
    eps = jax.random.normal(rng_eps, jbatch["x"].shape, jnp.float32)
    seen = []

    def capture(next_fun, args, kwargs, context):
        if isinstance(context.module, fnn.Embed) and context.method_name == "__call__":
            seen.append(np.asarray(args[0]))
        return next_fun(*args, **kwargs)

    with fnn.intercept_methods(capture):
        trainer.model.apply({"params": jparams}, jbatch["x"], t, jbatch["y"], train=True,
                            rngs={"label_dropout": rng_model})
    drop = seen[0] == cfg.num_classes
    assert drop.any() and not drop.all()
    loss_fn = jax_make_loss_fn(trainer.model, cfg.loss)
    grads = jax.jit(jax.grad(lambda p: jax_combine_losses(
        loss_fn(p, jbatch, step_rng, 0), 0, cfg.curriculum)[0]))(jparams)
    state = trainer.init_state()
    state = state.replace(params=jparams, ema_params=jax.tree.map(jnp.copy, jparams),
                          opt_state=trainer.optimizer.init(jparams))
    with trainer.mesh:
        state, metrics = trainer.train_step(state, jbatch, trainer.train_rng)
    to_port = lambda tree: state_dict_from_flax(jax.tree.map(np.asarray, tree), 2)
    inputs = {"params": to_port(params), "batch": batch,
              "draws": (np.asarray(t), np.asarray(eps), drop)}
    return inputs, {"grads": to_port(grads), "metrics": {k: float(v) for k, v in
                                                          metrics.items()},
                    "params": to_port(state.params), "ema": to_port(state.ema_params)}


def _one_process(ckpt_dir):
    """The image case in one process: two steps (clip 1.0 and 0.5), and
    its state at step 2 (saved under ckpt_dir) and after 4 steps."""
    with torch_dp.settings(fields=torch_dp.TP_FIELDS):
        one = {"image": torch_dp.run_case("image")}
        with torch_dp.settings(fields=torch_dp.TP_FIELDS, grad_clip=torch_dp.CLIPPED["image"]):
            one["clip"] = torch_dp.run_case("image")
        trainer, batches = torch_dp._image()
    batches += [trainer.synthetic_batch(torch.Generator().manual_seed(12 + i))
                for i in range(2)]
    state = trainer.init_state()
    mgr = checkpoint.CheckpointManager(ckpt_dir, save_interval_steps=2)
    for batch in batches[:2]:
        state, _ = trainer.train_step(state, batch)
    mgr.save(state, trainer.generator)
    one["saved"] = torch_dp.state_tensors(state)
    for batch in batches[2:]:
        state, _ = trainer.train_step(state, batch)
    one["straight"] = torch_dp.state_tensors(state)
    one["lr"] = trainer.cfg.optim.lr
    return one


@pytest.fixture(scope="module")
def tp_run(tmp_path_factory):
    """The two-rank and four-rank results, the one-process references and
    reed_tpu's steps, computed before the ranks start."""
    out = tmp_path_factory.mktemp("tensor_parallel")
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jax_sit._SIZES, "SiT-T", torch_dp.TINY_SIT)
        mp.setitem(port_sit._SIZES, "SiT-T", torch_dp.TINY_SIT)
        jax_steps = {name: _jax_step(torch_dp.TP_MESHES[name]) for name in TWO_RANK}
        one = _one_process(out / "ckpt_one_image")
    torch.save({name: inputs for name, (inputs, _) in jax_steps.items()},
               out / "jax_inputs.pt")
    torch_dp.spawn(out, "tensor_parallel")
    torch_dp.spawn(out, "tensor_parallel_mesh", world=4)
    two = [torch.load(out / f"tp_rank{r}.pt", weights_only=False) for r in range(2)]
    four = [torch.load(out / f"tp_mesh_rank{r}.pt", weights_only=False) for r in range(4)]
    return out, two, four, one, {k: v for k, (_, v) in jax_steps.items()}


def _noise(want):
    """Parameter elements whose gradient is at rounding level (below 1e-6 of
    the step's largest) on some step: Adam's first updates move them by up
    to lr whatever the gradient's digits."""
    names = list(want["params"])
    noise = {n: torch.zeros_like(p, dtype=torch.bool) for n, p in want["params"].items()}
    for gw in want["grads"]:
        top = max(float(g.abs().max()) for g in gw)
        for n, g in zip(names, gw):
            noise[n] |= g.abs() < 1e-6 * top
    return noise


def _check_run(got, want):
    """A run_case result against one process's: each metric within REL of
    the step's largest, each gradient within REL of that tensor's largest,
    each parameter within REL of the largest parameter, as the
    data-parallel tests hold them (the adaLN and final layers start at 0, so
    after two Adam steps their own scale is lr's; parameters whose gradient
    is at rounding level within 2 lr a step)."""
    for step, (mg, mw) in enumerate(zip(got["metrics"], want["metrics"])):
        assert set(mg) == set(mw)
        top = max(abs(v) for v in mw.values())
        bad = {k: (mg[k], mw[k]) for k in mw if abs(mg[k] - mw[k]) > REL * top}
        assert not bad, (step, bad)
    names = list(want["params"])
    for step, (gg, gw) in enumerate(zip(got["grads"], want["grads"])):
        for n, a, b in zip(names, gg, gw):
            assert a.shape == b.shape, n
            assert float((a - b).abs().max()) <= REL * float(b.abs().max()), (step, n)
    noise = _noise(want)
    top = max(float(w.abs().max()) for w in want["params"].values())
    for n, w in want["params"].items():
        diff = (got["params"][n] - w).abs()
        bound = torch.where(noise[n], 2 * 2 * want["lr"], REL * top)
        assert bool((diff <= bound).all()), (n, float(diff.max()))


# --- against one process ----------------------------------------------------


@pytest.mark.parametrize("mesh_name", TWO_RANK + FOUR_RANK)
def test_step_matches_one_process(tp_run, mesh_name):
    """Two image steps on the mesh, on every rank, against one process."""
    _, two, four, one, _ = tp_run
    runs = ([r[mesh_name, False] for r in two] if mesh_name in TWO_RANK
            else [r[mesh_name] for r in four])
    for got in runs:
        _check_run(got, one["image"])


@pytest.mark.parametrize("mesh_name", TWO_RANK)
def test_step_with_the_clip_acting_matches_one_process(tp_run, mesh_name):
    _, two, _, one, _ = tp_run
    assert all(m["grad_norm"] > torch_dp.CLIPPED["image"] for m in one["clip"]["metrics"])
    for r in two:
        _check_run(r[mesh_name, "clip"], one["clip"])


@pytest.mark.parametrize("mesh_name,remat", list(itertools.product(TWO_RANK, (True, "dots"))))
def test_remat_is_bitwise_the_step_without(tp_run, mesh_name, remat):
    _, two, _, _, _ = tp_run
    for r in two:
        a, b = r[mesh_name, remat], r[mesh_name, False]
        assert a["metrics"] == b["metrics"]
        assert all(torch.equal(x, y) for ga, gb in zip(a["grads"], b["grads"])
                   for x, y in zip(ga, gb))
        assert all(torch.equal(a["params"][k], v) for k, v in b["params"].items())


def _within(a, b, lr):
    """State tensors a against b: within REL of the largest of b (2 lr a step
    where a parameter's element moved by Adam's first updates alone)."""
    top = max(float(v.abs().max()) for v in b.values())
    return {k: float((a[k] - w).abs().max()) for k, w in b.items()
            if float((a[k] - w).abs().max()) > max(REL * top, 4 * lr if
                                                    k.startswith("param/") else 0.0)}


@pytest.mark.parametrize("mesh_name", TWO_RANK)
def test_checkpoint_written_on_the_mesh_resumes_in_one_process(tp_run, mesh_name):
    """The file rank 0 wrote holds the ranks' whole state (parameters
    joined over the tensor group); one process restores it bit for bit."""
    out, two, _, one, _ = tp_run
    saved = two[0][mesh_name, "resume"]["saved"]
    assert all(torch.equal(saved[k], two[1][mesh_name, "resume"]["saved"][k]) for k in saved)
    with torch_dp.settings(fields=torch_dp.TP_FIELDS):
        trainer, batches = torch_dp._image()
    state = trainer.init_state()
    checkpoint.CheckpointManager(out / f"ckpt_{mesh_name}", save_interval_steps=2).restore(
        state, trainer.generator)
    assert state.step == 2 and state.opt.count == 2
    restored = torch_dp.state_tensors(state)
    assert set(restored) == set(saved)
    assert all(torch.equal(restored[k], saved[k]) for k in saved)
    assert not _within(saved, one["saved"], one["lr"])


@pytest.mark.parametrize("mesh_name", TWO_RANK)
def test_one_process_checkpoint_resumes_on_the_mesh(tp_run, mesh_name):
    """Each rank restores the one-process checkpoint into its shards: joined
    back, the state is the one saved, bit for bit, and 2 more steps match
    the uninterrupted one-process run."""
    _, two, _, one, _ = tp_run
    for r in two:
        res = r[mesh_name, "resume"]
        assert res["step"] == 4
        assert all(torch.equal(res["restored"][k], one["saved"][k]) for k in one["saved"])
        assert not _within(res["resumed"], one["straight"], one["lr"])


@pytest.mark.parametrize("mesh_name", TWO_RANK)
def test_sharded_generation_matches_one_process(tp_run, mesh_name):
    _, two, _, _, _ = tp_run
    model = torch_dp.seeded_sit()
    want = generate_samples(lambda x, t, y: model(x, t, y)[0], torch_dp.gen_cfg(),
                            device="cpu")
    for r in two:
        got = r[mesh_name, "generate"]
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= GEN_REL * np.abs(want).max()


# --- against reed_tpu on the same mesh --------------------------------------


@pytest.mark.parametrize("mesh_name", TWO_RANK)
def test_step_matches_reed_tpu_on_the_same_mesh(tp_run, mesh_name):
    """Metrics to 1e-5; every gradient to 5e-4; the parameters after the
    step to 2e-6 where reed_tpu's gradient exceeds 1e-6 and to 2 lr
    elsewhere; the EMA to 1e-6 (tests/test_torch_image_train.py)."""
    _, two, _, _, jax_steps = tp_run
    want = jax_steps[mesh_name]
    for r in two:
        got = r[mesh_name, "jax"]
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
            assert diff.max().item() <= 2 * 1e-3, n
            np.testing.assert_allclose(got["ema"][n].numpy(), want["ema"][n].numpy(),
                                       rtol=0, atol=1e-6, err_msg=n)


# --- the CLI and the groups -------------------------------------------------


def _cli_one_process(out, tag):
    """train-image in one process as tp_cli runs it, and generate-image from
    the EMA of the checkpoint the ranks wrote."""
    state = cli.main(["train-image", "--device", "cpu", *torch_dp.CLI_TINY["train-image"],
                      "--steps", "2", "--log-every", "1", "--set", "input_size=16"])
    cli.main(["generate-image", "--device", "cpu", *torch_dp.CLI_TINY["generate-image"],
              *torch_dp.TP_GENERATE, "--ckpt-dir", str(out / f"cli_{tag}"),
              "--out", str(out / f"gen_one_{tag}.npz")])
    return state


@pytest.mark.parametrize("mesh_name", sorted(torch_dp.TP_CLI) + sorted(torch_dp.TP_CLI_4))
def test_cli_train_and_generate_image_on_the_mesh(tp_run, mesh_name):
    """train-image --distributed with the mesh flags: two steps, every
    rank's whole parameters equal and within REL of one process's (2 lr a
    step where a parameter moved by Adam's first updates alone), and its
    checkpoint one file of whole parameters; generate-image from that
    checkpoint's EMA on the mesh (rank 0 writes the npz) within GEN_REL of
    one process's."""
    out, two, four, _, _ = tp_run
    ranks = two if mesh_name in torch_dp.TP_CLI else four
    state = _cli_one_process(out, mesh_name)
    want = {f"param/{k}": v.detach() for k, v in state.model.named_parameters()}
    got = [r[mesh_name, "cli"] for r in ranks]
    for step, params in got:
        assert step == 2
        assert all(torch.equal(params[k], got[0][1][k]) for k in params)
        assert not _within({f"param/{k}": v for k, v in params.items()}, want,
                           state.opt.cfg.lr)
    ckpt = torch.load(out / f"cli_{mesh_name}" / "2.pt", weights_only=False)
    assert all(torch.equal(ckpt["model"][k], v) for k, v in got[0][1].items())
    gen = np.load(out / f"gen_cli_{mesh_name}.npz")["arr_0"]
    ref = np.load(out / f"gen_one_{mesh_name}.npz")["arr_0"]
    assert gen.shape == ref.shape == (4, 16, 16, 4)
    assert np.abs(gen - ref).max() <= GEN_REL * np.abs(ref).max()


def test_groups_on_four_ranks_are_make_meshs(tp_run):
    """Each rank's tensor, seq, fsdp, data, replica and batch groups are the
    ranks that share its indices on the other axes of make_mesh's layout."""
    _, _, four, _, _ = tp_run
    for name, axes in torch_dp.TP_MESHES_4.items():
        sizes = {a: axes.get(a, 1) for a in mesh.MESH_AXES}
        for rank, r in enumerate(four):
            for kind, ranks in r[name, "groups"].items():
                want = mesh.group_ranks(kind, rank, sizes)
                assert (ranks or [rank]) == want, (name, rank, kind)


# --- without ranks -----------------------------------------------------------


@pytest.mark.parametrize("shape", [(1, 1, 2, 2), (2, 1, 1, 2), (1, 2, 2, 1), (2, 2, 1, 2),
                                   (1, 2, 2, 2), (2, 1, 2, 2), (1, 1, 1, 8)])
def test_rank_layout_is_make_meshs(shape):
    """rank = ((d F + f) S + s) T + t: the device at [d, f, s, t] of
    make_mesh's array (devices taken in id order) has id rank, and the
    port's groups are its slices."""
    data, fsdp, seq, tensor = shape
    devices = sorted(jax.devices(), key=lambda d: d.id)
    grid = jax_mesh.make_mesh(data, fsdp, tensor, devices=devices, seq=seq).devices
    sizes = dict(zip(mesh.MESH_AXES, shape))
    for index in np.ndindex(*shape):
        coords = dict(zip(mesh.MESH_AXES, index))
        rank = mesh.mesh_rank(coords, sizes)
        assert grid[index].id == rank and mesh.mesh_coords(rank, sizes) == coords
    # the tensor group is T consecutive ranks; the replica group the ranks
    # of one tensor index
    assert mesh.group_ranks("tensor", 0, sizes) == list(range(tensor))
    assert mesh.group_ranks("replica", 0, sizes) == [int(d.id) for d in
                                                     grid[..., 0].reshape(-1)]
    assert mesh.group_ranks("batch", 0, sizes) == [int(d.id) for d in
                                                   grid[:, :, 0, 0].reshape(-1)]


def _flags(flax_params, flag_of):
    """{port name: whether flag_of(flax path) holds} through the SiT
    converter (a leaf filled with 1.0 or 0.0)."""
    flat = jax.tree_util.tree_flatten_with_path(flax_params)[0]
    paths = {"/".join(str(k.key) for k in path) for path, _ in flat}
    marked = jax.tree_util.tree_map_with_path(
        lambda path, leaf: np.full(np.shape(leaf), float(flag_of(
            "/".join(str(k.key) for k in path))), np.float32), flax_params)
    assert paths
    return {k: bool(v.reshape(-1)[0]) for k, v in state_dict_from_flax(marked, 2).items()}


def test_tensor_rule_shards_what_reed_tpus_sit_rules_match():
    """The port's rule names the weights whose flax kernels reed_tpu's
    SIT_TP_RULES match (column rules on the torch weight's dimension 0, row
    rules on 1), and beyond them the biases of the column-parallel qkv and
    fc1, which split with their columns; nothing else."""
    model = jax_sit.SiT(input_size=16, patch_size=2, hidden_size=64, depth=2, num_heads=4,
                        num_classes=10, encoder_depth=1, z_dims=(8,), projector_dim=32)
    params = random_params(model, std=0.1, seed=0)["params"]

    def rule_of(path):
        for pattern, spec in jax_mesh.SIT_TP_RULES:
            if re.search(pattern, path):
                return spec
        return None

    matched = _flags(params, lambda path: rule_of(path) is not None)
    column = _flags(params, lambda path: rule_of(path) == P(None, jax_mesh.TENSOR_AXIS))
    for name, hit in matched.items():
        rule = mesh.tensor_rule(name, mesh.SIT_TP_RULES)
        if name.endswith(".weight"):
            assert (rule is not None) == hit, name
            if hit:
                assert rule[0] == (0 if column[name] else 1), name
        else:
            want = name.endswith(("attn.qkv.bias", "mlp.fc1.bias"))
            assert (rule is not None) == want, name
    assert sum(matched.values()) == 4 * 2


def test_fsdp_spec_with_a_tensor_dimension_taken_matches_reed_tpu():
    """reed_tpu's fsdp_spec with a tensor spec on one dimension: the port's
    names the same dimension for fsdp, or none."""
    shapes = [(1152, 3456), (3456, 1152), (64, 192), (192, 64), (4608, 1152), (6, 4096),
              (8, 8192)]
    for shape in shapes:
        for taken in range(2):
            spec = [None, None]
            spec[taken] = jax_mesh.TENSOR_AXIS
            for fsdp in (2, 3, 4):
                for min_size in (mesh.FSDP_MIN_SIZE, 16):
                    got = jax_mesh.fsdp_spec(shape, fsdp, P(*spec), min_size=min_size)
                    assert got[taken] == jax_mesh.TENSOR_AXIS
                    want = [i for i, ax in enumerate(got) if ax is not None and i != taken]
                    port = mesh.fsdp_spec(shape, fsdp, min_size, taken=taken)
                    assert ([] if port is None else [port]) == want, (shape, taken, fsdp)


def test_split_and_join_of_a_whole_state_dict():
    """shard_state_dict gives a rank qkv's rows of its heads of q, k and v,
    fc1's rows and proj's and fc2's columns; ShardPlan.join_state_dict, the
    join a checkpoint writes through, is its inverse (here with a tensor
    group whose gather hands back every rank's shard)."""
    model = port_sit.create_sit("SiT-T/2", input_size=16, num_classes=10, encoder_depth=1,
                                z_dims=(8,), projector_dim=32)
    model.initialize_weights(torch.Generator().manual_seed(0))
    with torch.no_grad():
        for p in model.parameters():
            p.add_(torch.randn(p.shape, generator=torch.Generator().manual_seed(p.numel())))
    whole = model.state_dict()
    shards = [mesh.shard_state_dict(whole, types.SimpleNamespace(tensor=2, tensor_index=t),
                                    mesh.SIT_TP_RULES) for t in range(2)]
    qkv = whole["blocks.0.attn.qkv.weight"].reshape(3, 4, 16, 64)  # (q k v, heads, dim, in)
    for t, sd in enumerate(shards):
        assert torch.equal(sd["blocks.0.attn.qkv.weight"],
                           qkv[:, 2 * t:2 * t + 2].reshape(96, 64))
        assert torch.equal(sd["blocks.0.attn.proj.weight"],
                           whole["blocks.0.attn.proj.weight"][:, 32 * t:32 * t + 32])
        assert torch.equal(sd["blocks.0.mlp.fc1.bias"],
                           whole["blocks.0.mlp.fc1.bias"][128 * t:128 * t + 128])
        assert torch.equal(sd["blocks.0.mlp.fc2.bias"], whole["blocks.0.mlp.fc2.bias"])
    names = {id(v): k for k, v in shards[0].items()}
    dp = types.SimpleNamespace(fsdp=1, fsdp_min_size=mesh.FSDP_MIN_SIZE, tensor=2,
                               tensor_index=0,
                               tensor_gather=lambda t: [sd[names[id(t)]] for sd in shards])
    named = [(k, v) for k, v in shards[0].items() if k in dict(model.named_parameters())]
    plan = mesh.ShardPlan(dp, named, mesh.SIT_TP_RULES)
    joined = plan.join_state_dict(shards[0])
    assert set(joined) == set(whole)
    assert all(torch.equal(joined[k], whole[k]) for k in whole)


def test_sizes_that_do_not_divide_raise():
    parallel = types.SimpleNamespace(tensor=3, seq=1, tensor_index=0, seq_index=0)
    with pytest.raises(ValueError, match="tensor=3 does not divide the 4 attention heads"):
        port_sit.create_sit("SiT-T/2", input_size=16, parallel=parallel)
    parallel = types.SimpleNamespace(tensor=1, seq=3, tensor_index=0, seq_index=0)
    with pytest.raises(ValueError, match="seq=3 does not divide SiT's 64 tokens"):
        port_sit.create_sit("SiT-T/2", input_size=16, parallel=parallel)


@pytest.mark.parametrize("sq,sk", [(32, 64), (64, 32), (25, 64), (1, 7)])
def test_attention_references_with_queries_against_longer_keys(sq, sk):
    """sdpa_reference and flash_attention_reference (f32) with q [B, Sq, H,
    D] against k, v [B, Sk, H, D], as a seq rank calls K1, against reed_tpu's
    sdpa_xla, and against the rows of the full attention they are."""
    rng = np.random.default_rng(sq * 100 + sk)
    q, k, v = (rng.standard_normal((2, s, 4, 16)).astype(np.float32) for s in (sq, sk, sk))
    want = np.asarray(sdpa_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    for fn in (fa.sdpa_reference, fa.flash_attention_reference, fa.flash_attention):
        got = fn(tq, tk, tv)
        assert got.shape == (2, sq, 4, 16)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # the same rows of attention over queries and keys of one length
    full_q = torch.cat([tq, torch.from_numpy(
        rng.standard_normal((2, sk, 4, 16)).astype(np.float32))], dim=1)
    full = fa.sdpa_reference(full_q, tk, tv)
    torch.testing.assert_close(full[:, :sq], fa.sdpa_reference(tq, tk, tv))
