"""SiT activation checkpointing (`remat`) in reed_tpu_torch, on the CPU.

- Against reed_tpu's SiT with the same weights and remat=True or 'dots'
  (its nn.remat of the blocks): the velocity, the projections, a loss and
  every gradient within the SiT parity tolerances (tests/test_torch_sit.py,
  tests/test_torch_image_train.py).
- Against the port without remat: a generator-driven image train step
  (t, eps and label drops drawn from the trainer's generator) in f32 and
  bf16 under each setting gives the same metrics and gradients, bitwise
  (the recompute runs the same kernels on the same inputs), and so over
  two gloo ranks at data=2 and at fsdp=2 (tests/torch_dp.py, one spawn for
  the file).
- What each policy saves: 'dots' keeps the linear layers' products (no mm
  or addmm is recomputed in the backward, the attention's bmm are), True
  recomputes them, 'dots_saveable' keeps bmm too; 'nothing_saveable' is
  True and 'everything_saveable' is False; another name raises.
- The blocks draw no random numbers, so the recompute sees the forward's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import torch_dp
from reed_tpu_torch.encoders.sit_convert import state_dict_from_flax
from reed_tpu_torch.models import sit as port_sit
from reed_tpu_torch.models.sit import REMAT_POLICIES, remat_saves
from torch_parity import tiny_inputs, tiny_pair

torch.set_num_threads(1)

ATOL = 2e-4      # the SiT forward parity tolerance (tests/test_torch_sit.py)
GRAD_TOL = 5e-4  # the image gradient parity tolerance (tests/test_torch_image_train.py)
REMATS = (False, True, "dots", "dots_with_no_batch_dims_saveable",
          "checkpoint_dots_with_no_batch_dims", "dots_saveable", "checkpoint_dots",
          "nothing_saveable", "everything_saveable")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("remat")
    torch_dp.spawn(out, "remat")
    return [torch.load(out / f"remat_rank{r}.pt", weights_only=False)
            for r in range(torch_dp.WORLD)]


def _loss(v, zs):
    return (v ** 2).mean() + sum((z ** 2).mean() for z in zs)


@pytest.mark.parametrize("remat", [True, "dots"])
def test_remat_matches_reed_tpu(remat):
    jax_model, variables, model = tiny_pair(std=0.1, remat=remat)
    model.train()
    x, t, y = tiny_inputs()

    def jax_loss(params):
        v, zs = jax_model.apply(params, x, t, y, train=False, return_zs=True)
        return _loss(v, zs), (v, zs)

    (jloss, (jv, jzs)), jgrads = jax.value_and_grad(jax_loss, has_aux=True)(
        jax.tree.map(jnp.asarray, variables))
    v, zs = model(torch.tensor(x), torch.tensor(t), torch.tensor(y).long(), return_zs=True)
    loss = _loss(v, zs)
    names, leaves = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(v.detach().numpy(), np.asarray(jv), atol=ATOL, rtol=0)
    for a, b in zip(zs, jzs):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), atol=ATOL, rtol=0)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    want = state_dict_from_flax(jax.tree.map(np.asarray, jgrads), 2)
    for name, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=name)


def _step(remat, dtype):
    with torch_dp.settings(fields={"remat": remat, "compute_dtype": dtype}, grad_clip=None):
        return torch_dp.run_case("image")


def _same_step(got, want):
    """Metrics equal; every gradient within 1e-6 of the step's largest (they
    read bitwise); parameters and state equal."""
    assert got["metrics"] == want["metrics"]
    for gg, gw in zip(got["grads"], want["grads"]):
        top = max(float(g.abs().max()) for g in gw)
        assert all(float((a - b).abs().max()) <= 1e-6 * top for a, b in zip(gg, gw))
        assert all(torch.equal(a, b) for a, b in zip(gg, gw))
    assert all(torch.equal(got["params"][k], v) for k, v in want["params"].items())
    assert all(torch.equal(got["state"]["ema"][k], v) for k, v in want["state"]["ema"].items())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("remat", REMATS[1:])
def test_generator_driven_step_equals_no_remat(remat, dtype, monkeypatch):
    monkeypatch.setitem(port_sit._SIZES, "SiT-T", torch_dp.TINY_SIT)
    _same_step(_step(remat, dtype), _step(False, dtype))


@pytest.mark.parametrize("mesh", ["data", "fsdp"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("remat", [True, "dots"])
def test_remat_on_two_ranks_equals_no_remat(ranks, mesh, dtype, remat):
    for r in ranks:
        _same_step(r[mesh, dtype, remat], r[mesh, dtype, False])
    if mesh == "fsdp":
        res = ranks[0][mesh, dtype, remat]["resident"]
        assert res["bytes"] == res["expected"] < res["whole"]


class _Count(TorchDispatchMode):
    """Counts the aten ops run inside the block, by name."""

    def __init__(self):
        super().__init__()
        self.n = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        self.n[name] = self.n.get(name, 0) + 1
        return func(*args, **(kwargs or {}))


def _backward_ops(remat):
    """The aten ops the backward of a tiny SiT (plain attention) runs."""
    torch_dp.register_tiny_sit()
    model = port_sit.create_sit("SiT-T/2", input_size=8, in_channels=4, num_classes=10,
                                encoder_depth=1, z_dims=(8,), projector_dim=16,
                                attn_impl="reference", remat=remat)
    gen = torch.Generator().manual_seed(0)
    v, zs = model(torch.randn(4, 8, 8, 4, generator=gen), torch.rand(4, generator=gen),
                  torch.randint(0, 10, (4,), generator=gen), train=True,
                  drop=torch.zeros(4, dtype=torch.bool))
    with _Count() as count:
        torch.autograd.grad(_loss(v, zs), list(model.parameters()))
    return count.n


def test_what_each_policy_saves(monkeypatch):
    """Two blocks: each recomputes its 5 linear products (qkv, proj, fc1,
    fc2, adaLN: addmm) under True and none under 'dots', its 2 attention
    products (bmm) under True and 'dots' and none under 'dots_saveable'."""
    monkeypatch.setitem(port_sit._SIZES, "SiT-T", torch_dp.TINY_SIT)
    base = _backward_ops(False)
    full, dots, dots_bmm = (_backward_ops(r) for r in (True, "dots", "dots_saveable"))
    depth = torch_dp.TINY_SIT["depth"]
    assert full.get("addmm", 0) - base.get("addmm", 0) == 5 * depth
    assert dots.get("addmm", 0) == base.get("addmm", 0)
    assert full["bmm"] - base["bmm"] == dots["bmm"] - base["bmm"] == 2 * depth
    assert dots_bmm["bmm"] == base["bmm"] and dots_bmm.get("addmm", 0) == base.get("addmm", 0)
    assert full["native_layer_norm"] == dots["native_layer_norm"] > base.get(
        "native_layer_norm", 0)
    assert _backward_ops("nothing_saveable") == full
    assert _backward_ops("everything_saveable") == base


def test_policy_names():
    assert remat_saves(False) is None and remat_saves("everything_saveable") is None
    assert remat_saves(True) == () == remat_saves("nothing_saveable")
    assert remat_saves("dots") == remat_saves("dots_with_no_batch_dims_saveable") == (
        "mm", "addmm") == remat_saves("checkpoint_dots_with_no_batch_dims")
    assert remat_saves("dots_saveable") == remat_saves("checkpoint_dots") == (
        "mm", "addmm", "bmm", "baddbmm")
    assert set(REMAT_POLICIES) == set(REMATS[2:])
    for bad in ("save_anything_except_these_names", "dot", "offload_dot_with_no_batch_dims"):
        with pytest.raises(ValueError, match="dots_saveable"):
            remat_saves(bad)


def test_unknown_policy_raises_in_the_trainer(monkeypatch):
    from reed_tpu_torch.train.image import ImageTrainConfig, build_model

    monkeypatch.setitem(port_sit._SIZES, "SiT-T", torch_dp.TINY_SIT)
    cfg = ImageTrainConfig(model="SiT-T/2", input_size=8, num_classes=10, encoder_depth=1,
                           z_dims=(8,), projector_dim=16, remat="dots_savable")
    with pytest.raises(ValueError, match="remat policy 'dots_savable' is not supported"):
        build_model(cfg, device="cpu")


def test_blocks_draw_no_random_numbers(monkeypatch):
    """A training forward under remat with the label drops drawn from a
    generator leaves torch's global random state where it was: the
    checkpoint's replay of that state has nothing to replay."""
    monkeypatch.setitem(port_sit._SIZES, "SiT-T", torch_dp.TINY_SIT)
    model = port_sit.create_sit("SiT-T/2", input_size=8, in_channels=4, num_classes=10,
                                encoder_depth=1, z_dims=(8,), projector_dim=16,
                                attn_impl="reference", remat=True)
    before = torch.get_rng_state()
    gen = torch.Generator().manual_seed(0)
    v, zs = model(torch.zeros(4, 8, 8, 4), torch.full((4,), 0.5), torch.arange(4), train=True,
                  generator=gen)
    torch.autograd.grad(_loss(v, zs), list(model.parameters()))
    assert torch.equal(torch.get_rng_state(), before)
