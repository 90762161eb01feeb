"""The port's EDM weight conversion: a port state_dict through reed_tpu's
converter (convert_torch_edm, the reference checkpoint layout with
`module.dynamics.` and `gamma.` keys) and back through the port's
state_dict_from_flax / gamma_state_dict_from_params is the identity for
every leaf, fake_latent and the attention stack included; a reference
checkpoint file loads straight into the port's modules, and one of the
wrong width is refused by name."""

import numpy as np
import pytest
import torch

from reed_tpu.encoders.edm_convert import convert_torch_edm
from reed_tpu_torch.diffusion.edm import GammaNetwork
from reed_tpu_torch.encoders import edm_convert
from reed_tpu_torch.models.egnn import EGNNDynamics
from torch_parity import EDM_TINY, edm_pair

torch.set_num_threads(1)


def _reference_state_dict(model, gamma):
    sd = {f"module.dynamics.{k}": v for k, v in model.state_dict().items()}
    sd.update({f"module.gamma.{k}": v for k, v in gamma.state_dict().items()})
    return sd


def _gamma(seed=3):
    net = GammaNetwork(hidden=8)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in net.parameters():
            p.copy_(torch.randn(p.shape, generator=gen))
    return net


@pytest.mark.parametrize("overrides", [{}, dict(attn_block_num=2, inv_sublayers=1),
                                       dict(rep_nf=None, attention=False)],
                         ids=["default", "two_attn_blocks", "no_rep_no_attention"])
def test_round_trip_through_reed_tpu(overrides):
    _, _, model = edm_pair(**overrides)
    gamma = _gamma()
    sd = _reference_state_dict(model, gamma)
    flax_params, gamma_params = convert_torch_edm({k: v.numpy() for k, v in sd.items()})
    back = edm_convert.state_dict_from_flax(flax_params)
    want = model.state_dict()
    assert set(back) == set(want)
    for k, v in want.items():
        assert torch.equal(back[k], v), k
    gback = edm_convert.gamma_state_dict_from_params(gamma_params)
    for k, v in gamma.state_dict().items():
        assert torch.equal(gback[k], v), k


def test_reference_checkpoint_loads(tmp_path):
    _, _, model = edm_pair()
    gamma = _gamma()
    path = tmp_path / "generative_model_ema.npy"
    torch.save(_reference_state_dict(model, gamma), path)
    dyn, gamma_sd = edm_convert.load_torch_edm_checkpoint(str(path))
    fresh = EGNNDynamics(**EDM_TINY)
    edm_convert.load_into(fresh, dyn)
    net = GammaNetwork(hidden=8)
    edm_convert.load_into(net, gamma_sd)
    t = torch.linspace(0, 1, 5)
    with torch.no_grad():
        assert torch.equal(net(t), gamma(t))
    for k, v in model.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k
    # a bare dynamics state dict has no schedule
    dyn2, none = edm_convert.split_edm_state_dict(model.state_dict())
    assert none is None and set(dyn2) == set(model.state_dict())
    wide = EGNNDynamics(**dict(EDM_TINY, hidden_nf=64))
    with pytest.raises((ValueError, RuntimeError)):
        edm_convert.load_into(wide, dyn)
    deeper = EGNNDynamics(**dict(EDM_TINY, n_layers=3))
    with pytest.raises(ValueError, match="missing"):
        edm_convert.load_into(deeper, dyn)


def test_torch_name_refuses_unknown_leaves():
    with pytest.raises(KeyError):
        edm_convert.torch_name(("egnn", "embedding", "mystery"))
    assert edm_convert.torch_name(("egnn", "attn_3_1", "ff_proj", "kernel")) == \
        "egnn.attns.3.1.ff.net.0.proj.weight"
    assert edm_convert.torch_name(("egnn", "e_block_2", "gcl_equiv", "coord_out",
                                   "kernel")) == "egnn.e_block_2.gcl_equiv.coord_mlp.4.weight"
    np.testing.assert_equal(edm_convert.torch_name(("fake_latent",)), "fake_latent")
