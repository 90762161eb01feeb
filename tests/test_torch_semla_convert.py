"""SemlaFlow weights between the port, reed_tpu and the reference torch
layout, on the CPU: a port state_dict (in the reference's layout, size
table of max_atoms rows) goes through reed_tpu's own converter into flax
params that give reed_tpu's model the port's outputs, with the same leaves
as the model's; `state_dict_from_flax` maps every flax leaf (the
RepConditioner's and the time embedding's included) and loads strictly
into the port, so nothing is left over in either direction; a
Lightning-style checkpoint with the `ema_gen.module.` prefix loads through
`load_torch_semla_checkpoint`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reed_tpu.encoders.semla_convert import convert_torch_semla as jax_convert
from reed_tpu.models.semla import SemlaGenerator as JaxSemla
from reed_tpu_torch.encoders import semla_convert
from reed_tpu_torch.models.semla import SemlaGenerator
from torch_parity import SEMLA_TINY, semla_inputs, semla_random_params

torch.set_num_threads(1)


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, prefix + (k,)))
        return out
    return {prefix: np.asarray(tree)}


def _port_model(seed=0, **kw):
    model = SemlaGenerator(**dict(SEMLA_TINY, **kw)).initialize_weights(
        torch.Generator().manual_seed(seed))
    with torch.no_grad():
        for p in model.parameters():  # no bias or norm left at its init value
            p.add_(torch.randn(p.shape, generator=torch.Generator().manual_seed(1)) * 0.05)
    return model.eval()


def test_reed_tpu_converter_reads_the_port_state_dict():
    model = _port_model()
    sd = model.state_dict()
    reference = dict(sd, **{"size_emb.weight": sd["size_emb.weight"][:-1]})
    params = jax_convert(reference)
    inputs = semla_inputs(SEMLA_TINY)
    jax_model = JaxSemla(**SEMLA_TINY)
    shapes = jax.eval_shape(lambda: jax_model.init(
        jax.random.PRNGKey(0), **{k: jnp.asarray(v) for k, v in inputs.items()}))["params"]
    got, want = _leaves(params), _leaves(jax.tree.map(lambda s: np.zeros(s.shape), shapes))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].shape == want[k].shape, k
    jout = jax_model.apply({"params": jax.tree.map(jnp.asarray, params)},
                           **{k: jnp.asarray(v) for k, v in inputs.items()})
    with torch.no_grad():
        tout = model(**{k: torch.from_numpy(v) for k, v in inputs.items()})
    for a, b in zip(tout[:4], jout[:4]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                   atol=1e-5 * np.abs(np.asarray(b)).max())
    # and back: every flax leaf lands on the state_dict entry it came from
    back = semla_convert.state_dict_from_flax(params)
    assert back.keys() == sd.keys()
    for k in sd:
        want_k = sd[k] if k != "size_emb.weight" else torch.cat(
            [sd[k][:-1], torch.zeros_like(sd[k][:1])])
        assert torch.equal(back[k], want_k), k


@pytest.mark.parametrize("cond_type", ["adaLN", "cross_attn"])
def test_state_dict_from_flax_covers_every_leaf(cond_type):
    kw = dict(SEMLA_TINY, cond_type=cond_type, align_depth=(0, 2))
    jax_model = JaxSemla(**kw)
    params = semla_random_params(jax_model, semla_inputs(kw))
    sd = semla_convert.state_dict_from_flax(params)
    assert len(sd) == len(_leaves(params))
    assert any(".rep_cond." in k for k in sd) and any("time_embedder" in k for k in sd)
    model = SemlaGenerator(**kw)
    missing, unexpected = model.load_state_dict(sd, strict=False)
    assert not missing and not unexpected
    with pytest.raises(KeyError):
        semla_convert.state_dict_from_flax({"dynamics": {"odd": {"leaf": np.zeros(2)}}})


def test_load_lightning_checkpoint(tmp_path):
    model = _port_model(seed=3)
    sd = model.state_dict()
    ckpt = {"state_dict": {**{f"gen.{k}": v * 2 for k, v in sd.items()
                              if k != "size_emb.weight"},
                           **{f"ema_gen.module.{k}": v for k, v in sd.items()
                              if k != "size_emb.weight"},
                           "gen.size_emb.weight": sd["size_emb.weight"][:-1],
                           "ema_gen.module.size_emb.weight": sd["size_emb.weight"][:-1],
                           "ema_gen.n_averaged": torch.tensor(3)}}
    path = str(tmp_path / "last.ckpt")
    torch.save(ckpt, path)
    other = SemlaGenerator(**SEMLA_TINY)
    semla_convert.load_into(other, semla_convert.load_torch_semla_checkpoint(path))
    for k, v in other.state_dict().items():
        want = sd[k] if k != "size_emb.weight" else torch.cat(
            [sd[k][:-1], torch.zeros_like(sd[k][:1])])
        assert torch.equal(v, want), k
    semla_convert.load_into(other, semla_convert.load_torch_semla_checkpoint(path, ema=False))
    assert torch.equal(other.state_dict()["feat_proj.0.weight"], 2 * sd["feat_proj.0.weight"])
    with pytest.raises(ValueError, match="lacks"):
        semla_convert.load_into(SemlaGenerator(**dict(SEMLA_TINY, cond_type="adaLN")),
                                semla_convert.load_torch_semla_checkpoint(path))
