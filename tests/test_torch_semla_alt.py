"""reed_tpu_torch's alternative SemlaFlow generators (models/semla_alt.py)
against reed_tpu's on the CPU: VanillaEgnnGenerator and EqgatGenerator at
d_model 32 and 2 layers with the same seeded-normal weights (carried by
encoders/semla_convert.state_dict_from_flax) and the same inputs, f32:
every output to 1e-5 of its max, with and without self-conditioning and rep
conditioning; rotation equivariance of the coordinates and invariance of the
logits; one train step's metrics (1e-5) and every gradient (1e-4 of its
max) against jax.grad of reed_tpu's SemlaFlow loss with arch egnn / eqgat;
mixed precision against reed_tpu's bf16 forward (bound in its test); the
trainer's arch switch and the initialisation of the coordinate head."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reed_tpu.core.config import CurriculumConfig as JaxCurriculum
from reed_tpu.core.config import MeshConfig as JaxMesh
from reed_tpu.core.trainer import combine_losses as jax_combine_losses
from reed_tpu.diffusion.molecule_fm import MoleculeInterpolantConfig as JaxInterp
from reed_tpu.diffusion.molecule_fm import MoleculePriorConfig as JaxPrior
from reed_tpu.models import semla_alt as jalt
from reed_tpu.train.molecule_semla import SemlaTrainConfig as JaxConfig
from reed_tpu.train.molecule_semla import SemlaTrainer as JaxTrainer
from reed_tpu.train.molecule_semla import make_loss_fn as jax_make_loss_fn
from reed_tpu_torch.core.config import CurriculumConfig
from reed_tpu_torch.core.ema import ema_init
from reed_tpu_torch.core.train_state import make_optimizer
from reed_tpu_torch.core.trainer import combine_losses
from reed_tpu_torch.diffusion.molecule_fm import MoleculeInterpolantConfig, MoleculePriorConfig
from reed_tpu_torch.encoders.semla_convert import state_dict_from_flax
from reed_tpu_torch.models import semla_alt
from reed_tpu_torch.train import molecule_semla as ms
from torch_parity import semla_inputs, semla_random_params

torch.set_num_threads(1)
FWD_RTOL = 1e-5
METRIC_TOL = 1e-5
GRAD_RTOL = 1e-4
BASE = dict(d_model=32, vocab_size=6, n_atom_feats=6, d_edge=8, n_edge_types=5,
            n_charge_types=7, n_layers=2, d_rep=16)
CASES = {
    "egnn_sc_rep_align": (jalt.VanillaEgnnGenerator, semla_alt.VanillaEgnnGenerator,
                          dict(self_cond=True, rep_alignment=True, align_depth=(0, 1)), True),
    "egnn_plain": (jalt.VanillaEgnnGenerator, semla_alt.VanillaEgnnGenerator,
                   dict(self_cond=False), False),
    "eqgat_sc_rep": (jalt.EqgatGenerator, semla_alt.EqgatGenerator,
                     dict(self_cond=True, n_equi_feats=4), True),
    "eqgat_plain": (jalt.EqgatGenerator, semla_alt.EqgatGenerator,
                    dict(self_cond=False, n_equi_feats=4), False),
}


def _pair(case, dtype="float32"):
    jcls, tcls, kw, with_rep = CASES[case]
    kw = dict(BASE, **kw)
    inputs = semla_inputs(kw, batch=3, n=9)
    inputs.pop("times")
    jax_model = jcls(**kw, dtype=jnp.dtype(dtype))
    params = semla_random_params(jax_model, inputs, std=0.1)
    model = tcls(**kw, compute_dtype=getattr(torch, dtype)).eval()
    model.load_state_dict(state_dict_from_flax(params))
    if not with_rep:
        inputs.pop("rep")
    return jax_model, params, model, inputs


def _outputs(jax_model, params, model, inputs):
    ref = jax_model.apply({"params": jax.tree.map(jnp.asarray, params)},
                          **{k: jnp.asarray(v) for k, v in inputs.items()})
    with torch.no_grad():
        out = model(**{k: torch.tensor(v) for k, v in inputs.items()})
    return ref, out


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_matches_jax(case):
    jax_model, params, model, inputs = _pair(case)
    assert len(model.state_dict()) == len(jax.tree.leaves(params))
    ref, out = _outputs(jax_model, params, model, inputs)
    names = ["coords", "type_logits", "bond_logits", "charge_logits"]
    for name, a, b in zip(names, out[:4], ref[:4]):
        b = np.asarray(b)
        assert a.dtype == torch.float32, name
        err = np.abs(a.numpy() - b).max()
        assert err <= FWD_RTOL * np.abs(b).max(), (name, err, np.abs(b).max())
    assert len(out[4]) == len(ref[4])
    for a, b in zip(out[4], ref[4]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                   atol=FWD_RTOL * np.abs(np.asarray(b)).max())


@pytest.mark.parametrize("case", ["egnn_sc_rep_align", "eqgat_sc_rep"])
def test_equivariance(case):
    """Rotating the input (and self-conditioning) coordinates rotates the
    predicted coordinates and leaves the logits unchanged; the predicted
    coordinates are zero-CoM over the real atoms."""
    _, _, model, inputs = _pair(case)
    t = {k: torch.tensor(v) for k, v in inputs.items()}
    q, _ = torch.linalg.qr(torch.tensor(np.random.default_rng(4).standard_normal((3, 3)),
                                        dtype=torch.float32))
    with torch.no_grad():
        out = model(**t)
        rot = dict(t, coords=t["coords"] @ q.T, cond_coords=t["cond_coords"] @ q.T)
        out_r = model(**rot)
    scale = out[0].abs().max()
    assert (out_r[0] - out[0] @ q.T).abs().max() <= 1e-5 * scale
    for a, b in zip(out_r[1:4], out[1:4]):
        assert (a - b).abs().max() <= 1e-5 * b.abs().max()
    mask = t["atom_mask"][..., None]
    assert (out[0] * mask).sum(1).abs().max() < 1e-5


@pytest.mark.parametrize("case", ["egnn_sc_rep_align", "eqgat_sc_rep"])
def test_bf16_forward_follows_jax(case):
    """compute_dtype bfloat16 against reed_tpu's dtype=bfloat16 forward. Each
    framework rounds to bf16 at its own points (XLA on the CPU keeps f32
    inside a fusion), so the bound is 5e-2 of each output's max (2.1e-2 at
    most seen); the port must sit at least 0.2x reed_tpu's bf16 distance
    from the f32 forward (0.56x at least seen), so that a port computing in
    f32 fails."""
    jax_model, params, model, inputs = _pair(case, "bfloat16")
    ref, out = _outputs(jax_model, params, model, inputs)
    jf32, _, f32_model, _ = _pair(case)
    ref32, out32 = _outputs(jf32, params, f32_model, inputs)
    for a, b, c in zip(out[:4], ref[:4], ref32[:4]):
        b, c = np.asarray(b), np.asarray(c)
        assert a.dtype == torch.float32
        assert np.abs(a.numpy() - b).max() <= 5e-2 * np.abs(b).max()
        assert np.abs(a.numpy() - c).max() >= 0.2 * np.abs(b - c).max()


def test_check_config_and_arch_switch():
    for arch, cls in (("egnn", semla_alt.VanillaEgnnGenerator),
                      ("eqgat", semla_alt.EqgatGenerator)):
        cfg = ms.SemlaTrainConfig(arch=arch, d_model=32, n_layers=2, d_edge=8, d_rep=16)
        ms.check_config(cfg)
        model = ms.build_model(cfg, generator=torch.Generator().manual_seed(0))
        assert type(model) is cls
    with pytest.raises(ValueError, match="arch"):
        ms.check_config(ms.SemlaTrainConfig(arch="gvp"))


def test_coordinate_head_init():
    """phi_x_fc3 ~ variance_scaling(1e-6, fan_avg, uniform), as reed_tpu
    draws it: bounded by sqrt(3e-6 / fan_avg), spread over the bound."""
    model = semla_alt.VanillaEgnnGenerator(d_model=64, vocab_size=6, n_atom_feats=6,
                                           n_layers=2).initialize_weights(
        torch.Generator().manual_seed(0))
    limit = (3e-6 / ((64 + 1) / 2)) ** 0.5
    for layer in model.layers:
        w = layer.phi_x_fc3.weight
        assert w.abs().max() <= limit and w.abs().max() > 0.8 * limit
        assert (layer.phi_x_fc3.bias == 0).all()
        assert layer.phi_e_fc1.weight.std() > 100 * limit


# -- one train step against reed_tpu's --

TINY = dict(vocab_size=6, n_bond_types=5, n_charge_types=7, max_atoms=12, d_model=32,
            n_layers=2, d_edge=8, d_rep=16, rep_alignment=True, align_depth=(1,),
            batch_size=3, self_cond=True)
TRAIN_CASES = {
    "egnn_sc": ("egnn", True, dict()),
    "egnn_no_sc_cross_attn": ("egnn", False, dict(cond_type="cross_attn")),
    "eqgat_sc_adaLN": ("eqgat", True, dict(cond_type="adaLN")),
    "eqgat_no_sc": ("eqgat", False, dict()),
}


def _key_with_coin(use_sc):
    """A key whose step-0 self-conditioning coin comes out `use_sc`."""
    for k in range(100):
        key = jax.random.PRNGKey(k)
        coin = jax.random.uniform(jax.random.fold_in(jax.random.fold_in(key, 0), 1), ())
        if bool(coin > 0.5) == use_sc:
            return key
    raise AssertionError("no key")


@pytest.mark.parametrize("case", sorted(TRAIN_CASES))
def test_train_step_matches_jax(case):
    """Metrics to 1e-5 and every gradient to 1e-4 of its max, against
    jax.value_and_grad of reed_tpu's loss at step 0 with the same
    self-conditioning coin; then the port's whole step runs (optimizer and
    EMA) to finite parameters."""
    arch, use_sc, kw = TRAIN_CASES[case]
    jcfg = JaxConfig(**TINY, arch=arch, **kw,
                     interpolant=JaxInterp(prior=JaxPrior(vocab_size=6), coord_noise_std=0.2),
                     mesh=JaxMesh(data=1),
                     curriculum=JaxCurriculum(proj_coeff=0.2, diffusion_warmup_steps=0))
    tcfg = ms.SemlaTrainConfig(**TINY, arch=arch, **kw,
                               interpolant=MoleculeInterpolantConfig(
                                   prior=MoleculePriorConfig(vocab_size=6),
                                   coord_noise_std=0.2),
                               curriculum=CurriculumConfig(proj_coeff=0.2,
                                                           diffusion_warmup_steps=0))
    jtrainer = JaxTrainer(jcfg)
    kwm = dict(vocab_size=6, n_edge_types=5, d_edge=8, self_cond=True, d_rep=16)
    shape_inputs = semla_inputs(kwm, batch=2, n=8)
    params = semla_random_params(jtrainer.model, shape_inputs, std=0.1)
    batch = ms.example_batch(tcfg, 3, max_n=10, seed=1)
    jbatch = jax.tree.map(jnp.asarray, batch)
    curriculum = JaxCurriculum(**{**jcfg.curriculum.__dict__,
                                  "proj_coeff": jcfg.repa_loss_weight})
    loss_fn = jax_make_loss_fn(jtrainer.model, jcfg)
    step_rng = jax.random.fold_in(_key_with_coin(use_sc), 0)

    def total(p):
        metrics = loss_fn(p, jbatch, step_rng, 0)
        return jax_combine_losses(metrics, 0, curriculum)[0], metrics

    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(total, has_aux=True))(
        jax.tree.map(jnp.asarray, params))

    trainer = ms.SemlaTrainer(tcfg, device="cpu")
    state = trainer.init_state()
    state.model.load_state_dict(state_dict_from_flax(params))
    state.ema = ema_init(state.model)
    state.opt = make_optimizer(tcfg.optim, list(state.model.parameters()))
    tbatch = ms.batch_to_device(batch, "cpu")
    metrics = ms.make_loss_fn(tcfg)(state.model, tbatch, 0, use_sc=use_sc)
    loss, _ = combine_losses(metrics, 0, trainer.curriculum)
    assert set(metrics) == set(jmetrics)
    for k, v in list(jmetrics.items()) + [("loss", jloss)]:
        got = loss if k == "loss" else metrics[k]
        np.testing.assert_allclose(float(got.detach()), float(v), rtol=METRIC_TOL,
                                   atol=METRIC_TOL, err_msg=k)
    if arch == "eqgat":
        assert float(metrics["proj_loss"]) == 0.0
    names, leaves = zip(*state.model.named_parameters())
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    want = state_dict_from_flax(jax.tree.map(np.array, jgrads))
    assert set(want) == set(names)
    for name, g, p in zip(names, grads, leaves):
        g = torch.zeros_like(p) if g is None else g
        scale = want[name].abs().max().item()
        err = (g - want[name]).abs().max().item()
        assert err <= GRAD_RTOL * scale + 1e-12, (name, err, scale)

    state, metrics = trainer.train_step(state, tbatch, use_sc=use_sc)
    assert all(torch.isfinite(p).all() for p in state.model.parameters())
    assert torch.isfinite(metrics["loss"])


@pytest.mark.parametrize("arch", ["egnn", "eqgat"])
def test_generate_runs(arch):
    """The Euler integrator with either generator: finite molecules, zero-CoM
    coordinates, probabilities that sum to one."""
    cfg = ms.SemlaTrainConfig(**dict(TINY, arch=arch),
                              interpolant=MoleculeInterpolantConfig(
                                  prior=MoleculePriorConfig(vocab_size=6)))
    cfg = dataclasses.replace(cfg, integrator=dataclasses.replace(cfg.integrator, steps=3))
    trainer = ms.SemlaTrainer(cfg, device="cpu")
    state = trainer.init_state()
    mask = np.ones((2, 7), np.float32)
    mask[1, 5:] = 0
    prior = trainer.sample_prior(np.random.default_rng(0), mask)
    out = trainer.generate(state.model, prior, generator=torch.Generator().manual_seed(0))
    assert all(torch.isfinite(out[k]).all() for k in ("coords", "atomics", "bonds"))
    torch.testing.assert_close(out["atomics"].sum(-1), torch.ones(2, 7))
