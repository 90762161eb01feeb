"""reed_tpu_torch's property guidance (models/property_classifier.py,
encoders/property_convert.py, train/property.py, and the CLI's
train-property and eval-conditional) against reed_tpu's on the CPU.

The classifier is tiny (hidden 16, 2 layers, 8 atoms, 4 types, padded rows)
with every weight drawn from a seeded normal on reed_tpu's side and carried
to the port by property_convert: its forward to 1e-5 of the max. One
PropertyTrainer step and then a second on the cosine schedule against
reed_tpu's jitted steps: the loss to 1e-5, every gradient to 1e-5 of its
max, the parameters after Adam to 2e-6 where reed_tpu's moved by more than
half a learning rate (to 2 learning rates elsewhere: Adam's first update is
lr * sign(g) where |g| is near eps) and the EMA to 1e-6; the same for the
linear probe. The conditional EDM step and the CLI are in
tests/test_torch_property_cli.py.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reed_tpu.core.config import MeshConfig as JaxMesh
from reed_tpu.core.config import OptimConfig as JaxOptim
from reed_tpu.models.property_classifier import PropertyClassifier as JaxClassifier
from reed_tpu.train import property as jprop
from reed_tpu_torch.core.config import OptimConfig
from reed_tpu_torch.core.ema import ema_init
from reed_tpu_torch.core.train_state import make_optimizer
from reed_tpu_torch.encoders import property_convert
from reed_tpu_torch.models.property_classifier import (PropertyClassifier,
                                                       conditional_generation_mae)
from reed_tpu_torch.train import property as prop

torch.set_num_threads(1)
FWD_RTOL = 1e-5
METRIC_TOL = 1e-5
GRAD_RTOL = 1e-5
TINY = dict(hidden_nf=16, n_layers=2, max_nodes=8, num_atom_types=4)


def _inputs(b=5, n=8, types=4, seed=1):
    """Numpy classifier inputs with padded rows (sizes 3..n), and labels."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(3, n + 1, size=b)
    sizes[0] = n
    mask = (np.arange(n)[None, :] < sizes[:, None]).astype(np.float32)[..., None]
    edge = mask[:, :, None, :] * mask[:, None, :, :] * (1 - np.eye(n, dtype=np.float32)
                                                        [None, :, :, None])
    x = rng.standard_normal((b, n, 3)).astype(np.float32) * 1.5 * mask
    one_hot = np.eye(types, dtype=np.float32)[rng.integers(0, types, (b, n))] * mask
    label = (rng.standard_normal(b) * 2 + 3).astype(np.float32)
    return {"one_hot": one_hot, "positions": x, "node_mask": mask, "edge_mask": edge,
            "label": label}


def _random_params(jmodel, inputs, std=0.3, seed=0):
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), *(jnp.asarray(inputs[k]) for k in
                                 ("one_hot", "positions", "node_mask", "edge_mask"))))
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda s: (rng.standard_normal(s.shape) * std).astype(np.float32),
                        shapes)["params"]


def _close(name, ours, ref, rtol):
    ours = np.asarray(torch.as_tensor(ours).detach())
    ref = np.asarray(ref)
    assert ours.shape == ref.shape, (name, ours.shape, ref.shape)
    err, scale = np.abs(ours - ref).max(), np.abs(ref).max()
    assert np.isfinite(ours).all() and err <= rtol * scale, (name, err, scale)


def _jax_trainer(**kw):
    return jprop.PropertyTrainer(jprop.PropertyTrainConfig(**kw, mesh=JaxMesh(data=1)))


def test_forward_matches_reed_tpu_and_names_convert():
    inputs = _inputs()
    jmodel = JaxClassifier(hidden_nf=16, n_layers=2)
    params = _random_params(jmodel, inputs)
    want = jmodel.apply({"params": params}, *(jnp.asarray(inputs[k]) for k in
                                               ("one_hot", "positions", "node_mask",
                                                "edge_mask")))
    model = PropertyClassifier(4, hidden_nf=16, n_layers=2).eval()
    sd = property_convert.state_dict_from_flax(params)
    assert set(sd) == set(model.state_dict())
    assert tuple(sd["gcl_1.edge_fc1.weight"].shape) == (16, 2 * 16 + 1)
    model.load_state_dict(sd)
    with torch.no_grad():
        got = model(*(torch.from_numpy(inputs[k]) for k in
                      ("one_hot", "positions", "node_mask", "edge_mask")))
    _close("forward", got, want, FWD_RTOL)
    # the inverse gives reed_tpu's tree back, leaf for leaf
    back = property_convert.flax_from_state_dict(model.state_dict())
    for path, leaf in jax.tree_util.tree_leaves_with_path(params):
        node = back
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(node, leaf, err_msg=str(path))


def test_edge_fc1_blocks_are_not_interchangeable():
    """Swapping the h_i and h_j blocks of edge_fc1 changes the output: the
    forward check above sees the split order."""
    inputs = _inputs()
    model = PropertyClassifier(4, hidden_nf=16, n_layers=2).initialize_weights(
        torch.Generator().manual_seed(0)).eval()
    args = [torch.from_numpy(inputs[k]) for k in ("one_hot", "positions", "node_mask",
                                                   "edge_mask")]
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.Linear):
                m.bias.normal_(0, 0.3, generator=torch.Generator().manual_seed(1))
        ref = model(*args)
        w = model.gcl_0.edge_fc1.weight
        w.copy_(torch.cat([w[:, 16:32], w[:, :16], w[:, 32:]], 1))
        assert (model(*args) - ref).abs().max() > 1e-3


def test_init_follows_reed_tpu():
    """lecun-normal weights (edge_fc1's fan_in the whole 2d + 1 kernel) and
    zero biases, as flax initialises reed_tpu's classifier."""
    model = PropertyClassifier(5, hidden_nf=128, n_layers=7).initialize_weights(
        torch.Generator().manual_seed(0))
    inputs = _inputs(b=1, n=29, types=5)
    jparams = jax.jit(lambda: JaxClassifier().init(
        jax.random.PRNGKey(0), *(jnp.asarray(inputs[k]) for k in
                                 ("one_hot", "positions", "node_mask", "edge_mask"))))()
    want = property_convert.state_dict_from_flax(jax.tree.map(np.array, jparams["params"]))
    for name, p in model.state_dict().items():
        assert p.shape == want[name].shape, name
        if name.endswith("bias"):
            assert not p.any(), name
        else:
            ratio = p.std().item() / want[name].std().item()
            bound = 2 * p.shape[1] ** -0.5 / 0.87962566103423978
            assert 0.8 < ratio < 1.25 and p.abs().max() <= bound, (name, ratio)


def _port_state(trainer, sd):
    state = trainer.init_state()
    state.model.load_state_dict(sd)
    state.ema = ema_init(state.model)
    state.opt = make_optimizer(trainer.cfg.optim, list(state.model.parameters()))
    return state


def test_train_steps_match_reed_tpu():
    """Two PropertyTrainer steps (Adam, cosine over 2 steps, weight decay
    1e-16, EMA) from the same seeded-normal state and batch."""
    kw = dict(TINY, batch_size=5, mean=3.0, mad=2.0)
    optim = dict(lr=1e-3, weight_decay=1e-16, schedule="cosine", warmup_steps=0,
                 total_steps=2)
    jtrainer = _jax_trainer(**kw, optim=JaxOptim(**optim))
    trainer = prop.PropertyTrainer(prop.PropertyTrainConfig(**kw, optim=OptimConfig(**optim)),
                                   device="cpu")
    inputs = _inputs()
    jstate = jtrainer.init_state()
    params = _random_params(jtrainer.model, inputs)
    jparams = jax.tree.map(jnp.asarray, params)
    jstate = jstate.replace(params=jparams, ema_params=jax.tree.map(jnp.copy, jparams),
                            opt_state=jtrainer.optimizer.init(jparams))
    state = _port_state(trainer, property_convert.state_dict_from_flax(params))
    before = {n: p.detach().clone() for n, p in state.model.named_parameters()}

    # the gradient of the first step, every parameter
    jb = {k: jnp.asarray(v) for k, v in inputs.items()}

    def jloss(p):
        pred = jtrainer.model.apply({"params": p}, jb["one_hot"], jb["positions"],
                                    jb["node_mask"], jb["edge_mask"])
        return jnp.abs(pred - (jb["label"] - 3.0) / 2.0).mean()

    jgrads = property_convert.state_dict_from_flax(
        jax.tree.map(np.array, jax.grad(jloss)(jparams)))
    batch = prop.batch_to_device(inputs, "cpu")
    loss = prop.make_loss_fn(trainer.cfg)(state.model, batch, 0)["denoising_loss"]
    names, leaves = zip(*state.model.named_parameters())
    for name, g in zip(names, torch.autograd.grad(loss, leaves)):
        _close(f"grad {name}", g, jgrads[name], GRAD_RTOL)

    jmetrics, metrics = [], []
    with jtrainer.mesh:
        for i in range(2):
            jstate, m = jtrainer.train_step(jstate, jax.device_put(jb, jtrainer.batch_sharding),
                                            jax.random.PRNGKey(i))
            jmetrics.append(m)
    for _ in range(2):
        state, m = trainer.train_step(state, batch)
        metrics.append(m)
    assert state.step == 2 and state.opt.count == 2
    assert trainer.curriculum.max_steps == 2
    for jm, tm in zip(jmetrics, metrics):
        for k in ("denoising_loss", "loss", "grad_norm"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=METRIC_TOL,
                                       atol=METRIC_TOL, err_msg=k)
    after = property_convert.state_dict_from_flax(jax.tree.map(np.array, jstate.params))
    ema = property_convert.state_dict_from_flax(jax.tree.map(np.array, jstate.ema_params))
    lr = optim["lr"]
    for name, p in state.model.named_parameters():
        moved = (after[name] - before[name]).abs() > 0.5 * lr
        diff = (p.detach() - after[name]).abs()
        assert moved.any(), name
        assert diff[moved].max().item() <= 2e-6, name
        assert diff.max().item() <= 2 * lr, name
        np.testing.assert_allclose(state.ema[name].numpy(), ema[name].numpy(), rtol=0,
                                   atol=1e-6, err_msg=name)


def test_linear_probe_step_matches_reed_tpu():
    kw = dict(rep_dim=12, batch_size=16, mean=1.0, mad=0.5)
    optim = dict(lr=1e-2, weight_decay=1e-16, schedule="cosine", total_steps=3)
    jtrainer = jprop.LinearProbeTrainer(jprop.LinearProbeConfig(
        **kw, optim=JaxOptim(**optim), mesh=JaxMesh(data=1)))
    trainer = prop.LinearProbeTrainer(prop.LinearProbeConfig(**kw, optim=OptimConfig(**optim)),
                                      device="cpu")
    rng = np.random.default_rng(4)
    batch = {"rep": rng.standard_normal((16, 12)).astype(np.float32),
             "label": rng.standard_normal(16).astype(np.float32)}
    params = {"kernel": rng.standard_normal((12, 1)).astype(np.float32) * 0.3,
              "bias": rng.standard_normal(1).astype(np.float32)}
    jparams = jax.tree.map(jnp.asarray, params)
    jstate = jtrainer.init_state()
    jstate = jstate.replace(params=jparams, ema_params=jax.tree.map(jnp.copy, jparams),
                            opt_state=jtrainer.optimizer.init(jparams))
    state = _port_state(trainer, property_convert.probe_state_dict_from_flax(params))
    tb = prop.batch_to_device(batch, "cpu")
    jb = jax.device_put({k: jnp.asarray(v) for k, v in batch.items()}, jtrainer.batch_sharding)
    with jtrainer.mesh:
        for i in range(3):
            jstate, jm = jtrainer.train_step(jstate, jb, jax.random.PRNGKey(i))
            state, tm = trainer.train_step(state, tb)
            np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                       rtol=METRIC_TOL, atol=METRIC_TOL)
    want = property_convert.probe_state_dict_from_flax(jax.tree.map(np.array, jstate.params))
    for name, p in state.model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), rtol=0, atol=2e-6,
                                   err_msg=name)
    back = property_convert.probe_flax_from_state_dict(state.model.state_dict())
    np.testing.assert_array_equal(back["kernel"], np.asarray(
        property_convert.probe_flax_from_state_dict(want)["kernel"]))
    # reed_tpu's predict against the port's, denormalised
    np.testing.assert_allclose(
        trainer.predict(state.model, batch["rep"]).numpy(),
        np.asarray(jtrainer.predict(jstate.params, batch["rep"])), rtol=1e-5, atol=1e-5)


def _qm9_like(m=32, src_n=10, seed=0):
    """tests/test_property.py's fabricated QM9 EDM npz layout with alpha."""
    rng = np.random.default_rng(seed)
    num_atoms = rng.integers(3, 9, m)
    positions = rng.standard_normal((m, src_n, 3)).astype(np.float32)
    charges = np.array([1, 6, 7, 8])[rng.integers(0, 4, (m, src_n))]
    for i, n in enumerate(num_atoms):
        positions[i, n:] = 0
        charges[i, n:] = 0
    alpha = num_atoms * 3.0 + rng.standard_normal(m)
    return {"positions": positions, "charges": charges, "num_atoms": num_atoms,
            "alpha": alpha.astype(np.float32)}


def test_mean_mad_epoch_batches_and_predict_match_reed_tpu():
    v = np.array([1.0, 2.0, 3.0, 6.0])
    assert prop.compute_mean_mad(v) == jprop.compute_mean_mad(v)
    assert prop.compute_mean_mad(np.ones(3))[1] == 1e-12
    assert prop.QM9_PROPERTIES == jprop.QM9_PROPERTIES
    data = _qm9_like()
    ours = list(prop.property_epoch_batches(data, "alpha", 8, np.random.default_rng(3),
                                            max_nodes=8, num_atom_types=4))
    theirs = list(jprop.property_epoch_batches(data, "alpha", 8, np.random.default_rng(3),
                                               max_nodes=8, num_atom_types=4))
    assert len(ours) == len(theirs) == 4
    for a, b in zip(ours, theirs):
        assert set(a) == set(b) == {"positions", "one_hot", "node_mask", "edge_mask",
                                    "label"}
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    # predict(denormalize=True) is mad * raw + mean, as reed_tpu's
    cfg = prop.PropertyTrainConfig(**TINY, mean=10.0, mad=2.0)
    trainer = prop.PropertyTrainer(cfg, device="cpu")
    state = trainer.init_state()
    b = trainer.synthetic_batch(torch.Generator().manual_seed(0), 4)
    args = [b[k] for k in ("one_hot", "positions", "node_mask", "edge_mask")]
    raw = trainer.predict(state.model, *args, denormalize=False)
    np.testing.assert_allclose(trainer.predict(state.model, *args).numpy(),
                               raw.numpy() * 2.0 + 10.0, rtol=1e-6, atol=1e-5)
    params = jax.tree.map(jnp.asarray, property_convert.flax_from_state_dict(
        state.model.state_dict()))
    jtrainer = _jax_trainer(**TINY, mean=10.0, mad=2.0)
    want = jtrainer.predict(params, *(np.asarray(a) for a in args))
    np.testing.assert_allclose(trainer.predict(state.model, *args).numpy(),
                               np.asarray(want), rtol=1e-5, atol=1e-5)
    assert conditional_generation_mae(lambda p: p, torch.tensor([1.0, 3.0]),
                                      np.array([2.0, 2.0])) == 1.0


def test_synthetic_batch_schema_and_learning():
    trainer = prop.PropertyTrainer(prop.PropertyTrainConfig(**TINY, batch_size=8),
                                   device="cpu")
    state = trainer.init_state()
    batch = trainer.synthetic_batch(torch.Generator().manual_seed(0))
    mask = batch["node_mask"]
    assert set(batch) == set(prop.BATCH_KEYS) - {"rep"}
    assert mask.sum((1, 2)).min() >= 4 and torch.equal(batch["one_hot"].sum(-1, keepdim=True),
                                                       mask)
    losses = [trainer.train_step(state, batch)[1]["loss"].item() for _ in range(15)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses


@pytest.mark.slow
def test_learning_bound_is_twice_reed_tpus_worst_seed():
    """chip_smoke.py's learning check (PROPERTY_LEARN) run by reed_tpu on the
    CPU: its bound is at least twice reed_tpu's worst seed, whose late means
    read 0.0877, 0.1470, 0.0767, 0.0646 and 0.0932 at seeds 0-4. Marked
    slow: five reed_tpu runs of 200 steps (~75 s)."""
    import chip_smoke

    c = chip_smoke.PROPERTY_LEARN
    lates = []
    for seed in c["seeds"]:
        trainer = _jax_trainer(hidden_nf=c["hidden_nf"], n_layers=c["n_layers"],
                               batch_size=c["batch_size"], seed=seed,
                               optim=JaxOptim(lr=c["lr"], weight_decay=1e-16,
                                              schedule="cosine", warmup_steps=0,
                                              total_steps=c["steps"]))
        state, losses = trainer.init_state(), []
        with trainer.mesh:
            for i in range(c["steps"]):
                batch = jax.device_put(trainer.synthetic_batch(jax.random.PRNGKey(i)),
                                       trainer.batch_sharding)
                state, metrics = trainer.train_step(state, batch, jax.random.PRNGKey(i))
                losses.append(float(metrics["loss"]))
        lates.append(float(np.mean(losses[-20:])))
    assert 2 * max(lates) <= chip_smoke.PROPERTY_LEARN_LOSS_MAX + 1e-3, lates
    np.testing.assert_allclose(lates, [0.0877, 0.1470, 0.0767, 0.0646, 0.0932], atol=5e-4)
