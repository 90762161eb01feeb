"""reed_tpu_torch/parallel against reed_tpu/parallel/mesh.py and over two
gloo ranks on the CPU (tests/torch_dp.py, one spawn for the file's checks):
the mesh check that stands in for make_mesh, this rank's rows against
reed_tpu's batch sharding, the global-batch draws, the collectives
(bucketed gradient mean, row gather, sums, metric means), cross-process
stats, and the CLI's mesh flags and --distributed; and two spawns in one
directory, each through a rendezvous file of its own."""

import types

import jax
import numpy as np
import pytest
import torch

import torch_dp
from reed_tpu.parallel import mesh as jax_mesh
from reed_tpu_torch import cli
from reed_tpu_torch.core import stats
from reed_tpu_torch.core.config import MeshConfig
from reed_tpu_torch.parallel import draws, mesh

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh")
    torch_dp.spawn(out, "mesh")
    return [torch.load(out / f"mesh_rank{r}.pt", weights_only=False)
            for r in range(torch_dp.WORLD)]


def test_spawns_in_one_directory_meet_through_files_of_their_own(tmp_path):
    """torch.distributed's file:// rendezvous removes its file when the
    last process using the store releases it, which does not always
    happen, and a later group meeting through a left file reads the old
    group's keys and hangs. torch_dp.spawn gives every spawn a file of its
    own and removes it once the ranks have exited: after two ranks that
    leave theirs behind, four ranks meet in the same directory."""
    torch_dp.spawn(tmp_path, "leave_store", timeout=120)
    assert not list(tmp_path.glob("store*"))
    torch_dp.spawn(tmp_path, "mesh", world=4, timeout=120)
    assert all((tmp_path / f"mesh_rank{r}.pt").exists() for r in range(4))


def test_axis_names_match_reed_tpu():
    assert (mesh.DATA_AXIS, mesh.FSDP_AXIS, mesh.TENSOR_AXIS, mesh.SEQ_AXIS) == (
        jax_mesh.DATA_AXIS, jax_mesh.FSDP_AXIS, jax_mesh.TENSOR_AXIS, jax_mesh.SEQ_AXIS)
    assert mesh.MESH_AXES == jax_mesh.MESH_AXES


@pytest.mark.parametrize("axis", ["fsdp", "tensor", "seq"])
def test_unported_axes_raise_naming_roadmap(axis):
    """fsdp is ported on every family: data x fsdp must be the world size
    (data None takes the rest, as make_mesh's data=None does), else
    ValueError with the torchrun line. tensor runs on SiT and ProteinMPNN
    (SIT_AXES, PMPNN_AXES) and seq on SiT alone, where data x fsdp x seq x
    tensor must be the world size and the batch splits over data x fsdp;
    on the other families tensor raises naming ROADMAP item 8b, and seq
    outside SiT raises saying that it splits SiT's tokens alone."""
    if axis == "fsdp":
        assert mesh.check_mesh(MeshConfig(fsdp=2), 2) == (1, 2)
        assert mesh.check_mesh(MeshConfig(fsdp=2), 8, batch_size=8) == (4, 2)
        assert mesh.check_mesh(MeshConfig(data=2, fsdp=2), 4) == (2, 2)
        with pytest.raises(ValueError, match="fsdp=2 does not divide the 3 process"):
            mesh.check_mesh(MeshConfig(fsdp=2), 3)
        with pytest.raises(ValueError, match="data=2, but 2 process.*2 x 2 ranks.*"
                                             "torchrun --nproc_per_node 4"):
            mesh.check_mesh(MeshConfig(data=2, fsdp=2), 2)
        assert "fsdp" not in mesh.NOT_PORTED
    else:
        running = [mesh.SIT_AXES] + ([mesh.PMPNN_AXES] if axis == "tensor" else [])
        refused = [()] + ([mesh.PMPNN_AXES] if axis == "seq" else [])
        why = ("ROADMAP.md Queue 1 item 8b" if axis == "tensor"
               else "the seq axis splits SiT's tokens alone.*token_sharding")
        for axes in refused:
            with pytest.raises(NotImplementedError, match=why):
                mesh.check_mesh(MeshConfig(**{axis: 2}), 2, axes=axes)
        for axes in running:
            assert mesh.check_mesh(MeshConfig(**{axis: 2}), 2, axes=axes) == (1, 1)
            assert mesh.check_mesh(MeshConfig(fsdp=2, **{axis: 2}), 8, batch_size=4,
                                   axes=axes) == (2, 2)
            with pytest.raises(ValueError, match=f"{axis}=2 does not divide the 1 process.*"
                                                 "torchrun --nproc_per_node 2"):
                mesh.check_mesh(MeshConfig(**{axis: 2}), 1, axes=axes)
            with pytest.raises(ValueError, match="data=2, but 4 process.*"
                                                 "data x fsdp x seq x tensor = 2 x 1 x .*"
                                                 "torchrun --nproc_per_node 8"):
                mesh.check_mesh(MeshConfig(data=2, **{axis: 4}), 4, axes=axes)
            with pytest.raises(ValueError, match="batch of 6 does not split over 4 ranks"):
                mesh.check_mesh(MeshConfig(data=4, **{axis: 2}), 8, batch_size=6, axes=axes)
    mesh.check_mesh(MeshConfig(**{axis: 1}), 2)


def test_data_axis_and_batch_checks():
    for data, world in ((2, 1), (1, 2), (4, 2)):
        with pytest.raises(ValueError, match=f"data={data}, but {world} process"):
            mesh.check_mesh(MeshConfig(data=data), world)
    for data in (None, 2):
        mesh.check_mesh(MeshConfig(data=data), 2, batch_size=8)
    with pytest.raises(ValueError, match="global batch of 6 does not split over 4 ranks"):
        mesh.check_mesh(MeshConfig(), 4, batch_size=6)
    with pytest.raises(ValueError, match="batch of 5 rows does not split over 2 ranks"):
        mesh.local_rows({"x": np.zeros((5, 2))}, 0, 2)
    # without a process group there is no context, and data above 1 raises
    assert mesh.data_parallel(MeshConfig(data=1), 7) is None
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 2"):
        mesh.data_parallel(MeshConfig(data=2), 8)


@pytest.mark.parametrize("world", [2, 4, 8])
def test_local_rows_are_reed_tpus_batch_shards(world):
    """Rank r's rows are the shard of device r when reed_tpu puts the batch
    on a data mesh of that many devices (one process)."""
    x = np.arange(16 * 3, dtype=np.float32).reshape(16, 3)
    sharded = jax.device_put(x, jax_mesh.batch_sharding(jax_mesh.make_mesh(data=world)))
    shards = sorted(sharded.addressable_shards, key=lambda s: s.index[0].start or 0)
    assert len(shards) == world
    for rank, shard in enumerate(shards):
        rows = mesh.local_rows({"x": x, "nested": [torch.from_numpy(x)], "n": 3}, rank, world)
        np.testing.assert_array_equal(rows["x"], np.asarray(shard.data))
        np.testing.assert_array_equal(rows["nested"][0].numpy(), np.asarray(shard.data))
        assert rows["n"] == 3


def test_draws_are_the_global_batch_rows():
    """Inside global_rows each rank draws the whole batch's values and keeps
    its rows; every rank's generator ends where one process's does."""
    shapes = [((2, 3), draws.rand), ((2,), draws.randn)]
    one = torch.Generator().manual_seed(3)
    whole = [fn((4,) + shape[1:], generator=one) for shape, fn in shapes]
    whole.append(draws.randint(0, 9, (4, 5), generator=one))
    for rank in range(2):
        gen = torch.Generator().manual_seed(3)
        with draws.global_rows(types.SimpleNamespace(rank=rank, world=2)):
            got = [fn(shape, generator=gen) for shape, fn in shapes]
            got.append(draws.randint(0, 9, (2, 5), generator=gen))
        for g, w in zip(got, whole):
            assert torch.equal(g, w[2 * rank:2 * rank + 2])
        assert torch.equal(gen.get_state(), one.get_state())
    # outside the block (and with dp None) they are torch's own draws
    with draws.global_rows(None):
        assert torch.equal(draws.rand((3,), generator=torch.Generator().manual_seed(1)),
                           torch.rand((3,), generator=torch.Generator().manual_seed(1)))


def test_collectives_over_two_ranks(ranks):
    # the ranks cap a bucket at 13 elements: [12] and [5, 8] in f32, [6] in f64
    grads = [r["grads"] for r in ranks]
    for got in (r["reduced"] for r in ranks):
        for i, g in enumerate(got):
            assert g.shape == grads[0][i].shape and g.dtype == grads[0][i].dtype
            torch.testing.assert_close(g, (grads[0][i] + grads[1][i]) / 2, rtol=0, atol=1e-7)
        assert torch.equal(got[0], ranks[0]["reduced"][0])
        assert torch.equal(ranks[0]["gathered"][:2], torch.zeros(2, 3))
        assert torch.equal(ranks[0]["gathered"][2:], torch.ones(2, 3))
    for r in ranks:
        assert torch.equal(r["summed"], torch.tensor([2.0, 1.0]))
        assert float(r["metrics"]["a"]) == 0.5 and r["metrics"]["b"] == 2.0
        assert torch.equal(r["gathered"], ranks[0]["gathered"])


def test_global_rows_under_a_process_group(ranks):
    gen = torch.Generator().manual_seed(3)
    whole = [torch.rand((4, 3), generator=gen), torch.randn((4,), generator=gen),
             torch.randint(0, 9, (4, 4), generator=gen)]
    for rank, r in enumerate(ranks):
        for got, w in zip(r["drawn"], whole):
            assert torch.equal(got, w[2 * rank:2 * rank + 2])


def test_cross_process_stats_equal_one_process(ranks):
    """Two ranks' update(cross_process=True) against one process fed both
    ranks' reports (report0's from rank 0 alone)."""
    stats.reset()
    try:
        for rank in range(torch_dp.WORLD):
            rng = np.random.default_rng(rank)
            for v in rng.standard_normal(3 + rank):
                stats.report("loss", v)
        stats.report("acc", np.array([0.5, 0.75]))
        collector = stats.Collector()
        collector.update()
        want = collector.as_dict()
    finally:
        stats.reset()
    for r in ranks:
        assert set(r["stats"]) == set(want) == {"loss", "acc"}
        for name, moments in want.items():
            assert r["stats"][name]["num"] == moments["num"]
            for k in ("mean", "std"):
                assert r["stats"][name][k] == pytest.approx(moments[k], rel=1e-12)


@pytest.mark.parametrize("cmd", ["generate-image", "eval-protein", "train-protein",
                                 "train-image", "train-molecule-semla", "eval-semla",
                                 "train-molecule-edm", "train-rdm", "eval-molecule",
                                 "train-property", "eval-conditional", "train-multiflow",
                                 "eval-multiflow"])
def test_every_subcommand_but_compute_fid_takes_the_mesh_flags(cmd, monkeypatch):
    """reed_tpu's --dp/--fsdp/--tp/--sp/--distributed: --tp 2 on one process
    raises, on train-image, generate-image (whose SiT runs the tensor axis),
    train-protein (whose ProteinMPNN does), train-molecule-semla,
    train-molecule-edm and train-property (SemlaFlow and the EGNN family)
    with the data x fsdp x seq x tensor world size and the torchrun line,
    elsewhere naming ROADMAP item 8b; --sp 2 outside SiT raises saying that
    it splits SiT's tokens
    alone; --distributed without
    torchrun's environment raises, an eval subcommand raises on --dp 2 or
    --fsdp 2 (naming ROADMAP item 11), and a train-* one (or
    generate-image) on a --dp x --fsdp that is not the world size, naming
    the torchrun line."""
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(key, raising=False)
    base = [cmd, "--device", "cpu"]
    data_parallel = cmd.startswith("train-") or cmd == "generate-image"
    with pytest.raises(ValueError if data_parallel else NotImplementedError,
                       match="fsdp=2 does not divide the 1 process" if data_parallel
                       else "ROADMAP.md Queue 1 item 11"):
        cli.main(base + ["--fsdp", "2"])
    if cmd in ("train-image", "generate-image", "train-protein", "train-molecule-semla",
               "train-molecule-edm", "train-property"):
        with pytest.raises(ValueError, match="tensor=2 does not divide the 1 process.*"
                                             "torchrun --nproc_per_node 2"):
            cli.main(base + ["--tp", "2", "--sp", "1"])
    else:
        with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 item 8b"):
            cli.main(base + ["--tp", "2", "--sp", "1"])
    if cmd not in ("train-image", "generate-image"):
        with pytest.raises(NotImplementedError, match="splits SiT's tokens alone"):
            cli.main(base + ["--sp", "2"])
    with pytest.raises(RuntimeError, match="RANK, WORLD_SIZE, LOCAL_RANK"):
        cli.main(base + ["--distributed"])
    with pytest.raises(ValueError if data_parallel else NotImplementedError,
                       match="torchrun" if data_parallel else "ROADMAP.md Queue 1 item 11"):
        cli.main(base + ["--dp", "2"])


def test_compute_fid_takes_no_mesh_flags():
    with pytest.raises(SystemExit):
        cli.main(["compute-fid", "a.npz", "b.npz", "--dp", "1"])


def test_distributed_without_a_rendezvous_raises(monkeypatch):
    """torchrun's variables without its rendezvous: env:// raises at once."""
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("LOCAL_RANK", "0")
    for key in ("MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(ValueError, match="MASTER_ADDR"):
        mesh.init_distributed("cpu")
    assert not torch.distributed.is_initialized()
