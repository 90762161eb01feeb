"""The mesh axes, data parallelism and the fsdp axis over torch.distributed,
counterpart of reed_tpu/parallel/mesh.py.

reed_tpu runs one jit over the global batch on a ('data', 'fsdp', 'seq',
'tensor') mesh: its gradient is the gradient of the global batch's loss
and its draws are the global batch's draws. The port runs the 'data' and
'fsdp' axes: one process a rank (launched by torchrun; NCCL with one card
a rank, or gloo), each holding the whole model as its working copy and
rows [r*B/W, (r+1)*B/W) of the global batch of B rows over W = data * fsdp
ranks, the layout reed_tpu's batch_sharding (over data x fsdp) gives a
one-process mesh. A step then equals reed_tpu's:
  * each rank's loss is written so that its mean over the ranks is the
    global batch's loss (a mean of per-sample terms over equal local
    batches is; a loss normalised by a count over the batch takes the
    global count, diffusion/protein_losses.py), so the mean of the ranks'
    gradients is the global batch's gradient;
  * every rank draws each batch draw at the global shape from the one
    generator all ranks share and keeps its rows (parallel/draws.py), and
    builds host batches (OT couplings included) as one process would
    before it keeps its rows (`local_rows`).

The fsdp axis shards the optimizer's state. reed_tpu's make_mesh reshapes
the devices to (data, fsdp, seq, tensor), so rank r = d * F + f: an fsdp
group is F consecutive ranks, a data group the D ranks that share f. A
parameter that reed_tpu's fsdp_spec shards (`fsdp_spec`, `ShardPlan`) is
owned in F contiguous flat chunks, chunk f by the ranks of fsdp index f:
its gradient is reduce-scattered over the fsdp group, all-reduced over
the data group and divided by W (`ShardPlan.reduce_grads`), and Adam's
moments, the accumulation buffer and the EMA live on the chunk; after the
update the chunks are all-gathered into every rank's whole parameter.
Replicated parameters keep the data axis's bucketed all-reduce. A W-rank
run equals the one-process run up to the order of the reductions, and a
checkpoint stays one file with one generator state. The parameters are not
sharded at rest (ROADMAP.md Queue 1 item 7b), and the tensor and seq axes
are not ported: sizes above 1 raise.
"""

from __future__ import annotations

import math
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from reed_tpu_torch import resolve_device
from reed_tpu_torch.core.config import MeshConfig

DATA_AXIS = "data"
FSDP_AXIS = "fsdp"
TENSOR_AXIS = "tensor"
SEQ_AXIS = "seq"
MESH_AXES = (DATA_AXIS, FSDP_AXIS, SEQ_AXIS, TENSOR_AXIS)

# the ROADMAP.md Queue 1 items of the axes not ported
NOT_PORTED = {TENSOR_AXIS: "ROADMAP.md Queue 1 item 8 (tensor and seq)",
              SEQ_AXIS: "ROADMAP.md Queue 1 item 8 (tensor and seq)"}

# elements a gradient bucket holds at most (256 MB in f32): SiT-XL/2's
# 675 M parameters go in 11 all-reduces
BUCKET_ELEMENTS = 1 << 26

# reed_tpu's minimum leaf size (elements) for fsdp sharding
FSDP_MIN_SIZE = 65536


def fsdp_spec(shape: Sequence[int], fsdp_size: int,
              min_size: int = FSDP_MIN_SIZE) -> Optional[int]:
    """The dimension of `shape` that reed_tpu's fsdp_spec (without a tensor
    spec) shards over an fsdp axis of `fsdp_size`, or None where the leaf
    stays replicated: a leaf is sharded when it has at least 2 dimensions
    and `min_size` elements and some dimension (dimension 0 first, then the
    largest) is divisible by fsdp_size and at least twice it. Whether a leaf
    is sharded is the same for any order of its dimensions, so a torch
    Linear weight [out, in] is sharded exactly when the flax kernel [in,
    out] is; the dimension named is the one of the shape given. The port
    shards flat chunks, not this dimension (ShardPlan)."""
    if fsdp_size <= 1 or len(shape) < 2 or math.prod(shape) < max(1, min_size):
        return None
    order = [0] + sorted(range(1, len(shape)), key=lambda i: -shape[i])
    for i in order:
        if shape[i] % fsdp_size == 0 and shape[i] >= 2 * fsdp_size:
            return i
    return None


def check_mesh(mesh, world: int, batch_size: Optional[int] = None):
    """What stands in for reed_tpu's make_mesh: `mesh` (a MeshConfig) must
    ask for data * fsdp = `world` ranks (data None takes world / fsdp, as
    make_mesh's data=None absorbs the rest), and `batch_size` (the global
    batch) must split evenly over the ranks. Returns (data, fsdp). Raises
    NotImplementedError for tensor or seq above 1 and ValueError
    otherwise."""
    for axis, size in ((TENSOR_AXIS, mesh.tensor), (SEQ_AXIS, mesh.seq)):
        if size is not None and size > 1:
            raise NotImplementedError(
                f"mesh axis '{axis}' of size {size} is not ported: the port runs the "
                f"'data' and 'fsdp' axes only; '{axis}' is {NOT_PORTED[axis]}")
    fsdp = mesh.fsdp or 1
    if fsdp < 1 or world % fsdp:
        raise ValueError(
            f"mesh fsdp={fsdp} does not divide the {world} process(es) that run: launch "
            f"data x fsdp ranks (torchrun --nproc_per_node {fsdp} -m reed_tpu_torch.cli "
            "... --distributed)")
    data = world // fsdp if mesh.data is None else mesh.data
    if data * fsdp != world:
        raise ValueError(
            f"mesh data={data}, but {world} process(es) run, and data x fsdp = {data} x "
            f"{fsdp} ranks: launch one process a rank (torchrun --nproc_per_node "
            f"{data * fsdp} -m reed_tpu_torch.cli ... --distributed)")
    if batch_size is not None and batch_size % world:
        raise ValueError(f"a global batch of {batch_size} does not split over "
                         f"{world} ranks")
    return data, fsdp


def local_rows(x, rank: int, world: int):
    """Rank `rank`'s rows [rank*B/W, (rank+1)*B/W) of every array and
    tensor in `x` (nested dicts, lists and tuples; other leaves and 0-d
    arrays as they are), B its leading size. Raises ValueError when the
    world size does not divide B."""
    if isinstance(x, dict):
        return {k: local_rows(v, rank, world) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(local_rows(v, rank, world) for v in x)
    if isinstance(x, (torch.Tensor, np.ndarray)) and x.ndim:
        n = x.shape[0]
        if n % world:
            raise ValueError(f"a global batch of {n} rows does not split over "
                             f"{world} ranks")
        b = n // world
        return x[rank * b:(rank + 1) * b]
    return x


def local_batch(dp, batch):
    """This rank's rows of a global batch under `dp` (a DataParallel), the
    batch itself with dp None."""
    return batch if dp is None else local_rows(batch, dp.rank, dp.world)


def _buckets(sizes: Sequence[int], dtypes: Sequence[torch.dtype],
             cap: Optional[int] = None) -> List[List[int]]:
    """The indices of `sizes` in flat buckets of one dtype and up to `cap`
    (default BUCKET_ELEMENTS) elements each (a larger one alone), in
    order within each dtype."""
    cap = BUCKET_ELEMENTS if cap is None else cap
    by_dtype: Dict[torch.dtype, List[int]] = {}
    for i, dt in enumerate(dtypes):
        by_dtype.setdefault(dt, []).append(i)
    out = []
    for idx in by_dtype.values():
        part, size = [], 0
        for i in idx:
            if part and size + sizes[i] > cap:
                out.append(part)
                part, size = [], 0
            part.append(i)
            size += sizes[i]
        if part:
            out.append(part)
    return out


# (default group, fsdp) -> (this rank's fsdp group, its data group)
_subgroups: Dict = {}


def _fsdp_groups(world: int, fsdp: int):
    """This rank's fsdp group (F consecutive ranks) and data group (the
    ranks of its fsdp index), made once for the default group: every rank
    makes every group, in one order, as new_group requires."""
    key = (dist.group.WORLD, fsdp)
    if key not in _subgroups:
        rank, mine = dist.get_rank(), [None, None]
        for d in range(world // fsdp):
            g = dist.new_group(list(range(d * fsdp, (d + 1) * fsdp)))
            if rank // fsdp == d:
                mine[0] = g
        for f in range(fsdp):
            g = dist.new_group(list(range(f, world, fsdp)))
            if rank % fsdp == f:
                mine[1] = g
        _subgroups[key] = tuple(mine)
    return _subgroups[key]


class DataParallel:
    """This process's place on the data x fsdp mesh of the default process
    group: `rank`, `world` (the batch side: rank r holds rows r of W),
    `data` and `fsdp` (the axes' sizes), `fsdp_index` (f of r = d * F + f),
    `is_main`, and the collectives the port's data parallelism runs.
    Collectives on host data run on `device` (the rank's current card
    under NCCL, the CPU under gloo)."""

    def __init__(self, fsdp: int = 1, fsdp_min_size: Optional[int] = None):
        self.rank = dist.get_rank()
        self.world = dist.get_world_size()
        self.backend = dist.get_backend()
        self.device = (torch.device("cuda", torch.cuda.current_device())
                       if self.backend == "nccl" else torch.device("cpu"))
        self.fsdp = fsdp
        self.data = self.world // fsdp
        self.fsdp_index = self.rank % fsdp
        self.fsdp_min_size = FSDP_MIN_SIZE if fsdp_min_size is None else fsdp_min_size
        self.fsdp_group, self.data_group = (_fsdp_groups(self.world, fsdp) if fsdp > 1
                                            else (None, None))

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def shard_plan(self, named_params) -> Optional["ShardPlan"]:
        """The ShardPlan of `named_params` (name, tensor) on this mesh, or
        None where the fsdp axis is 1."""
        return ShardPlan(self, named_params) if self.fsdp > 1 else None

    def all_reduce_grads(self, grads: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The mean over the ranks of each gradient, all-reduced in flat
        buckets of up to BUCKET_ELEMENTS (one dtype a bucket); returns views
        into the buckets, in the order given."""
        out: List[Optional[torch.Tensor]] = [None] * len(grads)
        for part in _buckets([g.numel() for g in grads], [g.dtype for g in grads]):
            flat = torch.cat([grads[i].reshape(-1) for i in part])
            dist.all_reduce(flat)
            flat.div_(self.world)
            for i, view in zip(part, torch.split(flat, [grads[i].numel() for i in part])):
                out[i] = view.view(grads[i].shape)
        return out

    def reduce_scatter(self, buf: torch.Tensor) -> torch.Tensor:
        """The sum over this rank's fsdp group of row `fsdp_index` of `buf`
        ([F, S], contiguous): [S]."""
        out = torch.empty(buf.shape[1:], dtype=buf.dtype, device=buf.device)
        dist.reduce_scatter_tensor(out, buf.view(-1), group=self.fsdp_group)
        return out

    def all_gather(self, row: torch.Tensor) -> torch.Tensor:
        """Every rank of the fsdp group's `row` ([S]), by fsdp index: [F, S]."""
        out = torch.empty((self.fsdp, row.numel()), dtype=row.dtype, device=row.device)
        dist.all_gather_into_tensor(out.view(-1), row, group=self.fsdp_group)
        return out

    def mean_metrics(self, metrics: Dict) -> Dict:
        """The tensor entries of `metrics` (scalars) averaged over the
        ranks in one all-reduce on their device, with no host sync; other
        entries as they are."""
        keys = [k for k, v in metrics.items() if isinstance(v, torch.Tensor)]
        if not keys:
            return dict(metrics)
        flat = torch.stack([metrics[k].float().reshape(()) for k in keys])
        dist.all_reduce(flat)
        flat.div_(self.world)
        return {**metrics, **dict(zip(keys, flat.unbind()))}

    def all_sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of `x` over the ranks (a new tensor, no gradient)."""
        x = x.detach().clone()
        dist.all_reduce(x)
        return x

    def all_sum_host(self, x: np.ndarray) -> np.ndarray:
        """The sum over the ranks of a host array, in f64."""
        t = torch.as_tensor(np.asarray(x, np.float64), device=self.device)
        dist.all_reduce(t)
        return t.cpu().numpy()

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's rows `x` stacked in rank order: each rank writes its
        rows into a zeroed buffer of the global shape, then one all-reduce
        (a sum) fills it. Works under NCCL and gloo alike."""
        b = x.shape[0]
        full = torch.zeros((b * self.world,) + tuple(x.shape[1:]), dtype=x.dtype,
                           device=x.device)
        full[self.rank * b:(self.rank + 1) * b] = x
        dist.all_reduce(full)
        return full

    def barrier(self):
        dist.barrier()


class ShardPlan:
    """Which of a model's parameters the fsdp axis shards (reed_tpu's rule,
    `fsdp_spec` with the mesh's fsdp_min_size), and the collectives over
    them. A sharded parameter of n elements is owned in F flat chunks of
    n / F (fsdp_spec only shards a leaf with a dimension divisible by F);
    `local` gives this rank's chunk as a view, so an update in place of
    the chunk updates the working copy. State lists (gradients, moments,
    EMA) are in parameter order, chunks where `sharded`."""

    def __init__(self, dp: DataParallel, named_params):
        self.dp = dp
        named = list(named_params)
        self.names = [n for n, _ in named]
        self.shapes = [tuple(p.shape) for _, p in named]
        self.sharded = [fsdp_spec(p.shape, dp.fsdp, dp.fsdp_min_size) is not None
                        for _, p in named]
        self.index = {n: i for i, n in enumerate(self.names)}

    @property
    def any_sharded(self) -> bool:
        return any(self.sharded)

    def chunk_size(self, i: int) -> int:
        return math.prod(self.shapes[i]) // self.dp.fsdp

    def local(self, i: int, t: torch.Tensor) -> torch.Tensor:
        """This rank's chunk of tensor `t` of parameter `i` (a view; `t`
        itself where the parameter is replicated)."""
        if not self.sharded[i]:
            return t
        n = self.chunk_size(i)
        return t.view(-1)[self.dp.fsdp_index * n:(self.dp.fsdp_index + 1) * n]

    def local_named(self, name: str, t: torch.Tensor) -> torch.Tensor:
        return self.local(self.index[name], t)

    def resident_elements(self) -> int:
        """Elements of one copy of the state a rank holds: the chunks of the
        sharded parameters and the whole replicated ones."""
        return sum(self.chunk_size(i) if s else math.prod(self.shapes[i])
                   for i, s in enumerate(self.sharded))

    def _sharded_buckets(self, dtypes) -> List[List[int]]:
        idx = [i for i, s in enumerate(self.sharded) if s]
        parts = _buckets([self.chunk_size(i) * self.dp.fsdp for i in idx],
                         [dtypes[i] for i in idx])
        return [[idx[j] for j in part] for part in parts]

    def reduce_grads(self, grads: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The mean over every rank of each whole gradient in `grads`, as
        this rank keeps it: the chunk of a sharded parameter (reduce-scatter
        over the fsdp group, all-reduce over the data group, / W, in flat
        buckets) and the whole of a replicated one (the data axis's
        bucketed all-reduce over every rank)."""
        dp, F = self.dp, self.dp.fsdp
        out: List[Optional[torch.Tensor]] = [None] * len(grads)
        repl = [i for i, s in enumerate(self.sharded) if not s]
        for i, g in zip(repl, dp.all_reduce_grads([grads[i] for i in repl])):
            out[i] = g
        for part in self._sharded_buckets([g.dtype for g in grads]):
            buf = torch.cat([grads[i].reshape(F, -1) for i in part], dim=1)
            mine = dp.reduce_scatter(buf)
            if dp.data > 1:
                dist.all_reduce(mine, group=dp.data_group)
            mine = mine.div(dp.world)
            for i, view in zip(part, torch.split(mine, [self.chunk_size(i) for i in part])):
                out[i] = view
        return out

    def _gather_whole(self, chunks: Sequence[torch.Tensor]):
        """(part, [F, S]) for each bucket of the sharded entries of `chunks`:
        the part's chunks all-gathered over the fsdp group, bit for bit."""
        for part in self._sharded_buckets([t.dtype for t in chunks]):
            yield part, self.dp.all_gather(torch.cat([chunks[i] for i in part]))

    def gather(self, tensors: Sequence[Optional[torch.Tensor]]) -> List[torch.Tensor]:
        """The whole tensors of a state list (chunks where sharded) in the
        parameters' shapes, gathered over the fsdp group bit for bit;
        replicated entries as they are. A collective: every rank of the
        group calls it."""
        out = list(tensors)
        for part, full in self._gather_whole(tensors):
            off = 0
            for i in part:
                n = self.chunk_size(i)
                out[i] = full[:, off:off + n].reshape(self.shapes[i])
                off += n
        return out

    def gather_named(self, state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """`gather` of a state dict keyed by parameter name (the EMA)."""
        whole = self.gather([state[n] for n in self.names])
        return dict(zip(self.names, whole))

    @torch.no_grad()
    def gather_params(self, params: Sequence[torch.Tensor]):
        """All-gather every rank's updated chunks into the whole parameters
        (in place)."""
        whole = self.gather([self.local(i, p) for i, p in enumerate(params)])
        for i, p in enumerate(params):
            if self.sharded[i]:
                p.copy_(whole[i])

    def norm(self, grads: Sequence[torch.Tensor]) -> torch.Tensor:
        """The global norm of the whole gradient from this rank's `grads`:
        the squares of the sharded chunks summed over the fsdp group, those
        of the replicated leaves added once."""
        sh = [g for g, s in zip(grads, self.sharded) if s]
        rp = [g for g, s in zip(grads, self.sharded) if not s]
        sq = torch.stack(torch._foreach_norm(sh)).square().sum()
        dist.all_reduce(sq, group=self.dp.fsdp_group)
        if rp:
            sq = sq + torch.stack(torch._foreach_norm(rp)).square().sum()
        return sq.sqrt()


def init_distributed(device="cuda", backend: Optional[str] = None,
                     init_method: Optional[str] = None):
    """Join the process group torchrun describes (RANK, WORLD_SIZE,
    LOCAL_RANK in the environment): NCCL on `cuda` (the device becomes
    cuda:LOCAL_RANK, made the current device) and gloo on `cpu`, unless
    `backend` names another; the rendezvous is torchrun's (env://) unless
    `init_method` names one (file://path). Returns (device, DataParallel).
    Raises when the environment, the device, the backend or the
    rendezvous is missing; a group already joined is reused."""
    missing = [k for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK") if k not in os.environ]
    if missing:
        raise RuntimeError(
            f"--distributed needs {', '.join(missing)} in the environment: launch "
            "with torchrun --nproc_per_node N -m reed_tpu_torch.cli ... --distributed")
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    device = resolve_device(device)
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if dist.is_initialized():
        if (dist.get_rank(), dist.get_world_size()) != (rank, world):
            raise RuntimeError(f"the process group holds rank {dist.get_rank()} of "
                               f"{dist.get_world_size()}, the environment says {rank} "
                               f"of {world}")
    else:
        dist.init_process_group(backend, init_method=init_method or "env://",
                                rank=rank, world_size=world)
    return device, DataParallel()


def data_parallel(mesh=None, batch_size: Optional[int] = None) -> Optional[DataParallel]:
    """The data-parallel context of the default process group on `mesh`'s
    data x fsdp axes, carrying its fsdp size and min size (the rule of its
    ShardPlan), or None when there is no group (one process, no
    collectives), after `check_mesh` of `mesh` and the global `batch_size`
    against its world size."""
    mesh = MeshConfig() if mesh is None else mesh
    world = dist.get_world_size() if dist.is_initialized() else 1
    _, fsdp = check_mesh(mesh, world, batch_size)
    if not dist.is_initialized():
        return None
    return DataParallel(fsdp, mesh.fsdp_min_size)
