"""The mesh axes and data parallelism over torch.distributed, counterpart
of reed_tpu/parallel/mesh.py.

reed_tpu runs one jit over the global batch on a ('data', 'fsdp', 'seq',
'tensor') mesh: its gradient is the gradient of the global batch's loss
and its draws are the global batch's draws. The port runs the 'data' axis:
one process a rank (launched by torchrun; NCCL with one card a rank, or
gloo), each holding the whole model and rows [r*B/W, (r+1)*B/W) of the
global batch of B rows over W ranks, the layout reed_tpu's batch_sharding
gives a one-process mesh. A step then equals reed_tpu's:
  * each rank's loss is written so that its mean over the ranks is the
    global batch's loss (a mean of per-sample terms over equal local
    batches is; a loss normalised by a count over the batch takes the
    global count, diffusion/protein_losses.py), so the mean of the ranks'
    gradients, which the train step all-reduces in a few flat buckets
    (core/trainer.py), is the global batch's gradient;
  * every rank draws each batch draw at the global shape from the one
    generator all ranks share and keeps its rows (parallel/draws.py), and
    builds host batches (OT couplings included) as one process would
    before it keeps its rows (`local_rows`).
A W-rank run equals the one-process run up to the order of the
reductions, and a checkpoint stays one file with one generator state.
The fsdp, tensor and seq axes are not ported: sizes above 1 raise.
"""

from __future__ import annotations

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
NOT_PORTED = {FSDP_AXIS: "ROADMAP.md Queue 1 item 7 (FSDP)",
              TENSOR_AXIS: "ROADMAP.md Queue 1 item 8 (tensor and seq)",
              SEQ_AXIS: "ROADMAP.md Queue 1 item 8 (tensor and seq)"}

# elements a gradient bucket holds at most (256 MB in f32): SiT-XL/2's
# 675 M parameters go in 11 all-reduces
BUCKET_ELEMENTS = 1 << 26


def check_mesh(mesh, world: int, batch_size: Optional[int] = None):
    """What stands in for reed_tpu's make_mesh: `mesh` (a MeshConfig) must
    ask for the data axis alone, of size None (every rank) or `world`, and
    `batch_size` (the global batch) must split evenly over the ranks.
    Raises NotImplementedError for fsdp, tensor or seq above 1 and
    ValueError otherwise."""
    for axis, size in ((FSDP_AXIS, mesh.fsdp), (TENSOR_AXIS, mesh.tensor),
                       (SEQ_AXIS, mesh.seq)):
        if size is not None and size > 1:
            raise NotImplementedError(
                f"mesh axis '{axis}' of size {size} is not ported: the port runs the "
                f"'data' axis only; '{axis}' is {NOT_PORTED[axis]}")
    if mesh.data is not None and mesh.data != world:
        raise ValueError(
            f"mesh data={mesh.data}, but {world} process(es) run: launch one process "
            f"a rank (torchrun --nproc_per_node {mesh.data} -m reed_tpu_torch.cli ... "
            "--distributed)")
    if batch_size is not None and batch_size % world:
        raise ValueError(f"a global batch of {batch_size} does not split over "
                         f"{world} ranks")


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


class DataParallel:
    """This process's place on the data axis of the default process group:
    `rank`, `world`, `is_main`, and the collectives the port's data
    parallelism runs. Collectives on host data run on `device` (the rank's
    current card under NCCL, the CPU under gloo)."""

    def __init__(self):
        self.rank = dist.get_rank()
        self.world = dist.get_world_size()
        self.backend = dist.get_backend()
        self.device = (torch.device("cuda", torch.cuda.current_device())
                       if self.backend == "nccl" else torch.device("cpu"))

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def all_reduce_grads(self, grads: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The mean over the ranks of each gradient, all-reduced in flat
        buckets of up to BUCKET_ELEMENTS (one dtype a bucket); returns views
        into the buckets, in the order given."""
        out: List[Optional[torch.Tensor]] = [None] * len(grads)
        buckets: Dict[torch.dtype, List[int]] = {}
        for i, g in enumerate(grads):
            buckets.setdefault(g.dtype, []).append(i)
        for idx in buckets.values():
            start = 0
            while start < len(idx):
                stop, size = start, 0
                while stop < len(idx) and (stop == start or size + grads[idx[stop]].numel()
                                           <= BUCKET_ELEMENTS):
                    size += grads[idx[stop]].numel()
                    stop += 1
                part = idx[start:stop]
                flat = torch.cat([grads[i].reshape(-1) for i in part])
                dist.all_reduce(flat)
                flat.div_(self.world)
                for i, view in zip(part, torch.split(flat, [grads[i].numel() for i in part])):
                    out[i] = view.view(grads[i].shape)
                start = stop
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
    """The data-parallel context of the default process group, or None
    when there is none (one process, no collectives), after `check_mesh`
    of `mesh` and the global `batch_size` against its world size."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    check_mesh(MeshConfig() if mesh is None else mesh, world, batch_size)
    return DataParallel() if dist.is_initialized() else None

