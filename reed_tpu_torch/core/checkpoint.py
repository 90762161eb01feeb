"""Checkpoints of a whole TrainState, counterpart of
reed_tpu/core/checkpoint.py in the port's own format (torch.save; reed_tpu
writes orbax).

A checkpoint `{directory}/{step}.pt` holds the step, the model's
state_dict, the EMA, the optimizer's moments (mu in its own dtype), count
and accumulation state, and the random streams: the trainer's
torch.Generator and torch's global CPU and CUDA generators. A resumed run
then draws the same t, eps, dropout and corruption as an uninterrupted one.
Each file is written under a temporary name and renamed, so a run cut
during a save leaves no half checkpoint.

Whether a step is saved is decided from the steps this manager saw (the
directory's at its start, then its own saves), not from the directory,
which under data parallelism rank 0 may be writing while another rank
looks. Data parallel (`dp`): every rank holds the same state and the same
generator (parallel/mesh.py), so rank 0 alone writes the one file, then
every rank waits at a barrier; every rank restores from it, the saving
device's CUDA stream onto its own device. Under the fsdp and tensor axes
(a ShardPlan, state.opt.plan) a rank holds its tensor shards of the
parameters, the moments, the accumulation buffer and the EMA, and of the
fsdp-sharded ones its chunks alone (the parameters too, sharded at rest):
every rank takes part in gathering them whole before rank 0 writes, and on
restore every rank reads the whole tensors and keeps its share. The file
is the same whatever the mesh, so a run resumes on another fsdp, tensor or
seq size or in one process.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Optional

import torch

from reed_tpu_torch.core.train_state import TrainState

_NAME = re.compile(r"^(\d+)\.pt$")


def _rng_state(generator: Optional[torch.Generator]) -> Dict:
    state = {"cpu": torch.get_rng_state()}
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        state["cuda"] = torch.cuda.get_rng_state_all()
        state["cuda_device"] = torch.cuda.current_device()
    if generator is not None:
        state["generator"] = generator.get_state()
    return state


def _set_rng_state(state: Dict, generator: Optional[torch.Generator]):
    torch.set_rng_state(state["cpu"])
    if "cuda" in state and torch.cuda.is_available():
        # the saving device's stream onto this process's device
        torch.cuda.set_rng_state(state["cuda"][state.get("cuda_device", 0)])
    if generator is not None:
        if "generator" not in state:
            raise KeyError("the checkpoint holds no trainer generator state")
        generator.set_state(state["generator"])


def _copy_into(dst: List[torch.Tensor], src: List[torch.Tensor], what: str, plan=None):
    """Copy the whole tensors `src` into the state list `dst` (this rank's
    share where `plan` shards)."""
    if len(dst) != len(src):
        raise ValueError(f"{what}: {len(src)} tensors in the checkpoint, "
                         f"{len(dst)} in the state")
    for i, (d, s) in enumerate(zip(dst, src)):
        if plan is not None:
            s = plan.share(i, s)
        if d.shape != s.shape or d.dtype != s.dtype:
            raise ValueError(f"{what}[{i}]: checkpoint {tuple(s.shape)} {s.dtype}, "
                             f"state {tuple(d.shape)} {d.dtype}")
        d.copy_(s)


def whole_state(state: TrainState) -> Dict:
    """The model's state_dict, EMA, mu, nu and acc of `state` whole: as they
    are, or gathered over the fsdp and tensor groups where state.opt.plan
    shards (a collective)."""
    opt, plan = state.opt, state.opt.plan
    if plan is None:
        return {"model": state.model.state_dict(), "ema": dict(state.ema),
                "mu": list(opt.mu), "nu": list(opt.nu),
                "acc": None if opt.acc is None else list(opt.acc)}
    return {"model": plan.join_state_dict(state.model.state_dict()),
            "ema": plan.whole_named(state.ema),
            "mu": plan.whole(opt.mu), "nu": plan.whole(opt.nu),
            "acc": None if opt.acc is None else plan.whole(opt.acc)}


class CheckpointManager:
    """save / restore / latest_step over `directory`, keeping the newest
    `max_to_keep` checkpoints; `save` writes only at steps that are a
    multiple of `save_interval_steps` and newer than the latest checkpoint
    (orbax's should_save). With `dp` (a parallel.mesh.DataParallel) rank 0
    writes and every rank restores."""

    def __init__(self, directory: str, max_to_keep: int = 5,
                 save_interval_steps: int = 1, dp=None):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.save_interval_steps = max(1, save_interval_steps)
        self.dp = dp
        os.makedirs(self.directory, exist_ok=True)
        self._latest_seen = self.latest_step()

    def all_steps(self) -> List[int]:
        return sorted(int(m.group(1)) for m in map(_NAME.match, os.listdir(self.directory))
                      if m)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"{step}.pt")

    def should_save(self, step: int) -> bool:
        return step % self.save_interval_steps == 0 and (
            self._latest_seen is None or step > self._latest_seen)

    def save(self, state: TrainState, generator: Optional[torch.Generator] = None) -> bool:
        """Write `state` (and the trainer's `generator`) at state.step;
        returns whether it was written (by rank 0, under dp; every rank
        gathers the sharded state first)."""
        step = int(state.step)
        if not self.should_save(step):
            return False
        self._latest_seen = step
        whole = whole_state(state)
        if self.dp is None or self.dp.is_main:
            self._write(state, whole, generator, step)
        if self.dp is not None:
            self.dp.barrier()
        return True

    def _write(self, state: TrainState, whole: Dict, generator: Optional[torch.Generator],
               step: int):
        opt = state.opt
        payload = {
            "step": step,
            "model": whole["model"],
            "ema": whole["ema"],
            "opt": {"count": opt.count, "mini_step": opt.mini_step, "mu": whole["mu"],
                    "nu": whole["nu"], "acc": whole["acc"]},
            "rng": _rng_state(generator),
        }
        tmp = self.path(step) + ".tmp"
        torch.save(payload, tmp)
        os.replace(tmp, self.path(step))
        for old in self.all_steps()[:-self.max_to_keep]:
            os.remove(self.path(old))

    def restore(self, state: TrainState, generator: Optional[torch.Generator] = None,
                step: Optional[int] = None) -> TrainState:
        """Load checkpoint `step` (default the latest) into `state` in place,
        on its devices and in its dtypes (this rank's chunks of the sharded
        state), and set the random streams; the trainer's `generator` too
        where given. Returns `state`."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        ckpt = torch.load(self.path(step), map_location="cpu", weights_only=False)
        opt, saved = state.opt, ckpt["opt"]
        plan = opt.plan
        with torch.no_grad():
            state.model.load_state_dict(ckpt["model"] if plan is None else
                                        plan.share_state_dict(ckpt["model"]))
            names = list(state.ema) if plan is None else plan.names
            if set(names) != set(ckpt["ema"]) or set(names) != set(state.ema):
                raise ValueError("the checkpoint's EMA names differ from the state's")
            _copy_into([state.ema[n] for n in names], [ckpt["ema"][n] for n in names],
                       "ema", plan)
            _copy_into(opt.mu, saved["mu"], "mu", plan)
            _copy_into(opt.nu, saved["nu"], "nu", plan)
            if (opt.acc is None) != (saved["acc"] is None):
                raise ValueError("accum_steps differs from the checkpoint's")
            if opt.acc is not None:
                _copy_into(opt.acc, saved["acc"], "acc", plan)
            opt.count, opt.mini_step = saved["count"], saved["mini_step"]
        _set_rng_state(ckpt["rng"], generator)
        state.step = ckpt["step"]
        return state

    def load_ema(self, step: Optional[int] = None) -> Dict[str, torch.Tensor]:
        """The EMA weights of checkpoint `step` (default the latest), on the
        CPU, keyed by parameter name."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        return torch.load(self.path(step), map_location="cpu", weights_only=False)["ema"]
