"""Training statistics: accumulate scalar statistics across steps, then
report means and standard deviations. Counterpart of reed_tpu/core/stats.py
on one process: `report` accumulates [count, sum, sum of squares] moments,
and `Collector.update(cross_process=True)` would sum them across
processes, which at a world size of 1 leaves them as they are (multi-GPU
is not ported)."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

_counters: Dict[str, np.ndarray] = {}


def _process_index() -> int:
    dist = torch.distributed
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def report(name: str, value) -> None:
    """Accumulate [num, sum, sum_sq] moments of `value` for `name`."""
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu().double().numpy()
    arr = np.asarray(value, np.float64).ravel()
    if arr.size == 0:
        return
    moments = np.array([arr.size, arr.sum(), np.square(arr).sum()], np.float64)
    _counters[name] = _counters.get(name, np.zeros(3)) + moments


def report0(name: str, value) -> None:
    """Report only on process 0."""
    if _process_index() == 0:
        report(name, value)


class Collector:
    """Snapshot-and-query interface over the reported moments."""

    def __init__(self):
        self._deltas: Dict[str, np.ndarray] = {}
        self._cumulative: Dict[str, np.ndarray] = {}

    def update(self, cross_process: bool = False):
        """Capture the moments reported since the last update. The port runs
        one process, so `cross_process` has nothing to sum."""
        if cross_process and torch.distributed.is_available() \
                and torch.distributed.is_initialized() \
                and torch.distributed.get_world_size() > 1:
            raise NotImplementedError("cross-process stats: multi-GPU is not ported")
        for name, total in list(_counters.items()):
            self._deltas[name] = total - self._cumulative.get(name, np.zeros(3))
            self._cumulative[name] = total.copy()

    def names(self):
        return list(self._deltas)

    def num(self, name: str) -> int:
        return int(self._deltas.get(name, np.zeros(3))[0])

    def mean(self, name: str) -> float:
        d = self._deltas.get(name, np.zeros(3))
        return float(d[1] / d[0]) if d[0] > 0 else float("nan")

    def std(self, name: str) -> float:
        d = self._deltas.get(name, np.zeros(3))
        if d[0] <= 1:
            return 0.0
        mean = d[1] / d[0]
        return float(np.sqrt(max(d[2] / d[0] - mean ** 2, 0.0)))

    def as_dict(self) -> Dict[str, Dict[str, float]]:
        return {name: {"num": self.num(name), "mean": self.mean(name),
                       "std": self.std(name)} for name in self.names()}


def reset():
    _counters.clear()
