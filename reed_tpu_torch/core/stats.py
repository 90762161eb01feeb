"""Training statistics: accumulate scalar statistics across steps, then
report means and standard deviations. Counterpart of reed_tpu/core/stats.py:
`report` accumulates [count, sum, sum of squares] moments, and
`Collector.update(cross_process=True)` sums them over the ranks of the
process group (reed_tpu's process_allgather(...).sum(0)); `report0`
reports on rank 0 only."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from reed_tpu_torch.parallel.mesh import data_parallel

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
        """Capture the moments reported since the last update; with
        `cross_process` under a process group, summed over the ranks in one
        all-reduce over the names any rank reported (report0's only on rank
        0)."""
        dp = data_parallel() if cross_process else None
        names = sorted(_counters)
        if dp is not None:
            everyone = [None] * dp.world
            torch.distributed.all_gather_object(everyone, names)
            names = sorted(set().union(*everyone))
        zero = np.zeros(3)
        deltas = [_counters.get(n, zero) - self._cumulative.get(n, zero) for n in names]
        for name in names:
            self._cumulative[name] = _counters.get(name, zero).copy()
        if dp is not None and names:
            deltas = list(dp.all_sum_host(np.stack(deltas)))
        self._deltas.update(zip(names, deltas))

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
