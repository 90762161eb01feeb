"""Random draws over the batch axis that keep a data-parallel step equal
to the one-process step.

reed_tpu draws t, eps, label drops, dropout masks and coordinate noise
once for the global batch from one key. Inside `global_rows(dp)` (which
the train step and sharded generation enter) each helper here draws at
the global batch's shape, the local leading size times the batch side's
size (dp.world), from the generator every rank holds in the same state,
and returns the rows [b*n, (b+1)*n) of this rank's batch index b
(dp.rank). Each rank then sees the rows of the draws one process makes for
the whole batch, the seq and tensor ranks of one batch index the same
ones, and every rank's generator advances as that process's does. Outside the block, or with dp None, the
helpers are torch.rand, torch.randn and torch.randint. Draws whose leading
axis is not the batch (a scalar coin) call torch directly.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Optional, Sequence, Tuple

import torch

# (rank, world) inside global_rows, per thread and task
_rows: contextvars.ContextVar[Optional[Tuple[int, int]]] = contextvars.ContextVar(
    "global_rows", default=None)


@contextlib.contextmanager
def global_rows(dp):
    """Draw batch draws at the global shape and keep `dp`'s rows inside the
    block (dp None: draw as one process)."""
    token = _rows.set(None if dp is None else (dp.rank, dp.world))
    try:
        yield
    finally:
        _rows.reset(token)


def _draw(fn, shape: Sequence[int], *args, **kwargs) -> torch.Tensor:
    shape = tuple(shape)
    rows = _rows.get()
    if rows is None or not shape:
        return fn(*args, shape, **kwargs)
    rank, world = rows
    b = shape[0]
    return fn(*args, (b * world,) + shape[1:], **kwargs)[rank * b:(rank + 1) * b]


def rand(shape, **kwargs) -> torch.Tensor:
    """torch.rand(shape, **kwargs), drawn for the global batch."""
    return _draw(torch.rand, shape, **kwargs)


def randn(shape, **kwargs) -> torch.Tensor:
    """torch.randn(shape, **kwargs), drawn for the global batch."""
    return _draw(torch.randn, shape, **kwargs)


def randint(low: int, high: int, shape, **kwargs) -> torch.Tensor:
    """torch.randint(low, high, shape, **kwargs), drawn for the global batch."""
    return _draw(torch.randint, shape, low, high, **kwargs)
