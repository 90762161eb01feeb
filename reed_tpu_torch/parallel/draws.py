"""Random draws over the batch axis that keep a data-parallel step equal
to the one-process step.

reed_tpu draws t, eps, label drops, dropout masks and coordinate noise
once for the global batch from one key. Inside `global_rows(dp)` (which
the train step and sharded generation enter) each helper here draws at
the global batch's shape, the local leading size times the batch side's
size (dp.world), from the generator every rank holds in the same state,
and returns the rows [b*n, (b+1)*n) of this rank's batch index b
(dp.rank). Inside `global_rows(dp, n)` (sharded evaluation, whose batches
need not divide) the global batch is n rows, split as np.array_split
splits them (split_rows), and a draw keeps this batch index's
share. Each rank then sees the rows of the draws one process makes for the
whole batch, the seq and tensor ranks of one batch index the same ones,
and every rank's generator advances as that process's does. A draw whose
batch axis is not axis 0 ([steps, B, ...]) names it (`axis=1`), and
`keep` takes this rank's rows of a tensor given at the global shape (the
draws a test injects). Outside the block, or with dp None, the helpers are
torch.rand, torch.randn and torch.randint and `keep` returns its input.
Draws whose leading axis is not the batch (a scalar coin) call torch
directly.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

# (rank, world, global rows or None) inside global_rows, per thread and task
_rows: contextvars.ContextVar[Optional[Tuple[int, int, Optional[int]]]] = (
    contextvars.ContextVar("global_rows", default=None))


def split_rows(n: int, world: int) -> Tuple[np.ndarray, np.ndarray]:
    """(starts, counts) of n rows over `world` batch indices as
    np.array_split makes them: the first n mod world indices take one row
    more."""
    counts = np.full(world, n // world, np.int64)
    counts[:n % world] += 1
    return np.concatenate([[0], np.cumsum(counts)[:-1]]), counts


@contextlib.contextmanager
def global_rows(dp, n: Optional[int] = None):
    """Draw batch draws at the global shape and keep `dp`'s rows inside the
    block (dp None: draw as one process). `n`: the global batch's rows,
    split by split_rows (None: every batch index holds as many rows as the
    draw asks for)."""
    token = _rows.set(None if dp is None else (dp.rank, dp.world, n))
    try:
        yield
    finally:
        _rows.reset(token)


def splitting() -> bool:
    """Whether a draw here keeps one batch index's rows of several."""
    rows = _rows.get()
    return rows is not None and rows[1] > 1


def _span(local: int) -> Tuple[int, int, int]:
    """(start, count, global size) of this rank's rows of an axis whose
    local size is `local` inside the block."""
    rank, world, n = _rows.get()
    n = local * world if n is None else n
    starts, counts = split_rows(n, world)
    if local != counts[rank]:
        raise ValueError(f"a draw of {local} rows, but batch index {rank} holds "
                         f"{counts[rank]} of the global batch's {n}")
    return int(starts[rank]), local, n


def _draw(fn, shape: Sequence[int], *args, axis: int = 0, **kwargs) -> torch.Tensor:
    shape = tuple(shape)
    if _rows.get() is None or not shape:
        return fn(*args, shape, **kwargs)
    start, count, total = _span(shape[axis])
    whole = fn(*args, shape[:axis] + (total,) + shape[axis + 1:], **kwargs)
    return whole.narrow(axis, start, count)


def keep(x, axis: int = 0):
    """This rank's rows along `axis` of `x`, given at the global batch's
    shape (None as it is; all of it outside the block)."""
    rows = _rows.get()
    if rows is None or x is None:
        return x
    rank, world, n = rows
    total = x.shape[axis]
    if n is not None and total != n:
        raise ValueError(f"a draw of {total} rows along axis {axis}, the global batch "
                         f"holds {n}")
    starts, counts = split_rows(total, world)
    if n is None and total % world:
        raise ValueError(f"a draw of {total} rows does not split over {world} ranks")
    return x.narrow(axis, int(starts[rank]), int(counts[rank]))


def rand(shape, axis: int = 0, **kwargs) -> torch.Tensor:
    """torch.rand(shape, **kwargs), drawn for the global batch (its batch
    along `axis`)."""
    return _draw(torch.rand, shape, axis=axis, **kwargs)


def randn(shape, axis: int = 0, **kwargs) -> torch.Tensor:
    """torch.randn(shape, **kwargs), drawn for the global batch."""
    return _draw(torch.randn, shape, axis=axis, **kwargs)


def randint(low: int, high: int, shape, **kwargs) -> torch.Tensor:
    """torch.randint(low, high, shape, **kwargs), drawn for the global batch."""
    return _draw(torch.randint, shape, low, high, **kwargs)
