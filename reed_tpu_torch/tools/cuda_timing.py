"""Timing on the card: device time by CUDA events, host launch cost.

Used by chip_smoke.py and reed_tpu_torch.tools.attention_variants.
"""

from __future__ import annotations

import time

import torch


def cuda_ms(fn, iters=50, warmup=5, queued=True):
    """ms per call of fn by CUDA events around `iters` calls. queued: the
    calls are queued behind a sleep kernel that outlasts their launch, so
    the events time the device alone and not the host's launch rate."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(warmup):
        fn()
    host_s = (time.perf_counter() - t0) / warmup
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queued:  # ~2 GHz SM clock, 1.5x the host's time to launch them all
        torch.cuda._sleep(int(3e9 * host_s * iters) + 10_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def timed_in_turns(fns, iters=50):
    """Device ms of each function, taken in the order a b c, c b a and
    averaged, so that a drift of the card's clocks is shared."""
    order = list(fns) + list(fns)[::-1]
    times = {name: [] for name in fns}
    for name in order:
        times[name].append(cuda_ms(fns[name], iters=iters))
    return {name: sum(t) / len(t) for name, t in times.items()}


def host_us(fn, calls=200):
    """Host time to launch one call of fn, in us (the device lags behind)."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = 1e6 * (time.perf_counter() - t0) / calls
    torch.cuda.synchronize()
    return us
