"""Benchmark timing discipline (paper §6) for the port: one warmup, then N
timed reps, mean; the device is synchronized before every clock read."""
from __future__ import annotations

import time
from typing import Callable

import torch

REPS = 3          # the paper uses 10


def sync() -> None:
    """Wait for the card (nothing on the CPU), before a clock read."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def timeit(fn: Callable, *args, reps: int = REPS, **kw) -> float:
    """Mean seconds per call: one warmup, then ``reps`` timed runs."""
    fn(*args, **kw)                               # warmup (cold plan)
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn(*args, **kw)
    sync()
    return (time.perf_counter() - t0) / reps


def gflops(nprod: int, seconds: float) -> float:
    """Paper's metric: 2*n_prod / time."""
    return 2.0 * nprod / seconds / 1e9
