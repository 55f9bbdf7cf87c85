"""§6.3.4/6.3.5 reproduction on the port: dispatch order and allocation
overlap.

  * overlap  the paper overlaps cudaMalloc with kernel execution; the
    port's counterpart is the engine's asynchronous dispatch: ``submit``
    queues N independent SpGEMMs and ``drain`` keeps a window of
    dispatches in flight (host-side planning, arena leasing and the
    verify reads overlap device work), against a loop that waits for
    every request (``execute``, then a synchronize).  The difference is
    the host time hidden behind device work.
  * order    the paper launches large-row kernels first (§5.5); the
    port's hash path dispatches its rungs largest first, so the measured
    pipeline inherits that order.

Drives :class:`repro_torch.engine.SpgemmEngine` with ESC on the cage12
analog (``matrices.NORMAL[7]``), 8 requests, ``window=2`` (two lease sets
in flight: enough to overlap planning with the card, few enough that the
arena serves the stream from its free lists), with the arena's hit rate.
:func:`case` runs any matrix.

Run from the repo root:
  PYTHONPATH=src python -m benchmarks.torch.bench_overlap \\
      [--device cpu] [--scale S]
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional, Tuple

from repro_torch.core import SpgemmConfig, resolve_device
from repro_torch.core.csr import CSR
from repro_torch.engine import Arena, SpgemmEngine

from .common import REPS, sync
from .matrices import NORMAL, generate


def case(A: CSR, *, n: int = 8, window: int = 2
         ) -> Tuple[str, Dict[str, float]]:
    """The serialized loop against submit + drain on C = A·A ->
    (the reference's row, its numbers)."""
    engine = SpgemmEngine(SpgemmConfig(method="esc"), arena=Arena())

    def serialized():
        for _ in range(n):
            engine.execute(A, A)
            sync()

    def pipelined():
        for _ in range(n):
            engine.submit(A, A)
        engine.drain(window=window)
        sync()

    def timed(fn) -> float:
        fn()                              # warmup (cold plan + arena fill)
        sync()
        t0 = time.perf_counter()
        for _ in range(REPS):
            fn()
        return (time.perf_counter() - t0) / REPS

    t_serial = timed(serialized)
    t_pipe = timed(pipelined)
    hit = engine.arena.hit_rate
    row = (f"bench_overlap/async_dispatch,{t_pipe*1e6:.0f},"
           f"serialized_us={t_serial*1e6:.0f};"
           f"overlap_gain={t_serial/t_pipe:.3f}x;"
           f"arena_hit_rate={hit:.3f}")
    return row, dict(pipelined_us=t_pipe * 1e6, serialized_us=t_serial * 1e6,
                     overlap_gain=t_serial / t_pipe, arena_hit_rate=hit)


def run(device="cuda", scale: Optional[int] = None) -> List[str]:
    dev = resolve_device(device)
    row, _ = case(generate(NORMAL[7], scale=scale, device=dev))
    print(row, flush=True)
    return [row]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--scale", type=int, default=None,
                    help="row cut 1/S (default: full rows on the card, the "
                         "reference's 1/32 on the CPU)")
    args = ap.parse_args(argv)
    run(args.device, args.scale)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
