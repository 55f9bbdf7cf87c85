"""The reference's engine gates (benchmarks/bench_engine.py) on the port.

Every gate and threshold is the reference's; ``scripts/ci_torch.sh`` runs
each of its nine configurations on the CPU, and ``chip_smoke.py`` runs
them on the card.

The main stream: >= 20 same-bucket requests; the cold call over the
steady state (mean of the tail) must be >= 5x, the plan-cache hit rate
>= 90 %, and after the warmup there must be ZERO retraces (in the port a
retrace is a pipeline build: ``repro_torch.engine.stats.total_traces``).
A second phase drains the same stream through ``submit``/``drain``.

  ``--method hash``  the hash steady state (table accesses recorded);
  ``--fused``        hash: the fused one-build steady state with row
                     packing; gates an access reduction >= 1.5 over
                     symbolic + numeric and bitwise parity with two-pass;
  ``--adaptive``     hash: no static knobs (AUTO shard count, tracked
                     headroom, fused by default); gates that every request
                     went through the policy, parity with two-pass, and a
                     steady state <= 2x the fixed-2x baseline that a plain
                     ``--method hash`` run recorded in the ``--json`` file;
  ``--shards N``     the partition-aware engine; gates parity with the
                     unsharded path (values allclose: a merge, as in the
                     reference);
  ``--arena``        K shape-bucket plans under a governor cap of 0.6x the
                     per-plan-buffer baseline; gates peak <= cap <
                     baseline, zero retraces, bitwise parity against an
                     uncapped engine;
  ``--estimate``     ``plan_mode="estimate"`` first, exact planning second
                     (one process); gates sizing >= 3x, the first call no
                     slower, zero retraces, steady state <= 1.5x exact,
                     every estimate resolved, bitwise parity;
  ``--trace PATH``   telemetry on; gates every required span, a schema-
                     valid Chrome trace and < 5 % tracing overhead
                     (same-process A/B);
  ``--serve``        the service under a seeded FaultPlan; gates zero
                     failed requests, each chaos result bitwise equal to
                     its fault-free twin, a bounded p99, a poisoned request
                     that errors without a retry, a stalled one that times
                     out, and the tenant counters on a live ``/metrics``
                     scrape.

The operands are the reference's matrices: the reference draws them with
``random_csr(jax.random.PRNGKey(2s))`` and ``PRNGKey(2s + 1)``, and the
port's ``random_csr`` draws the same bits from the int seeds that those
keys give (``repro_torch.core.csr.prng_key_seed``, JAX's threefry
computed without JAX).  The plain int seeds ``2s``, ``2s + 1`` give other
matrices, on which both packages' hash engines rebuild once after the
warmup (the adaptive headroom's trim at the 16th admitted call).

``--device cuda`` (the default) runs on the card, and a missing card is an
error; every timed call ends in ``torch.cuda.synchronize()``.  A gate that
compares hash results bit for bit runs inside
``torch.use_deterministic_algorithms(True)``, where the hash wrappers
launch their fixed-order kernels (``repro_torch.kernels.spgemm_hash``),
and the mode is restored after it; the bench prints each gate's mode.
Each run records one entry, with the device (on the card its name and
power limit as ``nvidia-smi`` gives them), in its own trajectory file
(``--json``, by default ``chiprun_out/bench_engine_torch.json``); it never
writes the reference's ``BENCH_engine.json``.  It exits 1 when any gate
fails, as the reference does.

Run from the repo root:
  PYTHONPATH=src python -m benchmarks.torch.bench_engine [--smoke]
      [--device cpu] [--method hash] [--fused | --adaptive | --shards 2 |
      --arena | --estimate | --serve] [--trace PATH] [--json PATH]
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import json
import subprocess
import sys
import time
import urllib.request
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core import (SpgemmConfig, bin_rows_for_ladder, next_bucket,
                              nprod_into_rpt, random_csr, resolve_device,
                              spgemm_reference)
from repro_torch.core.analysis import exclusive_sum_in_place
from repro_torch.core.csr import prng_key_seed
from repro_torch.core.faults import FaultPlan, FaultSpec
from repro_torch.engine import (AdaptivePolicy, Arena, MatrixSig,
                                MemoryGovernor, SpgemmEngine, Telemetry,
                                git_rev, total_traces, utc_now_iso,
                                validate_chrome_trace)
from repro_torch.kernels import spgemm_hash
from repro_torch.serve import SpgemmService

REPO = Path(__file__).resolve().parents[2]
DEFAULT_JSON = REPO / "chiprun_out" / "bench_engine_torch.json"


# ---------------------------------------------------------------------------
# Device, modes and the trajectory file.
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def describe(dev: torch.device) -> str:
    return card() if dev.type == "cuda" else str(dev)


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@contextlib.contextmanager
def fixed_order(on: bool):
    """``torch.use_deterministic_algorithms(on)`` inside, the caller's
    mode after; yields the mode's name."""
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(on)
    try:
        yield "deterministic" if on else "default"
    finally:
        torch.use_deterministic_algorithms(was)


def record_trajectory(path: Path, key: str, entry: dict) -> None:
    """Merge one configuration's entry into the trajectory file at
    ``path`` (an unreadable file is set aside as ``<name>.corrupt``)."""
    if path.resolve() == (REPO / "BENCH_engine.json").resolve():
        raise ValueError("the port's trajectory never goes to "
                         "BENCH_engine.json (the reference's file)")
    payload = {}
    if path.exists():
        try:
            payload = json.loads(path.read_text())
        except (ValueError, OSError):
            corrupt = path.with_suffix(".json.corrupt")
            path.rename(corrupt)
            print(f"WARNING: unreadable {path.name} preserved as "
                  f"{corrupt.name}; starting a fresh trajectory",
                  file=sys.stderr)
    payload[key] = entry
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(payload, indent=1, sort_keys=True) + "\n")


def read_trajectory(path: Path, key: str) -> Optional[dict]:
    try:
        return json.loads(path.read_text()).get(key)
    except (ValueError, OSError):
        return None


class Gates:
    """A run's gates: correctness gates (the result must hold), timing
    gates (a measured value against the reference's threshold) and the
    mode each bitwise gate ran in."""

    def __init__(self):
        self.correctness: Dict[str, bool] = {}
        self.timing: Dict[str, dict] = {}
        self.modes: Dict[str, str] = {}

    def check(self, name: str, ok: bool) -> bool:
        self.correctness[name] = bool(ok)
        return bool(ok)

    def time(self, name: str, value: float, target: str, ok: bool) -> bool:
        self.timing[name] = dict(value=value, target=target, ok=bool(ok))
        return bool(ok)

    @property
    def ok(self) -> bool:
        return (all(self.correctness.values())
                and all(t["ok"] for t in self.timing.values()))

    def as_dict(self, **extra) -> dict:
        return dict(ok=self.ok, correctness=dict(self.correctness),
                    timing={k: dict(v) for k, v in self.timing.items()},
                    modes=dict(self.modes), **extra)


# ---------------------------------------------------------------------------
# Operands and comparisons.
# ---------------------------------------------------------------------------

def build_stream(n_requests: int, m: int, k: int, n: int, avg: float,
                 device):
    """Distinct matrices canonicalized to ONE shape-bucket signature: the
    reference's, of keys PRNGKey(2s) and PRNGKey(2s + 1)."""
    pairs = []
    for s in range(n_requests):
        A = random_csr(prng_key_seed(2 * s), m, k, avg_nnz_per_row=avg,
                       device=device)
        B = random_csr(prng_key_seed(2 * s + 1), k, n,
                       avg_nnz_per_row=avg, device=device)
        pairs.append((A, B))
    # Same-bucket premise: pad every operand to the stream-wide pow-2
    # bucket (the serving tier's batching discipline).
    cap_a = next_bucket(max(A.capacity for A, _ in pairs))
    cap_b = next_bucket(max(B.capacity for _, B in pairs))
    return [(A.with_capacity(cap_a), B.with_capacity(cap_b))
            for A, B in pairs]


def measure_hash_accesses(A, B, config: SpgemmConfig, *,
                          with_fused: bool = True):
    """Fig.-9 access counters on one pair: two-pass vs fused table builds
    -> ``(sym, num, fused)`` table-transaction totals (fused None unless
    ``with_fused``).  On the card these are the kernels' own counts."""
    m = A.nrows
    sym_lad, num_lad = config.ladders()
    nprod = nprod_into_rpt(A, B)[:m]
    sym_bn = bin_rows_for_ladder(nprod, sym_lad)
    nnz_buf, acc_s = spgemm_hash.symbolic_binned(
        A, B, sym_bn, sym_lad, single_access=config.hash_single_access,
        collect_accesses=True)
    num_bn = bin_rows_for_ladder(nnz_buf[:m], num_lad)
    cap = next_bucket(max(int(nnz_buf[:m].sum()), 1))
    rpt = exclusive_sum_in_place(nnz_buf)
    _, acc_n = spgemm_hash.numeric_binned(
        A, B, rpt, num_bn, num_lad, nnz_capacity=cap,
        single_access=config.hash_single_access, collect_accesses=True)
    if not with_fused:
        return int(acc_s), int(acc_n), None
    _, acc_f = spgemm_hash.fused_binned(
        A, B, sym_bn, sym_lad, nnz_capacity=cap,
        single_access=config.hash_single_access,
        row_packing=config.row_packing, collect_accesses=True)
    return int(acc_s), int(acc_n), int(acc_f)


def _host(x: torch.Tensor) -> np.ndarray:
    return x.cpu().numpy()


def result_parity(base, res, *, bitwise_val: bool) -> bool:
    """nnz/rpt/col/val parity of two SpgemmResults (bitwise structure;
    values bitwise or allclose: sharded merges may reorder float sums)."""
    nnz = base.total_nnz
    val_eq = np.array_equal if bitwise_val else np.allclose
    return (
        res.total_nnz == nnz
        and np.array_equal(_host(res.C.rpt), _host(base.C.rpt))
        and np.array_equal(_host(res.C.col)[:nnz], _host(base.C.col)[:nnz])
        and val_eq(_host(res.C.val)[:nnz], _host(base.C.val)[:nnz]))


def check_dense(A, B, res) -> None:
    ref = _host(spgemm_reference(A, B))
    np.testing.assert_allclose(_host(res.C.to_dense()), ref, rtol=1e-4,
                               atol=1e-4)


def _lease_bytes(spec) -> int:
    """Bucketed bytes one plan's workspace lease pins (the per-plan-buffer
    baseline sums these)."""
    return sum(Arena._bucket_bytes(k) for k in Arena._buckets(spec))


def _mode_line(gates: Gates, name: str, mode: str) -> None:
    gates.modes[name] = mode
    print(f"mode:          {mode:>9s}  ({name})")


# ---------------------------------------------------------------------------
# The gates.
# ---------------------------------------------------------------------------

def run_arena_gate(args, dev) -> dict:
    """K distinct shape-bucket plans served out of one governor-capped
    arena (the reference's arena gate)."""
    cfg = SpgemmConfig(method=args.method)
    K, rounds, window = args.plans, 3, 3
    gates = Gates()
    pairs = []
    for i in range(K):          # distinct nrows: K cached plans
        m = args.m + 8 * i
        A = random_csr(prng_key_seed(2 * i), m, args.k,
                       avg_nnz_per_row=args.avg, device=dev)
        B = random_csr(prng_key_seed(2 * i + 1), args.k, args.n,
                       avg_nnz_per_row=args.avg, device=dev)
        pairs.append((A, B))

    with fixed_order(args.method == "hash") as mode:
        _mode_line(gates, "arena parity", mode)
        engine = SpgemmEngine(cfg, arena=Arena())
        for A, B in pairs:                # cold (steps) + hot (first lease)
            engine.execute(A, B)
            engine.execute(A, B)
        sync(dev)
        entries = [engine.cache.get((MatrixSig.of(A), MatrixSig.of(B), cfg))
                   for A, B in pairs]
        specs = [e.plan.workspace_spec() for e in entries]
        leasable = gates.check("every plan leases",
                               all(s is not None for s in specs))
        baseline = sum(_lease_bytes(s) for s in specs if s is not None)
        cap = int(0.6 * baseline)
        engine.governor = MemoryGovernor(cap_bytes=cap)
        engine.arena.reclaim()            # drop warmup leases: cap must bind
        engine.arena.reset_peak()
        hits0, misses0 = engine.arena.lease_hits, engine.arena.lease_misses
        warm_traces = total_traces()

        last = None
        t0 = time.perf_counter()
        for _ in range(rounds):
            uids = [engine.submit(A, B) for A, B in pairs]
            results = engine.drain(window=window)
            sync(dev)
            last = [results[u] for u in uids]
        traffic_s = time.perf_counter() - t0
        n_reqs = rounds * K

        peak = engine.arena.peak_bytes
        retraces = total_traces() - warm_traces
        hits = engine.arena.lease_hits - hits0
        misses = engine.arena.lease_misses - misses0
        hit_rate = hits / max(hits + misses, 1)

        # Bitwise parity: an uncapped fresh engine (own arena) must give
        # byte-identical results.
        fresh = SpgemmEngine(cfg, arena=Arena())
        parity = True
        for (A, B), res in zip(pairs, last):
            fresh.execute(A, B)
            base = fresh.execute(A, B)     # hot path, like the gated stream
            parity = parity and result_parity(base, res, bitwise_val=True)

    gates.check("peak <= cap", leasable and peak <= cap)
    gates.check("peak < baseline", leasable and peak < baseline)
    gates.check("zero retraces", retraces == 0)
    gates.check("parity", parity)
    print(f"plans:         {K:9d} distinct shape buckets "
          f"({rounds} rounds, window {window})")
    print(f"baseline:      {baseline:9d} B  (per-plan private workspaces)")
    print(f"governor cap:  {cap:9d} B  (0.6x baseline)")
    print(f"arena peak:    {peak:9d} B  "
          f"({peak / max(baseline, 1):.2f}x baseline, "
          f"{'OK' if peak <= cap and peak < baseline else 'OVER'})")
    print(f"lease reuse:   {hits:9d} hits / {misses} misses "
          f"({hit_rate * 100:.1f}% hit rate, "
          f"{engine.stats.arena_pressure} pressure events)")
    print(f"hot traces:    {total_traces():9d}  "
          f"({retraces} after warmup, target 0)")
    print(f"parity:        {'OK' if parity else 'MISMATCH':>9s}  "
          f"(capped arena vs fresh engine: nnz/rpt/col/val bitwise)")
    print(f"traffic:       {traffic_s * 1e3:9.1f} ms for {n_reqs} requests "
          f"({traffic_s / n_reqs * 1e3:.2f} ms/req)")
    print()
    print(engine.report())

    key = f"{args.method}_arena@{args.m}x{args.k}x{args.n}k{K}"
    entry = dict(
        plans=K, rounds=rounds, window=window,
        shape=[args.m, args.k, args.n], baseline_workspace_bytes=baseline,
        governor_cap_bytes=cap, peak_workspace_bytes=peak,
        peak_over_baseline=round(peak / max(baseline, 1), 4),
        arena_hit_rate=round(hit_rate, 4),
        pressure_events=engine.stats.arena_pressure,
        retraces_after_warmup=retraces,
        traffic_ms_per_request=round(traffic_s / n_reqs * 1e3, 4))
    return gates.as_dict(key=key, entry=entry)


def run_estimate_gate(args, dev) -> dict:
    """Estimation-based cold planning (the reference's estimate gate): the
    estimate stream first, cold, then exact planning on a fresh engine in
    the same process."""
    gates = Gates()
    stream = build_stream(args.requests, args.m, args.k, args.n, args.avg,
                          dev)

    def run_stream(config):
        engine = SpgemmEngine(config)
        times, results = [], []
        warm = total_traces()
        for i, (A, B) in enumerate(stream):
            t0 = time.perf_counter()
            res = engine.execute(A, B)
            sync(dev)
            times.append(time.perf_counter() - t0)
            results.append(res)
            if i == args.warmup - 1:
                # Absorb any pending schedule rebuild before the gate arms.
                engine.execute(A, B)
                sync(dev)
                warm = total_traces()
            if args.check:
                check_dense(A, B, res)
        return engine, times, results, total_traces() - warm

    with fixed_order(args.method == "hash") as mode:
        _mode_line(gates, "estimate parity", mode)
        est_engine, est_t, est_res, retraces = run_stream(
            SpgemmConfig(method=args.method, plan_mode="estimate"))
        exact_engine, ex_t, ex_res, _ = run_stream(
            SpgemmConfig(method=args.method))

    est_cold, ex_cold = est_t[0], ex_t[0]
    est_steady = min(est_t[len(est_t) // 2:])
    ex_steady = min(ex_t[len(ex_t) // 2:])
    parity = all(result_parity(b, r, bitwise_val=True)
                 for b, r in zip(ex_res, est_res))
    phases_ms = {n: round(t * 1e3, 3)
                 for n, t in sorted(est_res[0].timings.items())}
    # The exact cold call IS the symbolic sizing pass; the "estimate" phase
    # is what stands in for it.
    plan_ms = phases_ms.get("estimate", 0.0)
    plan_ratio = ex_cold * 1e3 / max(plan_ms, 1e-6)
    s = est_engine.stats
    gates.time("sizing speedup", plan_ratio, ">= 3x",
               plan_ratio >= 3.0 and plan_ms > 0.0)
    gates.time("first call", est_cold * 1e3,
               f"<= exact cold {ex_cold * 1e3:.3f} ms", est_cold <= ex_cold)
    gates.time("steady state", est_steady * 1e3,
               f"<= 1.5x exact {ex_steady * 1e3:.3f} ms",
               est_steady <= 1.5 * ex_steady)
    gates.check("zero retraces", retraces == 0)
    gates.check("estimates resolved", s.estimates > 0 and (
        s.estimate_hits + s.estimate_misses >= s.estimates))
    gates.check("parity", parity)

    print(f"method:        {args.method:>9s}  (plan_mode=estimate vs exact)")
    print(f"sizing pass:   {plan_ms:9.1f} ms estimate vs "
          f"{ex_cold * 1e3:.1f} ms exact symbolic sizing = "
          f"{plan_ratio:.1f}x (target >= 3x)")
    print(f"cold call:     {est_cold * 1e3:9.1f} ms estimate vs "
          f"{ex_cold * 1e3:.1f} ms exact")
    print("cold phases:   " + ", ".join(
        f"{n} {t:.1f} ms" for n, t in phases_ms.items()))
    print(f"steady state:  {est_steady * 1e3:9.2f} ms estimate vs "
          f"{ex_steady * 1e3:.2f} ms exact min-of-tail")
    print(f"estimates:     {s.estimates:9d} plans "
          f"({s.estimate_hits} confirmed / {s.estimate_misses} retraced, "
          f"headroom {est_engine.est_state.headroom:.2f})")
    print(f"retraces:      {retraces:9d} after {args.warmup}-request "
          f"warmup (target 0)")
    print(f"parity:        {'OK' if parity else 'MISMATCH':>9s}  "
          f"(estimate vs exact stream: nnz/rpt/col/val bitwise, "
          f"{len(stream)} requests)")
    print()
    print(est_engine.report())

    key = f"{args.method}_estimate@{args.m}x{args.k}x{args.n}r{args.requests}"
    entry = dict(
        requests=args.requests, shape=[args.m, args.k, args.n],
        cold_ms=round(est_cold * 1e3, 3), exact_cold_ms=round(ex_cold * 1e3, 3),
        plan_ms=round(plan_ms, 3), plan_speedup=round(plan_ratio, 2),
        steady_min_ms=round(est_steady * 1e3, 4),
        exact_steady_min_ms=round(ex_steady * 1e3, 4), phases_ms=phases_ms,
        estimates=s.estimates, estimate_hits=s.estimate_hits,
        estimate_misses=s.estimate_misses, retraces_after_warmup=retraces)
    return gates.as_dict(key=key, entry=entry)


def run_serve_gate(args, dev) -> dict:
    """The fault-tolerant serving front end under chaos (the reference's
    chaos gate)."""
    gates = Gates()
    cfg = SpgemmConfig(method=args.method)
    stream = build_stream(args.requests, args.m, args.k, args.n, args.avg,
                          dev)
    tenants = ["alpha", "beta"]
    assign = [tenants[i % 2] for i in range(len(stream))]

    def run_service(faults=None):
        svc = SpgemmService(cfg, arena=Arena(), faults=faults,
                            backoff_base_s=1e-3, backoff_cap_s=0.05)
        outs, lats = [], []
        for (A, B), ten in zip(stream, assign):
            t0 = time.perf_counter()
            r = svc.call(A, B, tenant=ten, deadline_s=60.0)
            sync(dev)
            lats.append(time.perf_counter() - t0)
            outs.append(r)
        return svc, outs, lats

    def p99(lats):
        return sorted(lats)[min(len(lats) - 1, int(0.99 * len(lats)))]

    with fixed_order(args.method == "hash") as mode:
        _mode_line(gates, "chaos parity", mode)
        # Phase 1: the chaos stream against its fault-free twin.
        _, clean, clean_lats = run_service()
        chaos_plan = FaultPlan([
            # Visits 5 and 6 are one request's acquisition and its retry
            # after reclaim (or two requests'): at least one
            # ArenaPressureError reaches the service's retry loop.
            FaultSpec(site="lease_denial", at=(5, 6)),
            FaultSpec(site="lease_denial", probability=0.25),
            FaultSpec(site="verify_overflow", probability=0.15),
        ], seed=args.seed)
        svc, chaos, chaos_lats = run_service(chaos_plan)

    failed = [i for i, r in enumerate(chaos) if not r.ok]
    parity = all(r.ok and result_parity(c.value, r.value, bitwise_val=True)
                 for c, r in zip(clean, chaos))
    retries = sum(r.retries for r in chaos)
    survived = sum(r.faults_survived for r in chaos)
    injected = chaos_plan.total_injected
    p99_clean, p99_chaos = p99(clean_lats), p99(chaos_lats)
    p99_bound = max(5.0 * p99_clean, 0.5)

    # Phase 2: the structured-failure contract.
    A0, B0 = stream[0]
    svc_poison = SpgemmService(cfg, arena=Arena(), faults=FaultPlan(
        [FaultSpec(site="executor_raise", at=(0,), message="poisoned")]))
    r_poison = svc_poison.call(A0, B0, tenant="alpha")
    svc_slow = SpgemmService(cfg, arena=Arena(), faults=FaultPlan(
        [FaultSpec(site="slow_dispatch", at=(1,), delay_s=0.3)]))
    svc_slow.call(A0, B0, tenant="alpha")        # warm: latency history
    r_slow = svc_slow.call(A0, B0, tenant="alpha", deadline_s=0.05)

    # Phase 3: a live /metrics scrape (the service's own server, on
    # localhost).
    server = svc.serve_http()
    try:
        body = urllib.request.urlopen(server.url, timeout=10).read().decode()
    finally:
        svc.close()
    scrape_ok = all(
        f'opsparse_service_requests_total{{tenant="{t}"}}' in body
        for t in tenants) and all(name in body for name in (
            "opsparse_service_retries_total",
            "opsparse_service_timeouts_total",
            "opsparse_service_sheds_total",
            "opsparse_service_faults_survived_total",
            "opsparse_engine_faults_injected_total"))

    gates.check("zero failed requests", not failed)
    gates.check("parity", parity)
    gates.check("faults injected", injected > 0)
    gates.check("poisoned request errors without retry",
                r_poison.status == "error" and r_poison.retries == 0
                and "poisoned" in (r_poison.error or ""))
    gates.check("stalled request times out",
                r_slow.status == "timeout" and r_slow.value is None)
    gates.check("/metrics tenant series", scrape_ok)
    gates.time("p99 under chaos", p99_chaos * 1e3,
               f"<= {p99_bound * 1e3:.0f} ms (5x clean p99, 500 ms floor)",
               p99_chaos <= p99_bound)

    n = len(stream)
    print(f"stream:        {n:9d} requests over {len(tenants)} tenants "
          f"(seed {args.seed})")
    print(f"chaos:         {injected:9d} faults injected "
          f"({retries} service retries, {survived} survived on ok paths)")
    print(f"failures:      {len(failed):9d} failed well-formed requests "
          f"(target 0){'' if not failed else ' -> ' + str(failed)}")
    print(f"parity:        {'OK' if parity else 'MISMATCH':>9s}  "
          f"(chaos vs fault-free twin: nnz/rpt/col/val bitwise)")
    print(f"p99 latency:   {p99_chaos * 1e3:9.1f} ms under chaos vs "
          f"{p99_clean * 1e3:.1f} ms clean (bound {p99_bound * 1e3:.0f} ms)")
    print(f"poisoned req:  {r_poison.status:>9s}  "
          f"({r_poison.retries} retries, target error/0)")
    print(f"deadline req:  {r_slow.status:>9s}  (injected stall vs 50 ms "
          f"budget, target timeout)")
    print(f"scrape:        {'OK' if scrape_ok else 'MISSING':>9s}  "
          f"(per-tenant series on live /metrics)")

    key = f"{args.method}_serve@{args.m}x{args.k}x{args.n}"
    entry = dict(
        requests=n, tenants=tenants, shape=[args.m, args.k, args.n],
        seed=args.seed, faults_injected=injected,
        fault_sites=chaos_plan.snapshot()["injected"],
        service_retries=retries, faults_survived=survived,
        failed_requests=len(failed), p99_clean_ms=round(p99_clean * 1e3, 3),
        p99_chaos_ms=round(p99_chaos * 1e3, 3))
    return gates.as_dict(key=key, entry=entry)


def run_stream_gate(args, dev) -> dict:
    """The main stream: plan cache, retraces, and the --fused, --adaptive,
    --shards and --trace gates."""
    gates = Gates()
    stream = build_stream(args.requests, args.m, args.k, args.n, args.avg,
                          dev)
    telemetry = (Telemetry(enabled=True, events_capacity=1 << 16)
                 if args.trace else None)
    if args.adaptive:
        config = SpgemmConfig(method="hash")
        engine = SpgemmEngine(config, shards="auto",
                              policy=AdaptivePolicy(trim_streak=6),
                              telemetry=telemetry)
    else:
        config = SpgemmConfig(method=args.method, fuse_numeric=args.fused,
                              row_packing=args.fused)
        engine = SpgemmEngine(config, shards=args.shards,
                              telemetry=telemetry)

    # Phase 1: per-call wall clock over the stream.
    times = []
    warm_traces = 0
    cold_phases = None
    for i, (A, B) in enumerate(stream):
        t0 = time.perf_counter()
        res = engine.execute(A, B)
        sync(dev)
        times.append(time.perf_counter() - t0)
        if i == 0 and res.timings:
            cold_phases = {n: round(t * 1e3, 3)
                           for n, t in sorted(res.timings.items())}
        if i == args.warmup - 1:
            # A schedule grow on this request leaves the rebuild pending:
            # absorb it with an untimed repeat before the gate arms.
            engine.execute(A, B)
            sync(dev)
            warm_traces = total_traces()
        if args.check:
            check_dense(A, B, res)

    cold = times[0]
    tail = times[len(times) // 2:]
    steady = sum(tail) / len(tail)
    steady_min = min(tail)
    speedup = cold / steady
    hit_rate = engine.cache.hit_rate
    retraces = total_traces() - warm_traces
    gates.time("speedup", speedup, ">= 5x", speedup >= 5.0)
    gates.check("hit rate >= 90%", hit_rate >= 0.90)
    gates.check("zero retraces", retraces == 0)

    print("request,call_ms")
    for i, t in enumerate(times):
        print(f"{i},{t * 1e3:.2f}")
    print()
    print(f"method:        {args.method:>9s}")
    print(f"cold call:     {cold * 1e3:9.1f} ms")
    print(f"steady state:  {steady * 1e3:9.2f} ms  "
          f"(mean of last {len(tail)} calls)")
    print(f"speedup:       {speedup:9.1f} x   (target >= 5x)")
    print(f"hit rate:      {hit_rate * 100:9.1f} %   (target >= 90%)")
    print(f"hot traces:    {total_traces():9d}  "
          f"({retraces} after {args.warmup}-request warmup, target 0)")

    # Sharded parity: the merged C against the unsharded path.
    if args.shards > 1:
        A0, B0 = stream[0]
        base = SpgemmEngine(SpgemmConfig(method=args.method)).execute(A0, B0)
        parity = gates.check("shard parity", result_parity(
            base, engine.execute(A0, B0), bitwise_val=False))
        print(f"shard parity:  {'OK' if parity else 'MISMATCH':>9s}  "
              f"({args.shards} shards vs unsharded: nnz/rpt/col/val, "
              f"values allclose)")

    # Fused gates: bitwise parity with two-pass and the access reduction.
    access = None
    if args.method == "hash":
        A0, B0 = stream[0]
        acc_s, acc_n, acc_f = measure_hash_accesses(
            A0, B0, config, with_fused=args.fused)
        access = {"symbolic": acc_s, "numeric": acc_n, "fused": acc_f}
        if args.fused:
            reduction = (acc_s + acc_n) / max(acc_f, 1)
            access["reduction"] = round(reduction, 3)
            gates.check("access reduction >= 1.5x", reduction >= 1.5)
            print(f"table access:  {acc_s + acc_n:9d} two-pass (sym {acc_s} "
                  f"+ num {acc_n}) vs {acc_f} fused = "
                  f"{reduction:.2f}x reduction")
            with fixed_order(True) as mode:
                _mode_line(gates, "fused parity", mode)
                base = SpgemmEngine(SpgemmConfig(
                    method="hash", fuse_numeric=False)).execute(A0, B0)
                fused_parity = result_parity(base, engine.execute(A0, B0),
                                             bitwise_val=True)
            gates.check("fused parity", fused_parity)
            print(f"fused parity:  {'OK' if fused_parity else 'MISMATCH':>9s}"
                  f"  (fused vs two-pass oracle: nnz/rpt/col/val bitwise)")
        else:
            print(f"table access:  {acc_s + acc_n:9d} two-pass "
                  f"(sym {acc_s} + num {acc_n})")

    # Adaptive gates: no static knobs, parity, headroom latency.
    if args.adaptive:
        gates.check("every request through the AUTO policy",
                    engine.stats.auto_requests >= args.requests)
        decisions = sorted({e.plan.policy.shard_decision
                            for _, e in engine.cache.items()
                            if e.plan.policy is not None
                            and e.plan.policy.shard_decision is not None})
        headrooms = sorted({round(e.plan.policy.headroom, 3)
                            for _, e in engine.cache.items()
                            if e.plan.policy is not None
                            and e.plan.hash_schedule is not None})
        print(f"policy:        shards->{decisions} headroom={headrooms} "
              f"({engine.stats.schedule_trims} schedule trims, "
              f"{engine.stats.policy_revisions} shard revisions)")
        A0, B0 = stream[0]
        # Bitwise when unsharded; a sharded merge keeps the structure
        # bitwise but may reorder float sums.
        bitwise = engine.stats.sharded_requests == 0
        with fixed_order(bitwise) as mode:
            _mode_line(gates, "adaptive parity", mode)
            base = SpgemmEngine(SpgemmConfig(
                method="hash", fuse_numeric=False)).execute(A0, B0)
            adaptive_parity = result_parity(base, engine.execute(A0, B0),
                                            bitwise_val=bitwise)
        gates.check("adaptive parity", adaptive_parity)
        print(f"adapt parity:  "
              f"{'OK' if adaptive_parity else 'MISMATCH':>9s}  "
              f"(fused-default vs two-pass oracle)")
        fixed_key = f"hash@{args.m}x{args.k}x{args.n}r{args.requests}"
        fixed = read_trajectory(args.json, fixed_key)
        if fixed is not None:
            gates.time("adaptive steady", steady * 1e3,
                       f"<= 2x fixed {fixed['steady_ms']:.3f} ms",
                       steady * 1e3 <= 2.0 * fixed["steady_ms"])
            print(f"vs fixed 2x:   {steady * 1e3:9.2f} ms adaptive vs "
                  f"{fixed['steady_ms']:.2f} ms fixed")
        else:
            print(f"vs fixed 2x:   no '{fixed_key}' baseline in "
                  f"{args.json}; run --method hash first to arm the "
                  f"latency gate")

    # Phase 2: batched submit/drain.
    uids = [engine.submit(A, B) for A, B in stream]
    t0 = time.perf_counter()
    engine.drain()
    sync(dev)
    drain_s = time.perf_counter() - t0
    print(f"drain:         {drain_s * 1e3:9.1f} ms for {len(uids)} requests "
          f"({drain_s / len(uids) * 1e3:.2f} ms/req, "
          f"{engine.stats.overlapped} overlapped, "
          f"{engine.stats.reordered} reordered)")
    print()
    print(engine.report())

    key = args.method + ("_fused" if args.fused else "")
    if args.adaptive:
        key += "_adaptive"
    if args.shards > 1:
        key += f"_shards{args.shards}"
    key += f"@{args.m}x{args.k}x{args.n}r{args.requests}"

    # Trace export and the telemetry gates.
    phases_ms = cold_phases
    trace_tax = None
    if args.trace:
        trace_path = Path(args.trace)
        trace_path.parent.mkdir(parents=True, exist_ok=True)
        telemetry.export_chrome_trace(trace_path)
        n_jsonl = telemetry.export_jsonl(trace_path.with_suffix(".jsonl"))
        n_events = validate_chrome_trace(trace_path)  # raises on bad schema
        spans = telemetry.finished_spans()
        names = {s["name"] for s in spans}
        required = {"request", "plan_lookup", "dispatch", "cold_steps",
                    "symbolic", "numeric", "verify_sync", "finalize",
                    "drain"}
        if args.shards > 1:
            required |= {"shard", "partition", "shard_merge"}
        missing = sorted(required - names)
        gates.check("required spans", not missing)
        agg = {}
        for s in spans:
            agg[s["name"]] = agg.get(s["name"], 0.0) + s["dur"]
        phases_ms = {n: round(t * 1e3, 3) for n, t in sorted(agg.items())}
        print(f"trace:         {n_events} trace_event records -> "
              f"{trace_path} (+{n_jsonl} JSONL rows), "
              f"{telemetry.events.dropped} ring overflows"
              + ("" if not missing else f"; MISSING spans {missing}"))

        # Same-process A/B: the steady tail with tracing on, then off,
        # twice each in turns, min of each.
        def steady_pass():
            ts = []
            for A, B in stream[len(stream) // 2:]:
                t0 = time.perf_counter()
                engine.execute(A, B)
                sync(dev)
                ts.append(time.perf_counter() - t0)
            return min(ts)

        traced_min, control_min = float("inf"), float("inf")
        for _ in range(2):
            engine.telemetry.enabled = True
            traced_min = min(traced_min, steady_pass())
            engine.telemetry.enabled = False
            control_min = min(control_min, steady_pass())
        engine.telemetry.enabled = True
        gates.time("tracing overhead %", (traced_min / control_min - 1.0)
                   * 100.0, "< 5", traced_min <= 1.05 * control_min)
        trace_tax = {"traced_min_ms": round(traced_min * 1e3, 4),
                     "control_min_ms": round(control_min * 1e3, 4)}
        print(f"trace tax:     {traced_min * 1e3:9.2f} ms traced vs "
              f"{control_min * 1e3:.2f} ms tracing-off steady-min "
              f"(same-process A/B)")
        base = read_trajectory(args.json, key)
        if base and base.get("steady_min_ms"):
            print(f"               cross-run: {steady_min * 1e3:.2f} ms "
                  f"this run vs {base['steady_min_ms']:.2f} ms untraced "
                  f"'{key}' baseline (informational)")
        key += "_traced"

    entry = dict(
        requests=args.requests, shape=[args.m, args.k, args.n],
        cold_ms=round(cold * 1e3, 3), steady_ms=round(steady * 1e3, 4),
        steady_min_ms=round(steady_min * 1e3, 4), speedup=round(speedup, 2),
        hit_rate=round(hit_rate, 4), retraces_after_warmup=retraces,
        drain_ms_per_request=round(drain_s / len(uids) * 1e3, 4),
        peak_workspace_bytes=engine.arena.peak_bytes,
        arena_hit_rate=round(engine.arena.hit_rate, 4),
        table_accesses=access, phases_ms=phases_ms, trace_tax=trace_tax,
        traced=bool(args.trace))
    return gates.as_dict(key=key, entry=entry)


# ---------------------------------------------------------------------------
# The command line.
# ---------------------------------------------------------------------------

def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="small sizes for CI (20 requests, 64x64x64)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--method", choices=("esc", "hash"), default="esc")
    ap.add_argument("--fused", action="store_true")
    ap.add_argument("--adaptive", action="store_true")
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--warmup", type=int, default=None,
                    help="requests before the zero-retrace gate arms "
                         "(default 4, or 12 under --adaptive)")
    ap.add_argument("--m", type=int, default=256)
    ap.add_argument("--k", type=int, default=256)
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--avg", type=float, default=4.0)
    ap.add_argument("--shards", type=int, default=1)
    ap.add_argument("--arena", action="store_true")
    ap.add_argument("--plans", type=int, default=8)
    ap.add_argument("--estimate", action="store_true")
    ap.add_argument("--serve", action="store_true")
    ap.add_argument("--seed", type=int, default=0,
                    help="serve gate: FaultPlan seed")
    ap.add_argument("--check", action="store_true",
                    help="verify every result against the dense oracle")
    ap.add_argument("--trace", metavar="PATH", default=None)
    ap.add_argument("--json", type=Path, default=DEFAULT_JSON,
                    help="the trajectory file (never BENCH_engine.json)")
    args = ap.parse_args(argv)
    if args.requests < 1:
        ap.error("--requests must be >= 1")
    if args.smoke:
        args.requests, args.m, args.k, args.n = 20, 64, 64, 64
    if args.warmup is None:
        args.warmup = 12 if args.adaptive else 4
    if not 0 < args.warmup < args.requests:
        ap.error("--warmup must be in [1, effective --requests)")
    if args.fused and args.method != "hash":
        ap.error("--fused requires --method hash")
    if args.adaptive and args.method != "hash":
        ap.error("--adaptive requires --method hash")
    if args.adaptive and args.shards > 1:
        ap.error("--adaptive picks the shard count itself; drop --shards")
    if args.adaptive and args.fused:
        ap.error("--adaptive already runs the fused-by-default config; "
                 "drop --fused")
    if args.arena and (args.fused or args.adaptive or args.shards > 1
                       or args.estimate or args.serve):
        ap.error("--arena is its own gate; drop --fused/--adaptive/"
                 "--shards/--estimate/--serve")
    if args.arena and args.plans < 4:
        ap.error("--plans must be >= 4")
    if args.estimate and (args.fused or args.adaptive or args.shards > 1
                          or args.trace or args.serve):
        ap.error("--estimate is its own gate; drop --fused/--adaptive/"
                 "--shards/--trace/--serve")
    if args.serve and (args.fused or args.adaptive or args.shards > 1
                       or args.trace):
        ap.error("--serve is its own gate; drop --fused/--adaptive/"
                 "--shards/--trace")
    return args


def run(argv=None) -> dict:
    """Run the configuration ``argv`` names and record its trajectory
    entry; returns its gates (``ok``, ``correctness``, ``timing``,
    ``modes``), ``key`` and ``entry``."""
    args = parse(argv)
    dev = resolve_device(args.device)
    print(f"device:        {describe(dev)}; torch {torch.__version__}",
          flush=True)
    gate = (run_arena_gate if args.arena else
            run_estimate_gate if args.estimate else
            run_serve_gate if args.serve else run_stream_gate)
    out = gate(args, dev)
    out["entry"].update(device=describe(dev), modes=out["modes"],
                        git_rev=git_rev(REPO), recorded_at=utc_now_iso())
    record_trajectory(args.json, out["key"], out["entry"])
    print(f"trajectory:    {args.json} <- {out['key']}")
    print()
    print(summary(out))
    return out


def summary(out: dict) -> str:
    """``PASS`` or ``FAIL``, with every gate that failed."""
    bad = [k for k, v in out["correctness"].items() if not v]
    bad += [f"{k} {v['value']:.3g} (target {v['target']})"
            for k, v in out["timing"].items() if not v["ok"]]
    return ("PASS" if out["ok"] else "FAIL") + (
        f" ({', '.join(bad)} failed)" if bad else " (every gate held)")


def main(argv=None) -> int:
    return 0 if run(argv)["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
