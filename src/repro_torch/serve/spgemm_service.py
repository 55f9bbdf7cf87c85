"""Fault-tolerant SpGEMM serving front-end.

The engine (``repro_torch.engine.executor``) already recovers from
everything it can observe *inside* one request: capacity overflows redo
through the steps oracle, governor pressure walks a four-rung
degradation ladder down to :class:`~repro_torch.core.workspace.
ArenaPressureError` backpressure.  What it cannot do is decide what a
*request* is worth: whether a denied lease should be retried and when,
whether a deadline still has budget for a cold plan, which tenant's
traffic a shared cap should shed first.  :class:`SpgemmService` owns
those request-level decisions:

Tenancy
    Each tenant gets its own :class:`~repro_torch.engine.executor.
    SpgemmEngine` (a private plan-cache namespace and metrics registry)
    while ALL tenants share one :class:`~repro_torch.core.workspace.Arena`
    bounded by one :class:`~repro_torch.engine.autotune.MemoryGovernor`
    cap.  One tenant's plan churn cannot evict another's plans; one
    tenant's workspace burst is bounded by the same cap as everyone
    else's.

Deadlines
    ``call(..., deadline_s=...)`` is admission-controlled up front: a hot
    plan's predicted latency is the steady-state histogram's conservative
    quantile; a cold plan's is a per-tenant seconds-per-flop EWMA
    (calibrated from observed cold calls) times the request's flop count,
    falling back to the cold-path histogram.  A request predicted to blow
    its budget, or one that expires between retries, returns a structured
    ``status="timeout"`` result.  No exception escapes
    :meth:`SpgemmService.call`.

Retry + degradation ladder
    Failures are classified: :class:`ArenaPressureError` and *transient*
    :class:`~repro_torch.core.faults.InjectedFault` retry with exponential
    backoff and seeded jitter, walking a service-level ladder that extends
    the governor's:

      rung 0  reclaim the arena's idle leases and retry unchanged
      rung 1  shed sharding (``shards=1``): fan-out multiplies workspace
      rung 2  spill fused numeric to the two-pass schedule (hash only)
      rung 3  reject with ``retry_after_s`` backpressure for the client

    Non-transient failures never retry: they return a structured
    ``status="error"`` result immediately (a poisoned request must not
    burn its tenant's budget three more times).

Fault injection
    A seeded :class:`~repro_torch.core.faults.FaultPlan` threads through
    the service into every tenant engine, so a test can provoke each rung
    deterministically and hold the recovered results to a fault-free run.

Observability
    :meth:`SpgemmService.prometheus_text` merges every tenant engine's
    sample blocks under ``tenant="<name>"`` labels plus service-level
    counters (retries, timeouts, sheds, spills, rejections, faults
    survived) into one exposition document, served by
    :class:`MetricsHTTPServer`, a stdlib ``http.server`` endpoint with
    ``GET /metrics`` and ``GET /healthz``.

On the card
    The service has no device argument: a request runs where its operands
    live, as ``spgemm()`` does, and the private arena leases on that
    device.  Tenant threads share the device's default stream (torch's
    current stream is per thread and defaults to it), so tenants' device
    work is serialized in enqueue order, and an arena buffer handed from
    one tenant to the next is safe without events.  Latency is the host
    clock around ``SpgemmEngine.execute``: an unsharded call returns after
    finalize's host read, which is enqueued after every write of C, so it
    counts C; a sharded call's merge is enqueued after the shards' reads
    and may still run when ``execute`` returns (any later torch op on C is
    ordered after it on the same stream).  A caller that times a request
    end to end synchronizes before reading its clock.
"""
from __future__ import annotations

import contextlib
import dataclasses
import random
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Iterator, List, Optional, Tuple

from repro_torch.core.csr import CSR
from repro_torch.core.faults import FaultPlan, InjectedFault, resolve_faults
from repro_torch.core.spgemm import SpgemmConfig, SpgemmResult
from repro_torch.core.workspace import Arena, ArenaPressureError
from repro_torch.engine.autotune import MemoryGovernor
from repro_torch.engine.executor import SpgemmEngine
from repro_torch.engine.plan import MatrixSig
from repro_torch.engine.telemetry import (MetricsRegistry,
                                          engine_sample_blocks,
                                          histogram_quantile,
                                          merge_sample_blocks)

# Degradation rungs above the governor's, walked in order by the retry
# loop; a rung that does not apply to the request's config is skipped.
SERVICE_RUNGS: Tuple[str, ...] = ("reclaim", "shed_shards",
                                  "spill_two_pass")


@dataclasses.dataclass
class ServiceResult:
    """What every :meth:`SpgemmService.call` returns, success or not.

    ``status``   "ok" | "timeout" | "rejected" | "error"
    ``value``    the :class:`SpgemmResult` when ``status == "ok"``
    ``error``    human-readable failure description otherwise
    ``retries``  transient-failure retries this request consumed
    ``degraded`` deepest service rung the request walked (None = none)
    ``retry_after_s``  backpressure hint on "rejected" results: the
                 client should wait at least this long before resubmit
    ``faults_survived``  injected faults absorbed on the way to "ok"
    """

    status: str
    tenant: str
    value: Optional[SpgemmResult] = None
    error: Optional[str] = None
    retries: int = 0
    degraded: Optional[str] = None
    retry_after_s: Optional[float] = None
    elapsed_s: float = 0.0
    faults_survived: int = 0

    @property
    def ok(self) -> bool:
        return self.status == "ok"


class _Tenant:
    """One tenant namespace: a private engine (plan cache + registry)
    plus the service-level counters rendered under its label."""

    def __init__(self, name: str, engine: SpgemmEngine):
        self.name = name
        self.engine = engine
        # Engine calls for one tenant are serialized (the engine's
        # dispatch/finalize bookkeeping is single-stream); cross-tenant
        # concurrency is safe because the shared arena and fault plan
        # carry their own locks.
        self.lock = threading.Lock()
        # Cold-call cost model: EWMA of observed seconds per flop,
        # calibrated after every cold (unspecialized-plan) call.  None
        # until the first cold call completes.
        self.cold_s_per_flop: Optional[float] = None  # guarded-by: lock
        reg = engine.telemetry.registry
        self.c_requests = reg.counter("opsparse_service_requests_total")
        self.c_retries = reg.counter("opsparse_service_retries_total")
        self.c_timeouts = reg.counter("opsparse_service_timeouts_total")
        self.c_sheds = reg.counter("opsparse_service_sheds_total")
        self.c_spills = reg.counter("opsparse_service_spills_total")
        self.c_rejected = reg.counter("opsparse_service_rejected_total")
        self.c_errors = reg.counter("opsparse_service_errors_total")
        self.c_faults_survived = reg.counter(
            "opsparse_service_faults_survived_total")


class SpgemmService:
    """Multi-tenant, deadline-aware, fault-tolerant SpGEMM front-end.

    ::

        svc = SpgemmService(governor=MemoryGovernor(cap_bytes=64 << 20))
        r = svc.call(A, B, tenant="acme", deadline_s=0.5)
        if r.ok:
            use(r.value)
        elif r.status == "rejected":
            resubmit_after(r.retry_after_s)

    No exception escapes :meth:`call`: every outcome is a structured
    :class:`ServiceResult`.  See the module docstring for the full
    contract.
    """

    def __init__(self, config: Optional[SpgemmConfig] = None, *,
                 governor: Optional[MemoryGovernor] = None,
                 arena: Optional[Arena] = None,
                 faults: Optional[FaultPlan] = None,
                 max_tenants: int = 8,
                 cache_capacity: int = 64,
                 max_retries: int = 3,
                 backoff_base_s: float = 0.005,
                 backoff_cap_s: float = 0.25,
                 backoff_jitter: float = 0.5,
                 deadline_quantile: float = 0.99,
                 telemetry: bool = True,
                 seed: int = 0):
        self.config = config or SpgemmConfig()
        self.governor = governor or MemoryGovernor()
        # A PRIVATE arena by default (not the process-wide default arena):
        # the service's cap and fault schedule must not leak into
        # unrelated engines in the same process.
        self.arena = arena if arena is not None else Arena()
        self.faults = resolve_faults(faults)
        self.max_tenants = int(max_tenants)
        self.cache_capacity = int(cache_capacity)
        self.max_retries = int(max_retries)
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_cap_s = float(backoff_cap_s)
        self.backoff_jitter = float(backoff_jitter)
        self.deadline_quantile = float(deadline_quantile)
        self.telemetry_enabled = bool(telemetry)
        self._rng = random.Random(seed)  # guarded-by: _lock
        self._lock = threading.Lock()
        self._tenants: "Dict[str, _Tenant]" = {}  # guarded-by: _lock
        # Service-wide registry: cross-tenant counters that have no
        # tenant label (admission rejections name tenants that were
        # never admitted, so they cannot live in a tenant registry).
        self.registry = MetricsRegistry()
        self._g_tenants = self.registry.gauge("opsparse_service_tenants")
        self._c_admission_rejected = self.registry.counter(
            "opsparse_service_admission_rejected_total")
        self._http: Optional[MetricsHTTPServer] = None  # guarded-by: _lock

    # -- tenancy ------------------------------------------------------------
    def _get_tenant(self, name: str) -> Optional[_Tenant]:
        """Admit-or-return the tenant namespace; ``None`` means the
        tenant roster is full (the caller renders a rejection)."""
        with self._lock:
            ten = self._tenants.get(name)
            if ten is not None:
                return ten
            if len(self._tenants) >= self.max_tenants:
                self._c_admission_rejected.inc()
                return None
            engine = SpgemmEngine(
                self.config, cache_capacity=self.cache_capacity,
                telemetry=self.telemetry_enabled, arena=self.arena,
                governor=self.governor, faults=self.faults)
            ten = self._tenants[name] = _Tenant(name, engine)
            self._g_tenants.set(len(self._tenants))
            return ten

    def tenants(self) -> List[str]:
        with self._lock:
            return sorted(self._tenants)

    def engine(self, tenant: str = "default") -> SpgemmEngine:
        """The tenant's engine (admitting the tenant if needed), for
        tests and prewarm flows; raises if the roster is full."""
        ten = self._get_tenant(tenant)
        if ten is None:
            raise RuntimeError(
                f"tenant roster full ({self.max_tenants}); "
                f"cannot admit {tenant!r}")
        return ten.engine

    # -- failure classification + ladder ------------------------------------
    @staticmethod
    def classify_failure(exc: BaseException) -> str:
        """``"pressure"`` (retry with backoff + ladder) or ``"fatal"``
        (structured error, NO retry).  Injected faults carry their own
        classification; anything unrecognized is fatal: retrying an
        unknown failure mode re-runs unknown side effects."""
        if isinstance(exc, ArenaPressureError):
            return "pressure"
        if isinstance(exc, InjectedFault):
            return "pressure" if exc.transient else "fatal"
        return "fatal"

    def _next_rung(self, rung: Optional[str],
                   config: SpgemmConfig) -> Optional[str]:
        """The next *applicable* service rung after ``rung`` (None =
        start of ladder); returns None when the ladder is exhausted."""
        start = 0 if rung is None else SERVICE_RUNGS.index(rung) + 1
        for cand in SERVICE_RUNGS[start:]:
            if cand == "shed_shards" and config.shards == 1:
                continue
            if cand == "spill_two_pass" and not (
                    config.method == "hash" and config.fuse_numeric):
                continue
            return cand
        return None

    def _apply_rung(self, ten: _Tenant, rung: str,
                    config: SpgemmConfig) -> SpgemmConfig:
        """Execute one rung's action; returns the (possibly degraded)
        config the retry should run under."""
        if rung == "reclaim":
            self.arena.reclaim()
            return config
        if rung == "shed_shards":
            ten.c_sheds.inc()
            ten.engine.telemetry.event("service_shed_shards",
                                       tenant=ten.name)
            return dataclasses.replace(config, shards=1)
        ten.c_spills.inc()
        ten.engine.telemetry.event("service_spill_two_pass",
                                   tenant=ten.name)
        return dataclasses.replace(config, fuse_numeric=False)

    # -- deadline admission --------------------------------------------------
    def _flops(self, A: CSR, B: CSR) -> int:
        from repro_torch.core.analysis import row_flops  # host sync: lazy
        return max(1, int(row_flops(A, B).sum()))

    def _plan_entry(self, ten: _Tenant, A: CSR, B: CSR,
                    config: SpgemmConfig):
        key = (MatrixSig.of(A), MatrixSig.of(B), config)
        return ten.engine.cache.peek(key)

    def _predict_latency_s(self, ten: _Tenant, A: CSR, B: CSR,
                           config: SpgemmConfig) -> Optional[float]:
        """Conservative latency prediction for deadline admission;
        ``None`` = no basis to predict, admit blind."""
        reg = ten.engine.telemetry.registry
        ten.engine.flush_latencies()
        entry = self._plan_entry(ten, A, B, config)
        if entry is not None and entry.plan.is_specialized:
            return histogram_quantile(
                reg.get("opsparse_request_latency_seconds"),
                self.deadline_quantile)
        if ten.cold_s_per_flop is not None:
            return ten.cold_s_per_flop * self._flops(A, B)
        return histogram_quantile(reg.get("opsparse_cold_steps_seconds"),
                                  self.deadline_quantile)

    def _calibrate_cold(self, ten: _Tenant, flops: int, dt: float) -> None:
        per_flop = dt / flops
        prev = ten.cold_s_per_flop
        ten.cold_s_per_flop = (per_flop if prev is None
                               else 0.7 * prev + 0.3 * per_flop)

    def _backoff_s(self, attempt: int) -> float:
        base = min(self.backoff_cap_s,
                   self.backoff_base_s * (2.0 ** attempt))
        with self._lock:
            jitter = self._rng.random()
        return base * (1.0 + self.backoff_jitter * jitter)

    # -- the request loop ----------------------------------------------------
    def call(self, A: CSR, B: CSR, *, tenant: str = "default",
             config: Optional[SpgemmConfig] = None,
             deadline_s: Optional[float] = None) -> ServiceResult:
        """Execute one product under the service contract.

        Never raises: timeouts, rejections, and errors all come back as
        structured :class:`ServiceResult` values (see class docstring).
        """
        t0 = time.perf_counter()
        ten = self._get_tenant(tenant)
        if ten is None:
            return ServiceResult(
                status="rejected", tenant=tenant,
                error=f"tenant roster full ({self.max_tenants} tenants)",
                retry_after_s=self.governor.retry_after_s)
        deadline = None if deadline_s is None else t0 + float(deadline_s)

        with ten.lock:
            ten.c_requests.inc()
            cfg = ten.engine._effective_config(config)
            faults_before = ten.engine.stats.faults_injected

            # Up-front admission: don't start work a budget can't absorb.
            if deadline is not None:
                pred = self._predict_latency_s(ten, A, B, cfg)
                if pred is not None \
                        and time.perf_counter() + pred > deadline:
                    ten.c_timeouts.inc()
                    return ServiceResult(
                        status="timeout", tenant=tenant,
                        error=("deadline %.3fs < predicted latency %.3fs"
                               % (deadline_s, pred)),
                        elapsed_s=time.perf_counter() - t0)

            retries = 0
            rung: Optional[str] = None
            while True:
                entry = self._plan_entry(ten, A, B, cfg)
                was_hot = entry is not None and entry.plan.is_specialized
                try:
                    t_call = time.perf_counter()
                    value = ten.engine.execute(A, B, cfg)
                except Exception as exc:  # noqa: BLE001 — classified below
                    kind = self.classify_failure(exc)
                    if kind == "fatal":
                        ten.c_errors.inc()
                        return ServiceResult(
                            status="error", tenant=tenant,
                            error=f"{type(exc).__name__}: {exc}",
                            retries=retries, degraded=rung,
                            elapsed_s=time.perf_counter() - t0)
                    # Transient: walk the ladder, back off, retry, within
                    # the retry budget and the deadline.
                    if retries >= self.max_retries:
                        ten.c_rejected.inc()
                        return ServiceResult(
                            status="rejected", tenant=tenant,
                            error=f"{type(exc).__name__}: {exc} "
                                  f"(after {retries} retries)",
                            retries=retries, degraded=rung,
                            retry_after_s=self.governor.retry_after_s,
                            elapsed_s=time.perf_counter() - t0)
                    nxt = self._next_rung(rung, cfg)
                    if nxt is not None:
                        rung = nxt
                        cfg = self._apply_rung(ten, rung, cfg)
                    else:
                        # Ladder exhausted for this config: stay on the
                        # deepest rung, reclaim again and retry until the
                        # retry budget runs out.
                        self.arena.reclaim()
                    delay = self._backoff_s(retries)
                    if deadline is not None:
                        remaining = deadline - time.perf_counter()
                        if remaining <= delay:
                            ten.c_timeouts.inc()
                            return ServiceResult(
                                status="timeout", tenant=tenant,
                                error=("deadline expired after %d "
                                       "retries" % retries),
                                retries=retries, degraded=rung,
                                elapsed_s=time.perf_counter() - t0)
                    time.sleep(delay)
                    retries += 1
                    ten.c_retries.inc()
                    continue

                # Success path.
                if not was_hot:
                    # Calibrated with the time the request's C took to
                    # complete: for a sharded request on the card that
                    # lands after its merge, without waiting for it here.
                    flops = self._flops(A, B)
                    ten.engine.on_complete(
                        value, lambda done, t=t_call, f=flops:
                        self._calibrate_cold(ten, f, done - t))
                if deadline is not None \
                        and time.perf_counter() > deadline:
                    # Completed, but past its budget: the client stopped
                    # waiting, so the contract says timeout; the warmed
                    # plan still benefits the next request.
                    ten.c_timeouts.inc()
                    return ServiceResult(
                        status="timeout", tenant=tenant,
                        error="completed after deadline",
                        retries=retries, degraded=rung,
                        elapsed_s=time.perf_counter() - t0)
                survived = (ten.engine.stats.faults_injected
                            - faults_before)
                if survived > 0:
                    ten.c_faults_survived.inc(survived)
                return ServiceResult(
                    status="ok", tenant=tenant, value=value,
                    retries=retries, degraded=rung,
                    elapsed_s=time.perf_counter() - t0,
                    faults_survived=survived)

    # -- batched sessions ----------------------------------------------------
    @contextlib.contextmanager
    def session(self, tenant: str = "default") -> Iterator["ServiceSession"]:
        """A batched client session: ``submit`` products, ``drain`` for
        results.  Holds the tenant's serialization lock for the whole
        session (sessions from different tenants run concurrently)."""
        ten = self._get_tenant(tenant)
        if ten is None:
            raise RuntimeError(
                f"tenant roster full ({self.max_tenants}); "
                f"cannot admit {tenant!r}")
        with ten.lock:
            yield ServiceSession(self, ten)

    # -- observability -------------------------------------------------------
    def prometheus_text(self) -> str:
        """One exposition document for the whole service: every tenant
        engine's samples under ``tenant="<name>"`` plus the service-wide
        registry.  This is what ``GET /metrics`` returns verbatim."""
        with self._lock:
            tenants = list(self._tenants.values())
        blocks = []
        for t in tenants:
            t.engine.flush_latencies()   # sharded merges finished since
            blocks.append(engine_sample_blocks(t.engine,
                                               f'tenant="{t.name}"'))
        blocks.append(self.registry.sample_blocks())
        return merge_sample_blocks(blocks)

    def serve_http(self, host: str = "127.0.0.1",
                   port: int = 0) -> "MetricsHTTPServer":
        """Start (or return the already-running) metrics endpoint.  The
        check-then-create runs under ``_lock``, so two racing threads
        start one listener."""
        with self._lock:
            if self._http is None:
                self._http = MetricsHTTPServer(self, host=host, port=port)
            return self._http

    def close(self) -> None:
        with self._lock:
            http, self._http = self._http, None
        if http is not None:
            http.close()  # join the server thread outside the lock


class ServiceSession:
    """Handle yielded by :meth:`SpgemmService.session`: thin, batched
    access to the tenant engine with service-grade pressure handling
    (drain retries once through an arena reclaim before giving up)."""

    def __init__(self, service: SpgemmService, tenant: _Tenant):
        self._service = service
        self._tenant = tenant

    def submit(self, A: CSR, B: CSR,
               config: Optional[SpgemmConfig] = None) -> int:
        return self._tenant.engine.submit(A, B, config)

    def drain(self, **kw) -> Dict[int, SpgemmResult]:
        try:
            return self._tenant.engine.drain(**kw)
        except ArenaPressureError:
            # The engine already reaped everything it had in flight;
            # reclaim idle leases service-wide and retry once.
            self._service.arena.reclaim()
            return self._tenant.engine.drain(**kw)


# ---------------------------------------------------------------------------
# Stdlib HTTP metrics endpoint.
# ---------------------------------------------------------------------------

class _MetricsHandler(BaseHTTPRequestHandler):
    service: SpgemmService  # set by the server subclass

    def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler API
        if self.path in ("/metrics", "/"):
            body = self.server.service.prometheus_text().encode()
            ctype = "text/plain; version=0.0.4; charset=utf-8"
        elif self.path == "/healthz":
            body = b"ok\n"
            ctype = "text/plain; charset=utf-8"
        else:
            self.send_error(404)
            return
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt, *args):  # silence per-request stderr spam
        pass


class _Server(ThreadingHTTPServer):
    daemon_threads = True
    service: SpgemmService


class MetricsHTTPServer:
    """Background-thread HTTP endpoint serving a service's metrics.

    ``GET /metrics`` returns :meth:`SpgemmService.prometheus_text`;
    ``GET /healthz`` returns ``ok``.  ``port=0`` binds an ephemeral port
    (tests); :attr:`url` is the scrape address.
    """

    def __init__(self, service: SpgemmService, *,
                 host: str = "127.0.0.1", port: int = 0):
        self._server = _Server((host, port), _MetricsHandler)
        self._server.service = service
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="opsparse-metrics",
            daemon=True)
        self._thread.start()

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    @property
    def url(self) -> str:
        host = self._server.server_address[0]
        return f"http://{host}:{self.port}/metrics"

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=5)
