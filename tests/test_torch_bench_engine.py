"""The port's engine gates (benchmarks/torch/bench_engine.py) on the CPU.

Each of the reference's nine CI configurations (``scripts/ci.sh``), and
the chaos gate on hash, runs in process at the reference's ``--smoke`` size, and its
CORRECTNESS gates must hold: parity
(bitwise where the reference compares bits), zero retraces, the hit rate,
the AUTO policy, the spans, peak <= cap, zero failed requests, the
poisoned and stalled contracts and the ``/metrics`` series.  Timing gates
are printed by the bench and kept out of pytest: a CPU's times say nothing
of the card.  The trajectory goes to the ``--json`` path given, never to
the reference's ``BENCH_engine.json``.  Also: the request-latency fix for
sharded requests (the histogram observes each one once its merge is done,
on the CPU and with the card's events stood in for).

The reference package is imported to hold the port's stream to the
reference bench's: the same matrices, of the same keys.
"""
import hashlib
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import csr as jcsr
from repro_torch.core import SpgemmConfig, random_csr
from repro_torch.core.csr import prng_key_seed
from repro_torch.engine import SpgemmEngine
from repro_torch.engine import executor as texecutor

from benchmarks.torch import bench_engine

REPO = Path(__file__).resolve().parents[1]
SMALL = ["--device", "cpu", "--smoke"]    # the reference's CI size

SERVE_GATES = {"zero failed requests", "parity", "faults injected",
               "poisoned request errors without retry",
               "stalled request times out", "/metrics tenant series"}
# The reference's CI configurations (scripts/ci.sh), in its order, and the
# chaos gate on hash, with the correctness gates each must report.
CONFIGS = {
    "esc": ([], {"hit rate >= 90%", "zero retraces"}),
    "hash": (["--method", "hash"], {"hit rate >= 90%", "zero retraces"}),
    "adaptive": (["--method", "hash", "--adaptive"],
                 {"hit rate >= 90%", "zero retraces", "adaptive parity",
                  "every request through the AUTO policy"}),
    "fused": (["--method", "hash", "--fused"],
              {"hit rate >= 90%", "zero retraces", "fused parity",
               "access reduction >= 1.5x"}),
    "shards": (["--shards", "2"],
               {"hit rate >= 90%", "zero retraces", "shard parity"}),
    "arena": (["--arena", "--plans", "4"],
              {"every plan leases", "peak <= cap", "peak < baseline",
               "zero retraces", "parity"}),
    "estimate": (["--estimate", "--method", "hash"],
                 {"zero retraces", "estimates resolved", "parity"}),
    "trace": (["--shards", "2", "--trace", "TRACE"],
              {"hit rate >= 90%", "zero retraces", "shard parity",
               "required spans"}),
    "serve": (["--serve"], SERVE_GATES),
    # Hash plans lease nothing at this shape (no fallback rows), so only
    # verify_overflow injects, and seed 0's draws all miss its p = 0.15:
    # seed 1 keeps the chaos gate armed.
    "serve-hash": (["--serve", "--method", "hash", "--seed", "1"],
                   SERVE_GATES),
}
BITWISE_ON_HASH = {"adaptive": "adaptive parity", "fused": "fused parity",
                   "estimate": "estimate parity",
                   "serve-hash": "chaos parity"}


def _digest(path: Path) -> str:
    return hashlib.sha256(path.read_bytes()).hexdigest()


@pytest.fixture(scope="module")
def trajectory(tmp_path_factory):
    """One trajectory file for the module: the adaptive gate reads the
    hash run's entry from it, as in the reference's CI order."""
    return tmp_path_factory.mktemp("bench") / "bench_engine_torch.json"


@pytest.mark.parametrize("name", list(CONFIGS))
def test_gate_correctness(name, trajectory, tmp_path):
    extra, expected = CONFIGS[name]
    extra = [str(tmp_path / "trace.json") if a == "TRACE" else a
             for a in extra]
    ref_json = REPO / "BENCH_engine.json"
    before = _digest(ref_json)
    if name == "adaptive" and bench_engine.read_trajectory(
            trajectory, "hash@64x64x64r20") is None:
        # The adaptive latency gate reads the plain hash run's entry.
        bench_engine.run(SMALL + CONFIGS["hash"][0]
                         + ["--json", str(trajectory)])
    out = bench_engine.run(SMALL + extra + ["--json", str(trajectory)])
    assert expected <= set(out["correctness"]), out["correctness"]
    assert all(out["correctness"].values()), out["correctness"]
    if name in BITWISE_ON_HASH:
        assert out["modes"][BITWISE_ON_HASH[name]] == "deterministic"
    entry = bench_engine.read_trajectory(trajectory, out["key"])
    assert entry is not None and entry["device"] == "cpu"
    assert _digest(ref_json) == before
    assert not torch.are_deterministic_algorithms_enabled()   # restored
    if name == "trace":
        assert (tmp_path / "trace.json").exists()
    if name == "adaptive":      # armed by the plain hash run's entry
        assert "adaptive steady" in out["timing"]


def test_prng_key_seed_is_jaxs():
    """prng_key_seed(s) is the int seed the reference's random_csr draws
    from jax.random.PRNGKey(s)."""
    for s in list(range(64)) + [2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1]:
        want = int(jax.random.bits(jax.random.PRNGKey(s), dtype=jnp.uint32))
        assert prng_key_seed(s) == want, s
    with pytest.raises(ValueError):
        prng_key_seed(2 ** 32)


def test_trajectory_never_goes_to_the_reference_file():
    with pytest.raises(ValueError, match="BENCH_engine.json"):
        bench_engine.record_trajectory(REPO / "BENCH_engine.json", "k", {})


def test_stream_is_the_reference_benchs_stream():
    """The port's stream is the reference bench's: its matrices of keys
    PRNGKey(2s) and PRNGKey(2s + 1), drawn without JAX."""
    stream = bench_engine.build_stream(3, 32, 32, 32, 4.0, "cpu")
    for s, (A, B) in enumerate(stream):
        for M, seed in ((A, 2 * s), (B, 2 * s + 1)):
            J = jcsr.random_csr(jax.random.PRNGKey(seed), 32, 32,
                                avg_nnz_per_row=4.0)
            nnz = int(J.rpt[-1])
            np.testing.assert_array_equal(M.rpt.numpy(), np.asarray(J.rpt))
            np.testing.assert_array_equal(M.col.numpy()[:nnz],
                                          np.asarray(J.col)[:nnz])
            np.testing.assert_array_equal(M.val.numpy()[:nnz],
                                          np.asarray(J.val)[:nnz])


def test_cli_rejects_what_the_reference_rejects():
    for argv in (["--fused"], ["--adaptive"],
                 ["--method", "hash", "--adaptive", "--shards", "2"],
                 ["--arena", "--serve"], ["--estimate", "--trace", "x"],
                 ["--arena", "--plans", "3"], ["--requests", "3",
                                               "--warmup", "4"]):
        with pytest.raises(SystemExit):
            bench_engine.parse(["--device", "cpu"] + argv)


# ---------------------------------------------------------------------------
# A sharded request's latency includes its merge.
# ---------------------------------------------------------------------------

def _pairs(n, m=40):
    return [(random_csr(2 * s, m, m, avg_nnz_per_row=4.0, device="cpu"),
             random_csr(2 * s + 1, m, m, avg_nnz_per_row=4.0, device="cpu"))
            for s in range(n)]


def _request_hist(engine):
    return engine.telemetry.registry.get("opsparse_request_latency_seconds")


@pytest.mark.parametrize("method", ["esc", "hash"])
def test_sharded_request_histogram_observes_every_request(method):
    engine = SpgemmEngine(SpgemmConfig(method=method), shards=2,
                          telemetry=True)
    pairs = _pairs(5)
    for A, B in pairs:
        engine.execute(A, B)
    for A, B in pairs:
        engine.submit(A, B)
    engine.drain()
    assert engine.stats.sharded_requests == 10
    hist = _request_hist(engine)
    assert hist.count == 10 and hist.sum > 0.0
    assert engine.flush_latencies() == 0


class _FakeEvent:
    """A stand-in for a CUDA timing event: complete once ``done`` is set,
    ``elapsed_time`` in ms as the card reports it."""

    def __init__(self, t_ms):
        self.t_ms, self.done = t_ms, False

    def query(self):
        return self.done

    def synchronize(self):
        self.done = True

    def elapsed_time(self, end):
        return end.t_ms - self.t_ms


def test_sharded_latency_waits_for_the_merge_event(monkeypatch):
    """With the card's events stood in for: finalize returns without the
    merge's completion and observes nothing; once the event after the
    merge has completed, the next finalize (or a flush) observes
    ``t_merge - t0 + elapsed(merge)``, the time the request's C took, and
    an ``on_complete`` sink given the result gets the same completion
    time."""
    events = []

    def fake_event(device):
        ev = _FakeEvent(len(events) * 250.0)     # the merge took 250 ms
        events.append(ev)
        return ev

    monkeypatch.setattr(texecutor, "_timing_event", fake_event)
    engine = SpgemmEngine(SpgemmConfig(method="esc"), shards=2,
                          telemetry=True)
    (A, B), = _pairs(1)
    rec = engine.dispatch(A, B)
    t0 = rec.t0
    result = engine.finalize(rec)
    hist = _request_hist(engine)
    assert hist.count == 0 and len(events) == 2
    assert result.completion.end is events[1]
    seen = []
    engine.on_complete(result, seen.append)     # beside the histogram's
    assert seen == [] and engine.flush_latencies() == 2
    events[1].done = True
    assert engine.flush_latencies() == 0
    assert hist.count == 1
    assert len(seen) == 1
    t_merge = seen[0] - 0.25
    assert t0 < t_merge <= time.perf_counter()
    assert hist.sum == pytest.approx(seen[0] - t0)
    # The unsharded path is complete at return: observed at finalize, and
    # an on_complete sink is called at once.
    plain = engine.execute(A, B, SpgemmConfig(method="esc", shards=1))
    assert hist.count == 2 and plain.completion is None
    engine.on_complete(plain, seen.append)
    assert len(seen) == 2 and t_merge < seen[1] <= time.perf_counter()


def test_sharded_latency_flush_waits_when_asked(monkeypatch):
    monkeypatch.setattr(texecutor, "_timing_event",
                        lambda device: _FakeEvent(0.0))
    engine = SpgemmEngine(SpgemmConfig(method="esc"), shards=2,
                          telemetry=True)
    (A, B), = _pairs(1)
    engine.execute(A, B)
    assert _request_hist(engine).count == 0
    assert engine.flush_latencies(wait=True) == 0
    assert _request_hist(engine).count == 1
