"""The readers of the program's ranges and read spans, on hand-made
summaries and spans: each returns None where there is nothing to read
(no trace, or a program without the ranges or marks), and the right
value otherwise; each ``.cold`` reader reads what its base reads."""
import types

import pytest

from opbench.harness import ROOT, load_reader
from opbench.trace import TraceSummary

RANGES = {"hash_setup": 0.2e-3, "hash_binning": 0.3e-3,
          "hash_rungs": 4.0e-3, "hash_fallback": 1.0e-3,
          "hash_alloc": 0.1e-3, "hash_epilogue": 10.0e-3,
          "operand_pad": 0.05e-3, "verify_sync": 0.02e-3,
          "sync:max": 0.01e-3, "step_wait:setup": 0.0,
          # an engine phase wrapping the partition: never summed
          "dispatch": 15.0e-3}


def summary(ranges, ops_s, products=2):
    return TraceSummary(window_s=1.0, busy_s=0.5, products=products,
                        range_device_s=dict(ranges),
                        op_device_s={"k": ops_s}, idle_by_host={},
                        unlinked_ops=0)


def ctx(metric, trace=None, spans=(), products=4):
    return types.SimpleNamespace(
        cell=types.SimpleNamespace(root=ROOT), trace=trace,
        window=types.SimpleNamespace(spans=list(spans)), products=products,
        extra={}, metric=metric)


@pytest.mark.parametrize("metric", ["hash_rungs.device_ms",
                                    "hash_rungs.device_ms.cold"])
def test_hash_rungs_device_ms(metric):
    read = load_reader(ROOT, metric)
    assert read(ctx(metric)) is None
    assert read(ctx(metric, summary({"hash_epilogue": 1.0}, 2.0))) is None
    assert read(ctx(metric, summary(RANGES, 0.1))) == pytest.approx(2.0)


@pytest.mark.parametrize("metric", ["product.unranged_device_ms",
                                    "product.unranged_device_ms.cold"])
def test_product_unranged_device_ms(metric):
    read = load_reader(ROOT, metric)
    assert read(ctx(metric)) is None
    # The parent's ranges alone: nothing to read.
    parent = {k: RANGES[k] for k in ("hash_fallback", "hash_epilogue",
                                     "step_wait:setup")}
    assert read(ctx(metric, summary(parent, 20e-3))) is None
    c = ctx(metric, summary(RANGES, 15.68e-3 + 0.4e-3))
    partition_ms = sum(v for k, v in RANGES.items() if k != "dispatch") * 1e3
    assert partition_ms == pytest.approx(15.68)
    assert read(c) == pytest.approx(0.4 / 2)
    extra = c.extra[metric]
    assert extra["device_ms"] == pytest.approx((15.68 + 0.4) / 2)
    assert "dispatch" not in extra["ranges_ms"]
    assert extra["ranges_ms"]["hash_rungs"] == pytest.approx(2.0)


def test_engine_host_syncs_cold():
    metric = "engine.host_syncs.cold"
    read = load_reader(ROOT, metric)
    assert read(ctx(metric)) is None
    unmarked = [{"name": "cold_steps", "attrs": {}},
                {"name": "symbolic", "attrs": {}}]
    assert read(ctx(metric, spans=unmarked)) is None
    marked = unmarked + [{"name": n, "attrs": {"sync": True}}
                         for n in ["setup", "sync:nprod"] * 26]
    assert read(ctx(metric, spans=marked, products=4)) == pytest.approx(13)
