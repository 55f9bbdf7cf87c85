"""The trace reduction on a hand-made trace: busy and idle time inside
the products, device time by every range through the launch's
correlation id, and idle gaps named by what the host was doing."""
import pytest

from opbench import trace


def x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid, "args": args}


def test_summarize_hand_made_trace():
    events = [
        # Two products on thread 1, 0-100 and 120-200 us.
        x("user_annotation", "opbench.product", 0, 100),
        x("user_annotation", "opbench.product", 120, 80),
        x("user_annotation", "hash_epilogue", 10, 30),
        x("cuda_runtime", "cudaLaunchKernel", 12, 2, correlation=1),
        x("cuda_runtime", "cudaLaunchKernel", 50, 2, correlation=2),
        x("cpu_op", "aten::item", 60, 30),
        x("user_annotation", "step_wait:alloc", 125, 10),
        x("cuda_driver", "cuLaunchKernel", 130, 2, correlation=3),
        # Kernels on the device: 20-40 (epilogue), 45-55, 150-170.
        x("kernel", "void (anonymous namespace)::hash_rows_kernel<1, 0>"
          "(int const*)", 20, 20, tid=7, correlation=1),
        x("kernel", "scatter_kept_kernel<unsigned int>(int*)", 45, 10,
          tid=7, correlation=2),
        x("gpu_memcpy", "Memcpy DtoD", 150, 20, tid=7, correlation=3),
        x("kernel", "outside", 300, 10, tid=7, correlation=9),
    ]
    s = trace.summarize(events)
    assert s.products == 2
    assert s.window_s == pytest.approx(180e-6)
    assert s.busy_s == pytest.approx(50e-6)
    # Every range the trace holds, none named in advance.
    assert s.range_device_s == {"hash_epilogue": pytest.approx(20e-6),
                                "step_wait:alloc": pytest.approx(20e-6)}
    assert s.op_device_s["hash_rows_kernel<1, 0>"] == pytest.approx(20e-6)
    assert s.unlinked_ops == 0
    # Idle inside products: 0-20, 40-45, 55-100 (aten::item open at 77.5
    # us), 120-150, 170-200.
    assert sum(s.idle_by_host.values()) == pytest.approx(130e-6)
    assert s.idle_by_host["opbench.product > aten::item"] == pytest.approx(
        45e-6)
    both = s + s
    assert both.products == 4 and both.busy_s == pytest.approx(100e-6)
    assert trace.summarize(events[2:]) is None


def test_short_name():
    assert trace.short_name(
        "void (anonymous namespace)::slot_rows_kernel<true, false, 0>"
        "(int const*, int)") == "slot_rows_kernel<true, false, 0>"
    assert len(trace.short_name("k" * 500)) == trace.NAME_CHARS
