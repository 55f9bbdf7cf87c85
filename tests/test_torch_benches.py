"""The port's figure benches, its MoE bench and its harness on the CPU.

``bench_binning_ranges`` (Figs. 10/11) runs the reference's own matrices
(``PRNGKey`` seeds) through the plain versions, which count table accesses
as the reference's Pallas kernels do: every access count and occupancy in
its rows equals the reference bench's (run here in interpret mode).
``bench_hashing`` (Fig. 9) is held to the reference the same way in
tests/test_torch_bench_hashing.py.  The other benches are held to their
row formats and to what their numbers must satisfy.
"""
import re

import pytest
import torch

from benchmarks import bench_binning_ranges as ref_ranges
from benchmarks.torch import (bench_binning, bench_binning_ranges,
                              bench_moe_dispatch, bench_overlap, run)
from benchmarks.torch import matrices as mx
from repro_torch.core.csr import random_csr


def _no_timing(monkeypatch, *modules):
    for mod in modules:
        monkeypatch.setattr(mod, "timeit", lambda *a, **k: 1.0)


def test_bench_binning_ranges_rows_are_the_reference_rows(monkeypatch):
    """Figs. 10/11: every multiplier's accesses and occupancy, as the
    reference's."""
    _no_timing(monkeypatch, bench_binning_ranges)
    assert bench_binning_ranges.run("cpu") == ref_ranges.run()


def test_bench_binning_case():
    """Fig. 7/8 on one small analog: both forms timed, binning a share of
    the call."""
    A = mx.generate(mx.NORMAL[5], scale=256, device="cpu")
    row, n = bench_binning.case("scircuit", A)
    assert re.fullmatch(r"bench_binning/scircuit,\d+,naive_us=\d+;"
                        r"speedup=[\d.]+x;binning_pct_of_total=[\d.]+%", row)
    assert 0 < n["binning_pct"] < 100
    sizes = torch.tensor([0, 5, 40, 1000, 7], dtype=torch.int32)
    from repro_torch.core import symbolic_ladder
    lad = symbolic_ladder(1.2)
    parts = bench_binning.naive_binning(sizes, lad)
    assert len(parts) == lad.num_bins
    assert sorted(int(i) for p in parts for i in p) == list(range(5))


def test_bench_overlap_case():
    """§6.3.4/6.3.5 on a small matrix: both loops run, the arena serves
    the steady stream from its free lists."""
    A = random_csr(0, 256, 256, avg_nnz_per_row=8.0, device="cpu")
    row, n = bench_overlap.case(A, n=4)
    assert re.fullmatch(r"bench_overlap/async_dispatch,\d+,"
                        r"serialized_us=\d+;overlap_gain=[\d.]+x;"
                        r"arena_hit_rate=[\d.]+", row)
    assert n["arena_hit_rate"] > 0.5


def test_bench_moe_dispatch_case():
    cfg = bench_moe_dispatch.config()
    assert (cfg.d_model, cfg.num_experts, cfg.experts_per_token, cfg.d_ff,
            cfg.dtype) == (256, 16, 4, 512, "float32")
    from repro_torch.models import moe as M
    from repro_torch.models.param import init_params
    p = init_params(M.moe_specs(cfg), torch.Generator().manual_seed(0),
                    "cpu")
    x = torch.randn((4, 16, 256), generator=torch.Generator().manual_seed(1))
    row, n = bench_moe_dispatch.case("tokens64", p, x, cfg)
    assert re.fullmatch(r"bench_moe_dispatch/tokens64,\d+,dense_us=\d+;"
                        r"binning_speedup=[\d.]+x", row)


def test_run_harness(capsys):
    """The header, one bench by --only, its rows; an unknown bench and a
    card that is not there raise."""
    assert run.main(["--device", "cpu", "--only", "moe_dispatch"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "name,us_per_call,derived"
    assert [r.split(",")[0] for r in out[1:]] == [
        f"bench_moe_dispatch/tokens{t}" for t in bench_moe_dispatch.TOKENS]
    assert set(run.benches("cpu")) == {"overall", "binning", "hashing",
                                       "binning_ranges", "overlap",
                                       "moe_dispatch"}
    with pytest.raises(KeyError):
        run.main(["--device", "cpu", "--only", "nope"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            run.main(["--only", "moe_dispatch"])
