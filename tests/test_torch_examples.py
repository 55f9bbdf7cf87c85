"""The port's examples on the CPU (``--device cpu``).

``examples/torch/quickstart.py`` must pass the dense-oracle check of
``examples/quickstart.py`` and print the reference quickstart's numbers
for the same ``PRNGKey(0)`` matrix (nnz, products, C's nnz, both
binnings), which the reference computes here with its ESC method;
``examples/torch/graph_analytics.py`` must run its BFS, powers and sharded
hop to the end.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np

from repro.core import SpgemmConfig, random_csr, spgemm

ROOT = Path(__file__).resolve().parents[1]


def _run(script: str) -> str:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, str(ROOT / "examples" / "torch" /
                                              script), "--device", "cpu"],
                         capture_output=True, text=True, env=env, cwd=ROOT,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    return out.stdout


def test_quickstart_matches_the_reference_quickstart():
    out = _run("quickstart.py")
    assert "dense-oracle check: OK" in out
    A = random_csr(jax.random.PRNGKey(0), 2000, 2000, avg_nnz_per_row=8.0,
                   max_nnz_per_row=200, distribution="powerlaw")
    res = spgemm(A, A, SpgemmConfig(method="esc", timing=True))
    assert f"A: (2000, 2000), nnz={int(A.nnz())}," in out
    assert (f"C = A@A: nnz={res.total_nnz}, intermediate products="
            f"{res.total_nprod}, compression ratio="
            f"{res.compression_ratio:.2f}") in out
    for which, binning in (("symbolic", res.sym_binning),
                           ("numeric ", res.num_binning)):
        line = re.search(rf"^{which} bin sizes: \[(.*)\]$", out, re.M)
        assert [int(v) for v in line.group(1).split()] == \
            np.asarray(binning.bin_size).tolist()


def test_graph_analytics_runs_to_the_end():
    out = _run("graph_analytics.py")
    hops = re.findall(r"^hop (\d): frontier nnz=(\d+)", out, re.M)
    assert [h for h, _ in hops] == ["1", "2", "3", "4"]
    assert "multi-source BFS done" in out and "A^3: nnz=" in out
    assert re.search(r"sharded hop: nnz=\d+, row blocks 0/\d+/3000", out)


def test_serve_lm_serves_rejects_and_scrapes():
    """examples/torch/serve_lm.py on the CPU: 10 requests served with 12
    tokens each, the oversized one rejected structurally, and the
    /metrics scrape shows the serve counters."""
    out = _run("serve_lm.py")
    assert re.search(r"^served 10/11 requests \(1 rejected\), 120 tokens",
                     out, re.M)
    assert "req 10: REJECTED: prompt length 200 >= max_len 96" in out
    for line in ("opsparse_serve_requests_total 10",
                 "opsparse_serve_rejected_total 1",
                 "opsparse_serve_tokens_total 120",
                 "opsparse_serve_decode_step_seconds_count"):
        assert line in out
