"""Run one cell of the benchmark of the port (``repro_torch``) on one
card, and print its result as the last line of standard output.

    python3 -m opbench.run --workload mono_500Hz.steady --seed 7 \\
        --seconds 35 --trace 0

from the root of a checkout (``src/`` is put on the path).  ``--trace 0``
prints the cell's end-to-end metrics, ``--trace 1`` its per-layer ones
from a run under ``torch.profiler``.  Set-up (the kernels' build or load,
A from the seed, the traffic's warm-up) runs before the window; the
check against the plain reference runs after it, and each number it
compares is printed with its limit as the last lines of standard error
and under ``checks``, the result's last key.  Without a CUDA card, or
without the port's package, it exits non-zero and prints no result.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # Every build and kernel cache inside the checkout, at fixed paths.
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["USE_FLAX"] = "0"
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    from opbench.harness import forbidden_modules, load_cell, run_cell
    cell = load_cell(args.workload, ROOT)
    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"opbench: {args.workload} needs {chips} CUDA card(s); "
              f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    try:
        import repro_torch  # noqa: F401
    except ImportError as exc:
        print(f"opbench: the port is not importable: {exc}", file=sys.stderr)
        return 3
    result = run_cell(cell, seed=args.seed, seconds=args.seconds,
                      trace=bool(args.trace), device=torch.device("cuda", 0),
                      t_process=T_PROCESS)
    import resource
    result["setup"]["host_rss_peak_kib"] = resource.getrusage(
        resource.RUSAGE_SELF).ru_maxrss
    loaded = forbidden_modules()
    if loaded:
        print(f"opbench: modules the run may not load were loaded: "
              f"{loaded}", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
