"""The readings that the check's limits are set from: the numbers it
compares, for the program on many seeds and for its control (the
program's own bfloat16 path, A's values rounded to bfloat16 and C
compared with the float32 reference) on a few, all in one process at the
cell's own size.

    python3 -m opbench.limits --workload mono_500Hz.steady \\
        --seeds 101 102 ... --control-seeds 201 202 203 --seconds 3

One JSON line per run on standard output.  Benchmark runs never run
the control.
"""
import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control", default="bfloat16")
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    from opbench.harness import load_cell, run_cell
    if not torch.cuda.is_available():
        print("opbench.limits: no CUDA card", file=sys.stderr)
        return 2
    cell = load_cell(args.workload, ROOT)
    runs = [(s, None) for s in args.seeds] + [
        (s, args.control) for s in args.control_seeds]
    for seed, control in runs:
        t0 = time.perf_counter()
        r = run_cell(cell, seed=seed, seconds=args.seconds, trace=False,
                     device=torch.device("cuda", 0), t_process=t0,
                     control=control)
        gc.collect()
        torch.cuda.empty_cache()
        print(json.dumps({
            "workload": args.workload, "seed": seed, "control": control,
            "correct": r["correct"], "products": r["attempted"],
            "checks": {k: v["value"] for k, v in r["checks"].items()},
            "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
