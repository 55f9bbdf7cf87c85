"""The window that gives a configuration its Table-3 compression.

    python3 -m opbench.calibrate --config cant --lo 1.9 --hi 2.3

Draws the configuration's matrix at each window of a bisection and counts
A·A's entries with the reference's expansion on the card; the
compression n_prod / nnz(C) falls as the window widens.  One JSON line a
window on standard output; the last names the window closest to the
paper's compression.  A configuration states the window it picked.
"""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def compression(config: dict, window: float, device) -> dict:
    import torch

    from opbench import reference
    from opbench.operands import STRUCTURE_KEYS
    from opbench.matrices import table3_structure
    args = dict((k, config[k]) for k in STRUCTURE_KEYS)
    args["window"] = window
    rpt_h, col_h = table3_structure(*args.values())
    rpt = torch.from_numpy(rpt_h).to(device)
    col = torch.from_numpy(col_h).to(device)
    ones = torch.ones(col.shape[0], dtype=torch.float32, device=device)
    nprod = int(reference.row_products(rpt, col).sum())
    c_nnz = sum(int(b.sizes.sum())
                for b in reference.reference_blocks(rpt, col, ones))
    return {"window": window, "nnz": int(col.shape[0]),
            "max_row": int((rpt[1:] - rpt[:-1]).max()), "nprod": nprod,
            "c_nnz": c_nnz, "compression": nprod / c_nnz}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--lo", type=float, required=True)
    ap.add_argument("--hi", type=float, required=True)
    ap.add_argument("--steps", type=int, default=8)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    config = json.loads(
        (ROOT / "opbench" / "configs" / f"{args.config}.json").read_text())
    target = float(config["paper_compression"])
    lo, hi, seen = args.lo, args.hi, []
    for _ in range(args.steps):
        mid = round((lo + hi) / 2, 4)
        r = compression(config, mid, device)
        seen.append(r)
        print(json.dumps(r), flush=True)
        if r["compression"] > target:
            lo = mid
        else:
            hi = mid
    best = min(seen, key=lambda r: abs(r["compression"] - target))
    print(json.dumps({"config": args.config, "target": target, **best}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
