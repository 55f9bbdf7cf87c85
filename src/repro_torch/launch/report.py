"""The dry run's tables: ``python -m repro_torch.launch.report``.

The counterpart of ``repro/launch/report.py``.  Prints three sections in
Markdown: the dry-run table (from the artifacts of
``python -m repro_torch.launch.dryrun`` under ``results/dryrun_torch/``),
the roofline table (the closed-form terms of ``analytic.analytic_cell``
on the H100 record, on one card and on the reference's 16x16 mesh of
H100s) and the consistency check (the FLOPs the trace counted against
the closed form's issued FLOPs on one card).
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Optional

from repro_torch.configs import ARCHS, get_arch

from . import shapes as shp
from .analytic import analytic_cell
from .dryrun import MESH_NAME, MICROBATCHES, RESULTS_DIR
from .mesh import make_production_mesh


def _load(results: Path, arch: str, shape: str) -> Optional[dict]:
    f = results / f"{arch}_{shape}_{MESH_NAME}.json"
    return json.loads(f.read_text()) if f.exists() else None


def _fmt_t(x):
    if x >= 1:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x*1e3:.1f}ms"
    return f"{x*1e6:.0f}us"


def _advice(cell, a):
    b = a.bottleneck
    if cell == "train_4k":
        if b == "memory":
            return ("activation traffic dominates: fuse residual+norm, "
                    "larger microbatch when HBM allows")
        if b == "collective":
            return ("overlap FSDP gathers with layer compute over NVLink / "
                    "widen TP")
        return ("tensor-core-bound: raise the batch a card or cut remat "
                "recompute")
    if cell == "prefill_32k":
        return ("KV/activation streaming from HBM dominates: larger "
                "attention k-blocks, keep caches sharded on write"
                if b == "memory" else
                "tensor-core-bound: fewer wasted FLOPs (causal blocks, "
                "MoE capacity)" if b == "compute" else
                "TP activation reductions over NVLink dominate: "
                "sequence-shard prefill")
    return ("weight+cache reads from HBM are the floor: int8 weights, "
            "more sequences a card" if b == "memory" else
            "per-layer TP reductions over NVLink dominate: duplicate small "
            "weights" if b == "collective" else
            "tensor-core-bound: cut MoE capacity padding")


def dryrun_table(results: Path = RESULTS_DIR) -> str:
    """One row per arch x cell: the counted FLOPs and bytes, their bound
    on the H100 record, the closed form's bound on one H100 at the same
    batch, and the resident bytes against the card."""
    rows = ["| arch | cell | batch | trace | FLOPs (counted) | "
            "bytes (counted) | bound (counted) | bound (closed form) | "
            "required | fits |",
            "|---|---|---|---|---|---|---|---|---|---|"]
    for arch in sorted(ARCHS):
        cfg = get_arch(arch)
        for cell in shp.cells_for(cfg):
            art = _load(results, arch, cell)
            if art is None:
                rows.append(f"| {arch} | {cell} | MISSING |")
                continue
            if "cut_after_s" in art:
                rows.append(f"| {arch} | {cell} | - | cut at "
                            f"{art['cut_after_s']}s | - | - | - | - | - "
                            "| - |")
                continue
            r, m = art["roofline"], art["memory"]
            a = analytic_cell(cfg, cell, batch=art["batch"],
                              microbatches=art.get("microbatches", 4))
            rows.append(
                f"| {arch} | {cell} | {art['batch']} | {art['trace_s']}s | "
                f"{r['flops']:.3e} | {r['hbm_bytes']:.3e} | "
                f"{_fmt_t(r['step_time_s'])} {r['bottleneck']} | "
                f"{_fmt_t(a.step_time)} {a.bottleneck} | "
                f"{m['required'] / 2 ** 30:.1f}G | "
                f"{'yes' if m['fits'] else 'no'} |")
    return "\n".join(rows)


def roofline_table() -> str:
    """One row per arch x cell: the closed form on one H100 (no links)
    and on the 16x16 mesh of H100s; the advice reads the one-card
    bottleneck."""
    rows = ["| arch | cell | 1xH100 t_comp | t_mem | bottleneck | MFU | "
            "16x16 t_comp | t_mem | t_coll | bottleneck | MFU | "
            "MODEL_FLOPS (1xH100) | useful/issued | "
            "what moves the one-card term |",
            "|---|---|---|---|---|---|---|---|---|---|---|---|---|---|"]
    pod = make_production_mesh()
    for arch in sorted(ARCHS):
        cfg = get_arch(arch)
        mb = MICROBATCHES.get(arch, 4)
        for cell in shp.cells_for(cfg):
            a = analytic_cell(cfg, cell, microbatches=mb)
            p = analytic_cell(cfg, cell, mesh=pod, microbatches=mb)
            rows.append(
                f"| {arch} | {cell} | {_fmt_t(a.t_compute)} | "
                f"{_fmt_t(a.t_memory)} | **{a.bottleneck}** | {a.mfu:.3f} | "
                f"{_fmt_t(p.t_compute)} | {_fmt_t(p.t_memory)} | "
                f"{_fmt_t(p.t_collective)} | {p.bottleneck} | {p.mfu:.3f} | "
                f"{a.model_flops:.2e} | {a.useful_ratio:.2f} | "
                f"{_advice(cell, a)} |")
    return "\n".join(rows)


def consistency_check(results: Path = RESULTS_DIR) -> str:
    """Counted FLOPs against the closed form's issued FLOPs, one card, at
    the artifact's batch.  The trace counts every matrix product the port
    issues: scores over the full sequence where the closed form takes the
    causal half, MoE capacity padding, and the head at the last position
    only in prefill."""
    lines = ["| arch/cell | batch | counted FLOPs | analytic issued | "
             "counted/analytic |", "|---|---|---|---|---|"]
    for arch in sorted(ARCHS):
        cfg = get_arch(arch)
        for cell in shp.cells_for(cfg):
            art = _load(results, arch, cell)
            if art is None or "cut_after_s" in art:
                continue
            a = analytic_cell(cfg, cell, batch=art["batch"],
                              microbatches=art.get("microbatches", 4))
            got = art["roofline"]["flops"]
            lines.append(f"| {arch}/{cell} | {art['batch']} | {got:.3e} | "
                         f"{a.flops_issued:.3e} | "
                         f"{got / a.flops_issued:.3f} |")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--results", type=Path, default=RESULTS_DIR,
                    help="the dry run's artifact directory")
    args = ap.parse_args(argv)
    print("## Dry-run table (traced on meta, one H100)\n")
    print(dryrun_table(args.results))
    print("\n## Roofline table (closed form, H100 record: one card and "
          "16x16)\n")
    print(roofline_table())
    print("\n## Counted-vs-analytic consistency (one card)\n")
    print(consistency_check(args.results))


if __name__ == "__main__":
    main()
