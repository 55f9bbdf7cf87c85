"""The single-H100 dry run: ``python -m repro_torch.launch.dryrun``.

The counterpart of ``repro/launch/dryrun.py``, which lowers and compiles
each (arch x shape) cell for a 256- or 512-chip TPU mesh and reads its
roofline terms from XLA.  Here each cell's step runs on the ``meta``
device (shapes and types, no storage, nothing computed) at the cell's
global batch, or at ``--batch``, under the two counters of
``roofline.count_step``: its FLOPs and its bytes give
``RooflineTerms`` with chips = 1.  Beside them the artifact records

  * the step's argument bytes by kind (parameters, optimizer state,
    gradients, caches, batch: the counterpart of ``memory_analysis``'s
    argument size) and whether what must be resident fits the card's
    memory (``torch.cuda.get_device_properties`` with a card, the data
    sheet's 80 GB without one; activations are not counted);
  * the closed-form terms of ``analytic.analytic_cell`` on one H100 and
    on the reference's production mesh (``--mesh``).

``--execute`` (on the card only) materializes the cell from a seeded
``torch.Generator`` at the largest power-of-two batch whose resident
bytes fit 3/4 of the card (caches counted once, as donated) and times
the step; a cell that fits at no batch is reported as such.  Artifacts
go to ``results/dryrun_torch/`` (``--out``).  ``--jobs N`` traces the
cells in N processes at once, each cut after ``--cell-timeout`` seconds
and listed as cut.
"""
from __future__ import annotations

import argparse
import json
import math
import signal
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path
from typing import Callable, Dict, Optional

import torch

from repro_torch.configs import ARCHS, get_arch
from repro_torch.core.csr import resolve_device
from repro_torch.models.model import Model
from repro_torch.models.param import tree_leaves
from repro_torch.models.quant import (abstract_quantized, quant_pspecs,
                                      quantize_params)
from repro_torch.optim import AdamWConfig

from . import shapes as shp
from . import sharding as shd
from .analytic import analytic_cell
from .mesh import ONE_CARD, make_production_mesh
from .roofline import H100, count_step, model_flops_for_cell, \
    terms_from_counts
from .steps import (abstract_train_state, init_train_state,
                    make_decode_step, make_prefill_step, make_train_step)

RESULTS_DIR = Path(__file__).resolve().parents[3] / "results" / \
    "dryrun_torch"
MESH_NAME = "1xH100"
EXECUTE_SHARE = 0.75      # of the card's memory, for --execute's batch
WARMUP, REPEATS = 1, 5
SEED = 0                  # --execute's generator

# Gradient-accumulation factor per arch (the reference's, chosen to keep
# train_4k's activations inside a TPU chip's HBM).
MICROBATCHES = {
    "falcon-mamba-7b": 8, "hubert-xlarge": 2, "qwen3-1.7b": 4,
    "minitron-4b": 4, "internlm2-1.8b": 4, "codeqwen1.5-7b": 4,
    "zamba2-1.2b": 8, "olmoe-1b-7b": 4, "qwen3-moe-30b-a3b": 4,
    "llama-3.2-vision-90b": 16,
}

# Gather-once FSDP: the reference's lever for archs whose TP-sharded bf16
# parameter copy fits next to the activations (not llama-90b's).
GATHER_ONCE_OK = {a: a != "llama-3.2-vision-90b" for a in MICROBATCHES}


def _nbytes(tree, named=None) -> int:
    """Bytes of one device's shards of the tensor leaves of ``tree``
    (``named``: its ``NamedSharding`` tree; whole tensors without)."""
    leaves = tree_leaves(tree)
    shards = tree_leaves(named) if named is not None else [None] * len(leaves)
    if len(shards) != len(leaves):
        raise ValueError(f"{len(shards)} shardings for {len(leaves)} leaves")
    total = 0
    for t, s in zip(leaves, shards):
        shape = s.shard_shape(t.shape) if s is not None else t.shape
        total += math.prod(shape) * t.element_size()
    return total


def card_memory(device: torch.device):
    """(bytes, source) of the memory the cell must fit."""
    if device.type == "cuda":
        props = torch.cuda.get_device_properties(device)
        return props.total_memory, f"{props.name} (device properties)"
    return H100.memory_bytes, "H100 data sheet (80 GB); no card asked for"


def _microbatches(arch: str, batch: int, microbatches: Optional[int]) -> int:
    """The reference's factor, clamped to the batch and made a divisor of
    it (each microbatch holds whole sequences)."""
    mb = max(1, min(microbatches or MICROBATCHES.get(arch, 4), batch))
    while batch % mb:
        mb -= 1
    return mb


def build_cell(arch: str, shape_name: str, *, batch: Optional[int] = None,
               microbatches: Optional[int] = None, gather_once: bool = False,
               overrides: Optional[dict] = None, quantize: bool = False,
               device: Optional[torch.device] = None,
               generator: Optional[torch.Generator] = None):
    """The cell's step function, its arguments and their bytes by kind.

    Without ``device`` the arguments are ``meta`` tensors; with it they
    are materialized there from ``generator``: random parameters, caches
    and tokens, decode at position ``seq_len - 1``."""
    cfg = get_arch(arch)
    if overrides:
        cfg = cfg.replace(**overrides)
    cell = shp.SHAPES[shape_name]
    if shape_name not in shp.cells_for(cfg):
        raise ValueError(f"{arch} skips {shape_name}")
    b = batch or cell.global_batch
    model = Model(cfg)
    specs = model.param_specs()
    mesh = ONE_CARD
    real = device is not None
    info: Dict = {"batch": b}
    mem: Dict[str, int] = {}

    def tokens(x):      # a batch entry: random ids or features
        if x.dtype.is_floating_point:
            return torch.randn(x.shape, generator=generator, device=device,
                               dtype=x.dtype)
        return torch.randint(0, cfg.vocab_size, x.shape,
                             generator=generator, device=device,
                             dtype=x.dtype)

    if cell.kind == "train":
        mb = _microbatches(arch, b, microbatches)
        info["microbatches"] = mb
        param_ps = shd.param_pspecs(specs, shd.train_rules(mesh), mesh)
        gather_specs = None
        if gather_once and GATHER_ONCE_OK.get(arch, False):
            gather_specs = shd.param_pspecs(specs, shd.serve_rules(mesh),
                                            mesh)
        state = (init_train_state(model, generator, device) if real
                 else abstract_train_state(model))
        batch_t = shp.abstract_batch(cfg, cell, b)
        if real:
            batch_t = {k: tokens(v) for k, v in batch_t.items()}
        named = shd.to_named(param_ps, mesh)
        mem["params"] = _nbytes(state.params, named)
        mem["grads"] = mem["params"]       # one gradient in their types
        mem["opt"] = sum(_nbytes(t, named) for t in
                         (state.opt.m, state.opt.v, state.opt.master))
        mem["opt_step"] = _nbytes(state.opt.step)
        mem["grad_accum"] = (4 * sum(p.numel() for p in
                                     tree_leaves(state.params))
                             if mb > 1 else 0)   # float32, one card
        mem["batch"] = _nbytes(batch_t, shd.to_named(shd.batch_pspecs(
            cfg, batch_t, mesh, b), mesh))
        mem["state"] = mem["params"] + mem["grads"] + mem["opt"]
        mem["arguments"] = (mem["params"] + mem["opt"] + mem["opt_step"]
                            + mem["batch"])
        mem["required"] = (mem["arguments"] + mem["grads"]
                           + mem["grad_accum"])
        fn = make_train_step(model, AdamWConfig(), microbatches=mb,
                             gather_specs=gather_specs)
        args = (state, batch_t)
    elif cell.kind == "prefill":
        param_ps = shd.param_pspecs(specs, shd.serve_rules(mesh), mesh)
        params = (model.init(generator, device) if real
                  else model.abstract_params())
        batch_t = shp.abstract_batch(cfg, cell, b)
        if real:
            batch_t = {k: tokens(v) for k, v in batch_t.items()}
        mem["params"] = _nbytes(params, shd.to_named(param_ps, mesh))
        mem["batch"] = _nbytes(batch_t)
        mem["caches"] = 0          # the step's output
        if not cfg.is_encoder:
            out = model.init_caches(b, cell.seq_len, abstract=True)
            mem["caches"] = _nbytes(out, shd.to_named(shd.cache_pspecs(
                cfg, out, mesh, global_batch=b, seq_len=cell.seq_len),
                mesh))
        mem["arguments"] = mem["params"] + mem["batch"]
        mem["required"] = mem["arguments"] + mem["caches"]
        fn = make_prefill_step(model, kv_cache_len=cell.seq_len)
        args = (params, batch_t)
    else:
        param_ps = shd.param_pspecs(specs, shd.serve_rules(mesh), mesh)
        params = model.abstract_params()
        if quantize:
            param_ps = quant_pspecs(param_ps, params)
            params = abstract_quantized(params)
        token, caches, pos = shp.abstract_decode_inputs(cfg, cell, b)
        if real:
            params = model.init(generator, device)
            if quantize:
                params = quantize_params(params)
            caches = model.init_caches(b, cell.seq_len, device=device)
            for t in tree_leaves(caches):
                t.normal_(generator=generator)
            token = tokens(token)
            pos = torch.full((), cell.seq_len - 1, dtype=torch.int32,
                             device=device)
        mem["params"] = _nbytes(params, shd.to_named(param_ps, mesh))
        mem["caches"] = _nbytes(caches, shd.to_named(shd.cache_pspecs(
            cfg, caches, mesh, global_batch=b, seq_len=cell.seq_len), mesh))
        mem["batch"] = _nbytes((token, pos))
        mem["arguments"] = mem["params"] + mem["caches"] + mem["batch"]
        mem["required"] = mem["arguments"]     # caches donated: one copy
        fn = make_decode_step(model, donate_caches=True)
        args = (params, token, caches, pos)
    return cfg, cell, model, fn, args, mem, info


def execute_batch(arch: str, shape_name: str, card_bytes: float,
                  **kw) -> Optional[int]:
    """The largest power of two, at most the cell's global batch, whose
    resident bytes fit ``EXECUTE_SHARE`` of ``card_bytes``; None if even
    one sequence does not."""
    b = 1 << (shp.SHAPES[shape_name].global_batch.bit_length() - 1)
    while b >= 1:
        mem = build_cell(arch, shape_name, batch=b, **kw)[5]
        if mem["required"] <= EXECUTE_SHARE * card_bytes:
            return b
        b //= 2
    return None


def lower_cell(arch: str, shape_name: str, *, batch: Optional[int] = None,
               microbatches: Optional[int] = None, gather_once: bool = False,
               overrides: Optional[dict] = None, quantize: bool = False,
               device="cuda", meshes=("16x16",)):
    """Trace one cell on ``meta`` under the counters; its artifact."""
    dev = resolve_device(device)
    cfg, cell, model, fn, args, mem, info = build_cell(
        arch, shape_name, batch=batch, microbatches=microbatches,
        gather_once=gather_once, overrides=overrides, quantize=quantize)
    t0 = time.perf_counter()
    _, flops, nbytes = count_step(fn, *args)
    trace_s = time.perf_counter() - t0
    b = info["batch"]
    mf = model_flops_for_cell(cfg, model.param_specs(), cell.kind,
                              shp.tokens_per_step(cfg, cell, b))
    terms = terms_from_counts(flops, nbytes, chips=1, model_flops=mf)
    card_bytes, card_src = card_memory(dev)
    mem.update(card=card_bytes, card_source=card_src,
               fits=mem["required"] <= card_bytes)
    mb = info.get("microbatches", 4)
    analytic = {MESH_NAME: analytic_cell(cfg, shape_name, microbatches=mb,
                                         gather_once=gather_once, batch=b)}
    for name in meshes:
        mesh = make_production_mesh(multi_pod=name == "2x16x16")
        analytic[name] = analytic_cell(cfg, shape_name, mesh=mesh,
                                       microbatches=mb,
                                       gather_once=gather_once)
    artifact = {
        "arch": arch, "shape": shape_name, "kind": cell.kind,
        "mesh": MESH_NAME, "chips": 1, **info, "quantize": quantize,
        "trace_s": round(trace_s, 2), "memory": mem,
        "roofline": terms.to_json(),
        "analytic": {k: _analytic_json(a) for k, a in analytic.items()},
    }
    return artifact, terms


def _analytic_json(a) -> Dict:
    return {"chips": a.chips, "flops_issued": a.flops_issued,
            "model_flops": a.model_flops, "hbm_bytes": a.hbm_bytes,
            "ici_bytes": a.ici_bytes, "t_compute_s": a.t_compute,
            "t_memory_s": a.t_memory, "t_collective_s": a.t_collective,
            "bottleneck": a.bottleneck, "step_time_s": a.step_time,
            "mfu": a.mfu, "hardware": a.hw.name}


def _finite(kind: str, out) -> bool:
    """The step's logits (its metrics for train) are finite."""
    small = {"train": out[1], "prefill": out[0], "decode": out[1]}[kind]
    return all(bool(torch.isfinite(t).all()) for t in tree_leaves(small)
               if t.dtype.is_floating_point)


def execute_cell(arch: str, shape_name: str, *, device="cuda",
                 quantize: bool = False, microbatches: Optional[int] = None,
                 gather_once: bool = False, batch: Optional[int] = None,
                 overrides: Optional[dict] = None,
                 profile: Optional[Callable] = None):
    """Run the cell on the card at the one-card batch (:func:`execute_batch`
    unless ``batch`` is given): 1 warm-up and 5 timed steps (host clock
    around a synchronize), the peak memory above what was held before the
    cell was built, then one more step under the counters (and, given
    ``profile``, ``profile(run_once)``'s result for one more).  Returns
    (artifact of the trace at that batch, execution record); the record
    says ``fits: False`` and nothing ran when no batch fits."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("--execute runs on the card only: device "
                         f"{dev} asked for")
    kw = dict(quantize=quantize, microbatches=microbatches,
              gather_once=gather_once, overrides=overrides)
    card_bytes, _ = card_memory(dev)
    b = batch or execute_batch(arch, shape_name, card_bytes, **kw)
    if b is None:
        return None, {"fits": False, "share_of_card": EXECUTE_SHARE}
    artifact, terms = lower_cell(arch, shape_name, batch=b, device=dev,
                                 meshes=(), **kw)
    torch.cuda.synchronize(dev)
    held = torch.cuda.memory_allocated(dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    _, cell, _, fn, args, mem, _ = build_cell(
        arch, shape_name, batch=b, device=dev, generator=gen, **kw)
    torch.cuda.synchronize(dev)
    built = torch.cuda.memory_allocated(dev) - held
    torch.cuda.reset_peak_memory_stats(dev)
    ms = []
    for i in range(WARMUP + REPEATS):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize(dev)
        if i >= WARMUP:
            ms.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated(dev) - held
    finite = _finite(cell.kind, out)
    del out
    _, flops_card, bytes_card = count_step(fn, *args)
    profiled = profile(lambda: fn(*args)) if profile else None
    median = statistics.median(ms)
    record = {
        "fits": True, "batch": b, "seed": SEED, "step_ms": ms,
        "step_ms_median": median, "held_gib": held / 2 ** 30,
        "argument_gib": mem["arguments"] / 2 ** 30,
        "built_gib": built / 2 ** 30, "peak_gib": peak / 2 ** 30,
        "bound_ms": terms.step_time * 1e3, "bound_by": terms.bottleneck,
        "roofline_share": terms.step_time / (median / 1e3),
        "mfu_roofline": terms.mfu(median / 1e3), "finite": finite,
        "flops_card": flops_card, "flops_trace": terms.flops,
        "bytes_card": bytes_card, "bytes_trace": terms.hbm_bytes,
        "card": torch.cuda.get_device_name(dev), "profile": profiled,
    }
    del args
    artifact["execute"] = record
    return artifact, record


def _tag(arch, shape_name):
    return f"{arch}|{shape_name}|{MESH_NAME}"


def _save(artifact: Dict, out_dir: Path, suffix: str = "") -> Path:
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"{artifact['arch']}_{artifact['shape']}_" \
        f"{MESH_NAME}{suffix}.json"
    path.write_text(json.dumps(artifact, indent=1))
    return path


def run_cell(arch, shape_name, *, verbose=True, out_dir=None,
             device="cuda", batch=None, execute=False, quantize=False,
             gather_once=False, meshes=("16x16",), profile=None):
    """Trace (and with ``execute`` run) one cell, print its line, write its
    artifact; the artifact, or None if the cell failed."""
    tag = _tag(arch, shape_name)
    try:
        if execute:
            artifact, rec = execute_cell(arch, shape_name, device=device,
                                         quantize=quantize,
                                         gather_once=gather_once,
                                         batch=batch, profile=profile)
            if artifact is None:
                print(f"[no fit] {tag}: no batch fits "
                      f"{EXECUTE_SHARE} of the card; not run")
                return {"arch": arch, "shape": shape_name, "execute": rec}
        else:
            artifact, _ = lower_cell(arch, shape_name, batch=batch,
                                     device=device, quantize=quantize,
                                     gather_once=gather_once, meshes=meshes)
    except Exception as e:
        print(f"[FAIL] {tag}: {e}")
        traceback.print_exc()
        return None
    if verbose:
        r, m = artifact["roofline"], artifact["memory"]
        print(f"[ok] {tag} trace={artifact['trace_s']}s "
              f"batch={artifact['batch']} flops={r['flops']:.3e} "
              f"bytes={r['hbm_bytes']:.3e} coll={r['coll_bytes']:.3e} "
              f"bottleneck={r['bottleneck']} "
              f"mfu_roofline={r['mfu_roofline']:.3f} "
              f"arg={m['arguments'] / 2 ** 30:.2f}GiB "
              f"required={m['required'] / 2 ** 30:.2f}GiB "
              f"fits={m['fits']}", flush=True)
        rec = artifact.get("execute")
        if rec:
            print(f"[run] {tag} batch={rec['batch']} "
                  f"median={rec['step_ms_median']:.2f}ms "
                  f"bound={rec['bound_ms']:.2f}ms ({rec['bound_by']}) "
                  f"share={rec['roofline_share']:.3f} "
                  f"mfu={rec['mfu_roofline']:.4f} "
                  f"peak={rec['peak_gib']:.2f}GiB "
                  f"flops_card={rec['flops_card']:.6e} "
                  f"flops_trace={rec['flops_trace']:.6e} "
                  f"finite={rec['finite']} on {rec['card']}", flush=True)
    _save(artifact, Path(out_dir) if out_dir else RESULTS_DIR,
          "_execute" if execute else "")
    return artifact


def _run_parallel(cells, args, argv_common) -> tuple:
    """Each cell in its own process, ``args.jobs`` at a time, each cut
    after ``args.cell_timeout`` seconds; (ok, cut, failed) counts.  The
    prefill cells, whose blocked attention's loops take the longest to
    trace, start first.  Stopped (SIGINT, or SIGTERM as ``timeout``
    sends it), the sweep cuts its running cells and the ones not
    started, and lists each."""
    pending = sorted(cells, key=lambda c: shp.SHAPES[c[1]].kind != "prefill")
    running = []
    n_ok = n_cut = n_fail = 0
    out_dir = Path(args.out) if args.out else RESULTS_DIR

    def cut(arch, cell, proc=None, waited=0.0):
        if proc is not None:
            proc.kill()
            proc.communicate()
        print(f"[cut] {_tag(arch, cell)} after {waited:.0f}s", flush=True)
        _save({"arch": arch, "shape": cell, "mesh": MESH_NAME,
               "cut_after_s": round(waited)}, out_dir)

    signal.signal(signal.SIGTERM, signal.default_int_handler)
    try:
        while pending or running:
            while pending and len(running) < args.jobs:
                arch, cell = pending.pop(0)
                cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                       "--arch", arch, "--shape", cell, *argv_common]
                proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True)
                running.append((arch, cell, proc, time.perf_counter()))
            time.sleep(0.5)
            for item in list(running):
                arch, cell, proc, t0 = item
                waited = time.perf_counter() - t0
                if proc.poll() is None and waited < args.cell_timeout:
                    continue
                running.remove(item)
                if proc.poll() is None:
                    n_cut += 1
                    cut(arch, cell, proc, waited)
                    continue
                print(proc.communicate()[0], end="", flush=True)
                if proc.returncode == 0:
                    n_ok += 1
                else:
                    n_fail += 1
    except KeyboardInterrupt:
        for arch, cell, proc, t0 in running:
            cut(arch, cell, proc, time.perf_counter() - t0)
        for arch, cell in pending:
            cut(arch, cell)
        n_cut += len(running) + len(pending)
        print(f"dry-run stopped: {n_ok} ok, {n_cut} cut, {n_fail} failed",
              flush=True)
        raise SystemExit(130) from None
    return n_ok, n_cut, n_fail


def main(argv=None):
    ap = argparse.ArgumentParser(description="single-H100 dry run")
    ap.add_argument("--arch", default=None,
                    help="architecture ids, comma-separated (default: all)")
    ap.add_argument("--shape", default=None,
                    help="shape cell (default: all applicable)")
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single",
                    help="the reference's production mesh whose analytic "
                    "terms the artifact also records (16x16, 2x16x16)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card) or cpu (no card: the memory "
                    "verdict uses the data sheet's 80 GB)")
    ap.add_argument("--batch", type=int, default=None,
                    help="sequences (default: the cell's global batch; "
                    "with --execute the largest power of two that fits)")
    ap.add_argument("--execute", action="store_true",
                    help="also run the cell on the card and time it")
    ap.add_argument("--quantize", action="store_true",
                    help="int8 weights for the decode cells")
    ap.add_argument("--out", default=None,
                    help=f"artifact directory (default {RESULTS_DIR})")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells traced at once, one process each")
    ap.add_argument("--cell-timeout", type=float, default=600.0,
                    help="with --jobs > 1: seconds before a cell is cut")
    args = ap.parse_args(argv)

    archs = args.arch.split(",") if args.arch else sorted(ARCHS)
    meshes = {"single": ("16x16",), "multi": ("2x16x16",),
              "both": ("16x16", "2x16x16")}[args.mesh]
    cells = [(a, c) for a in archs
             for c in ([args.shape] if args.shape
                       else shp.cells_for(get_arch(a)))]
    n_cut = 0
    if args.jobs > 1 and len(cells) > 1:
        common = ["--mesh", args.mesh, "--device", args.device]
        for flag, on in (("--execute", args.execute),
                         ("--quantize", args.quantize)):
            if on:
                common.append(flag)
        if args.batch:
            common += ["--batch", str(args.batch)]
        if args.out:
            common += ["--out", args.out]
        n_ok, n_cut, n_fail = _run_parallel(cells, args, common)
    else:
        n_ok = n_fail = 0
        for arch, cell in cells:
            art = run_cell(arch, cell, out_dir=args.out, device=args.device,
                           batch=args.batch, execute=args.execute,
                           quantize=args.quantize, meshes=meshes)
            if art is None:
                n_fail += 1
            else:
                n_ok += 1
    print(f"dry-run complete: {n_ok} ok, {n_cut} cut, {n_fail} failed")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
