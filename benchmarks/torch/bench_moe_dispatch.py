"""MoE token dispatch on the port: the OpSparse binning against the dense
one-hot einsums.

The binning dispatch (``core.binning.bin_by_id``, the paper's two-pass
method) replaces GShard's (T, E, C) one-hot dispatch einsums with a sort
and gathers / scatters.  Both give the same outputs (tests); this times
them at growing token counts on the reference's cut of olmoe-1b-7b
(d_model 256, 16 experts, top-4, d_ff 512, capacity factor 1.25,
float32), with the weights drawn from one ``torch.Generator`` seed and
the tokens from another, as batches of 4 groups.  :func:`case` times any
configuration and batch.

Run from the repo root:
  PYTHONPATH=src python -m benchmarks.torch.bench_moe_dispatch \\
      [--device cpu]
"""
from __future__ import annotations

import argparse
from typing import Dict, List, Tuple

import torch

from repro_torch.configs import get_arch
from repro_torch.core import resolve_device
from repro_torch.models import moe as M
from repro_torch.models.param import init_params

from .common import timeit

TOKENS = (512, 2048, 8192)


def config():
    """The reference bench's cut of olmoe-1b-7b."""
    return get_arch("olmoe-1b-7b").reduced().replace(
        d_model=256, num_experts=16, experts_per_token=4, d_ff=512,
        moe_capacity_factor=1.25, dtype="float32")


def case(name: str, params, x: torch.Tensor, cfg
         ) -> Tuple[str, Dict[str, float]]:
    """Binning against dense dispatch on one batch -> (the reference's
    row, its numbers)."""
    with torch.inference_mode():
        t_bin = timeit(lambda: M.moe(params, x, cfg)[0])
        t_dense = timeit(lambda: M.moe_dense_dispatch(params, x, cfg)[0])
    row = (f"bench_moe_dispatch/{name},{t_bin*1e6:.0f},"
           f"dense_us={t_dense*1e6:.0f};binning_speedup="
           f"{t_dense/t_bin:.2f}x")
    return row, dict(binning_us=t_bin * 1e6, dense_us=t_dense * 1e6)


def run(device="cuda") -> List[str]:
    dev = resolve_device(device)
    cfg = config()
    params = init_params(M.moe_specs(cfg),
                         torch.Generator(device="cpu").manual_seed(0), dev)
    gen = torch.Generator(device="cpu").manual_seed(1)
    rows = []
    for toks in TOKENS:
        x = torch.randn((4, toks // 4, cfg.d_model), generator=gen).to(dev)
        row, _ = case(f"tokens{toks}", params, x, cfg)
        rows.append(row)
        print(row, flush=True)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    run(ap.parse_args(argv).device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
