"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id>``.

Drives the continuous-batching engine on randomly generated requests,
with a reduced config of the architecture in float32 and random weights
from a seeded ``torch.Generator``, on the card unless ``--device cpu`` is
given.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.core.csr import resolve_device
from repro_torch.models.model import Model
from repro_torch.serve.engine import Request, ServingEngine


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new-tokens", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch).reduced().replace(dtype="float32")
    if cfg.is_encoder:
        raise SystemExit(f"{cfg.name} is encoder-only: no decode serving")
    device = resolve_device(args.device)
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device)
    engine = ServingEngine(model, params, max_batch=args.max_batch,
                           max_len=args.max_len)

    rng = np.random.default_rng(0)
    for uid in range(args.requests):
        plen = int(rng.integers(4, 32))
        engine.submit(Request(
            uid=uid, prompt=rng.integers(0, cfg.vocab_size,
                                         plen).astype(np.int32),
            max_new_tokens=args.max_new_tokens))

    t0 = time.perf_counter()
    results = engine.run()
    dt = time.perf_counter() - t0
    total = sum(len(v) for v in results.values())
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    print(f"{cfg.name}: served {len(results)} requests / {total} tokens "
          f"in {dt:.1f}s ({total/dt:.1f} tok/s) on {where}")


if __name__ == "__main__":
    main()
