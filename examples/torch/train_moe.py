"""End-to-end example: train a ~66M-parameter MoE LM for a few hundred
steps, on the card by default.

The port's ``examples/train_moe.py``.  The MoE token dispatch is the
paper's two-pass binning (``core.binning.bin_by_id``).  The loop
exercises the whole training path: the synthetic data stream, AdamW in
place, remat, asynchronous checkpoints, NaN rollback, straggler
accounting.

Run:  PYTHONPATH=src python examples/torch/train_moe.py [--steps 300]
      [--device cpu]
"""
import argparse
import logging
import os
import tempfile
import time

import torch

from repro_torch.configs import get_arch
from repro_torch.data.synthetic import DataConfig, SyntheticTokenStream
from repro_torch.launch.steps import init_train_state, make_train_step
from repro_torch.models.model import Model
from repro_torch.models.param import param_count
from repro_torch.optim import AdamWConfig
from repro_torch.train.trainer import Trainer, TrainerConfig

logging.basicConfig(level=logging.INFO, format="%(message)s")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_moe_ckpt"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    # olmoe topology shrunk to ~66M params
    cfg = get_arch("olmoe-1b-7b").replace(
        name="olmoe-100m", num_layers=6, d_model=384, num_heads=6,
        num_kv_heads=6, d_ff=512, vocab_size=8192, num_experts=16,
        experts_per_token=4, dtype="float32")
    model = Model(cfg)
    n_params = param_count(model.param_specs())
    print(f"arch {cfg.name}: {n_params/1e6:.1f}M params "
          f"({cfg.num_experts} experts, top-{cfg.experts_per_token})")

    state = init_train_state(model, torch.Generator().manual_seed(0),
                             args.device)
    step_fn = make_train_step(model, AdamWConfig(lr=1e-3, warmup_steps=20,
                                                 total_steps=args.steps),
                              microbatches=1)
    data = SyntheticTokenStream(
        DataConfig(vocab_size=cfg.vocab_size, seq_len=128, global_batch=8),
        device=args.device)

    tr = Trainer(step_fn, data,
                 TrainerConfig(total_steps=args.steps, ckpt_every=100,
                               ckpt_dir=args.ckpt, log_every=20))
    tr.install_signal_handlers()
    t0 = time.perf_counter()
    state, step = tr.fit(state, resume=False)
    dt = time.perf_counter() - t0

    first = tr.metrics_history[0]["loss"]
    last = tr.metrics_history[-1]["loss"]
    print(f"\ntrained {step} steps in {dt:.1f}s "
          f"({dt/max(step,1)*1e3:.0f} ms/step)")
    print(f"loss {first:.3f} -> {last:.3f} "
          f"({'LEARNED' if last < first * 0.8 else 'check data/config'})")


if __name__ == "__main__":
    main()
