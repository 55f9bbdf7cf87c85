"""Training launcher: ``python -m repro_torch.launch.train --arch <id>``.

Trains one architecture on the synthetic token stream through the
fault-tolerant ``Trainer`` (checkpoints, resume, NaN rollback,
preemption on SIGTERM/SIGINT), with a reduced config in float32 unless
``--full-size`` is given, random weights from a seeded
``torch.Generator``, on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import logging
import os
import tempfile

import torch

from repro_torch.configs import get_arch
from repro_torch.core.csr import resolve_device
from repro_torch.data.synthetic import DataConfig, SyntheticTokenStream
from repro_torch.launch.steps import init_train_state, make_train_step
from repro_torch.models.model import Model
from repro_torch.models.param import param_count
from repro_torch.optim import AdamWConfig
from repro_torch.train.trainer import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--full-size", action="store_true",
                    help="use the full config (default: reduced())")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s")

    cfg = get_arch(args.arch)
    if not args.full_size:
        cfg = cfg.reduced().replace(dtype="float32")
    device = resolve_device(args.device)
    model = Model(cfg)
    print(f"{cfg.name}: {param_count(model.param_specs())/1e6:.1f}M params")

    state = init_train_state(model, torch.Generator().manual_seed(0), device)
    step_fn = make_train_step(
        model, AdamWConfig(lr=args.lr, total_steps=args.steps),
        microbatches=args.microbatches)
    data = SyntheticTokenStream(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq,
        global_batch=args.batch), device=device)
    trainer = Trainer(step_fn, data, TrainerConfig(
        total_steps=args.steps, ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every))
    trainer.install_signal_handlers()
    state, step = trainer.fit(state)
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    print(f"done at step {step} on {where}; last loss "
          f"{trainer.metrics_history[-1]['loss']:.4f}")


if __name__ == "__main__":
    main()
