"""The served model's decode consistency under two rules for the random
init's fan-in, on the card.

olmoe-1b-7b at its published width, capacity factor 8 (= E / k: no
assignment dropped): ||prefill(s) + decode(1) - prefill(s+1)|| /
||prefill(s+1)|| on the last position's logits, in bfloat16 and float32,
with every normal leaf drawn as N(0, 1) / sqrt(fan_in) where fan_in is
the first axis (the reference's ``param._materialize``: the layer count
of a stacked weight) or the matrix's input axis (the port's
``param.fan_in``).  s + 1 is the first prompt length of ``chip_smoke.py``'s
LM stream (numpy ``default_rng(0)``).

Run:  PYTHONPATH=src python -m benchmarks.torch.lm_init_scale
"""
import argparse
import json
import subprocess
from unittest import mock

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.models import param
from repro_torch.models.model import Model

ARCH = "olmoe-1b-7b"
RULES = {"first_axis": lambda shape: shape[0], "input_axis": param.fan_in}


def init_with(model, rule, generator, device):
    """``param.init_params`` of the model's specs with ``param.fan_in``
    replaced by ``rule(shape)``."""
    with mock.patch.object(param, "fan_in", rule):
        return param.init_params(model.param_specs(), generator, device)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    card = "cpu"
    if args.device != "cpu":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip()
    base = get_arch(ARCH)
    rng = np.random.default_rng(0)
    n = int(rng.integers(32, 257, 8)[0])
    toks = torch.from_numpy(rng.integers(0, base.vocab_size, n))[None].to(
        args.device)
    s = n - 1
    for dtype in ("bfloat16", "float32"):
        model = Model(base.replace(dtype=dtype, moe_capacity_factor=8.0))
        for name, rule in RULES.items():
            gen = torch.Generator(device=args.device).manual_seed(0)
            p = init_with(model, rule, gen, args.device)
            with torch.inference_mode():
                full, _ = model.prefill(p, {"tokens": toks},
                                        kv_cache_len=s + 1)
                _, c = model.prefill(p, {"tokens": toks[:, :s]},
                                     kv_cache_len=s + 1)
                step, _ = model.decode_step(p, toks[:, s:], c, s)
                full = full.float()
                rel = float((step.float() - full).norm() / full.norm())
            print(json.dumps(dict(arch=ARCH, dtype=dtype, fan_in=name,
                                  s=s, rel=rel, card=card)), flush=True)
            del p, c
            if args.device == "cuda":
                torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
