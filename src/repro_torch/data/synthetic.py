"""Deterministic, resumable synthetic data pipeline.

The counterpart of ``repro/data/synthetic.py``.  Every batch is a pure
function of (seed, step): one ``torch.Generator`` seeded from both draws
it, so the stream needs no buffering, replays exactly after a restart
(the trainer checkpoints just the step counter) and is made where the
caller names (``device``, the card unless the caller asks for the CPU).

Token sequences follow the reference's noisy affine recurrence t[i+1] =
(a·t[i] + c) % V, each token resampled uniformly with probability
``noise``, so the examples show real loss curves.  The reference draws
with ``jax.random``, whose bits torch cannot reproduce: the two streams
share the recurrence and its statistics, not their tokens (tests that
compare the two packages feed both the reference's batches).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.csr import Device, resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    noise: float = 0.1
    mult: int = 3
    add: int = 7


def _generator(seed: int, step: int, device: torch.device) -> torch.Generator:
    """A generator on ``device`` seeded from (seed, step) alone."""
    state = np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)
    return torch.Generator(device=device).manual_seed(int(state[0]))


class SyntheticTokenStream:
    """Stateless-resumable LM token stream, made on ``device``."""

    def __init__(self, cfg: DataConfig, step: int = 0, *,
                 device: Device = "cuda"):
        self.cfg = cfg
        self.step = step
        self.device = resolve_device(device)

    # -- checkpointable state -------------------------------------------
    def state(self) -> Dict:
        return {"step": self.step, "seed": self.cfg.seed}

    @classmethod
    def from_state(cls, cfg: DataConfig, state: Dict, *,
                   device: Device = "cuda") -> "SyntheticTokenStream":
        if state["seed"] != cfg.seed:
            raise ValueError("restoring stream with wrong seed")
        return cls(cfg, step=int(state["step"]), device=device)

    # -- batch generation -------------------------------------------------
    def batch_at(self, step: int) -> Dict[str, torch.Tensor]:
        """{"tokens": (B, S+1) int32}.  The recurrence's i-th term is
        A_i·t_0 + C_i (mod V) with A_i, C_i from the same recurrence in
        Python integers, so the S+1 terms are one product on the device
        and exact."""
        cfg = self.cfg
        b, s, v = cfg.global_batch, cfg.seq_len, cfg.vocab_size
        gen = _generator(cfg.seed, step, self.device)
        start = torch.randint(0, v, (b, 1), generator=gen,
                              device=self.device)
        coef, const = [1], [0]
        for _ in range(s):
            coef.append(coef[-1] * cfg.mult % v)
            const.append((const[-1] * cfg.mult + cfg.add) % v)
        coef_t = torch.tensor(coef, dtype=torch.int64, device=self.device)
        const_t = torch.tensor(const, dtype=torch.int64, device=self.device)
        tokens = (start * coef_t + const_t) % v                # (B, S+1)
        noise_mask = torch.rand(tokens.shape, generator=gen,
                                device=self.device) < cfg.noise
        noise_tok = torch.randint(0, v, tokens.shape, generator=gen,
                                  device=self.device)
        return {"tokens": torch.where(noise_mask, noise_tok, tokens)
                .to(torch.int32)}

    def next_batch(self) -> Dict[str, torch.Tensor]:
        batch = self.batch_at(self.step)
        self.step += 1
        return batch


def batch_for_arch(cfg: ArchConfig, data_cfg: DataConfig, step: int,
                   stream: Optional[SyntheticTokenStream] = None, *,
                   device: Device = "cuda") -> Dict[str, torch.Tensor]:
    """Arch-aware batch: adds vision embeddings / encoder features, drawn
    from a generator seeded from (seed + 1, step) on the stream's
    device."""
    stream = stream or SyntheticTokenStream(data_cfg, step, device=device)
    dev = stream.device
    gen = _generator(data_cfg.seed + 1, step, dev)
    if cfg.family == "encoder":
        b, s = data_cfg.global_batch, data_cfg.seq_len
        feats = torch.randn((b, s, cfg.d_model), generator=gen, device=dev)
        labels = torch.argmax(feats[..., :cfg.vocab_size], dim=-1).to(
            torch.int32)
        return {"features": feats, "labels": labels}
    batch = stream.batch_at(step)
    if cfg.family == "vlm":
        batch["vision"] = torch.randn(
            (data_cfg.global_batch, cfg.vision_tokens, cfg.d_model),
            generator=gen, device=dev)
    return batch
