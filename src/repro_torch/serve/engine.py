"""Batched serving engine: slot-based continuous batching over the model's
prefill and decode steps.

The counterpart of ``repro/serve/engine.py``.  Requests queue up; the
engine owns ``max_batch`` decode slots with a shared KV/SSM cache of
``max_len`` positions.  Each slot tracks its own position:
``decode_step`` takes a PER-SLOT position vector, so sequences of
different lengths decode together and a finished slot is refilled from
the queue without draining the batch.  Prefill runs one request at a
time into its slot.

The engine runs where its parameters live (on the card unless the caller
built them on the CPU).  Its per-slot positions and last tokens live
there too, next to a host copy for the stop rules, so a decode step
reads the card from the host once: the argmax tokens.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.engine.telemetry import resolve_telemetry
from repro_torch.models.model import Model, params_device
from repro_torch.models.param import tree_map


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray               # (len,) int32
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    output: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    error: Optional[str] = None      # set on structured rejection


class ServingEngine:
    def __init__(self, model: Model, params, *, max_batch: int = 4,
                 max_len: int = 256, telemetry=None):
        if model.cfg.is_encoder:
            raise ValueError(f"{model.cfg.name} is encoder-only: no decode "
                             "serving")
        self.model = model
        self.params = params
        self.max_batch = max_batch
        self.max_len = max_len
        self.device = params_device(params)
        # The SpGEMM engine's telemetry layer: serve spans and latency
        # histograms land in the registry a /metrics endpoint renders.  No
        # extra fences: prefill and decode already wait on the argmax
        # token reads the spans wrap.
        self.telemetry = resolve_telemetry(telemetry)
        reg = self.telemetry.registry
        self._ctr_requests = reg.counter("opsparse_serve_requests_total")
        self._ctr_rejected = reg.counter("opsparse_serve_rejected_total")
        self._ctr_tokens = reg.counter("opsparse_serve_tokens_total")
        self._hist_prefill = reg.histogram("opsparse_serve_prefill_seconds")
        self._hist_decode = reg.histogram(
            "opsparse_serve_decode_step_seconds")
        self.queue: deque[Request] = deque()
        self.slots: List[Optional[Request]] = [None] * max_batch
        self.pos = np.zeros(max_batch, np.int32)        # per-slot position
        self.caches = model.init_caches(max_batch, max_len,
                                        device=self.device)
        # The card's copies of the per-slot state, written by fill kernels
        # (no host-to-device copy) when a slot changes.
        self._pos = torch.zeros(max_batch, dtype=torch.int64,
                                device=self.device)
        self._token = torch.zeros((max_batch, 1), dtype=torch.int64,
                                  device=self.device)
        self._active = torch.zeros(max_batch, dtype=torch.int64,
                                   device=self.device)

    # -- public API ---------------------------------------------------------
    def submit(self, req: Request):
        self.queue.append(req)

    def run(self, max_steps: int = 1000) -> Dict[int, List[int]]:
        """Drive until queue + slots drain (or step budget).

        Rejected requests (e.g. a prompt that cannot fit ``max_len``)
        appear in the results with their (empty) output and a set
        ``req.error``: a malformed request is the CLIENT's failure, and it
        must not take the engine down for everyone else's.
        """
        results: Dict[int, List[int]] = {}
        with torch.inference_mode():
            for _ in range(max_steps):
                self._fill_slots(results)
                if not any(s is not None for s in self.slots):
                    break
                self._decode_once(results)
        return results

    # -- internals ----------------------------------------------------------
    def _fill_slots(self, results: Dict[int, List[int]]):
        for i in range(self.max_batch):
            # A rejected request frees its slot at once: keep pulling from
            # the queue until a request lands (or the queue drains), so
            # one bad request cannot idle the slot for a decode step.
            while self.slots[i] is None and self.queue:
                req = self.queue.popleft()
                if self._prefill_into_slot(i, req):
                    break
                results[req.uid] = req.output

    def _prefill_into_slot(self, i: int, req: Request) -> bool:
        """Prefill ``req`` into slot ``i``; False = structured rejection
        (the request is marked done-with-error, the engine keeps going)."""
        plen = len(req.prompt)
        if plen >= self.max_len:
            req.error = (f"prompt length {plen} >= max_len "
                         f"{self.max_len}; request rejected")
            req.done = True
            self._ctr_rejected.inc()
            self.telemetry.event("serve_reject", uid=req.uid,
                                 prompt_len=plen, max_len=self.max_len)
            return False
        self._ctr_requests.inc()
        with self.telemetry.span("serve.prefill", uid=req.uid,
                                 slot=i, prompt_len=plen) as span:
            tokens = torch.from_numpy(
                np.asarray(req.prompt, np.int64))[None].to(self.device)
            logits, caches = self.model.prefill(
                self.params, {"tokens": tokens}, kv_cache_len=self.max_len)
            tok = int(torch.argmax(logits[0, -1]))   # host sync ends the span
            self._write_slot_cache(i, caches)
        if self.telemetry.enabled:
            self._hist_prefill.observe(span.dur)
        self._ctr_tokens.inc()
        self.slots[i] = req
        self.pos[i] = plen
        self._pos[i] = plen
        self._token[i, 0] = tok
        self._active[i] = 1
        req.output.append(tok)
        return True

    def _write_slot_cache(self, i: int, caches):
        """Copy a 1-sequence prefill cache into batch slot i, in place:
        the batch axis is the first where the destination is ``max_batch``
        long and the source 1 (attention and SSM leaves differ)."""
        def copy(dst, src):
            for ax, (ds, ss) in enumerate(zip(dst.shape, src.shape)):
                if ds == self.max_batch and ss == 1:
                    idx = tuple(slice(i, i + 1) if a == ax else slice(0, n)
                                for a, n in enumerate(src.shape))
                    dst[idx] = src.to(dst.dtype)
                    return dst
            raise ValueError((dst.shape, src.shape))

        self.caches = tree_map(copy, self.caches, caches)

    def _decode_once(self, results: Dict[int, List[int]]):
        active = sum(s is not None for s in self.slots)
        with self.telemetry.span("serve.decode_step",
                                 active_slots=active) as span:
            logits, self.caches = self.model.decode_step(
                self.params, self._token, self.caches, self._pos)
            nxt = torch.argmax(logits[:, -1], dim=-1)
            # The step's one host read; the span boundary rides it.
            next_np = nxt.cpu().numpy()
        if self.telemetry.enabled:
            self._hist_decode.observe(span.dur)
        self._ctr_tokens.inc(active)
        self._token = nxt[:, None]
        self._pos = self._pos + self._active
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            t = int(next_np[i])
            req.output.append(t)
            self.pos[i] += 1
            hit_eos = req.eos_id is not None and t == req.eos_id
            if len(req.output) >= req.max_new_tokens or hit_eos or \
                    self.pos[i] >= self.max_len - 1:
                req.done = True
                results[req.uid] = req.output
                self.slots[i] = None
                self._active[i] = 0
        return results
