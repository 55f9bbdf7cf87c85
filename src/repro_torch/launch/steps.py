"""Step factories: the functions the trainers run and the serving
wrappers.

The counterpart of ``repro/launch/steps.py``.  The gradient is autograd
through ``Model.loss_fn(remat=True)`` (the reference's
``jax.value_and_grad``), and the update is :func:`adamw_update` in
place, so a train step returns the state it was given, updated.  The
reference's ``gather_specs`` (gather-once FSDP, a sharding constraint on
the parameters) is accepted and, on one card, where every parameter is
whole, is the identity (``sharding.constrain``).
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.core.csr import Device, resolve_device
from repro_torch.models.model import Model
from repro_torch.models.param import tree_leaves, tree_map
from repro_torch.optim import (AdamWConfig, OptState, abstract_opt_state,
                               adamw_update, init_opt_state)

from .sharding import constrain

Tree = Any


class TrainState(NamedTuple):
    params: Tree
    opt: OptState


def abstract_train_state(model: Model) -> TrainState:
    p = model.abstract_params()
    return TrainState(params=p, opt=abstract_opt_state(p))


def init_train_state(model: Model, generator: torch.Generator,
                     device: Device = "cuda") -> TrainState:
    p = model.init(generator, resolve_device(device))
    return TrainState(params=p, opt=init_opt_state(p))


def loss_and_grads(model: Model, params: Tree, batch: Dict, *,
                   remat: bool = True
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Tree]:
    """(loss, metrics, grads): ``model.loss_fn`` and its gradient with
    respect to every parameter, a tree like ``params`` of tensors in each
    parameter's type (zeros where a parameter does not reach the loss)."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    it = iter(leaves)
    with torch.enable_grad():
        loss, metrics = model.loss_fn(tree_map(lambda _: next(it), params),
                                      batch, remat=remat)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    it = iter(grads)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_map(lambda _: next(it), params))


def make_train_step(model: Model, opt_cfg: AdamWConfig,
                    microbatches: int = 1, gather_specs=None):
    """Train step with optional gradient accumulation.

    ``microbatches > 1`` runs the batch's slices one after another,
    adding their gradients up in float32 (the reference's scan), so live
    activations are one microbatch's; the gradient, the loss and each
    metric are the microbatches' means.  The step updates the state's
    tensors in place and returns it with the metrics (0-d tensors on the
    parameters' device; nothing is read back to the host).

    ``gather_specs`` (a spec tree like the parameters', typically the
    serve rules'): the reference gathers the FSDP-sharded parameters once
    a step before the microbatch loop.  On one card they are whole, and
    the constraint leaves them as they are."""

    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        loss_params = state.params
        if gather_specs is not None:
            loss_params = constrain(state.params, gather_specs)
        if microbatches == 1:
            loss, metrics, grads = loss_and_grads(model, loss_params, batch)
        else:
            def split(x):
                b = x.shape[0]
                if b % microbatches:
                    raise ValueError(f"batch {b} is not a multiple of "
                                     f"{microbatches} microbatches")
                return x.reshape(microbatches, b // microbatches,
                                 *x.shape[1:])

            mbs = {k: split(v) for k, v in batch.items()}
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), state.params)
            loss = 0.0
            per_mb = []
            for i in range(microbatches):
                li, mi, gi = loss_and_grads(
                    model, loss_params, {k: v[i] for k, v in mbs.items()})
                for acc, g in zip(tree_leaves(grads), tree_leaves(gi)):
                    acc.add_(g.to(torch.float32))
                del gi
                loss = loss + li
                per_mb.append(mi)
            for acc in tree_leaves(grads):
                acc.div_(microbatches)
            loss = loss / microbatches
            metrics = {k: torch.stack([m[k] for m in per_mb]).mean()
                       for k in per_mb[0]}

        new_params, new_opt, opt_metrics = adamw_update(
            state.params, grads, state.opt, opt_cfg)
        metrics = {**metrics, **opt_metrics, "loss": loss}
        return TrainState(new_params, new_opt), metrics

    return train_step


def make_prefill_step(model: Model, kv_cache_len: Optional[int] = None):
    def serve_prefill(params, batch):
        return model.prefill(params, batch, kv_cache_len=kv_cache_len)

    return serve_prefill


def make_decode_step(model: Model, donate_caches: bool = False):
    """The serving decode step.  ``donate_caches`` (the reference's
    ``donate_argnums`` on the caches): the step writes the new position
    into the caches passed in and returns them."""
    def serve_decode(params, token, caches, pos):
        logits, new_caches = model.decode_step(params, token, caches, pos,
                                               donate=donate_caches)
        next_token = torch.argmax(logits[:, -1], dim=-1)[:, None].to(
            torch.int32)
        return next_token, logits, new_caches

    return serve_decode
