"""Unified model builder: one ``Model`` class drives all six families
(dense / encoder / ssm / hybrid / moe / vlm) from an ``ArchConfig``.

The counterpart of ``repro/models/model.py``.  Parameters and caches keep
the reference's stacked layout (a leading layer axis on every layer
parameter and cache leaf; the hybrid's Mamba groups and the vlm's self
layers grouped as the reference groups them), so trees carry across with
``repro_torch.convert`` one to one.  Where the reference scans a layer
body over that axis (``jax.lax.scan``), the port loops over it in Python;
an int8 tree (``quant.QTensor`` leaves) is dequantized one layer at a time
inside the loop.  Each stacked leaf is split once (``unbind``), so
autograd stacks a leaf's per-layer gradients in one step.  ``loss_fn``
rematerializes as the reference does (``jax.checkpoint``): every layer
body runs under ``torch.utils.checkpoint.checkpoint`` (non-reentrant),
and the hybrid's and vlm's groups are checkpointed around their layers'
(the reference's nested sqrt-L remat); values do not change with it.

Three entry points per model:
  * ``loss_fn(params, batch, remat=True)``: forward + mean token xent.
  * ``prefill(params, batch)``        : full-sequence forward, returns the
                                        last position's logits + caches.
  * ``decode_step(params, token, caches, pos)``: one token with caches.

They run where the parameters live: on the card by default
(:meth:`Model.init`), on the CPU only when asked.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.core.csr import Device, resolve_device

from . import layers as L
from . import moe as M
from . import ssm as S
from .hints import BATCH, hint
from .param import (ParamSpec, abstract_params, init_params, spec, tree_map,
                    tree_leaves)
from .quant import dequant_tree

Tree = Any


def _dt(cfg: ArchConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def stack_specs(tree: Tree, n: int) -> Tree:
    """Add a leading 'layers' axis to every spec in the tree."""
    return tree_map(
        lambda ps: ParamSpec((n,) + ps.shape, ps.dtype,
                             ("layers",) + ps.axes, ps.init, ps.scale),
        tree, is_leaf=lambda x: isinstance(x, ParamSpec))


def _block_specs(cfg: ArchConfig) -> Tree:
    """One decoder block: attn + (mlp | moe)."""
    s: Dict[str, Tree] = {
        "attn_norm": spec((cfg.d_model,), (None,), init="ones",
                          dtype=torch.float32),
        "attn": L.attention_specs(cfg),
        "mlp_norm": spec((cfg.d_model,), (None,), init="ones",
                         dtype=torch.float32),
    }
    if cfg.family == "moe":
        s["moe"] = M.moe_specs(cfg)
    else:
        s["mlp"] = L.mlp_specs(cfg)
    return s


def _ssm_block_specs(cfg: ArchConfig) -> Tree:
    mk = S.mamba2_specs if cfg.mamba_version == 2 else S.mamba1_specs
    return {
        "norm": spec((cfg.d_model,), (None,), init="ones",
                     dtype=torch.float32),
        "mamba": mk(cfg),
    }


def _cross_block_specs(cfg: ArchConfig) -> Tree:
    return {
        "attn_norm": spec((cfg.d_model,), (None,), init="ones",
                          dtype=torch.float32),
        "attn": L.attention_specs(cfg, cross=True),
        "mlp_norm": spec((cfg.d_model,), (None,), init="ones",
                         dtype=torch.float32),
        "mlp": L.mlp_specs(cfg),
        "gate_attn": spec((1,), (None,), init="zeros", dtype=torch.float32),
        "gate_mlp": spec((1,), (None,), init="zeros", dtype=torch.float32),
    }


def params_device(params: Tree) -> torch.device:
    """The device the parameters live on (their first tensor's)."""
    return tree_leaves(params)[0].device


def _layer(tree: Tree, i: int) -> Tree:
    """Slice ``i`` of the leading layer axis of every leaf (a QTensor's
    payload and scales alike)."""
    return tree_map(lambda a: a[i], tree)


def _unstack(tree: Tree, n: int) -> List[Tree]:
    """The ``n`` layers of a stacked tree, each leaf split once with
    ``unbind``: its backward stacks the layers' gradients in one step,
    where ``a[i]`` would add a zero-padded copy of the whole leaf a
    layer."""
    parts: Dict[int, tuple] = {}

    def part(a, i):
        if id(a) not in parts:
            parts[id(a)] = a.unbind(0)
        return parts[id(a)][i]
    return [tree_map(lambda a: part(a, i), tree) for i in range(n)]


def _call(fn, remat: bool, *args):
    """fn(*args), under a non-reentrant checkpoint when ``remat`` and
    autograd records (the reference's ``jax.checkpoint``)."""
    if remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _stack(ys: List[Tree]) -> Optional[Tree]:
    """The per-layer trees stacked on a new leading axis (None for none)."""
    if not ys or ys[0] is None:
        return None
    return tree_map(lambda *xs: torch.stack(xs), *ys)


class Model:
    def __init__(self, cfg: ArchConfig):
        self.cfg = cfg

    # ------------------------------------------------------------------
    # Parameter specs
    # ------------------------------------------------------------------
    def param_specs(self) -> Tree:
        cfg = self.cfg
        specs: Dict[str, Tree] = {
            "final_norm": spec((cfg.d_model,), (None,), init="ones",
                               dtype=torch.float32),
        }
        if cfg.family == "encoder":
            specs["head"] = spec((cfg.d_model, cfg.vocab_size),
                                 ("embed", "vocab"), dtype=_dt(cfg))
            specs["layers"] = stack_specs(_block_specs(cfg), cfg.num_layers)
            return specs

        specs["embed"] = L.embed_specs(cfg)
        if cfg.family in ("dense", "moe"):
            specs["layers"] = stack_specs(_block_specs(cfg), cfg.num_layers)
        elif cfg.family == "ssm":
            specs["layers"] = stack_specs(_ssm_block_specs(cfg),
                                          cfg.num_layers)
        elif cfg.family == "hybrid":
            specs["layers"] = stack_specs(_ssm_block_specs(cfg),
                                          cfg.num_layers)
            specs["shared"] = _block_specs(cfg)          # ONE shared block
        elif cfg.family == "vlm":
            n_cross = cfg.num_layers // cfg.cross_attn_every
            n_self = cfg.num_layers - n_cross
            specs["layers"] = stack_specs(_block_specs(cfg), n_self)
            specs["cross_layers"] = stack_specs(_cross_block_specs(cfg),
                                                n_cross)
        else:
            raise ValueError(cfg.family)
        return specs

    def init(self, generator: torch.Generator, device: Device = "cuda"
             ) -> Tree:
        """Random parameters from ``generator`` (drawn on its device), on
        ``device``."""
        return init_params(self.param_specs(), generator,
                           resolve_device(device))

    def abstract_params(self) -> Tree:
        return abstract_params(self.param_specs())

    # ------------------------------------------------------------------
    # Blocks
    # ------------------------------------------------------------------
    def _block(self, p, x, *, positions, causal, cache=None, cache_pos=None,
               kv_cache_len=None, return_kv=False, in_place=False):
        """Standard transformer block (dense/moe/encoder + hybrid shared).
        ``in_place``: a decode step writes its k/v into ``cache`` itself."""
        cfg = self.cfg
        p = dequant_tree(p)      # int8 serving: materialize ONE layer
        x = hint(x, BATCH, None, None)
        h, new_cache = L.attention(
            p["attn"], L.rmsnorm(x, p["attn_norm"], cfg.norm_eps), cfg,
            positions=positions, causal=causal, cache=cache,
            cache_pos=cache_pos, kv_cache_len=kv_cache_len,
            return_kv=return_kv, cache_in_place=in_place)
        x = x + h
        hi = L.rmsnorm(x, p["mlp_norm"], cfg.norm_eps)
        if "moe" in p:
            out, aux = M.moe(p["moe"], hi, cfg)
        else:
            out = L.mlp(p["mlp"], hi, cfg)
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return x + out, new_cache, aux

    def _ssm_block(self, p, x, cache=None, in_place=False):
        """A Mamba block; ``in_place``: a decode step writes its new state
        into ``cache`` itself."""
        cfg = self.cfg
        p = dequant_tree(p)      # int8 serving: materialize ONE layer
        x = hint(x, BATCH, None, None)
        fn = S.mamba2 if cfg.mamba_version == 2 else S.mamba1
        h, new_cache = fn(p["mamba"], L.rmsnorm(x, p["norm"], cfg.norm_eps),
                          cfg, cache=cache)
        if in_place:
            cache.conv.copy_(new_cache.conv)
            cache.h.copy_(new_cache.h)
            new_cache = cache
        return x + h, new_cache

    def _ssm_step(self, x, p, cache, in_place=False):
        return self._ssm_block(p, x, cache, in_place)

    def _cross_block(self, p, x, vision_kv, *, positions):
        """VLM cross-attention block (gated, llama-3.2 style).

        ``vision_kv`` is either raw vision embeddings (B, Vt, d) at
        train/prefill or a static AttnCache at decode."""
        cfg = self.cfg
        p = dequant_tree(p)      # int8 serving: materialize ONE layer
        hn = L.rmsnorm(x, p["attn_norm"], cfg.norm_eps)
        if isinstance(vision_kv, L.AttnCache):
            h, kv = L.attention(p["attn"], hn, cfg, positions=positions,
                                causal=False, cache=vision_kv,
                                cache_pos=None)
        else:
            h, kv = L.attention(p["attn"], hn, cfg, positions=positions,
                                causal=False, kv_x=vision_kv, return_kv=True)
        x = x + torch.tanh(p["gate_attn"]).to(x.dtype) * h
        out = L.mlp(p["mlp"], L.rmsnorm(x, p["mlp_norm"], cfg.norm_eps), cfg)
        x = x + torch.tanh(p["gate_mlp"]).to(x.dtype) * out
        return x, kv

    # ------------------------------------------------------------------
    # Forward (shared by train / prefill / decode)
    # ------------------------------------------------------------------
    def _forward(self, params, x, *, positions, caches=None, cache_pos=None,
                 kv_cache_len=None, return_caches=False, remat=False,
                 vision=None, donate=False):
        """x: (B, S, d) embedded inputs -> (hidden, new_caches, aux).
        ``donate``: a decode step updates ``caches`` in place and returns
        them as the new caches (no stacked copy)."""
        cfg = self.cfg
        causal = not cfg.is_encoder
        ssm_step = functools.partial(self._ssm_step, in_place=donate)

        if cfg.family in ("dense", "moe", "encoder"):
            def step(x, lp, cache):
                x, nc, aux = self._block(
                    lp, x, positions=positions, causal=causal, cache=cache,
                    cache_pos=cache_pos, kv_cache_len=kv_cache_len,
                    return_kv=return_caches, in_place=donate)
                return x, (nc, aux)

            x, ys = _scan_blocks(step, x,
                                 _unstack(params["layers"], cfg.num_layers),
                                 caches, remat)
            new_caches = caches if donate else _stack([nc for nc, _ in ys])
            return x, new_caches, torch.stack([aux for _, aux in ys]).sum()

        if cfg.family == "ssm":
            x, ys = _scan_blocks(ssm_step, x,
                                 _unstack(params["layers"], cfg.num_layers),
                                 caches, remat)
            return x, caches if donate else _stack(ys), _zero(x)

        if cfg.family == "hybrid":
            return self._forward_hybrid(
                params, x, positions=positions, caches=caches,
                cache_pos=cache_pos, kv_cache_len=kv_cache_len,
                return_caches=return_caches, remat=remat, ssm_step=ssm_step,
                donate=donate)

        if cfg.family == "vlm":
            return self._forward_vlm(
                params, x, positions=positions, caches=caches,
                cache_pos=cache_pos, kv_cache_len=kv_cache_len,
                return_caches=return_caches, remat=remat, vision=vision,
                donate=donate)

        raise ValueError(cfg.family)

    def _forward_hybrid(self, params, x, *, positions, caches, cache_pos,
                        kv_cache_len, return_caches, remat, ssm_step,
                        donate):
        """Zamba2-style: groups of `attn_every` mamba2 layers, each followed
        by ONE SHARED attention+MLP block; trailing mamba layers last."""
        cfg = self.cfg
        g = cfg.attn_every
        n_groups = cfg.num_layers // g
        n_main = n_groups * g
        layers = _unstack(params["layers"], cfg.num_layers)
        shared = params["shared"]
        if caches is None:
            ssm_main = ssm_tail = attn_caches = None
        else:
            ssm_main, ssm_tail, attn_caches = caches

        def group_step(x, gp, gssm, gattn):
            x, ys = _scan_blocks(ssm_step, x, gp, gssm, remat)
            x, nc, _ = self._block(
                shared, x, positions=positions, causal=True, cache=gattn,
                cache_pos=cache_pos, kv_cache_len=kv_cache_len,
                return_kv=return_caches, in_place=donate)
            return x, None if donate else _stack(ys), nc

        # Nested (sqrt-L) remat: group boundaries AND layer bodies are both
        # checkpointed, as the reference's.
        new_ssm_main, new_attn = [], []
        for j in range(n_groups):
            x, ns, nc = _call(
                group_step, remat, x, layers[j * g:(j + 1) * g],
                None if ssm_main is None else _layer(ssm_main, j),
                None if attn_caches is None else _layer(attn_caches, j))
            new_ssm_main.append(ns)
            new_attn.append(nc)
        x, ys = _scan_blocks(ssm_step, x, layers[n_main:], ssm_tail, remat)
        if donate:
            return x, caches, _zero(x)
        new_tail = _stack(ys)
        if new_tail is None:        # no trailing layers: a 0-long stack
            new_tail = tree_map(
                lambda a: a.new_zeros((0,) + tuple(a.shape)),
                S.init_ssm_cache(cfg, x.shape[0], _dt(cfg), x.device))
        return (x, (_stack(new_ssm_main), new_tail, _stack(new_attn)),
                _zero(x))

    def _forward_vlm(self, params, x, *, positions, caches, cache_pos,
                     kv_cache_len, return_caches, remat, vision, donate):
        """Llama-3.2-vision style: every `cross_attn_every`-th block is a
        gated cross-attention block over vision embeddings."""
        cfg = self.cfg
        e = cfg.cross_attn_every
        n_cross = cfg.num_layers // e
        g = e - 1                                    # self layers per group
        if caches is None:
            self_caches = cross_caches = None
        else:
            self_caches, cross_caches = caches
        layers = _unstack(params["layers"], n_cross * g)
        cross_layers = _unstack(params["cross_layers"], n_cross)

        def inner_step(x, lp, cache):
            x, nc, _ = self._block(
                lp, x, positions=positions, causal=True, cache=cache,
                cache_pos=cache_pos, kv_cache_len=kv_cache_len,
                return_kv=return_caches, in_place=donate)
            return x, nc

        def group_step(x, gp, cp, gself, vsrc):
            x, ys = _scan_blocks(inner_step, x, gp, gself, remat)
            x, kv = self._cross_block(cp, x, vsrc, positions=positions)
            return x, None if donate else _stack(ys), kv

        # Nested (sqrt-L) remat -- see _forward_hybrid.
        new_self, new_cross = [], []
        for j in range(n_cross):
            x, ns, kv = _call(
                group_step, remat, x, layers[j * g:(j + 1) * g],
                cross_layers[j],
                None if self_caches is None else _layer(self_caches, j),
                _layer(cross_caches, j) if cross_caches is not None
                else vision)
            new_self.append(ns)
            new_cross.append(kv)
        if donate:
            return x, caches, _zero(x)
        return x, (_stack(new_self), _stack(new_cross)), _zero(x)

    # ------------------------------------------------------------------
    # Train loss (forward; autograd gives the gradient)
    # ------------------------------------------------------------------
    def loss_fn(self, params, batch, *, remat: bool = True):
        cfg = self.cfg
        if cfg.family == "encoder":
            x = batch["features"].to(_dt(cfg))
            labels = batch["labels"]
            positions = torch.arange(labels.shape[1], device=x.device)[None]
            hidden, _, aux = self._forward(params, x, positions=positions,
                                           remat=remat)
            hidden = L.rmsnorm(hidden, params["final_norm"], cfg.norm_eps)
            loss = L.chunked_softmax_xent({"head": params["head"]}, hidden,
                                          labels)
            return loss, {"xent": loss}

        tokens = batch["tokens"]
        inputs, labels = tokens[:, :-1], tokens[:, 1:]
        positions = torch.arange(inputs.shape[1], device=tokens.device)[None]
        x = L.embed(params["embed"], inputs).to(_dt(cfg))
        vision = batch.get("vision")
        if vision is not None:
            vision = vision.to(_dt(cfg))
        hidden, _, aux = self._forward(params, x, positions=positions,
                                       remat=remat, vision=vision)
        hidden = L.rmsnorm(hidden, params["final_norm"], cfg.norm_eps)
        xent = L.chunked_softmax_xent(params["embed"], hidden, labels)
        loss = xent + 0.01 * aux
        return loss, {"xent": xent, "aux": aux}

    # ------------------------------------------------------------------
    # Serving
    # ------------------------------------------------------------------
    def prefill(self, params, batch, *, kv_cache_len: Optional[int] = None):
        """Full-sequence forward; returns (last_logits, caches).  The
        encoder family returns every position's logits and no cache."""
        cfg = self.cfg
        if cfg.family == "encoder":
            x = batch["features"].to(_dt(cfg))
            positions = torch.arange(x.shape[1], device=x.device)[None]
            hidden, _, _ = self._forward(params, x, positions=positions)
            hidden = L.rmsnorm(hidden, params["final_norm"], cfg.norm_eps)
            return hidden @ params["head"], None

        tokens = batch["tokens"]
        s = tokens.shape[1]
        positions = torch.arange(s, device=tokens.device)[None]
        embed_p = dequant_tree(params["embed"])
        x = L.embed(embed_p, tokens).to(_dt(cfg))
        vision = batch.get("vision")
        if vision is not None:
            vision = vision.to(_dt(cfg))
        hidden, caches, _ = self._forward(
            params, x, positions=positions, return_caches=True,
            kv_cache_len=kv_cache_len or s, vision=vision)
        hidden = L.rmsnorm(hidden[:, -1:], params["final_norm"], cfg.norm_eps)
        return L.logits(embed_p, hidden), caches

    def decode_step(self, params, token, caches, pos, *,  # opslint: steady static=donate
                    donate: bool = False):  # opslint: donates=caches if donate
        """token: (B, 1) ints; pos: an int, a () or a (B,) tensor (per-slot
        positions, continuous batching); returns (logits, new caches).  The
        caches passed in are left unchanged, or with ``donate`` updated in
        place and returned (the reference's donated caches: one copy of
        the caches is alive, not two).  Nothing here reads the card from
        the host: with ``token`` and a tensor ``pos`` on the card, a step
        only enqueues work."""
        cfg = self.cfg
        if cfg.family == "encoder":
            raise ValueError("encoder archs have no decode step")
        b = token.shape[0]
        pos_vec = L._pos_vec(pos, b, token.device)
        embed_p = dequant_tree(params["embed"])
        x = L.embed(embed_p, token).to(_dt(cfg))
        hidden, new_caches, _ = self._forward(
            params, x, positions=pos_vec[:, None], caches=caches,
            cache_pos=pos_vec, donate=donate)
        hidden = L.rmsnorm(hidden, params["final_norm"], cfg.norm_eps)
        return L.logits(embed_p, hidden), new_caches

    # ------------------------------------------------------------------
    # Cache construction
    # ------------------------------------------------------------------
    def init_caches(self, batch: int, max_len: int, *,
                    device: Device = "cuda", abstract: bool = False):
        """Zero caches for ``batch`` slots of ``max_len`` positions, in the
        reference's stacked layout; ``abstract=True`` gives them as
        ``meta`` tensors (shapes and types only)."""
        cfg = self.cfg
        dt = _dt(cfg)
        dev = torch.device("meta") if abstract else resolve_device(device)

        def attn_cache():
            return L.init_attn_cache(cfg, batch, max_len, dt, dev)

        def ssm_cache():
            return S.init_ssm_cache(cfg, batch, dt, dev)

        def stack(tree, n):
            return tree_map(
                lambda x: x.new_zeros((n,) + tuple(x.shape)), tree)

        if cfg.family in ("dense", "moe", "encoder"):
            return stack(attn_cache(), cfg.num_layers)
        if cfg.family == "ssm":
            return stack(ssm_cache(), cfg.num_layers)
        if cfg.family == "hybrid":
            g = cfg.attn_every
            n_groups = cfg.num_layers // g
            n_tail = cfg.num_layers - n_groups * g
            return (stack(stack(ssm_cache(), g), n_groups),
                    stack(ssm_cache(), n_tail),
                    stack(attn_cache(), n_groups))
        if cfg.family == "vlm":
            e = cfg.cross_attn_every
            n_cross = cfg.num_layers // e
            cross = L.init_attn_cache(cfg, batch, cfg.vision_tokens, dt, dev)
            return (stack(stack(attn_cache(), e - 1), n_cross),
                    stack(cross, n_cross))
        raise ValueError(cfg.family)


def _zero(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=x.device)


def _scan_blocks(step, x, layers: List[Tree], caches, remat: bool = False):
    """The reference's ``lax.scan`` over stacked layer params (and caches,
    when given) as a loop: ``step(x, layer_params, cache_or_None) -> (x,
    y)`` for each tree of ``layers`` (:func:`_unstack`), each call under a
    checkpoint when ``remat``; returns x and the list of ys."""
    ys = []
    for i, lp in enumerate(layers):
        x, y = _call(step, remat, x, lp,
                     None if caches is None else _layer(caches, i))
        ys.append(y)
    return x, ys
