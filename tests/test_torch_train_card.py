"""The training path on the card against the port's CPU path (card only:
every test skips without one).

This file imports no JAX: the CPU path it compares with is the port's
own, which ``tests/test_torch_train_step.py`` and its neighbours hold to
the reference.  Tolerances, float32 with TF32 off: the loss within 1e-4
relative; a gradient leaf within 1e-3 of its largest CPU magnitude
(cuBLAS and the gathers' atomic backward sum in other orders); after one
AdamW step the parameters within 2·lr (a near-zero gradient's sign can
flip).  A checkpoint moves bits: the round trips compare exactly.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, get_arch
from repro_torch.launch.steps import (init_train_state, loss_and_grads,
                                      make_train_step)
from repro_torch.models.model import Model
from repro_torch.models.param import tree_leaves, tree_map
from repro_torch.optim import AdamWConfig
from repro_torch.train import checkpoint as ckpt

LR = 1e-3


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _batch(cfg, seed, b=2, s=16):
    g = torch.Generator().manual_seed(seed)
    if cfg.family == "encoder":
        return {"features": torch.randn((b, s, cfg.d_model), generator=g),
                "labels": torch.randint(0, cfg.vocab_size, (b, s),
                                        generator=g)}
    out = {"tokens": torch.randint(0, cfg.vocab_size, (b, s + 1),
                                   generator=g)}
    if cfg.family == "vlm":
        out["vision"] = torch.randn((b, cfg.vision_tokens, cfg.d_model),
                                    generator=g)
    return out


def _to(tree, device):
    return tree_map(lambda t: t.to(device), tree)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_reduced_train_step_on_the_card_equals_the_cpu(cuda_device, arch):
    cfg = get_arch(arch).reduced().replace(dtype="float32")
    model = Model(cfg)
    state = init_train_state(model, torch.Generator().manual_seed(0), "cpu")
    batch = _batch(cfg, 1)
    dbatch = _to(batch, cuda_device)
    loss, _, grads = loss_and_grads(model, state.params, batch)
    dloss, _, dgrads = loss_and_grads(model, _to(state.params, cuda_device),
                                      dbatch)
    np.testing.assert_allclose(float(dloss), float(loss), rtol=1e-4)
    for g, dg in zip(tree_leaves(grads), tree_leaves(dgrads)):
        assert dg.device.type == "cuda"
        tol = 1e-3 * float(g.abs().max()) + 1e-7
        assert float((dg.cpu() - g).abs().max()) <= tol

    step = make_train_step(model, AdamWConfig(lr=LR, warmup_steps=1))
    dstate = _to(state, cuda_device)
    state, met = step(state, batch)
    dstate, dmet = step(dstate, dbatch)
    np.testing.assert_allclose(float(dmet["loss"]), float(met["loss"]),
                               rtol=1e-4)
    for p, dp in zip(tree_leaves(state.params), tree_leaves(dstate.params)):
        torch.testing.assert_close(dp.cpu(), p, rtol=0, atol=2 * LR)


@pytest.mark.gpu
def test_bfloat16_checkpoint_round_trip_on_the_card(cuda_device, tmp_path):
    """A reduced olmoe train state in bfloat16 on the card: saved, then
    restored onto the card bit for bit, and restored onto the CPU and
    from there back (the elastic restore both ways)."""
    cfg = get_arch("olmoe-1b-7b").reduced()
    model = Model(cfg)
    state = init_train_state(model, torch.Generator(
        device=cuda_device).manual_seed(0), cuda_device)
    step = make_train_step(model, AdamWConfig(lr=LR))
    state, _ = step(state, _to(_batch(cfg, 2), cuda_device))
    ckpt.save(tmp_path / "card", 1, state)
    back, _ = ckpt.restore(tmp_path / "card", state)
    host, _ = ckpt.restore(tmp_path / "card", state, device="cpu")
    ckpt.save(tmp_path / "host", 1, host)
    again, _ = ckpt.restore(tmp_path / "host", state, device=cuda_device)
    for want, got, h, a in zip(tree_leaves(state), tree_leaves(back),
                               tree_leaves(host), tree_leaves(again)):
        assert got.device.type == a.device.type == "cuda"
        assert h.device.type == "cpu"
        assert got.dtype == h.dtype == a.dtype == want.dtype
        assert torch.equal(got, want) and torch.equal(a, want)
        assert torch.equal(h, want.cpu())
    assert any(t.dtype == torch.bfloat16 for t in tree_leaves(back))
