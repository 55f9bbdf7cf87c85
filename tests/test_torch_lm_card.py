"""The LM serving path on the card against the port's CPU path (card
only: every test skips without one).

This file imports no JAX: the CPU path it compares with is the port's
own, which ``tests/test_torch_models_smoke.py`` and its neighbours hold
to the reference.  Tolerance: float32 rtol 1e-3 / atol 1e-4 with TF32
off (cuBLAS sums the same products in another order than the CPU).
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, get_arch
from repro_torch.models import moe as M
from repro_torch.models.model import Model
from repro_torch.models.param import tree_leaves, tree_map
from repro_torch.serve import Request, ServingEngine

TOL = dict(rtol=1e-3, atol=1e-4)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _to(tree, device):
    return tree_map(lambda t: t.to(device), tree)


def _batch(cfg, seed, b=2, s=12):
    g = torch.Generator().manual_seed(seed)
    out = {"tokens": torch.randint(0, cfg.vocab_size, (b, s + 1),
                                   generator=g)}
    if cfg.family == "vlm":
        out["vision"] = torch.randn((b, cfg.vision_tokens, cfg.d_model),
                                    generator=g)
    if cfg.family == "encoder":
        out = {"features": torch.randn((b, s, cfg.d_model), generator=g)}
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_reduced_prefill_and_decode_on_the_card_equal_the_cpu(cuda_device,
                                                              arch):
    cfg = get_arch(arch).reduced().replace(dtype="float32")
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    batch = _batch(cfg, 1)
    dev = {k: v.to(cuda_device) for k, v in batch.items()}
    if cfg.is_encoder:
        want, _ = model.prefill(params, batch)
        got, _ = model.prefill(_to(params, cuda_device), dev)
        torch.testing.assert_close(got.cpu(), want, **TOL)
        return
    s = batch["tokens"].shape[1] - 1
    pre = {k: (v[:, :s] if k == "tokens" else v) for k, v in batch.items()}
    pre_dev = {k: (v[:, :s] if k == "tokens" else v) for k, v in dev.items()}
    want, caches = model.prefill(params, pre, kv_cache_len=s + 4)
    got, dcaches = model.prefill(_to(params, cuda_device), pre_dev,
                                 kv_cache_len=s + 4)
    torch.testing.assert_close(got.cpu(), want, **TOL)
    tok = batch["tokens"][:, s:s + 1]
    want, _ = model.decode_step(params, tok, caches, s)
    got, _ = model.decode_step(_to(params, cuda_device), tok.to(cuda_device),
                               dcaches, torch.full((2,), s,
                                                   device=cuda_device))
    torch.testing.assert_close(got.cpu(), want, **TOL)


@pytest.mark.gpu
def test_engine_tokens_on_the_card_equal_the_cpu(cuda_device):
    cfg = get_arch("qwen3-1.7b").reduced().replace(dtype="float32")
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, int(rng.integers(3, 20)))
               .astype(np.int32) for _ in range(6)]
    out = []
    for p in (params, _to(params, cuda_device)):
        eng = ServingEngine(model, p, max_batch=4, max_len=48)
        for uid, pr in enumerate(prompts):
            eng.submit(Request(uid=uid, prompt=pr, max_new_tokens=8))
        out.append(eng.run())
        assert eng.device.type == p["final_norm"].device.type
    assert out[0] == out[1]


@pytest.mark.gpu
def test_decode_step_reads_nothing_from_the_card(cuda_device):
    """With the token and a tensor position on the card, a decode step
    only enqueues work (MoE dispatch included)."""
    cfg = get_arch("olmoe-1b-7b").reduced().replace(dtype="bfloat16")
    model = Model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    caches = model.init_caches(4, 32)
    tok = torch.zeros((4, 1), dtype=torch.int64, device=cuda_device)
    pos = torch.arange(4, device=cuda_device)
    model.decode_step(params, tok, caches, pos)      # warm up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        logits, new = model.decode_step(params, tok, caches, pos)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.isfinite(logits.float()).all()
    assert len(tree_leaves(new)) == len(tree_leaves(caches))


@pytest.mark.gpu
def test_moe_combine_is_bitwise_repeatable_on_the_card(cuda_device):
    """The fixed-order combine: one bfloat16 input twice, the same bits."""
    cfg = get_arch("olmoe-1b-7b").replace(dtype="bfloat16", num_layers=1)
    p = M.MoE(cfg, generator=torch.Generator(device="cuda").manual_seed(0))
    x = torch.randn((2, 256, cfg.d_model), device=cuda_device,
                    generator=torch.Generator(device="cuda").manual_seed(1)
                    ).to(torch.bfloat16)
    with torch.inference_mode():
        a, _ = p(x)
        b, _ = p(x)
    assert torch.equal(a, b)
