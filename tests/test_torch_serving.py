"""The reference's serving-engine tests on the port (continuous batching
with per-slot positions), and the engine's tokens against the reference
engine's on the same weights.

Weights come from the reference's own ``Model.init`` (``PRNGKey``),
carried across with ``convert.params_from_reference``, in float32; the
prompts are numpy arrays given to both engines.  Greedy tokens are
compared exactly.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.models.model import Model as JModel
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServingEngine as JServingEngine
from repro_torch.configs import get_arch
from repro_torch.convert import params_from_reference
from repro_torch.models.model import Model
from repro_torch.serve import Request, ServingEngine

TINY = dict(num_layers=2, d_model=32, d_ff=64, vocab_size=50, num_heads=2,
            num_kv_heads=2, dtype="float32")


@pytest.fixture(scope="module")
def tiny_lm():
    jcfg = jget_arch("internlm2-1.8b").reduced().replace(**TINY)
    cfg = get_arch("internlm2-1.8b").reduced().replace(**TINY)
    jmodel = JModel(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    params = params_from_reference(jax.device_get(jparams), device="cpu")
    return Model(cfg), params, jmodel, jparams


def test_engine_serves_batched_requests(tiny_lm):
    model, params = tiny_lm[:2]
    eng = ServingEngine(model, params, max_batch=3, max_len=48)
    rng = np.random.default_rng(0)
    for uid in range(7):   # more requests than slots -> continuous refill
        plen = int(rng.integers(3, 9))
        eng.submit(Request(uid=uid,
                           prompt=rng.integers(0, 50, plen).astype(np.int32),
                           max_new_tokens=5))
    results = eng.run()
    assert sorted(results) == list(range(7))
    assert all(len(v) == 5 for v in results.values())


def test_engine_matches_sequential_decode(tiny_lm):
    """Tokens from the batched engine == single-request greedy decode."""
    model, params = tiny_lm[:2]
    prompt = np.array([3, 14, 15, 9, 2], np.int32)

    eng = ServingEngine(model, params, max_batch=2, max_len=32)
    eng.submit(Request(uid=0, prompt=prompt, max_new_tokens=6))
    # a second concurrent request with a DIFFERENT length exercises the
    # per-slot position path
    eng.submit(Request(uid=1, prompt=prompt[:3], max_new_tokens=6))
    got = eng.run()[0]

    # reference: a plain prefill + decode loop, batch of 1
    logits, caches = model.prefill(
        params, {"tokens": torch.from_numpy(prompt)[None]}, kv_cache_len=32)
    toks = [int(torch.argmax(logits[0, -1]))]
    pos = len(prompt)
    for _ in range(5):
        lg, caches = model.decode_step(
            params, torch.tensor([[toks[-1]]]), caches, pos)
        toks.append(int(torch.argmax(lg[0, -1])))
        pos += 1
    assert got == toks


def test_engine_eos_stops_early(tiny_lm):
    model, params = tiny_lm[:2]
    eng = ServingEngine(model, params, max_batch=1, max_len=32)
    # run once to find the greedy token, then use it as eos
    eng.submit(Request(uid=0, prompt=np.array([1, 2, 3], np.int32),
                       max_new_tokens=4))
    first = eng.run()[0]
    eng2 = ServingEngine(model, params, max_batch=1, max_len=32)
    eng2.submit(Request(uid=1, prompt=np.array([1, 2, 3], np.int32),
                        max_new_tokens=8, eos_id=first[1]))
    out = eng2.run()[1]
    assert out[1] == first[1] and len(out) == 2


def test_engine_rejects_oversized_prompt_structurally(tiny_lm):
    """A prompt that can't fit max_len is rejected with ``req.error``
    set; the engine keeps serving the well-formed requests around it."""
    model, params = tiny_lm[:2]
    eng = ServingEngine(model, params, max_batch=2, max_len=16,
                        telemetry=True)
    rng = np.random.default_rng(1)
    good = [Request(uid=0, prompt=rng.integers(0, 50, 4).astype(np.int32),
                    max_new_tokens=3),
            Request(uid=2, prompt=rng.integers(0, 50, 5).astype(np.int32),
                    max_new_tokens=3)]
    bad = Request(uid=1, prompt=rng.integers(0, 50, 40).astype(np.int32))
    eng.submit(good[0])
    eng.submit(bad)            # between two well-formed requests
    eng.submit(good[1])
    results = eng.run()
    assert sorted(results) == [0, 1, 2]
    assert results[1] == [] and bad.done
    assert bad.error is not None and "max_len" in bad.error
    assert all(len(results[r.uid]) == 3 and r.error is None for r in good)
    reg = eng.telemetry.registry
    assert reg.counter("opsparse_serve_rejected_total").value == 1
    assert reg.counter("opsparse_serve_requests_total").value == 2
    names = [e["name"] for e in eng.telemetry.events.snapshot()]
    assert "serve.prefill" in names and "serve.decode_step" in names


def _requests(cls, n, vocab, seed, max_new, max_len):
    rng = np.random.default_rng(seed)
    out = []
    for uid in range(n):
        plen = int(rng.integers(2, 12))
        out.append(cls(uid=uid, prompt=rng.integers(0, vocab, plen).astype(
            np.int32), max_new_tokens=max_new))
    # one prompt that cannot fit, in the middle of the queue
    out.insert(n // 2, cls(uid=n, prompt=np.zeros(max_len + 3, np.int32)))
    return out


@pytest.mark.parametrize("max_batch,max_len,max_new", [(3, 40, 6),
                                                       (2, 16, 12)])
def test_engine_tokens_equal_the_reference_engine(tiny_lm, max_batch,
                                                  max_len, max_new):
    """The same request stream through both engines on the same weights:
    the same tokens for every request, the same rejection, and the stop
    at max_len - 1 (the second case's long outputs hit it)."""
    model, params, jmodel, jparams = tiny_lm
    jeng = JServingEngine(jmodel, jparams, max_batch=max_batch,
                          max_len=max_len)
    eng = ServingEngine(model, params, max_batch=max_batch, max_len=max_len)
    jreqs = _requests(JRequest, 7, 50, 2, max_new, max_len)
    reqs = _requests(Request, 7, 50, 2, max_new, max_len)
    for jr, r in zip(jreqs, reqs):
        jeng.submit(jr)
        eng.submit(r)
    want, got = jeng.run(), eng.run()
    assert got == {uid: [int(t) for t in v] for uid, v in want.items()}
    assert [r.error is None for r in reqs] == \
        [r.error is None for r in jreqs]
    assert any(len(v) < max_new for uid, v in got.items() if uid != 7) \
        == (max_len == 16)


def test_engine_runs_where_its_parameters_live(tiny_lm):
    """CPU parameters: caches and per-slot state on the CPU.  A model
    built without a device argument is on the card, and without one
    building it raises instead of falling back."""
    model, params = tiny_lm[:2]
    eng = ServingEngine(model, params, max_batch=2, max_len=16)
    assert eng.device.type == "cpu"
    assert all(t.device.type == "cpu" for t in
               [eng.caches.k, eng.caches.v, eng._pos, eng._token])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            model.init(torch.Generator().manual_seed(0))
        with pytest.raises(RuntimeError, match="device='cpu'"):
            model.init_caches(2, 16)
    enc = Model(get_arch("hubert-xlarge").reduced())
    with pytest.raises(ValueError):
        ServingEngine(enc, params)
