"""The reference's fault-tolerance tests (``tests/test_checkpoint_trainer.py``)
on the port, and the checkpoint format across the two packages.

All eight of the reference's functions: the checkpoint round trip,
atomicity and GC, the elastic restore (here onto another device than the
template's; the card's case is in ``tests/test_torch_train_card.py``),
the trainer's end-to-end run and resume, NaN rollback, preemption,
straggler accounting, and the data stream's determinism and resume.
Then the format: a reduced olmoe train state that the reference saved
(bfloat16 leaves included) restores in the port value for value and
trains on; a float32 one the port saved restores in the reference; both
write the same keys, shapes, types and ``.npy`` records; and an
asynchronous snapshot is not reached by the in-place step that follows
it.  ``test_the_reference_cannot_restore_bfloat16`` records the
reference's fault (``repro/train/checkpoint.py:135-137``).  Values
compare exactly: a checkpoint moves bits.
"""
import time
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.launch.steps import init_train_state as jinit_train_state
from repro.models.model import Model as JModel
from repro.train import checkpoint as jckpt
from repro_torch.configs import get_arch
from repro_torch.data.synthetic import DataConfig, SyntheticTokenStream
from repro_torch.launch.steps import init_train_state, make_train_step
from repro_torch.models.model import Model
from repro_torch.models.param import tree_leaves, tree_map
from repro_torch.optim import AdamWConfig
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.trainer import Trainer, TrainerConfig


def _tiny_setup(tmp_path, total_steps=12, ckpt_every=4):
    cfg = get_arch("internlm2-1.8b").reduced().replace(
        num_layers=2, d_model=32, d_ff=64, vocab_size=64, num_heads=2,
        num_kv_heads=2, dtype="float32")
    model = Model(cfg)
    state = init_train_state(model, torch.Generator().manual_seed(0), "cpu")
    step_fn = make_train_step(model, AdamWConfig(lr=1e-3))
    data = SyntheticTokenStream(DataConfig(vocab_size=64, seq_len=16,
                                           global_batch=4), device="cpu")
    tc = TrainerConfig(total_steps=total_steps, ckpt_every=ckpt_every,
                       ckpt_dir=str(tmp_path / "ck"), log_every=100)
    return model, state, step_fn, data, tc


def test_checkpoint_round_trip(tmp_path):
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.ones((4,), dtype=torch.int32)}}
    ckpt.save(tmp_path, 3, tree, extra={"train_step": 3, "data_step": 7})
    restored, extra = ckpt.restore(tmp_path, tree)
    assert extra["train_step"] == 3
    assert torch.equal(restored["a"], tree["a"])
    assert torch.equal(restored["b"]["c"], tree["b"]["c"])
    assert restored["b"]["c"].dtype == torch.int32


def test_checkpoint_atomicity_and_gc(tmp_path):
    tree = {"x": torch.zeros((3,))}
    for s in (1, 2, 3, 4, 5):
        ckpt.save(tmp_path, s, tree, keep=2)
    steps = sorted(p.name for p in tmp_path.glob("step_*"))
    assert steps == ["step_0000004", "step_0000005"]
    assert not list(tmp_path.glob("tmp_*"))
    assert ckpt.latest_step(tmp_path) == 5


def test_checkpoint_elastic_resharding(tmp_path):
    """Restore onto another device than the template's (the elastic
    restart path): a shapes-only ``meta`` template restored onto the
    CPU, bfloat16 included."""
    tree = {"w": torch.arange(16, dtype=torch.float32).reshape(4, 4),
            "h": torch.linspace(-2, 2, 8).to(torch.bfloat16)}
    ckpt.save(tmp_path, 1, tree)
    template = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                              device="meta"), tree)
    restored, _ = ckpt.restore(tmp_path, template, device="cpu")
    for k in tree:
        assert restored[k].device.type == "cpu"
        assert restored[k].dtype == tree[k].dtype
        assert torch.equal(restored[k], tree[k])


def test_trainer_end_to_end_and_resume(tmp_path):
    model, state, step_fn, data, tc = _tiny_setup(tmp_path)
    tr = Trainer(step_fn, data, tc)
    _, step = tr.fit(state, resume=False)
    assert step == tc.total_steps
    losses = [m["loss"] for m in tr.metrics_history]
    assert all(np.isfinite(l) for l in losses)

    # resume from checkpoint: a fresh trainer continues, not restarts
    tc2 = TrainerConfig(**{**tc.__dict__, "total_steps": 16})
    data2 = SyntheticTokenStream(data.cfg, device="cpu")
    tr2 = Trainer(step_fn, data2, tc2)
    state2, step2 = tr2.fit(state, resume=True)
    assert step2 == 16
    assert tr2.metrics_history[0]["step"] == 13   # continued, not restarted


def test_trainer_nan_rollback(tmp_path):
    model, state, step_fn, data, tc = _tiny_setup(tmp_path, total_steps=10,
                                                  ckpt_every=3)
    calls = {"n": 0}

    def poisoned_step(state, batch):
        calls["n"] += 1
        new_state, metrics = step_fn(state, batch)
        if calls["n"] == 5:       # poison exactly one step
            metrics = dict(metrics, loss=torch.tensor(float("nan")))
        return new_state, metrics

    tr = Trainer(poisoned_step, data, tc)
    _, step = tr.fit(state, resume=False)
    assert step == 10
    assert tr.rollbacks == 1
    assert all(np.isfinite(m["loss"]) for m in tr.metrics_history)


def test_trainer_preemption_checkpoints(tmp_path):
    model, state, step_fn, data, tc = _tiny_setup(tmp_path, total_steps=50,
                                                  ckpt_every=100)

    tr = Trainer(step_fn, data, tc)
    orig = tr.step_fn

    def slow_then_preempt(state, batch):
        out = orig(state, batch)
        if len(tr.metrics_history) >= 4:
            tr.preempted = True       # simulate SIGTERM delivery
        return out

    tr.step_fn = slow_then_preempt
    _, step = tr.fit(state, resume=False)
    assert step < 50
    assert ckpt.latest_step(tc.ckpt_dir) == step  # checkpointed on exit


def test_trainer_straggler_detection(tmp_path):
    model, state, step_fn, data, tc = _tiny_setup(tmp_path, total_steps=20)
    tc.straggler_warmup = 3
    tc.straggler_factor = 2.0
    events = []

    def slow_step(state, batch):
        if len(events) == 0 and data.step == 15:
            time.sleep(0.5)
        return step_fn(state, batch)

    tr = Trainer(slow_step, data, tc,
                 straggler_cb=lambda s, t: events.append((s, t)))
    tr.fit(state, resume=False)
    assert tr.straggler_events >= 1


def test_data_stream_determinism_and_resume():
    cfg = DataConfig(vocab_size=97, seq_len=256, global_batch=8, seed=5)
    s1 = SyntheticTokenStream(cfg, device="cpu")
    batches = [s1.next_batch()["tokens"] for _ in range(4)]
    s2 = SyntheticTokenStream.from_state(cfg, {"step": 2, "seed": 5},
                                         device="cpu")
    assert torch.equal(s2.next_batch()["tokens"], batches[2])
    assert batches[0].dtype == torch.int32
    assert batches[0].shape == (8, 257)
    # learnable structure: consecutive tokens obey the recurrence at the
    # (1-noise)^2 ~ 0.81 rate
    t = batches[0].numpy()
    hits = (t[:, 1:] == (t[:, :-1] * cfg.mult + cfg.add) % cfg.vocab_size)
    assert 0.7 < hits.mean() < 0.95


# ---------------------------------------------------------------------------
# The format across the two packages.
# ---------------------------------------------------------------------------

OLMOE = "olmoe-1b-7b"


def _flat(tree, prefix=""):
    """{key: float64 numpy} of a (Train/Opt)State of arrays or tensors."""
    if isinstance(tree, dict):
        return {k: v for key in tree
                for k, v in _flat(tree[key], f"{prefix}/{key}").items()}
    if isinstance(tree, tuple):
        return {k: v for f in tree._fields
                for k, v in _flat(getattr(tree, f), f"{prefix}.{f}").items()}
    if isinstance(tree, torch.Tensor):
        return {prefix: tree.double().numpy()}
    return {prefix: np.asarray(tree, dtype=np.float64)}


def _manifest(path):
    import json
    return json.loads((path / "manifest.json").read_text())


def test_a_reference_checkpoint_restores_in_the_port_and_trains_on(
        tmp_path):
    """The reference's reduced olmoe train state in bfloat16 (its default
    type), saved at step 5: the port restores every leaf value for value
    and type for type, and a Trainer resumes from it at step 6."""
    jcfg = jget_arch(OLMOE).reduced()
    assert jcfg.dtype == "bfloat16"
    jstate = jinit_train_state(JModel(jcfg), jax.random.PRNGKey(0))
    jckpt.save(tmp_path, 5, jstate, extra={"train_step": 5,
                                           "data_step": 5})
    assert "bfloat16" in _manifest(tmp_path / "step_0000005")["dtypes"]

    cfg = get_arch(OLMOE).reduced()
    model = Model(cfg)
    template = init_train_state(model, torch.Generator().manual_seed(1),
                                "cpu")
    restored, extra = ckpt.restore(tmp_path, template)
    assert extra == {"train_step": 5, "data_step": 5}
    want, got = _flat(jax.device_get(jstate)), _flat(restored)
    assert sorted(want) == sorted(got)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert [t.dtype for t in tree_leaves(restored)] == \
        [t.dtype for t in tree_leaves(template)]
    assert int(restored.opt.step) == 0

    data = SyntheticTokenStream(DataConfig(vocab_size=cfg.vocab_size,
                                           seq_len=16, global_batch=2),
                                device="cpu")
    tr = Trainer(make_train_step(model, AdamWConfig(lr=1e-3)), data,
                 TrainerConfig(total_steps=7, ckpt_every=100,
                               ckpt_dir=str(tmp_path), log_every=100))
    _, step = tr.fit(template, resume=True)
    assert step == 7
    assert [m["step"] for m in tr.metrics_history] == [6, 7]
    assert all(np.isfinite(m["loss"]) for m in tr.metrics_history)


def test_a_port_float32_checkpoint_restores_in_the_reference(tmp_path):
    cfg = get_arch(OLMOE).reduced().replace(dtype="float32")
    state = init_train_state(Model(cfg), torch.Generator().manual_seed(0),
                             "cpu")
    ckpt.save(tmp_path, 2, state, extra={"train_step": 2, "data_step": 3})
    jtemplate = jinit_train_state(
        JModel(jget_arch(OLMOE).reduced().replace(dtype="float32")),
        jax.random.PRNGKey(1))
    jrestored, extra = jckpt.restore(tmp_path, jtemplate)
    assert extra == {"train_step": 2, "data_step": 3}
    want, got = _flat(state), _flat(jax.device_get(jrestored))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_both_packages_write_the_same_format(tmp_path):
    """Keys, shapes and types in the manifest, and every ``.npy`` record
    of ``arrays.npz`` byte for byte, for the same bfloat16 train state."""
    jstate = jinit_train_state(JModel(jget_arch(OLMOE).reduced()),
                               jax.random.PRNGKey(0))
    jckpt.save(tmp_path / "ref", 1, jstate)
    template = init_train_state(Model(get_arch(OLMOE).reduced()),
                                torch.Generator().manual_seed(0), "cpu")
    state, _ = ckpt.restore(tmp_path / "ref", template)
    ckpt.save(tmp_path / "port", 1, state)
    ref, port = tmp_path / "ref" / "step_0000001", \
        tmp_path / "port" / "step_0000001"
    assert _manifest(port) == _manifest(ref)
    assert _manifest(port)["keys"][:2] == [".params/embed/embedding",
                                           ".params/embed/head"]
    with zipfile.ZipFile(ref / "arrays.npz") as zr, \
            zipfile.ZipFile(port / "arrays.npz") as zp:
        assert zp.namelist() == zr.namelist()
        for name in zr.namelist():
            assert zp.read(name) == zr.read(name), name


def test_the_reference_cannot_restore_bfloat16(tmp_path):
    """The reference's fault: ``np.savez`` writes a bfloat16 leaf as 2-byte
    ``<V2`` records and ``restore`` hands that array to
    ``jax.device_put``, which raises.  The port reads the type from the
    manifest."""
    tree = {"w": jnp.array([1.5, 2.25], jnp.bfloat16)}
    jckpt.save(tmp_path, 1, tree)
    with pytest.raises(TypeError, match="V2"):
        jckpt.restore(tmp_path, tree)
    restored, _ = ckpt.restore(
        tmp_path, {"w": torch.zeros(2, dtype=torch.bfloat16)})
    assert restored["w"].dtype == torch.bfloat16
    assert restored["w"].tolist() == [1.5, 2.25]


def test_an_async_snapshot_is_not_mutated_by_the_next_step(tmp_path):
    model, state, step_fn, data, tc = _tiny_setup(tmp_path)
    state, _ = step_fn(state, data.next_batch())
    before = {k: v.copy() for k, v in _flat(state).items()}
    saver = ckpt.AsyncCheckpointer(tmp_path / "async")
    saver.save(1, state, extra={"train_step": 1})
    state, _ = step_fn(state, data.next_batch())     # in place, at once
    saver.wait()
    saved, _ = ckpt.restore(tmp_path / "async", state)
    after = _flat(state)
    for k, v in _flat(saved).items():
        np.testing.assert_array_equal(v, before[k], err_msg=k)
    assert any(not np.array_equal(after[k], before[k]) for k in before)
