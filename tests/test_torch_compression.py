"""The port's gradient compression against the reference's on the CPU.

``quantize`` (q, scale and the new error), ``dequantize`` and
``compress_tree`` / ``decompress_tree`` bit for bit: the same float32
operations in the same order.  ``compressed_psum`` over a one-process
gloo group against the reference's inside ``jax.shard_map`` on a
one-device mesh, bit for bit too (a sum over one rank is the rank's own
payload), over several steps of error feedback, with float32 and
bfloat16 gradients.  The reference runs op by op here: under ``jax.jit``
XLA contracts ``target - q * scale`` into one fused multiply-add, so the
new error rounds once less (up to 9.3e-8 apart on 0.01 gradients).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as P

from repro.train import compression as JC
from repro_torch.convert import params_from_reference
from repro_torch.models.param import tree_leaves
from repro_torch.train import compression as C


def _grads(seed, dtype=jnp.float32):
    rng = np.random.default_rng(seed)
    tree = {"w": rng.standard_normal((6, 10)) * 0.01,
            "blk": {"b": rng.standard_normal((33,)),
                    "z": np.zeros((4,))}}          # an all-zero leaf
    jt = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), tree)
    return jt, params_from_reference(jax.device_get(jt), device="cpu")


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, torch.Tensor):
        return [tree.float().numpy() if tree.dtype == torch.bfloat16
                else tree.numpy()]
    return [np.asarray(tree, dtype=np.float32)
            if tree.dtype == jnp.bfloat16 else np.asarray(tree)]


def _equal(a, b, what):
    for x, y in zip(_leaves(a), _leaves(b)):
        np.testing.assert_array_equal(x, y, err_msg=what)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_bit_for_bit(seed):
    rng = np.random.default_rng(seed)
    g = rng.standard_normal(257).astype(np.float32) * 0.03
    err = rng.standard_normal(257).astype(np.float32) * 1e-4
    jq, js, je = JC.quantize(jnp.asarray(g), jnp.asarray(err))
    q, s, e = C.quantize(torch.from_numpy(g), torch.from_numpy(err))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(e.numpy(), np.asarray(je))
    np.testing.assert_array_equal(C.dequantize(q, s).numpy(),
                                  np.asarray(JC.dequantize(jq, js)))


def test_compress_tree_bit_for_bit():
    jg, g = _grads(3)
    jerr, err = JC.init_error_state(jg), C.init_error_state(g)
    for step in range(3):
        jq, js, jerr = JC.compress_tree(jg, jerr)
        q, s, err = C.compress_tree(g, err)
        _equal(q, jq, f"step {step} q")
        _equal(s, js, f"step {step} scale")
        _equal(err, jerr, f"step {step} err")
        _equal(C.decompress_tree(q, s), JC.decompress_tree(jq, js),
               f"step {step} decompressed")
    assert sorted(q) == sorted(jq)


@pytest.fixture
def gloo_group(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compressed_psum_matches_shard_map(gloo_group, dtype):
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    mesh = jax.make_mesh((1,), ("data",))
    jpsum = jax.shard_map(lambda g, e: JC.compressed_psum(g, e, "data"),
                          mesh=mesh, in_specs=P(), out_specs=P())
    jg, g = _grads(4, jdt)
    jerr, err = JC.init_error_state(jg), C.init_error_state(g)
    for step in range(3):
        jmean, jerr = jpsum(jg, jerr)
        mean, err = C.compressed_psum(g, err, gloo_group)
        assert all(m.dtype == x.dtype for m, x in zip(tree_leaves(mean),
                                                      tree_leaves(g)))
        _equal(mean, jmean, f"step {step} mean")
        _equal(err, jerr, f"step {step} err")
