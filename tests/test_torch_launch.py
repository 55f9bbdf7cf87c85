"""The port's ``launch/`` (shapes, meshes, sharding rules, model FLOPs, the
closed-form roofline) against the reference's, on the CPU.

The reference's production meshes need 256 or 512 devices only to place
arrays; its rules and specs read names and sizes, so the test builds
them on ``jax.sharding.AbstractMesh`` (16x16 and 2x16x16) and holds the
port's ``make_production_mesh`` to them.  Specs compare as tuples, leaf
by leaf in the reference's flattening order (dict keys sorted); both
sides drop trailing ``None`` entries before the comparison, the one
normalization a ``PartitionSpec`` may apply.  The analytic terms are
compared within 1e-12 relative (the same float expressions in the same
order); the times, bottleneck and MFU are equal when the port is given
the reference's hardware numbers, which the test reads from
``repro.launch.roofline``.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as JP

from repro.configs import get_arch as jget_arch
from repro.launch import analytic as janalytic
from repro.launch import roofline as jroofline
from repro.launch import shapes as jshapes
from repro.launch import sharding as jsharding
from repro.models import quant as jquant
from repro.models.model import Model as JModel
from repro_torch import convert
from repro_torch.configs import ARCHS, get_arch
from repro_torch.core import spgemm_reference
from repro_torch.engine import SpgemmEngine, data_axis_devices, shard_devices
from repro_torch.launch import analytic, mesh as pmesh, roofline, shapes
from repro_torch.launch import sharding
from repro_torch.launch.dryrun import MICROBATCHES
from repro_torch.models import quant
from repro_torch.models.model import Model

ARCH_IDS = sorted(ARCHS)
MESHES = {"16x16": (False, AbstractMesh((16, 16), ("data", "model"))),
          "2x16x16": (True, AbstractMesh((2, 16, 16),
                                         ("pod", "data", "model")))}
REF_HW = roofline.Hardware(
    name="the reference's TPU numbers (test only)",
    peak_flops=jroofline.PEAK_FLOPS, hbm_bw=jroofline.HBM_BW,
    link_bw=jroofline.ICI_BW, memory_bytes=0.0)
REL = 1e-12


def _port_leaves(tree):
    """Leaves in the reference's flattening order: dict keys sorted,
    tuples in order, a dataclass's fields in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _port_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _port_leaves(v)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [x for f in dataclasses.fields(tree)
                for x in _port_leaves(getattr(tree, f.name))]
    return [tree]


def _ref_spec_leaves(tree):
    return jax.tree_util.tree_leaves(tree,
                                     is_leaf=lambda x: isinstance(x, JP))


def _norm(spec):
    out = list(spec)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def _same_specs(got, want):
    got, want = _port_leaves(got), _ref_spec_leaves(want)
    assert all(isinstance(s, sharding.PartitionSpec) for s in got)
    assert [_norm(s) for s in got] == [_norm(s) for s in want]


def _same_shapes(got, want):
    got, want = _port_leaves(got), jax.tree_util.tree_leaves(want)
    assert [(tuple(t.shape), str(t.dtype).removeprefix("torch."))
            for t in got] == [(tuple(s.shape), str(s.dtype)) for s in want]
    assert all(t.device.type == "meta" for t in got)


def _close(a, b):
    assert abs(a - b) <= REL * max(abs(a), abs(b)), (a, b)


# ---------------------------------------------------------------------------
# Shapes
# ---------------------------------------------------------------------------

def test_shape_cells_equal_the_reference():
    assert {k: dataclasses.astuple(v) for k, v in shapes.SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in jshapes.SHAPES.items()}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cells_and_abstract_inputs_equal_the_reference(arch):
    cfg, jcfg = get_arch(arch), jget_arch(arch)
    assert shapes.cells_for(cfg) == jshapes.cells_for(jcfg)
    for name in shapes.cells_for(cfg):
        cell, jcell = shapes.SHAPES[name], jshapes.SHAPES[name]
        assert shapes.tokens_per_step(cfg, cell) == \
            jshapes.tokens_per_step(jcfg, jcell)
        if cell.kind == "decode":
            _same_shapes(shapes.abstract_decode_inputs(cfg, cell),
                         jshapes.abstract_decode_inputs(jcfg, jcell))
        else:
            _same_shapes(shapes.abstract_batch(cfg, cell),
                         jshapes.abstract_batch(jcfg, jcell))


# ---------------------------------------------------------------------------
# Model FLOPs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_equal_the_reference(arch):
    cfg, jcfg = get_arch(arch), jget_arch(arch)
    specs, jspecs = Model(cfg).param_specs(), JModel(jcfg).param_specs()
    assert roofline.model_flops_params(cfg, specs) == \
        jroofline.model_flops_params(jcfg, jspecs)
    for name in shapes.cells_for(cfg):
        cell = shapes.SHAPES[name]
        tokens = shapes.tokens_per_step(cfg, cell)
        assert roofline.model_flops_for_cell(cfg, specs, cell.kind, tokens) \
            == jroofline.model_flops_for_cell(jcfg, jspecs, cell.kind,
                                              tokens)


# ---------------------------------------------------------------------------
# Sharding specs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_equal_the_reference(arch, mesh_name):
    multi_pod, jmesh = MESHES[mesh_name]
    mesh = pmesh.make_production_mesh(multi_pod=multi_pod)
    assert mesh.shape == dict(jmesh.shape)
    assert pmesh.data_axes(mesh) == tuple(
        a for a in jmesh.axis_names if a in ("pod", "data"))
    assert pmesh.dp_size(mesh) == 16 * (2 if multi_pod else 1)
    cfg, jcfg = get_arch(arch), jget_arch(arch)
    specs, jspecs = Model(cfg).param_specs(), JModel(jcfg).param_specs()
    for rules, jrules in ((sharding.train_rules, jsharding.train_rules),
                          (sharding.serve_rules, jsharding.serve_rules)):
        assert rules(mesh) == jrules(jmesh)
        _same_specs(sharding.param_pspecs(specs, rules(mesh), mesh),
                    jsharding.param_pspecs(jspecs, jrules(jmesh), jmesh))
    for name in shapes.cells_for(cfg):
        cell, jcell = shapes.SHAPES[name], jshapes.SHAPES[name]
        if cell.kind == "decode":
            token, caches, _ = shapes.abstract_decode_inputs(cfg, cell)
            jtoken, jcaches, _ = jshapes.abstract_decode_inputs(jcfg, jcell)
            _same_specs(sharding.cache_pspecs(
                cfg, caches, mesh, global_batch=cell.global_batch,
                seq_len=cell.seq_len), jsharding.cache_pspecs(
                jcfg, jcaches, jmesh, global_batch=jcell.global_batch,
                seq_len=jcell.seq_len))
            batch, jbatch = {"t": token}, {"t": jtoken}
        else:
            batch = shapes.abstract_batch(cfg, cell)
            jbatch = jshapes.abstract_batch(jcfg, jcell)
        _same_specs(sharding.batch_pspecs(cfg, batch, mesh,
                                          cell.global_batch),
                    jsharding.batch_pspecs(jcfg, jbatch, jmesh,
                                           jcell.global_batch))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_quant_pspecs_equal_the_reference(arch):
    cfg, jcfg = get_arch(arch), jget_arch(arch)
    multi_pod, jmesh = MESHES["16x16"]
    mesh = pmesh.make_production_mesh(multi_pod=multi_pod)
    model, jmodel = Model(cfg), JModel(jcfg)
    ps = sharding.param_pspecs(model.param_specs(),
                               sharding.serve_rules(mesh), mesh)
    jps = jsharding.param_pspecs(jmodel.param_specs(),
                                 jsharding.serve_rules(jmesh), jmesh)
    got = quant.quant_pspecs(ps, model.abstract_params())
    want = jquant.quant_pspecs(jps, jmodel.abstract_params())
    _same_specs(got, want)
    # the spec tree and the quantized tree line up leaf for leaf
    leaves = _port_leaves(quant.abstract_quantized(model.abstract_params()))
    specs = _port_leaves(got)
    assert len(leaves) == len(specs)
    assert all(len(s) == t.dim() for s, t in zip(specs, leaves))


def test_named_shardings_split_by_the_mesh():
    pod = pmesh.make_production_mesh()
    spec = sharding.P("model", ("data",), None)
    assert sharding.to_named(spec, pod).shard_shape((32, 64, 5)) == \
        (2, 4, 5)
    one = pmesh.make_host_mesh(device="cpu")
    named = sharding.to_named({"a": spec}, one)["a"]
    assert named.shard_shape((32, 64, 5)) == (32, 64, 5)   # whole


# ---------------------------------------------------------------------------
# The closed-form roofline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("gather_once", [False, True])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_analytic_terms_equal_the_reference(arch, gather_once):
    cfg, jcfg = get_arch(arch), jget_arch(arch)
    mb = MICROBATCHES[arch]
    for mesh_name, (multi_pod, _) in sorted(MESHES.items()):
        mesh = pmesh.make_production_mesh(multi_pod=multi_pod)
        for name in shapes.cells_for(cfg):
            got = analytic.analytic_cell(cfg, name, mesh=mesh,
                                         microbatches=mb,
                                         gather_once=gather_once, hw=REF_HW)
            want = janalytic.analytic_cell(jcfg, name, multi_pod=multi_pod,
                                           microbatches=mb,
                                           gather_once=gather_once)
            for f in ("flops_issued", "model_flops", "hbm_bytes",
                      "ici_bytes"):
                _close(getattr(got, f), getattr(want, f))
            assert got.chips == want.chips
            assert (got.t_compute, got.t_memory, got.t_collective,
                    got.bottleneck, got.mfu, got.useful_ratio) == \
                (want.t_compute, want.t_memory, want.t_collective,
                 want.bottleneck, want.mfu, want.useful_ratio)


def test_analytic_one_card_default():
    """One H100 by default: no links, and olmoe-1b-7b's decode_32k at 8
    sequences reads 13.84 GB of weights and 34.36 GB of caches, about
    14.4 ms at 3.35 TB/s."""
    cfg = get_arch("olmoe-1b-7b")
    a = analytic.analytic_cell(cfg, "decode_32k", batch=8)
    assert a.chips == 1 and a.ici_bytes == 0.0 and a.t_collective == 0.0
    assert a.notes["cache_bytes_chip"] == 34359738368
    assert a.bottleneck == "memory"
    assert 14.3e-3 < a.step_time < 14.5e-3
    assert a.hw is roofline.H100


def test_roofline_terms_on_the_h100():
    t = roofline.terms_from_counts(989e12, 3.35e12 / 2, model_flops=494.5e12)
    assert (t.t_compute, t.t_memory, t.t_collective) == (1.0, 0.5, 0.0)
    assert t.bottleneck == "compute" and t.step_time == 1.0
    assert t.mfu_roofline == 0.5 and t.useful_flops_ratio == 0.5
    assert t.mfu(2.0) == 0.25
    js = t.to_json()
    assert js["coll_by_type"] == {k: 0 for k in jroofline.COLLECTIVE_OPS}
    assert set(js) >= {"flops", "hbm_bytes", "coll_bytes", "chips",
                       "model_flops", "t_compute_s", "t_memory_s",
                       "t_collective_s", "bottleneck", "step_time_s",
                       "useful_flops_ratio", "mfu_roofline"}


# ---------------------------------------------------------------------------
# The host mesh as the engine's placement (tests/test_partition.py)
# ---------------------------------------------------------------------------

def _pair(seed, m=32, k=28, n=36):
    from repro.core import csr as jcsr
    out = []
    for s, (r, c) in ((seed, (m, k)), (seed + 1, (k, n))):
        M = jcsr.random_csr(s, r, c, avg_nnz_per_row=3.0)
        out.append(convert.csr_from_reference(
            np.asarray(M.rpt), np.asarray(M.col), np.asarray(M.val),
            M.shape, device="cpu"))
    return out


def test_sharded_with_mesh_placement():
    mesh = pmesh.make_host_mesh(device="cpu")
    assert pmesh.data_axis_devices is data_axis_devices   # one definition
    assert data_axis_devices(mesh) == (torch.device("cpu"),)
    assert len(shard_devices(mesh, 3)) == 3
    engine = SpgemmEngine(shards=2, mesh=mesh)
    A, B = _pair(53)
    r = engine.execute(A, B)
    np.testing.assert_allclose(r.C.to_dense().numpy(),
                               spgemm_reference(A, B).numpy(),
                               rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError):
        data_axis_devices(pmesh.make_production_mesh())   # no devices
