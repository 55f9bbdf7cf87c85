"""The single-H100 dry run on the CPU: its two counters, its CLI, the
donated decode step, ``gather_specs``, counted against closed-form FLOPs,
and the report's tables.

Counted prefill FLOPs against the closed form (reduced configs, B = 2,
S = 64, below the blocked-attention threshold).  The closed form is the
reference's ``forward_flops_per_token`` with two changes that say what
the port computes: the scores at s_att = S (the unblocked attention
computes every score and masks the upper half; the reference's form
takes the causal S/2), and the head at the last position only (at every
position for the encoder, whose prefill returns every position's
logits).  ``FlopCounterMode`` counts matrix products only, so for the
Mamba1 arch the closed form's elementwise terms (the causal conv and the
scan's 10·d_inner·N) give way to the one product the scan issues,
y = C·h (2·d_inner·N).  Then the dense, encoder, MoE and SSM archs are
exact (the MoE's capacity term k·cf is the capacity buffer the port
fills: 2·16/8 of 64 tokens is a multiple of 8).  The hybrid's SSD and the
vlm's cross-attention hold 1 %: the closed form counts the SSD's
intra-chunk product at the causal half of the chunk, and the cross
layers' K/V projections at every text token where the port projects
the vision tokens.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import ARCHS, get_arch
from repro_torch.launch import analytic, dryrun, report, roofline, shapes
from repro_torch.launch import sharding
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.steps import (init_train_state, make_decode_step,
                                      make_prefill_step, make_train_step)
from repro_torch.models.model import Model
from repro_torch.models.param import tree_leaves, tree_map
from repro_torch.optim import AdamWConfig

REPO = Path(__file__).resolve().parents[1]
DECODERS = sorted(a for a in ARCHS if not get_arch(a).is_encoder)
EXACT_FAMILIES = ("dense", "encoder", "moe", "ssm")
LOOSE_REL = 1e-2          # hybrid, vlm: see the module docstring


# ---------------------------------------------------------------------------
# The counters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_counters_on_a_matmul(device):
    m, k, n = 8, 16, 4
    a = torch.ones((m, k), dtype=torch.bfloat16, device=device)
    b = torch.ones((k, n), dtype=torch.bfloat16, device=device)
    out, flops, nbytes = roofline.count_step(torch.matmul, a, b)
    assert out.shape == (m, n)
    assert flops == 2 * m * k * n
    assert nbytes == 2 * (m * k + k * n + m * n)


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_counters_on_views_and_slice_updates(device):
    x = torch.zeros((4, 8, 2), dtype=torch.float32, device=device)
    _, flops, nbytes = roofline.count_step(
        lambda t: t.reshape(32, 2).t()[0].unsqueeze(0), x)
    assert (flops, nbytes) == (0, 0)                 # views move nothing
    idx = (torch.tensor([0, 3], device=device),
           torch.tensor([5, 1], device=device))
    vals = torch.ones((2, 2), dtype=torch.float32, device=device)
    _, _, nbytes = roofline.count_step(lambda: x.index_put_(idx, vals))
    assert nbytes == 2 * vals.numel() * 4 + 2 * 2 * 8   # update in + out
    _, _, nbytes = roofline.count_step(lambda: x.index_put(idx, vals))
    # out of place: the target read and written whole, the update read
    assert nbytes == 2 * x.numel() * 4 + vals.numel() * 4 + 2 * 2 * 8


# ---------------------------------------------------------------------------
# The CLI (as the reference's tests/test_dryrun_cli.py runs its own)
# ---------------------------------------------------------------------------

def test_dryrun_cli_single_cell(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen3-1.7b", "--shape", "decode_32k", "--device", "cpu",
         "--out", str(tmp_path)],
        capture_output=True, text=True, timeout=120, env=env, cwd=tmp_path)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "[ok] qwen3-1.7b|decode_32k|1xH100" in proc.stdout
    art = json.loads((tmp_path / "qwen3-1.7b_decode_32k_1xH100.json")
                     .read_text())
    assert art["chips"] == 1 and art["mesh"] == "1xH100"
    assert art["batch"] == 128
    assert art["roofline"]["flops"] > 0
    assert art["roofline"]["coll_bytes"] == 0
    assert art["memory"]["arguments"] > 0
    assert art["memory"]["fits"] is False     # 452 GiB of caches
    assert set(art["analytic"]) == {"1xH100", "16x16"}


def test_execute_refuses_the_cpu():
    with pytest.raises(ValueError, match="card only"):
        dryrun.execute_cell("qwen3-1.7b", "decode_32k", device="cpu")


def test_train_state_bytes_are_16_a_parameter():
    """olmoe-1b-7b's train_4k: weights, one gradient in their types and
    the float32 m, v and master copy: 16 B a bfloat16 parameter, 20 B a
    float32 one (router and norms), 110.7 GB; it does not fit."""
    *_, mem, info = dryrun.build_cell("olmoe-1b-7b", "train_4k")
    leaves = tree_leaves(Model(get_arch("olmoe-1b-7b")).abstract_params())
    n16 = sum(p.numel() for p in leaves if p.dtype == torch.bfloat16)
    n32 = sum(p.numel() for p in leaves if p.dtype == torch.float32)
    assert n16 + n32 == sum(p.numel() for p in leaves)
    assert mem["state"] == 16 * n16 + 20 * n32
    assert 110.6e9 < mem["state"] < 110.8e9
    assert mem["required"] > roofline.H100.memory_bytes
    assert info["microbatches"] == dryrun.MICROBATCHES["olmoe-1b-7b"]


def test_execute_batch_is_the_largest_power_of_two_that_fits():
    """olmoe decode_32k: 8 sequences (13.84 GB of weights, 34.36 GB of
    caches) fit 3/4 of 80 GB, 16 do not."""
    assert dryrun.execute_batch("olmoe-1b-7b", "decode_32k",
                                roofline.H100.memory_bytes) == 8


# ---------------------------------------------------------------------------
# Donated decode
# ---------------------------------------------------------------------------

def _tiny(arch):
    return get_arch(arch).reduced().replace(dtype="float32")


@pytest.mark.parametrize("arch", DECODERS)
def test_donated_decode_equals_undonated(arch):
    cfg = _tiny(arch)
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    g = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 6),
                                     generator=g)}
    if cfg.family == "vlm":
        batch["vision"] = torch.randn((2, cfg.vision_tokens, cfg.d_model),
                                      generator=g)
    _, caches = make_prefill_step(model, kv_cache_len=12)(params, batch)
    token = batch["tokens"][:, -1:].to(torch.int32)
    runs = {}
    for donate in (False, True):
        step = make_decode_step(model, donate_caches=donate)
        c = tree_map(torch.clone, caches)
        passed = c
        tok, toks, logits = token, [], []
        for pos in range(6, 10):
            tok, lg, c = step(params, tok, c, pos)
            toks.append(tok)
            logits.append(lg)
        if donate:
            assert c is passed          # the caches passed in, updated
        else:
            assert all(torch.equal(a, b) for a, b in
                       zip(tree_leaves(passed), tree_leaves(caches)))
        runs[donate] = (toks, logits, c)
    for a, b in zip(runs[False][0] + runs[False][1],
                    runs[True][0] + runs[True][1]):
        assert torch.equal(a, b)
    got, want = tree_leaves(runs[True][2]), tree_leaves(runs[False][2])
    assert len(got) == len(want)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert not all(torch.equal(a, b) for a, b in
                   zip(got, tree_leaves(caches)))


# ---------------------------------------------------------------------------
# gather_specs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "qwen3-1.7b"])
def test_gather_specs_change_no_bit(arch):
    cfg = _tiny(arch)
    model = Model(cfg)
    mesh = make_host_mesh(device="cpu")
    gather = sharding.param_pspecs(model.param_specs(),
                                   sharding.serve_rules(mesh), mesh)
    g = torch.Generator().manual_seed(2)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (4, 17),
                                     generator=g)}
    out = []
    for specs in (None, gather):
        state = init_train_state(model, torch.Generator().manual_seed(0),
                                 "cpu")
        step = make_train_step(model, AdamWConfig(), microbatches=2,
                               gather_specs=specs)
        state, met = step(state, batch)
        out.append((tree_leaves(state), met["loss"]))
    assert torch.equal(out[0][1], out[1][1])
    assert all(torch.equal(a, b) for a, b in zip(out[0][0], out[1][0]))
    with pytest.raises(ValueError):     # a spec longer than its tensor
        sharding.constrain({"w": torch.zeros(3)},
                           {"w": sharding.P(None, None)})


# ---------------------------------------------------------------------------
# Counted prefill FLOPs against the closed form
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_counted_prefill_flops_match_the_closed_form(arch):
    b, s = 2, 64
    cfg = get_arch(arch).reduced()
    model = Model(cfg)
    cell = shapes.ShapeCell("prefill_64", "prefill", s, b)
    _, flops, nbytes = roofline.count_step(
        make_prefill_step(model, kv_cache_len=s), model.abstract_params(),
        shapes.abstract_batch(cfg, cell))
    assert nbytes > 0
    head = analytic.head_flops_token(cfg)
    per_token = analytic.forward_flops_per_token(cfg, s) - head
    if cfg.family == "ssm":
        di, n = cfg.d_inner, cfg.ssm_state
        per_token -= cfg.num_layers * (2 * cfg.ssm_conv * di + 8 * di * n)
    heads = b * s if cfg.is_encoder else b
    want = per_token * b * s + head * heads
    rel = 1e-12 if cfg.family in EXACT_FAMILIES else LOOSE_REL
    assert abs(flops - want) <= rel * want, (flops, want, flops / want)


# ---------------------------------------------------------------------------
# The report
# ---------------------------------------------------------------------------

def test_report_tables_have_a_row_per_cell(tmp_path):
    art = dryrun.run_cell("qwen3-1.7b", "decode_32k", device="cpu",
                          out_dir=tmp_path, verbose=False)
    assert art is not None
    n_cells = sum(len(shapes.cells_for(get_arch(a))) for a in ARCHS)
    for table in (report.dryrun_table(tmp_path), report.roofline_table()):
        rows = table.splitlines()[2:]
        assert len(rows) == n_cells
        assert len({tuple(r.split("|")[1:3]) for r in rows}) == n_cells
    assert "MISSING" in report.dryrun_table(tmp_path)
    assert "| qwen3-1.7b | decode_32k | 128 |" in \
        report.dryrun_table(tmp_path)
    check = report.consistency_check(tmp_path).splitlines()[2:]
    assert len(check) == 1 and check[0].startswith("| qwen3-1.7b/decode_32k")
    text = report.roofline_table()
    assert "MXU" not in text and "ICI" not in text
