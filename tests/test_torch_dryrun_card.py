"""The dry run's ``--execute`` on the card (card only: every test skips
without one).

A reduced qwen3-1.7b and olmoe-1b-7b decode_32k cell (the full 32,768
positions, 2 sequences) is built from a seeded generator on the card,
timed, and counted again under ``FlopCounterMode`` on the card's
tensors: the count equals the ``meta`` trace's.  This file imports no
JAX.
"""
import dataclasses
import math

import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.launch import dryrun


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "olmoe-1b-7b"])
def test_executed_reduced_cell_counts_what_the_trace_counts(cuda_device,
                                                            arch):
    red = get_arch(arch).reduced()
    overrides = {f.name: getattr(red, f.name)
                 for f in dataclasses.fields(red)}
    art, rec = dryrun.execute_cell(arch, "decode_32k", device=cuda_device,
                                   batch=2, overrides=overrides)
    assert rec["fits"] and rec["batch"] == 2 and rec["finite"]
    assert rec["flops_card"] == rec["flops_trace"] > 0
    assert len(rec["step_ms"]) == dryrun.REPEATS
    assert all(math.isfinite(v) and v > 0 for v in rec["step_ms"])
    assert rec["peak_gib"] <= 1.1 * rec["argument_gib"] + 0.25
    assert art["execute"] is rec and art["chips"] == 1
