#!/usr/bin/env bash
# The PyTorch/CUDA port's CPU gate: its tests against the JAX reference
# (the card's tests skip without a card) and a CPU smoke of the Fig. 5/6
# benchmark at the reference's cut of the Table-3 rows.
#   ./scripts/ci_torch.sh
set -euo pipefail
cd "$(dirname "$0")/.."
export PYTHONPATH=src${PYTHONPATH:+:$PYTHONPATH}
export JAX_PLATFORMS=cpu

echo "== the port's tests (tests/test_torch_*.py) =="
python -m pytest -q tests/test_torch_*.py

echo
echo "== bench_overall smoke (CPU, 1/2048 of the rows, ESC and hash) =="
# Every C is held to torch.sparse's; the command fails on a mismatch.
python -m benchmarks.torch.bench_overall --device cpu --scale 2048 \
    --method esc --method hash --reps 1 --jobs 2
