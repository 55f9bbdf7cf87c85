#!/usr/bin/env bash
# The PyTorch/CUDA port's CPU gate: its static analysis (opslint, new
# findings against opslint_torch_baseline.json fail), its tests against
# the JAX reference (the card's tests skip without a card), the LM serving
# CLI, and a CPU smoke of the Fig. 5/6 benchmark at the reference's cut of
# the Table-3 rows.
#   ./scripts/ci_torch.sh
set -euo pipefail
cd "$(dirname "$0")/.."
export PYTHONPATH=src${PYTHONPATH:+:$PYTHONPATH}
export JAX_PLATFORMS=cpu

echo "== opslint over the port (new findings vs opslint_torch_baseline.json) =="
python -m repro_torch.analysis_static src/repro_torch --fail-on-new \
    --baseline opslint_torch_baseline.json --format json

echo
echo "== the port's tests (tests/test_torch_*.py) =="
python -m pytest -q tests/test_torch_*.py

echo
echo "== the LM serving CLI (reduced qwen3-1.7b, CPU) =="
python -m repro_torch.launch.serve --arch qwen3-1.7b --device cpu --requests 4

echo
echo "== bench_overall smoke (CPU, 1/2048 of the rows, ESC and hash) =="
# Every C is held to torch.sparse's; the command fails on a mismatch.
python -m benchmarks.torch.bench_overall --device cpu --scale 2048 \
    --method esc --method hash --reps 1 --jobs 2

echo
echo "== engine gates (benchmarks/torch/bench_engine.py, CPU; scripts/ci.sh's nine) =="
# Each step exits 1 on any failed gate; every step runs, and the script
# fails at the end if one did.  The trajectory goes to the gitignored
# chiprun_out/, never to BENCH_engine.json.  Bitwise gates on hash run
# under torch.use_deterministic_algorithms(True).
failed=()
bench() {
    python -m benchmarks.torch.bench_engine --device cpu --smoke "$@" \
        || failed+=("bench_engine $*")
}
# Plan cache: cold/steady >= 5x, hit rate >= 90 %, 0 retraces after warmup.
bench
# The hash steady state: 0 retraces after rung discovery.
bench --method hash
# AUTO shards + tracked headroom: every request via the policy, parity.
bench --method hash --adaptive
# Fused one-build tables + row packing: access reduction, bitwise parity.
bench --method hash --fused
# Row-block sharding: merged C == unsharded, plan reuse.
bench --shards 2
# K shape buckets under a 0.6x governor cap: peak <= cap, bitwise parity.
bench --arena
# Sampled cold planning: sizing >= 3x, 0 retraces, bitwise parity.
bench --estimate --method hash
# Telemetry: every required span, a valid Chrome trace, < 5 % overhead.
bench --shards 2 --trace chiprun_out/bench_engine_trace.json
# Chaos: 0 failures, bitwise twins, p99 bound, poisoned/stalled contracts.
bench --serve

if ((${#failed[@]})); then
    printf 'failed: %s\n' "${failed[@]}" >&2
    exit 1
fi
