#!/usr/bin/env bash
# The port's verification gate, in one command (the counterpart of
# scripts/verify.sh for src/repro_torch; see README):
#
#   1. the port's CPU tests (tests/test_torch_*.py: each part of the port
#      held against the JAX package on the same numpy inputs)
#   2. the port's regression gate on the card: re-measures the stacked
#      round against BENCH_torch_round_step.json and the wire exchange
#      against BENCH_torch_wire_exchange.json (times within the
#      threshold, per-node bytes EXACT per wire spec), with the committed
#      phase invariants; the times are the card's
#
#   scripts/torch_verify.sh [extra pytest args...]
set -euo pipefail
cd "$(dirname "$0")/.."
export PYTHONPATH="src${PYTHONPATH:+:$PYTHONPATH}"

JAX_PLATFORMS=cpu python -m pytest -q tests/test_torch_*.py "$@"
python benchmarks/torch_check_regression.py
