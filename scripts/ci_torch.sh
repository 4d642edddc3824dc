#!/usr/bin/env bash
# CI gate of the PyTorch/CUDA port (src/repro_torch/), on the CPU.
#
#   bash scripts/ci_torch.sh            # analyze stage, then the port's CPU tests
#   bash scripts/ci_torch.sh analyze    # the analyze stage alone
#
# The analyze stage (stdlib only, no model compile, well under a minute):
# locklint + lockorder + kernelcheck over the port with zero unexplained
# findings, the committed lock-order artifact fresh against the tree, and the
# analyzer and witness tests with the engine-backed soaks deselected (the
# full run below still exercises them). The card's own checks are
# `python3 chip_smoke.py` and `pytest -m cuda tests/test_torch_cuda.py` on a
# machine with one.
set -euo pipefail
cd "$(dirname "$0")/.."

TIMEOUT_ARGS=()
if python -c "import pytest_timeout" 2>/dev/null; then
    TIMEOUT_ARGS=(--timeout=300 --timeout-method=thread)
fi

PYTHONPATH=src${PYTHONPATH:+:$PYTHONPATH} python -m repro_torch.analysis \
    --check-graph docs/lock_order_torch.json
PYTHONPATH=src${PYTHONPATH:+:$PYTHONPATH} python -m pytest -q \
    ${TIMEOUT_ARGS[@]+"${TIMEOUT_ARGS[@]}"} \
    tests/test_torch_analysis.py tests/test_torch_lock_witness.py -k "not engine"
if [[ "${1:-}" == "analyze" ]]; then
    echo "ci_torch.sh: analyze stage passed"
    exit 0
fi

PYTHONPATH=src${PYTHONPATH:+:$PYTHONPATH} python -m pytest -q \
    ${TIMEOUT_ARGS[@]+"${TIMEOUT_ARGS[@]}"} tests/test_torch_*.py "$@"
