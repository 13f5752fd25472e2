#!/usr/bin/env bash
# One-command CI gate (reference parity: .travis.yml pytest+pylint +
# codecov 90% target). Fails on any regression:
#   1. lint (AST gate, scripts/lint.py)
#   2. full test suite on {serial, 8-device virtual CPU mesh} under the
#      sys.monitoring line-coverage gate (floor 88%)
#   3. NumPy API coverage floors (the parity gate)
#   4. driver entry points (single-device compile check + multichip dryrun)
#   5. with NUMS_TPU_HW_TESTS=1, the GPU tier (`python chip_smoke.py`)
set -euo pipefail
cd "$(dirname "$0")/.."

echo "== lint =="
python scripts/lint.py nums_tpu

echo "== tests + line coverage (serial + virtual mesh) =="
# sys.monitoring-based line coverage (the image has no coverage.py);
# child interpreters (jax.distributed workers, dryrun subprocesses)
# are collected too via scripts/linecov_boot. The floor sits under the
# reference's codecov 90% target (.travis.yml/codecov.yml there), above
# any untested-new-module regression.
python scripts/linecov.py --floor 88 tests/ -q

echo "== API coverage floors =="
python -m nums_tpu.cmds.api_coverage \
  --min "numpy=100,numpy.random=100,numpy.linalg=100,numpy.fft=100" \
  --max-fallbacks "numpy=13,numpy.random=1,numpy.linalg=2,numpy.fft=0"

echo "== driver entry points =="
python __graft_entry__.py

if [[ "${NUMS_TPU_HW_TESTS:-0}" != "0" ]]; then
  echo "== GPU tier =="
  python chip_smoke.py
fi

echo "CI GATE: ALL GREEN"
