#!/usr/bin/env bash
# Tier-1 CI of the PyTorch port (src/repro_torch): its contract checks,
# its tests and its smokes, on the CPU.
#
#     bash scripts/ci_torch.sh
#
# scripts/ci.sh stays the JAX reference's entry point.  The smokes run
# with --device cpu here; without it they run on the card (cuda), as every
# entry point of the port does.
set -euo pipefail
cd "$(dirname "$0")/.."

export PYTHONPATH="src${PYTHONPATH:+:$PYTHONPATH}"
export JAX_PLATFORMS="${JAX_PLATFORMS:-cpu}"

echo "== portlint (python -m repro_torch.analysis) =="
python -m repro_torch.analysis src/repro_torch chip_smoke.py \
    scripts/smokes_torch examples/*_torch.py

echo "== pytest (the port's tests, parity with the reference) =="
python -m pytest -q tests/test_torch_*.py

for smoke in registry serve serve_async scenarios straggler elastic kernel \
             mesh; do
    echo "== $smoke smoke (--device cpu) =="
    python "scripts/smokes_torch/$smoke.py" --device cpu
done

echo "CI (port) OK"
