#!/usr/bin/env bash
# The PyTorch port's protocol fast lane (the twin of scripts/check.sh's):
# the port's protocol lints, the bounded model check of Tables I-III with
# every distinct transition replayed on the port's core.protocol and its
# LeaseEngine, then the port's verification tests against the JAX package.
# Runs on the CPU (the engine's device backend on CPU tensors runs the
# lease kernels' plain versions); on a machine with the card, pass
# "--backend device --device cuda" lanes by hand (scripts/model_check_torch.py).
#
#   bash scripts/check_torch.sh            # everything
#   bash scripts/check_torch.sh -k tso     # extra args go to pytest
set -euo pipefail
cd "$(dirname "$0")/.."

export PYTHONPATH="src${PYTHONPATH:+:$PYTHONPATH}"
export JAX_PLATFORMS="${JAX_PLATFORMS:-cpu}"

# lint rules 1 (table ownership) and 2 (kernel oracles) on src/repro_torch
python -m pytest -q tests/test_torch_lint.py

# bounded exhaustive model check: 2 cores / 1 block close under SC and TSO
python scripts/model_check_torch.py --cores 2 --blocks 1 --lease 2 \
    --ts-bits 2
python scripts/model_check_torch.py --cores 2 --blocks 1 --lease 2 \
    --ts-bits 2 --consistency tso --backend device --device cpu

python -m pytest -q tests/test_torch_model_check.py tests/test_torch_litmus.py \
    tests/test_torch_coherence_policy.py tests/test_torch_lease_engine.py "$@"

echo "check_torch.sh: all green"
