#!/usr/bin/env bash
# The PyTorch port's protocol fast lane (the twin of scripts/check.sh's):
# the port's protocol lints, the bounded model check of Tables I-III with
# every distinct transition replayed on the port's core.protocol and its
# LeaseEngine, the port's verification tests against the JAX package, then
# the twins of check.sh's CLI smokes (the one-cell dry run, the serving
# example under the sanitizer, the moe, 2-host and prefill/decode serves).
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

# the CLI smokes of scripts/check.sh on the port, on the CPU (each serving
# smoke passes --device cpu: the plain versions of the kernels).
# 1-cell dry run on the production mesh shapes (a fake 256-rank group)
out="$(mktemp -t dryrun_torch_check_XXXX.json)"
python -m repro_torch.launch.dryrun --mesh single --archs tinyllama-1.1b \
    --shapes decode_32k --no-hlo --out "$out"
python - "$out" <<'EOF'
import json, sys
recs = json.load(open(sys.argv[1]))
ok = [r for r in recs if r["status"] == "ok"]
assert ok, f"no ok cells: {recs}"
assert any(r.get("flops_total", 0) > 0 for r in ok), \
    f"no nonzero flops: {recs}"
print(f"dryrun smoke: {len(ok)} ok cell(s), nonzero flops")
EOF
rm -f "$out"

# serving smoke: continuous-batching paged decode through the LeaseEngine
# pool and a mid-stream weight hot-swap, under the lease sanitizer
TARDIS_SANITIZE=1 python examples/serve_tardis_torch.py --replicas 2 \
    --requests 16 --max-new 4 --layers 2 --d-model 64 --check --device cpu

smoke="$(mktemp -d -t serve_torch_check_XXXX)"
trap 'rm -rf "$smoke"' EXIT
# moe serving smoke: kimi-k2 scaled down pages BOTH cache stacks
python -m repro_torch.launch.serve --arch kimi-k2-1t-a32b --replicas 2 \
    --requests 6 --max-new 2 --max-batch 2 --device cpu \
    | tee "$smoke/moe.out"
grep -Eq "pool_tokens_appended_dense +[1-9]" "$smoke/moe.out"
grep -Eq "pool_tokens_appended_moe +[1-9]" "$smoke/moe.out"

# multi-host smoke: host 1 serves the prefix host 0 prefilled from
# migrated pages, with zero multicast / invalidation traffic
TARDIS_SANITIZE=1 python -m repro_torch.launch.serve --arch tinyllama-1.1b \
    --hosts 2 --replicas 1 --requests 6 --max-new 2 --prefix-len 16 \
    --prefix-block 4 --decode-pages 64 --max-pages 16 --max-batch 2 \
    --device cpu | tee "$smoke/xhost.out"
grep -Eq "host1_prefix_prefill_tokens_skipped +[1-9]" "$smoke/xhost.out"
grep -Eq "host1_xhost_pages_fetched +[1-9]" "$smoke/xhost.out"
grep -Eq "xhost_multicasts +0" "$smoke/xhost.out"
grep -Eq "xhost_invalidation_msgs +0" "$smoke/xhost.out"

# disaggregated smoke: the decode pod never prefills a cold prefix
TARDIS_SANITIZE=1 python -m repro_torch.launch.serve --arch tinyllama-1.1b \
    --roles prefill,decode --replicas 1 --requests 6 --max-new 2 \
    --prefix-len 16 --prefix-block 4 --decode-pages 64 --max-pages 16 \
    --max-batch 2 --device cpu | tee "$smoke/disagg.out"
grep -Eq "host1_role_cold_prefills +0" "$smoke/disagg.out"
grep -Eq "host0_role_prefill_jobs +[1-9]" "$smoke/disagg.out"
grep -Eq "host1_prefix_prefill_tokens_skipped +[1-9]" "$smoke/disagg.out"
grep -Eq "xhost_notifies +[1-9]" "$smoke/disagg.out"
grep -Eq "xhost_multicasts +0" "$smoke/disagg.out"

echo "check_torch.sh: all green"
