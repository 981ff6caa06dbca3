#!/bin/bash
# The dry-run's every (arch x input shape) combination at each mesh given
# (default: 256 and 8 cards), JOBS processes at a time (default: one a
# core), the slowest traces first (hymba-1.5b's and xlstm-350m's
# train_4k and prefill_32k: their Mamba scan and sLSTM loop trace op by
# op). Prints each combination's [dryrun] line or its failure,
# then the wall seconds; exits 1 if any combination failed. ARCHS (a
# space-separated list) keeps those archs only.
#
#   bash scripts/dryrun_all.sh [DEVICES ...] > dryrun_all.log
#   ARCHS="smollm-360m granite-3-2b yi-6b deepseek-67b" bash scripts/dryrun_all.sh 256 8
#   PYTHONPATH=src python scripts/dryrun_table.py dryrun_all.log  # the table
cd "$(dirname "$0")/.." || exit 1
export PYTHONPATH=src${PYTHONPATH:+:$PYTHONPATH}
start=$(date +%s)
python - "$@" <<'PY' | xargs -P "${JOBS:-$(nproc)}" -L 1 sh -c '
  out=$(python -m repro_torch.launch.dryrun --no-save --devices "$0" --arch "$1" --shape "$2" 2>&1)
  rc=$?
  printf "%s\n" "$out" | grep "^\[dryrun\] " | grep -v "traced OK\|failures$"
  [ $rc -eq 0 ] || printf "%s\n" "$out" | tail -n 3 | sed "s/^/[dryrun]   /"
  exit $rc'
import os
import sys
from repro_torch.configs import ASSIGNED_ARCHS, INPUT_SHAPES
slow = {(a, s) for a in ("hymba-1.5b", "xlstm-350m") for s in ("train_4k", "prefill_32k")}
archs = os.environ.get("ARCHS", "").split() or ASSIGNED_ARCHS
combos = [(d, a, s) for d in sys.argv[1:] or ["256", "8"]
          for a in archs for s in INPUT_SHAPES]
for d, a, s in sorted(combos, key=lambda c: c[1:] not in slow):
    print(d, a, s)
PY
rc=$?
echo "[dryrun_all] wall=$(( $(date +%s) - start ))s rc=$rc"
[ $rc -eq 0 ]
