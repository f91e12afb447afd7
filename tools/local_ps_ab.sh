#!/usr/bin/env bash
# Phase 11 of chip_smoke.py (two hosts of two ranks in PS mode on one
# card) for two trees in turns, on the card:
#
#     bash tools/local_ps_ab.sh OTHER_TREE OUT_DIR SIDE...
#
# OTHER_TREE is a second checkout (e.g. `git archive` of the parent
# unpacked into dist/, which is git-ignored and copied to the card's
# machine), SIDE is `this` or `other`, in the order to run them (e.g.
# other this this other). Both trees' kernels and C core are built first,
# in parallel. Each run's stderr goes to OUT_DIR/<n>_<side>.err; then
# each path's median step a rank and its five-way split are printed,
# after the card's name and power limit.
set -u
other=$1 out=$2
shift 2
mkdir -p "$out"
out=$(cd "$out" && pwd)
here=$(cd "$(dirname "$0")/.." && pwd)
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
(cd "$other" && python3 -c 'import chip_smoke as c; c.build_all()' \
    > /dev/null 2>&1) &
(cd "$here" && python3 -c 'import chip_smoke as c; c.build_all()' \
    > /dev/null 2>&1)
wait
i=0
for side in "$@"; do
    i=$((i + 1))
    if [ "$side" = other ]; then dir=$other; else dir=$here; fi
    (cd "$dir" && python3 -c 'import chip_smoke as c; c.local_ps_phase()' \
        > "$out/${i}_${side}.out" 2> "$out/${i}_${side}.err")
    echo "run $i $side rc=$?"
done
python3 - "$out" <<'PY'
import glob
import json
import os
import sys

for f in sorted(glob.glob(os.path.join(sys.argv[1], "*.err"))):
    for line in open(f, errors="replace"):
        if line.startswith("phase 11 (two hosts of two ranks, PS):"):
            d = json.loads(line.split(":", 1)[1])
            print(os.path.basename(f), "fleet_s", round(d["fleet_s"], 1))
            for label, m in d["gates"]["medians"].items():
                print(" ", label, "step", [round(x, 1) for x in m["step_ms"]],
                      {k: [round(x, 1) for x in v]
                       for k, v in m["split_ms"].items()})
PY
