#!/usr/bin/env bash
# A/B of chip_smoke.py between a parent commit and the working tree, on one
# card, each side run from a checkout that holds only what git would commit.
#
#   path_tracer_tpu_torch/scripts/ab_smoke.sh prepare [PARENT]
#       In a git checkout: unpack PARENT (default HEAD) into build/ab/parent
#       and the working tree as `git add -A` would stage it (through a
#       temporary index; the real index is left alone) into build/ab/change.
#   path_tracer_tpu_torch/scripts/ab_smoke.sh run
#       On the machine with the card, from the repo root: run chip_smoke.py
#       in the order parent, change, change, parent, each from its own
#       checkout (so each builds its kernels from its own sources), then the
#       change's `gpu`-marked tests.  Logs go to chiprun_out/<side>_<n>.log,
#       each run's JSON record to chiprun_out/<side>_<n>.json and the tests'
#       output to chiprun_out/gpu_tests.log.  Exits non-zero if any run did.
set -u
cd "$(dirname "$0")/../.."
AB=build/ab

case "${1:-}" in
prepare)
    parent="${2:-HEAD}"
    rm -rf "$AB"
    mkdir -p "$AB/parent" "$AB/change"
    git archive "$parent" | tar -x -C "$AB/parent" || exit 1
    cp "$(git rev-parse --git-dir)/index" "$AB/index"
    tree=$(GIT_INDEX_FILE="$AB/index" git add -A \
           && GIT_INDEX_FILE="$AB/index" git write-tree) || exit 1
    rm -f "$AB/index"
    git archive "$tree" | tar -x -C "$AB/change" || exit 1
    echo "parent $(git rev-parse "$parent") change tree $tree"
    ;;
run)
    mkdir -p chiprun_out
    nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
    status=0
    n_parent=0
    n_change=0
    for side in parent change change parent; do
        if [ "$side" = parent ]; then
            n_parent=$((n_parent + 1)); n=$n_parent
        else
            n_change=$((n_change + 1)); n=$n_change
        fi
        log="chiprun_out/${side}_${n}.log"
        (cd "$AB/$side" && timeout 1200 python3 chip_smoke.py) > "$log" 2>&1
        rc=$?
        [ "$rc" -eq 0 ] || status=1
        cp "$AB/$side/chiprun_out/chip_smoke.json" \
           "chiprun_out/${side}_${n}.json" 2>/dev/null
        echo "${side}_${n} rc $rc"
        tail -n 2 "$log"
    done
    (cd "$AB/change" && timeout 600 python3 -m pytest tests/test_torch_*.py \
        -q -m gpu -p no:cacheprovider) > chiprun_out/gpu_tests.log 2>&1
    rc=$?
    [ "$rc" -eq 0 ] || status=1
    echo "gpu tests rc $rc"
    tail -n 1 chiprun_out/gpu_tests.log
    exit $status
    ;;
*)
    echo "usage: $0 prepare [PARENT] | run" >&2
    exit 2
    ;;
esac
