#!/usr/bin/env bash
# The command lines behind the files of this folder: the initial-draw
# study of ROADMAP item 24 (ips_tpu_torch/scripts/init_study.py and its
# JAX arm, tests/torch_init_study_jax.py). From the root of the checkout:
#
#   bash ips_tpu_torch/results/init_study/run.sh draws         # CPU
#   bash ips_tpu_torch/results/init_study/run.sh calibration   # CPU
#   bash ips_tpu_torch/results/init_study/run.sh reduced       # CPU
#   chiprun --timeout 3300 -- bash ips_tpu_torch/results/init_study/run.sh card_a
#   chiprun --timeout 1500 -- bash ips_tpu_torch/results/init_study/run.sh card_b
#   bash ips_tpu_torch/results/init_study/run.sh tally
#
# `draws` writes both packages' initial draws at seeds 0-7 into
# chiprun_in/draws (gitignored; the chip tool copies it, so the card
# steps read JAX's draws there; the draws are the same bytes at both
# widths). The CPU steps run four processes at once, each pinned to two
# cores; the card steps run three or two processes on one card. Every
# step's processes share one store, written by the first under a lock
# into a temporary directory. Each step writes the files of the same
# name as this folder's into $OUT (default chiprun_out/study, which the
# chip tool brings back): `name.jsonl` from --out and, on the card,
# `name.log` from standard output.
set -euo pipefail
step=${1:?"step: draws, calibration, reduced, card_a, card_b or tally"}
here=ips_tpu_torch/results/init_study
draws=chiprun_in/draws
out=${OUT:-chiprun_out/study}
study=(python -m ips_tpu_torch.scripts.init_study)
jax_arm=(env JAX_PLATFORMS=cpu python tests/torch_init_study_jax.py)
cores=(0-1 2-3 4-5 6-7)
store=$(mktemp -d)
trap 'rm -rf "$store"' EXIT
mkdir -p "$out"
pids=()
rc=0

finish() {   # wait for every process started; rc 1 if any failed
    local p
    for p in "${pids[@]}"; do
        wait "$p" || rc=1
    done
    pids=()
}

pinned() {   # pinned CORES NAME COMMAND...: one CPU run, in the background
    local c=$1 name=$2
    shift 2
    taskset -c "$c" "$@" --stop-when-learned --threads 2 \
        --out "$out/$name.jsonl" &
    pids+=($!)
}

card() {     # card NAME OPTIONS...: one card run, in the background
    local name=$1
    shift
    "${study[@]}" --width full --store "$store" "$@" --stop-when-learned \
        --out "$out/$name.jsonl" > "$out/$name.log" 2>&1 &
    pids+=($!)
}

case $step in
draws)
    "${jax_arm[@]}" --write-draws 0-7 --init-dir "$draws" ;;
calibration)   # JAX from its own draws at 1000 + 200 images: 0 of 4 learn
    for s in 0 1 2 3; do
        pinned "${cores[$s]}" "calib_d_$s" "${jax_arm[@]}" --width reduced \
            --store "$store" --n-train 1000 --n-test 200 \
            --init-dir "$draws" --init-seeds "$s"
    done
    finish ;;
reduced)       # the four arms at the frozen 2000 + 200 images, 15 epochs
    for s in 0 1 2 3 4 5 6 7; do
        r=(--width reduced --store "$store")
        pinned "${cores[0]}" "a_$s" "${study[@]}" "${r[@]}" --device cpu \
            --port-seeds "$s"
        pinned "${cores[1]}" "b_$s" "${study[@]}" "${r[@]}" --device cpu \
            --init-dir "$draws" --init-seeds "$s"
        pinned "${cores[2]}" "c_$s" "${jax_arm[@]}" "${r[@]}" \
            --init-dir "$draws" --init-name port --init-seeds "$s"
        pinned "${cores[3]}" "d_$s" "${jax_arm[@]}" "${r[@]}" \
            --init-dir "$draws" --init-seeds "$s"
        finish
    done ;;
card_a)        # 12 epochs a draw
    card card_p12 --port-seeds 1-2
    card card_p34 --port-seeds 3-4
    card card_p5j --port-seeds 5 --init-dir "$draws" --init-seeds 2-5
    finish ;;
card_b)
    card card_p0 --port-seeds 0
    card card_j01 --init-dir "$draws" --init-seeds 0-1
    finish ;;
tally)
    "${study[@]}" --tally "$here"/card/*.jsonl "$here"/reduced/*.jsonl ;;
*)
    echo "unknown step: $step" >&2
    exit 2 ;;
esac
exit $rc
