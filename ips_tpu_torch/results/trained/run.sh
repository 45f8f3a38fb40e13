#!/usr/bin/env bash
# The command lines behind the files of this folder: the JAX package's
# TPU-trained MNIST checkpoints carried to the port
# (tests/torch_jax_checkpoints.py, JAX side, CPU) and evaluated, probed
# and resumed by the port (ips_tpu_torch/scripts/trained_eval.py). From
# the root of the checkout:
#
#   bash ips_tpu_torch/results/trained/run.sh write        # CPU, JAX
#   bash ips_tpu_torch/results/trained/run.sh calibrate    # CPU, both
#   bash ips_tpu_torch/results/trained/run.sh full_eval    # CPU, JAX
#   OUT=DIR bash ips_tpu_torch/results/trained/run.sh card   # on the card
#   bash ips_tpu_torch/results/trained/run.sh kept_fp32    # CPU, both
#   bash ips_tpu_torch/results/trained/run.sh near_tie_jax # CPU, JAX
#
# `write` writes the three .npz files and manifest.json here from
# ckpt_mnist150/{100,150} and ckpt_mnist40/44 (the card's machine has no
# JAX; these files are its only copy of the trained weights).
# `calibrate` runs, on the first 160 test images of the shipped store,
# the JAX package's eval under each run's overrides and in fp32 and its
# Predictor (calibration/jax_cpu_160.json), then the port's eval and
# Predictor on the CPU (calibration/port_cpu_160.jsonl). `full_eval`
# runs the JAX package's eval of mnist40_e44 over the whole test split
# (calibration/jax_full_eval.json). `card` runs every mode of
# trained_eval on the card into $OUT: card.jsonl from --out, card.log
# from standard output; card/card.jsonl here is such a run's file.
# `kept_fp32` runs both packages' Predictors in fp32 on the CPU on the
# images whose card kept set parted from JAX's without a near tie the card
# could see (calibration/kept_fp32.json). `near_tie_jax` replays the JAX
# Predictor's selection of the first 160 test images chunk by chunk in
# each run's dtype and in fp32 and, on every image whose two selections
# part, records the first step where they do, the gap at the M-th place
# of the run dtype's scores and the two scorings' largest difference
# and the fp32 replay's final kept set (calibration/near_tie_jax.json;
# ~5 min): bound (iv) accepts a kept set that parts from JAX's at a near
# tie on the card's side, or at one on JAX's where it equals JAX's fp32
# set. The CPU steps write into this folder; each step makes
# the shipped store in a temporary directory (SplitWriters, ~2 min on 8
# cores) unless $STORE names one.
set -euo pipefail
step=${1:?"step: write, calibrate, full_eval, card, kept_fp32 or near_tie_jax"}
here=ips_tpu_torch/results/trained
cal=$here/calibration
jax=(env JAX_PLATFORMS=cpu python tests/torch_jax_checkpoints.py)
te=(python -m ips_tpu_torch.scripts.trained_eval)
if [ -z "${STORE:-}" ]; then
    STORE=$(mktemp -d)
    trap 'rm -rf "$STORE"' EXIT
fi
mkdir -p "$cal"

case $step in
write)
    "${jax[@]}" write --out "$here" ;;
calibrate)
    # the JAX package reads the store the port writes (the same bytes:
    # tests/test_torch_mnist_shipped.py); the port's eval writes it first
    "${te[@]}" eval --device cpu --store "$STORE" --images 160 \
        --out "$cal/port_cpu_160.jsonl"
    "${jax[@]}" calibrate --store "$STORE" --images 160 \
        --out "$cal/jax_cpu_160.json" ;;
full_eval)
    [ -e "$STORE/test.npy" ] || python -m ips_tpu_torch.data.mnist "$STORE"
    "${jax[@]}" full-eval --store "$STORE" --out "$cal/jax_full_eval.json" ;;
kept_fp32)
    [ -e "$STORE/test.npy" ] || python -m ips_tpu_torch.data.mnist "$STORE"
    "${jax[@]}" kept-fp32 --store "$STORE" --card "$here/card/card.jsonl" \
        --out "$cal/kept_fp32.json" ;;
near_tie_jax)
    [ -e "$STORE/test.npy" ] || python -m ips_tpu_torch.data.mnist "$STORE"
    "${jax[@]}" near-tie-jax --store "$STORE" --images 160 \
        --card "$here/card/card.jsonl" --out "$cal/near_tie_jax.json" ;;
card)          # every mode runs; rc 1 if any failed or missed a bound
    out=${OUT:?"set OUT to the directory for card.jsonl and card.log"}
    mkdir -p "$out"
    rc=0
    run() { "${te[@]}" "$@" --store "$STORE" --out "$out/card.jsonl" \
        >> "$out/card.log" 2>&1 || rc=1; }
    run eval
    run eval --images 160 --against "$cal/jax_cpu_160.json" \
        --calibration "$cal/port_cpu_160.jsonl" \
        --jax-ties "$cal/near_tie_jax.json"
    run int8
    run resume --file mnist150_e100 --epochs 2
    run resume --file mnist40_e44
    grep -E "^missed|Error|error" "$out/card.log" || true
    exit $rc ;;
*)
    echo "unknown step $step" >&2
    exit 2 ;;
esac
