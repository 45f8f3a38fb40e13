#!/usr/bin/env bash
# The command behind the file of this folder: the JAX package's side of
# the README demo's learning count (tests/torch_demo_jax.py, CPU), which
# chip_smoke.py's phase demo prints beside the port's count on the card.
# From the root of the checkout:
#
#   bash ips_tpu_torch/results/demo/run.sh
#
# It runs examples/minimal_ips.py's loop (60 steps) at draws 0-7 (draw s:
# make_task from default_rng(s), the config's seed s, PRNGKey(s) folded
# with each step; draw 0 is the script as shipped) and writes each
# draw's per-step losses, batch accuracies, last-10-step mean loss and
# kept indices to jax_cpu.json here.
set -euo pipefail
JAX_PLATFORMS=cpu python tests/torch_demo_jax.py --seeds 0-7 --steps 60 \
    --out ips_tpu_torch/results/demo/jax_cpu.json
