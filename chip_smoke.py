#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (ips_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card, ``nvcc`` and
``nvidia-smi``. It imports nothing of JAX or of the JAX package. Phases:

  1. device  — the card's name and power limit;
  2. build   — ``nvcc`` builds every kernel from csrc/, all at once, and
               prints each instantiation's registers, shared memory and
               spills (``-Xptxas -v``);
  3. kernels — score_logits against its plain PyTorch version at the
               shapes of the main path (and of later paths), with stated
               tolerances; then both kernels' device times, their plain
               versions' and their library calls' from
               ``scripts/kernel_times.py`` in a process of its own (the
               profiler's where every profile was whole, else CUDA-event
               times, as each entry's ``ms_by`` says);
  4. predict — the main path: ``Predictor`` at the full megapixel-MNIST
               width (config/mnist_config.yml, random weights from the
               seed), several requests, launch counts and output checks,
               and the same selection with the plain scorer;
  5. train   — the training path: ``IPSTrainer.fused_multi_step`` at the
               same full width (K = steps_per_dispatch = 8 steps a call,
               dropout 0.1, shuffle), step time, peak memory and
               ``score_logits`` launches per step (8); an overfit check of
               20 ``fused_step``s on one batch; one small fp32 step scored
               by the kernel held against the same step scored by the
               plain version on the card and on the CPU; a profiler
               breakdown of one full-width step; one batch's pre-encoded
               selection (``preencode_chunked``) against the per-chunk
               one, and what ``preencode_select='auto'`` resolves to;
  6. cli     — ``ips_tpu_torch.infer.main`` on two .npy inputs and a
               ``torch.save`` checkpoint in a temporary directory;
  7. driver  — the training driver, ``ips_tpu_torch.main.main``, at the
               shipped config (sparse input densified on the card, K = 8)
               on a megapixel-MNIST set the port's generator writes at
               1500x1500 (128 train, 32 test images, synthetic digits):
               2 epochs with checkpoints and metrics lines, 8
               ``score_logits`` launches per step and per eval batch,
               densify on the card against the CPU, a checkpoint restored
               bitwise, a resumed run that trains only the next epoch, ms
               per step, peak memory and a profiler breakdown of one
               epoch with the device's idle share;
  8. parallel — data and exact context parallelism at the same full
               width on phase driver's store, two ranks sharing cuda:0
               over gloo (``ips_tpu_torch.parallel``): one K = 8 group of
               fused sparse steps at 2x1 and at 1x2 from the seed's
               weights against one process (kept sets equal or parted
               at a near tie, losses within a stated bound, parameters,
               AdamW moments and running statistics bitwise equal on both
               ranks, rank 0's ``score_logits`` launches), the local merge
               over the 2 ranks against one process's, ms a step and the
               collectives' CUDA-event ms (two ranks on one card: no
               multi-card speed); the CLI under
               ``torch.distributed.run`` as 2 ranks for one epoch against
               phase driver's epoch 0; a one-rank NCCL world whose 1x1
               sharded step is bitwise the single trainer's;
  9. camelyon — the camelyon feature-mode path through the driver
               (``ips_tpu_torch.main``) at the full width of
               config/camelyon_config.yml (2048-dim features projected to
               D = 512, M = I = 5000, B = 16 from B_seq = 1 slots, K = 4,
               bf16, ln_fold) on a synthetic corpus made from the seed (64
               train slides of 5001..10000 rows, one bucket; 16 test slides
               of 2000..15000 rows, buckets 5000 to 15000): 2 epochs, 16
               fp32 ``score_logits`` launches per optimizer step and one
               per 5000-row chunk beyond the first M in eval, metrics
               lines, one slide's selection against the plain scorer and
               its pre-encoded selection against the per-chunk one, what
               ``'auto'`` resolves to on the assembled step (pre-encode),
               epochs with each schedule in turns, ms per step, peak
               memory and a profiler breakdown of one epoch with the
               device's idle share. The card has no h5py, so
               the slides stay in memory (``CamelyonFeatures(slides=)``)
               and reach ``ips_tpu_torch.main.run``;
 10. camelyon_e2e — the camelyon end-to-end path through the driver at
               the full width of config/camelyon_e2e_config.yml (224x224x3
               uint8 tiles, ResNet-50 cut after layer2, D = 512, M = I =
               256, B = 8 from B_seq = 1, bf16, ``eager: false``: tiles
               in host memory streamed to the card in stages of G = 4
               chunks) with ``grad_encode_chunk = 32`` on synthetic slides
               made from the seed (8 train slides of 1281..2304 tiles, 4
               test slides in buckets 256 to 2304): 2 epochs, 8
               ``score_logits`` launches per train slide (64 per optimizer
               step) and 0/2/4/8 per test slide, the test probabilities
               behind the last AUC, one slide's selection
               against the plain scorer's, G = 4 against G = 1 bitwise,
               selection's peak memory on a 1280- and a 2304-tile slide
               within 64 MiB, ms per step, peak memory and the device's
               idle share over a profiled epoch;
 11. mnist_shipped — the training driver at the shipped MNIST config on
               the store as shipped: 5000 + 1000 images at 1500x1500 from
               the sklearn digits (the generator's defaults), written by
               two spawned processes, one a split, that start with the
               script; one epoch through ``ips_tpu_torch.main.main``: 313
               optimizer steps (39 K = 8 groups and a one-step group on
               the last batch, 8 rows padded to 16), 63 eval batches (the
               last of 8 rows), 8 ``score_logits`` launches per step and
               per eval batch, finite metrics lines, the first 4 train and
               2 test samples' digest against the JAX package's store's
               (``SHIPPED_DIGEST``); the store's generation and load
               seconds, host RSS, ms per step over the epoch, each group's
               and the eval batches' ms, peak memory, and the device's
               idle share over a window of the store that ends as the
               epoch does (2 K-groups and the one-step group);
 12. trained — the JAX package's TPU-trained MNIST checkpoints, carried
               to the port as flat ``.npz`` files
               (ips_tpu_torch/results/trained/), on phase mnist_shipped's
               store: ``train.loop.evaluate`` of ``mnist150_e150`` and
               ``mnist40_e44`` over the 1000 test images under each
               run's overrides, each task's accuracy and mean loss held
               against the TPU's line; the first served through
               ``infer.Predictor`` batch by batch with the eval's
               predictions image by image; the int8 probe on
               ``mnist40_e44`` (per-image Jaccard of int8 against bf16
               kept sets, int8 metrics) against the TPU's; the train
               state ``mnist150_e100`` written as the port's
               ``epoch_100.pt`` and resumed through ``main.run`` for one
               epoch, its lr, losses and test accuracy against the TPU's
               epoch 100 (bounds (i)-(iii) of
               ``scripts/trained_eval.BOUNDS``); 8 ``score_logits``
               launches per eval batch, request, selection and step;
 13. parallel_camelyon — streaming selection under a mesh and B_seq < B
               over data ranks at the full width of both camelyon configs,
               two ranks sharing cuda:0 over gloo, each making phase
               camelyon_e2e's and phase camelyon's corpora from the seed:
               (a) the streamed selection of a 2304-tile train slide at
               1x2, every stage of each rank holding 128 of each chunk's
               256 tiles, its kept indices against one process's (or
               parted at a near tie), 8 launches a rank, each rank's peak
               beside one process's and no larger; (b) camelyon_e2e
               through ``main.run`` at 2x1 for one epoch (one optimizer
               step of B = 8, 4 slides a rank, the 8 train slides as the
               test set, so that one full eval batch runs): the loss
               against one process's step on the same slides in the same
               order, every kept set, the eval predictions, state bitwise
               equal on both ranks, rank 0 alone writing metrics; (c)
               camelyon features through ``main.run`` at 2x1 for one
               epoch (one K = 4 group of B = 16 steps, 8 slots a rank):
               per-step losses against one process's on the same batches,
               state bitwise equal, the test set's buckets of fewer than
               B slides evaluating nothing (``drop_last``); ms a step and
               peaks, which are no multi-card speeds;
 14. traffic — the traffic-sign path through the driver at the full width
               of config/traffic_config.yml (1200x1600 RGB, N = 192
               patches of 100x100x3, M = 10, I = 32, B = 16, ResNet-18
               with all 4 blocks, D = 512, bf16, fp32 host normalization,
               8 loader threads) on a synthetic STS corpus made in memory
               from the seed (46 images a set): 2 epochs (the dense eager
               schedule, padded tail batches), 6 ``score_logits``
               launches per step and per eval batch, metrics lines, the
               saved checkpoint restored bitwise, one augmented batch's
               finite predictions and its selection against the plain
               scorer's, a train item's host time (augment, normalize and
               patchify), ms per step, peak memory and a profiler
               breakdown of one epoch with the device's idle share;
 15. hostops — the C++ host library (csrc/hostops.cpp) built with g++ on
               this machine (build seconds), ``densify_patchify``,
               ``patchify_dense`` and ``gather_patches`` (float32, into a new
               array and into a pinned buffer) bitwise against their numpy
               versions at the MNIST shapes (16 images of 1500x1500, 900
               patches of 50x50, a chunk of I = 100), host ms of each
               against numpy's;
 16. int8    — int8 selection (``select_dtype: int8``) at the full MNIST
               width: one select against the plain scorer's int8 selection
               (near-ties allowed), its device ms against the bf16
               selection's on the same batch; 4 ``Predictor`` requests (8
               launches each, finite outputs); the driver on dense input
               densified on the host by the C++ library (128 + 32 images,
               2 epochs, the launches the chunks say, finite losses, the
               checkpoint restored bitwise, ms per step, peak and the
               device's idle share); one streamed int8 selection of a
               camelyon_e2e slide at full width (ResNet-50/2 bottleneck
               blocks, uint8 224x224 tiles) and its peak;
 17. export  — the export CLI's ``main`` (ips_tpu_torch/export.py) on
               the full-width MNIST Predictor on the card with
               ``--selftest``; the artifact
               loaded in a fresh process that imports only
               ``ips_tpu_torch.ops.score_kernel``, 4 requests there (8
               ``score_logits`` launches each inside the program), its
               selected indices equal to the live Predictor's and its
               probabilities within 1e-5; artifact size, load seconds,
               request latency against the live Predictor; the operator's
               dispatch against the direct ctypes call;
 18. preprocess — the slide-preprocessing pipeline and pretrained weights
               (``ips_tpu_torch.data.camelyon`` synth, otsu, foreground,
               extract_feat; ``models.pretrained``): 4 train and 2 test
               slides of 5600x5600 made in memory from the seed; otsu
               thresholds and foreground tiles (256 px, fg 0.01) in worker
               processes while the next slide is made; a seeded
               torchvision-layout ResNet-50 state dict converted to an
               .npz and loaded with full cover; the features of every
               tile by the pipelined encoder (224 crops, batch 64,
               ResNet-50 with 4 stages, bf16, 2048-d): tiles/s, peak
               memory, the device's busy and idle share; gates: finite
               (n, 2048) fp32 features, pos and labels as the foreground
               table and the slides say, the pipeline bitwise equal to a
               synchronous loop, the first 8 tiles within a stated bf16
               tolerance of the CPU forward; then one evaluation of the
               camelyon feature config on those features;
 19. conv_probe — the fused BasicBlock kernel against its plain version
               at the layer1 shapes (1600, 13, 13, 64), paired
               (800, 13, 13, 128), a ragged one and layer2_block1's
               (1600, 7, 7, 128), timed in phase kernels; the main
               path's encoder layer1 timed at the same shape; then the
               layer1 conv probe (``ips_tpu_torch.scripts.probe_conv``)
               at its real shape, its kernel launches counted.

Any failed phase raises, so the script exits non-zero. The line before
the last is a JSON object with one entry per kernel; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from collections import Counter

# config/mnist_config.yml as a literal: the card machine has no pyyaml.
# tests/test_torch_config.py holds it equal to the YAML file.
MNIST_CONFIG = {
    "n_epoch": 150, "B": 16, "B_seq": 16, "n_epoch_warmup": 10, "lr": 0.001,
    "wd": 0.1, "n_class": 10,
    "data_dir": "data/megapixel_mnist/dsets/megapixel_mnist_1500",
    "n_worker": 8, "pin_memory": True, "eager": True, "eps": 1e-06,
    "seed": 0, "track_efficiency": False, "track_epoch": 0,
    "is_image": True, "enc_type": "resnet18", "pretrained": False,
    "n_chan_in": 1, "n_res_blocks": 2, "shuffle": True,
    "shuffle_style": "batch", "n_token": 4, "N": 900, "M": 100, "I": 100,
    "patch_size": [50, 50], "patch_stride": [50, 50], "use_pos": True,
    "H": 8, "D": 128, "D_k": 16, "D_v": 16, "D_inner": 512,
    "attn_dropout": 0.1, "dropout": 0.1,
    "tasks": {
        "task0": {"id": 0, "name": "majority", "act_fn": "softmax",
                  "metric": "accuracy"},
        "task1": {"id": 1, "name": "max", "act_fn": "softmax",
                  "metric": "accuracy"},
        "task2": {"id": 2, "name": "top", "act_fn": "softmax",
                  "metric": "accuracy"},
        "task3": {"id": 3, "name": "multi", "act_fn": "sigmoid",
                  "metric": "multilabel_accuracy"},
    },
    "compute_dtype": "bfloat16", "use_pallas": False, "mesh_data": 1,
    "mesh_patch": 1, "sparse_input": True, "input_dtype": "bfloat16",
    "steps_per_dispatch": 8,
}

# config/camelyon_config.yml as a literal, held equal to the YAML file by
# the same test.
CAMELYON_CONFIG = {
    "n_epoch": 50, "B": 16, "B_seq": 1, "n_epoch_warmup": 10, "lr": 0.0003,
    "wd": 0.1, "n_class": 1, "data_dir": "data/camelyon/dsets",
    "train_fname": "feat_train_500ep.hdf5",
    "test_fname": "feat_test_500ep.hdf5", "n_worker": 64,
    "pin_memory": False, "eager": True, "eps": 1e-06, "seed": 0,
    "track_efficiency": False, "track_epoch": 0, "is_image": False,
    "enc_type": "resnet50", "pretrained": False, "n_chan_in": 2048,
    "shuffle": True, "shuffle_style": "batch", "n_token": 1, "M": 5000,
    "I": 5000, "use_pos": False, "H": 8, "D": 512, "D_k": 64, "D_v": 64,
    "D_inner": 2048, "attn_dropout": 0.1, "dropout": 0.1,
    "tasks": {"task0": {"id": 0, "name": "metastases", "act_fn": "sigmoid",
                        "metric": "auc"}},
    "compute_dtype": "bfloat16", "use_pallas": False, "mesh_data": 1,
    "mesh_patch": 1, "ln_fold": True, "steps_per_dispatch": 4,
}

# config/camelyon_e2e_config.yml as a literal, held equal to the YAML file
# by the same test.
CAMELYON_E2E_CONFIG = {
    "n_epoch": 50, "B": 8, "B_seq": 1, "n_epoch_warmup": 5, "lr": 0.0003,
    "wd": 0.1, "n_class": 1, "data_dir": "data/camelyon/cam16",
    "n_worker": 8, "pin_memory": False, "eager": False,
    "stream_chunk_group": 4, "eps": 1e-06, "seed": 0,
    "track_efficiency": False, "track_epoch": 0, "is_image": True,
    "enc_type": "resnet50", "pretrained": False, "n_chan_in": 3,
    "n_res_blocks": 2, "shuffle": True, "shuffle_style": "batch",
    "n_token": 1, "M": 256, "I": 256, "patch_size": [224, 224],
    "patch_stride": [224, 224], "use_pos": False, "H": 8, "D": 512,
    "D_k": 64, "D_v": 64, "D_inner": 2048, "attn_dropout": 0.1,
    "dropout": 0.1,
    "tasks": {"task0": {"id": 0, "name": "metastases", "act_fn": "sigmoid",
                        "metric": "auc"}},
    "compute_dtype": "bfloat16", "mesh_data": 1, "mesh_patch": 1,
}

# config/traffic_config.yml as a literal, held equal to the YAML file by
# the same test.
TRAFFIC_CONFIG = {
    "n_epoch": 150, "B": 16, "B_seq": 16, "n_epoch_warmup": 10, "lr": 0.0003,
    "wd": 0.1, "n_class": 4, "data_dir": "data/traffic/dsets",
    "n_worker": 8, "pin_memory": True, "eager": True, "eps": 1e-06,
    "seed": 0, "track_efficiency": False, "track_epoch": 0,
    "is_image": True, "enc_type": "resnet18", "pretrained": False,
    "n_chan_in": 3, "n_res_blocks": 4, "shuffle": True,
    "shuffle_style": "batch", "n_token": 1, "N": 192, "M": 10, "I": 32,
    "patch_size": [100, 100], "patch_stride": [100, 100], "use_pos": False,
    "H": 8, "D": 512, "D_k": 64, "D_v": 64, "D_inner": 2048,
    "attn_dropout": 0.1, "dropout": 0.1,
    "tasks": {"task0": {"id": 0, "name": "sign", "act_fn": "softmax",
                        "metric": "accuracy"}},
    "compute_dtype": "bfloat16", "use_pallas": False, "mesh_data": 1,
    "mesh_patch": 1,
}

SEED = 0
N_REQUESTS = 4
N_TIMED_DISPATCHES = 3      # timed fused_multi_step calls after a warm-up
N_OVERFIT_STEPS = 20
# megapixel MNIST's training set (ips_tpu/data/mnist.py: n_train=5000)
MNIST_TRAIN_IMAGES = 5000
# phase driver: one K = 8 group of B = 16 a train epoch, 2 eval batches
DRIVER_TRAIN_IMAGES, DRIVER_TEST_IMAGES, DRIVER_EPOCHS = 128, 32, 2
# phase mnist_shipped: the store as shipped, 5000 + 1000 images at
# 1500x1500 from the sklearn digits with the generator CLI's defaults
# (ips_tpu_torch/data/mnist.py), made by two spawned processes that start
# with the script; one epoch. 5000 = 312 * 16 + 8: the last train batch
# is 8 rows padded to 16, and 313 = 39 * 8 + 1 steps end in a K-group of
# one step; 1000 = 62 * 16 + 8 eval rows end in a batch of 8
SHIPPED_TRAIN_IMAGES, SHIPPED_TEST_IMAGES = 5000, 1000
# the store's first 4 train and 2 test samples (store_digest): what the
# JAX package's generator writes for that seed and source
# (tests/test_torch_mnist_shipped.py computes it from ips_tpu)
SHIPPED_DIGEST_SAMPLES = (4, 2)
SHIPPED_DIGEST = ("ea8830c53b89d04ec87a0d4a2fa8c14c"
                  "32270cb4b0d5c6cef75e263a2dd22634")
# seconds the phase waits for the store beyond the phases before it
SHIPPED_STORE_WAIT = 600
# phase trained: the JAX package's TPU-trained checkpoints as the port
# carries them (ips_tpu_torch/results/trained/, scripts/trained_eval.py)
# on phase mnist_shipped's store: the eval of both inference files, the
# Predictor on the first, the int8 probe on the second, one resumed epoch
# of the train state; the bounds (i)-(iii) of trained_eval.BOUNDS
TRAINED_EVAL = ("mnist150_e150", "mnist40_e44")
TRAINED_RESUME, TRAINED_RESUME_EPOCHS = "mnist150_e100", 1
# the idle share is taken as phase driver takes it, over a window of the
# store that ends as the epoch does: 2 K-groups and a one-step group on a
# padded batch (16 * 16 + 8 images), unprofiled and then profiled (a
# profile of the whole epoch holds ~800k device ops)
SHIPPED_WINDOW_IMAGES = 16 * 16 + 8
# phase camelyon: (slides, rows drawn from [lo, hi)) of the synthetic
# corpus; the train set is one K = 4 group of four B = 16 steps at the
# reference's N = 10k bucket, the test set crosses buckets 5000..15000
CAMELYON_TRAIN, CAMELYON_TEST = (64, (5001, 10001)), (16, (2000, 15001))
CAMELYON_EPOCHS = 2
# phase camelyon_e2e: 8 train slides of 1281..2304 tiles (bucket 2304: 8
# chunks after the first M, two groups of G = 4), one optimizer step of
# B = 8 an epoch; 4 test slides in buckets 256, 768, 1280 and 2304 (the
# M >= N shortcut, two single-chunk stages, one group, two groups)
E2E_TRAIN_SLIDES, E2E_TRAIN_TILES = 8, (1281, 2305)
E2E_TEST_TILES = (200, 700, 1200, 2000)
E2E_EPOCHS = 2
# the train step re-encodes B * M = 2048 tiles with gradients; in slices of
# B * 32 (the JAX package's own runs at this tile shape used 32)
E2E_GRAD_ENCODE_CHUNK = 32
# streaming selection's peak memory may not grow with N: a 2304-tile and a
# 1280-tile slide peak within this of each other
E2E_PEAK_TOL = 64 * 2**20

# phase traffic: a synthetic STS corpus in memory at the size of the JAX
# package's own traffic learning run, 1200 x 1600 (RESULTS.md), 46 images
# a set (cut from STS's ~750 train images): after the visibility filter
# 43 a split, 2 full batches of B = 16 and a padded tail of 11 (48 a set
# would leave 48 test images, no padded batch); 2 epochs
TRAFFIC_IMAGES, TRAFFIC_HW, TRAFFIC_EPOCHS = 46, (1200, 1600), 2
# host time of one train item, averaged over this many items
TRAFFIC_HOST_ITEMS = 4

# phase hostops: the MNIST dense data path's host functions at the shipped
# width, 1500x1500 images cut into 900 patches of 50x50, B = 16, and a
# chunk of I = 100 gathered from a (16, 900, 50, 50, 1) batch
HOSTOPS_IMAGES = 16
HOSTOPS_REPEATS = 5
# phase int8: the streamed camelyon_e2e slide is the second train slide of
# e2e_corpus (a tumour slide), made alone from the same seed
E2E_INT8_SLIDE = 1

# phase export: requests of the exported program in a fresh process
EXPORT_REQUESTS = 4

# phase preprocess: the CAMELYON16 workflow (synth -> otsu -> foreground ->
# extract_feat -> the feature trainer) on slides of the JAX package's own
# camelyon_e2e learning run, 5600 x 5600 (~94 MB of uint8 each): 2 normal
# and 2 tumour train slides, 2 test slides (one tumour); tiles of 256 at
# level 0, center-cropped to 224, batches of 64, ResNet-50 with 4 stages
PRE_COUNTS, PRE_HW = (2, 2, 2), 5600
PRE_TILE, PRE_FG, PRE_BATCH = 256, 0.01, 64
PRE_WORKERS = 4
# card (cuDNN) against CPU features of the same bf16 encoder: both round
# the same tensors to bf16, and a sum on the other side of a rounding
# boundary moves one value by a bf16 ulp that the later convs carry;
# relative Frobenius distance. On the H100 this reads 9.854e-4, and the
# control, the card's fp32 forward against the CPU's bf16, 3.311e-3: the
# limit lies between, so a forward that ignored the dtype fails it
PRE_FEAT_REL = 2e-3

# Kernel vs plain tolerances. Both accumulate the same fp32 products (bf16
# inputs are widened exactly), in another order: logits of magnitude ~1
# summed over D <= 512 terms differ by a few fp32 ulps of the partial sums.
LOGITS_RTOL, LOGITS_ATOL = 1e-5, 1e-4
SCORES_RTOL, SCORES_ATOL = 1e-4, 1e-6
# Fused block vs plain: the same exact bf16 products summed in fp32 in
# another order, then h and the output rounded to bf16, so a rounding can
# move by one bf16 ulp: at most 2^-7 |y|, 1.6e-2 for |y| < 4.
BLOCK_RTOL, BLOCK_ATOL = 1.6e-2, 1.6e-2
KERNELS = ("score_logits", "conv_block")

# phase parallel: worlds of ranks sharing cuda:0 (gloo), each with this
# deadline in seconds; the meshes (data, patch) of its checked groups;
# the generators' seed; repetitions of each timed collective
PARALLEL_TIMEOUT = 240
PARALLEL_MESHES = ((2, 1), (1, 2))
PARALLEL_SEED = 500
PARALLEL_REPEATS = 20
# Losses against one process's. The first step of a K group differs only
# by the global statistics summed in two halves and bf16 encodes of 8 rows
# instead of 16 (measured 8e-5 at 2x1, 0 at 1x2); later steps also by
# AdamW's first moves, about lr * sign(g), which carry gradients within
# rounding of 0 either way, and the near-tie selections they lead to
# (measured 3.3e-3 over the group; the 2-rank CLI's epoch-0 losses 2.1e-3
# from phase driver's; NVIDIA H100 80GB HBM3, 700 W; PERF.md §6).
PARALLEL_STEP0_TOL = 1e-3
PARALLEL_LOSS_TOL = 1e-2
PARALLEL_CLI_TOL = 1e-2

# phase parallel_camelyon: the world's deadline in seconds; (a) streams
# this train slide of phase camelyon_e2e's corpus (bucket 2304). (b)'s
# train loss against one process's step on the same 8 slides: the ranks
# encode 4 rows in bf16 where one process encodes 8, and sum the global
# statistics and the gradient in two halves, so they round apart (phase
# parallel read 8e-5 at MNIST's first step); the eval predictions after
# the step also carry AdamW's first moves, about lr * sign(g), of
# gradients within rounding of 0 (phase parallel: 3.3e-3 over a group).
PC_TIMEOUT = 480
PC_SLIDE = 1
PC_E2E_LOSS_TOL = 1e-3
PC_PRED_TOL = 1e-2


def log(msg: str) -> None:
    print(msg, flush=True)


class Phase:
    """Prints one progress line per phase with its wall time."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        log(f"[{self.name}] start")
        return self

    def __exit__(self, exc_type, exc, tb):
        dt = time.perf_counter() - self.t0
        log(f"[{self.name}] {'ok' if exc is None else 'FAILED'} "
            f"({dt:.2f} s)")
        return False


def phase_device(torch):
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    log(f"device: {name} (count {torch.cuda.device_count()}), torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    log(f"nvidia-smi: {card}")
    return name, card


def ptxas_resources(nvcc_out):
    """One line per kernel instantiation from nvcc's -Xptxas -v report:
    its (mangled) name, registers, shared memory, stack and spills."""
    lines, name, props = [], None, ""
    for raw in nvcc_out.splitlines():
        line = raw.strip()
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "bytes stack frame" in line:
            props = line
        elif line.startswith("ptxas info") and "Used" in line and name:
            lines.append(f"{name}: {line.split(':', 1)[1].strip()}; "
                         f"{props}")
            name, props = None, ""
    return lines


def phase_build():
    """One nvcc per kernel source, all started together."""
    from concurrent.futures import ThreadPoolExecutor
    from ips_tpu_torch.utils.cuda_build import build_library
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        built = list(pool.map(build_library, KERNELS))
    dt = time.perf_counter() - t0
    for path, out in built:
        for line in ptxas_resources(out):
            log(f"  ptxas: {line}")
        for line in out.splitlines():      # warnings and the like
            if line.strip() and not line.lstrip().startswith(
                    "ptxas info") and "bytes stack frame" not in line:
                log(f"  nvcc: {line.rstrip()}")
        log(f"built {os.path.relpath(path)}")
    log(f"built {len(built)} kernels in {dt:.2f} s")


def kernel_times():
    """Both kernels' device times, their plain versions' and their library
    calls' at the timed shapes, from ``scripts/kernel_times.py`` in a
    process of its own (profiles late in this long process lose kernel
    records; a fresh process's have not). Returns its rows by (kernel,
    case, dtype)."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    proc = subprocess.run(
        [sys.executable, "-m", "ips_tpu_torch.scripts.kernel_times"],
        cwd=root, env=env, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"kernel_times failed ({proc.returncode}):\n"
                           f"{proc.stdout[-4000:]}{proc.stderr[-4000:]}")
    rows = {}
    for line in proc.stdout.splitlines():
        if line.startswith("{"):
            r = json.loads(line)
            rows[r["kernel"], r["case"], r["dtype"]] = r
        elif line.startswith("card: "):
            log(f"  kernel_times {line}")
    return rows


def timing_fields(row, bound_ms):
    """The ``ms``, ``plain_ms`` and ``library_ms`` of a kernel_times row:
    the profiler's device times where all three profiles were whole, else
    all three CUDA-event times of back-to-back calls; ``ms_by`` says
    which. Logs both and every refused profile."""
    keys = ("ms", "plain_ms", "library_ms")
    by = "profiler" if None not in (row[k] for k in keys) else "events"
    for counts in row["refused_profiles"]:
        log(f"    refused a profile with kernel counts {counts}")
    if by == "events":
        log("    profiles refused: the times below are CUDA-event times")
    for k in keys:
        dev = "refused" if row[k] is None else f"{row[k] * 1e3:.2f} us"
        log(f"    {k}: device {dev}, per call in a back-to-back loop "
            f"{row['event_' + k] * 1e3:.2f} us (bound "
            f"{bound_ms * 1e3:.3f} us)")
    return dict({k: row[k if by == "profiler" else "event_" + k]
                 for k in keys}, ms_by=by)


def phase_kernels(torch, np, device):
    """score_logits against its plain version, then both kernels' times in
    a process of their own; returns the JSON entry for the main-path
    shape, with every timed shape under ``shapes``, and the times."""
    from ips_tpu_torch.ops import score_kernel as sk
    from ips_tpu_torch.scripts.kernel_times import LOGITS_CASES, logits_bound
    rng = np.random.default_rng(SEED)
    # the timed shapes, the MNIST selection shape first, and a ragged L
    cases = LOGITS_CASES + (("ragged", 4, 1037, 128, 32, "float32"),)
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    errs = {}
    for name, B, L, D, TH, dt in cases:
        x = torch.from_numpy(rng.standard_normal((B, L, D), np.float32)
                             ).to(device, dtypes[dt])
        w = torch.from_numpy(0.1 * rng.standard_normal((D, TH), np.float32)
                             ).to(device, dtypes[dt])
        got = sk.logits(x, w)
        ref = sk.plain_logits(x, w)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        torch.testing.assert_close(got, ref, rtol=LOGITS_RTOL,
                                   atol=LOGITS_ATOL)
        torch.testing.assert_close(sk.scores(x, w), sk.fast_scores(x, w),
                                   rtol=SCORES_RTOL, atol=SCORES_ATOL)
        errs[name, dt] = err
        log(f"  logits {name} B={B} L={L} D={D} TH={TH} {dt}: max|err| "
            f"{err:.3e} (rtol {LOGITS_RTOL}, atol {LOGITS_ATOL}); scores "
            "match the plain epilogue")

    # masked scores: row 0 fully masked (must be uniform), row 1 ragged
    B, L, D, TH = 16, 200, 128, 32
    x = torch.from_numpy(rng.standard_normal((B, L, D), np.float32)
                         ).to(device)
    w = torch.from_numpy(0.1 * rng.standard_normal((D, TH), np.float32)
                         ).to(device)
    mask = torch.ones((B, L), dtype=torch.bool, device=device)
    mask[0] = False
    mask[1, -37:] = False
    got = sk.scores(x, w, mask)
    torch.testing.assert_close(got, sk.fast_scores(x, w, mask),
                               rtol=SCORES_RTOL, atol=SCORES_ATOL)
    torch.testing.assert_close(got[0], torch.full_like(got[0], 1.0 / L),
                               rtol=1e-6, atol=0.0)
    if got[1, -37:].max().item() > 1e-6:
        raise AssertionError("masked candidates took softmax mass")
    log("  masked scores: match plain; fully masked row uniform")

    # the camelyon path's masked scores: one fp32 slide padded to its
    # bucket, 7313 valid rows of 10000
    L, D, TH, n_valid = 10000, 512, 8, 7313
    x = torch.from_numpy(rng.standard_normal((1, L, D), np.float32)
                         ).to(device)
    w = torch.from_numpy(0.1 * rng.standard_normal((D, TH), np.float32)
                         ).to(device)
    mask = (torch.arange(L, device=device) < n_valid)[None]
    got = sk.scores(x, w, mask)
    torch.testing.assert_close(got, sk.fast_scores(x, w, mask),
                               rtol=SCORES_RTOL, atol=SCORES_ATOL)
    if got[0, n_valid:].max().item() > 1e-6:
        raise AssertionError("padded rows of a slide took softmax mass")
    log(f"  masked camelyon scores (1, {L}) with {n_valid} valid rows: "
        "match plain; padded rows take no mass")
    times = kernel_times()
    shapes = []
    for name, B, L, D, TH, dt in LOGITS_CASES:
        bound, bound_by = logits_bound(B, L, D, TH, dt)
        log(f"  timed logits {name} ({B}, {L}, {D})x({D}, {TH}) {dt}:")
        shapes.append(dict(
            {"case": name, "shape": [B, L, D, TH], "dtype": dt,
             "max_abs_err": errs[name, dt], "bound_ms": bound,
             "bound_by": bound_by},
            **timing_fields(times["score_logits", name, dt], bound)))
    main_entry = dict(
        {"name": "score_logits", "route": "cuda",
         "source": "ips_tpu_torch/csrc/score_logits.cu",
         "replaces": "ips_tpu/ops/score_kernel.py:88", "launches": None},
        **{k: v for k, v in shapes[0].items()
           if k not in ("case", "shape", "dtype")})
    main_entry["shapes"] = shapes
    return main_entry, times


def make_patches(np, conf, seed=SEED + 1):
    """A megapixel-MNIST-like batch: most patches blank, the rest random."""
    rng = np.random.default_rng(seed)
    ph, pw = conf.patch_size
    shape = (conf.B, conf.N, ph, pw, conf.n_chan_in)
    patches = rng.random(shape, dtype=np.float32)
    blank = rng.random((conf.B, conf.N)) < 0.7
    patches[blank] = 0.0
    return patches


def _plain_select(torch, model, conf, pos_table, x, mask, score, seed,
                  preencode=False, encode=None):
    """Eager selection of ``x`` scored by ``score``, in the schedule the
    path runs (``preencode``); with a ``seed``, the config's shuffle from
    a fresh generator of that seed on x's device. ``encode`` defaults to
    the model's."""
    from ips_tpu_torch.ops.selection import ips_select
    gen = (None if seed is None
           else torch.Generator(device=x.device).manual_seed(seed))
    with torch.inference_mode():
        return ips_select(encode or model.encode, score, x, M=conf.M,
                          I=conf.I, pos_table=pos_table, mask=mask,
                          generator=gen,
                          shuffle=seed is not None and conf.shuffle,
                          shuffle_style=conf.shuffle_style,
                          preencode=preencode,
                          preencode_chunked=conf.is_image)


def _table(torch, model, conf, x):
    """The pre-encoded (B, N, D) embeddings of x, built as the path builds
    them: for a conv encoder I patches at a time, zero-padded to a
    multiple of I; in one call else."""
    B, N, I = x.shape[0], x.shape[1], conf.I
    if not conf.is_image or N <= I:
        return model.encode(x)
    xp = torch.cat([x, x.new_zeros((B, -N % I) + x.shape[2:])], dim=1)
    return torch.cat([model.encode(xp[:, s:s + I])
                      for s in range(0, xp.shape[1], I)], dim=1)[:, :N]


def tie_report(torch, model, conf, pos_table, x, mask, seed, embed, other):
    """Replay the selection of ``x``: each step's candidates embedded by
    ``embed(idx)`` and scored by the model's scorer (the kernel), and
    scored again by ``other(idx, emb, valid)``. At the first step whose
    kept sets differ, return the gap at the M-th place of the kernel's
    scores and the two scorings' largest difference; None if no step
    differs."""
    from ips_tpu_torch.constants import NEG_INF
    from ips_tpu_torch.ops.selection import select_top_m
    from ips_tpu_torch.ops.shuffle import make_permutation
    M, I = conf.M, conf.I
    B, N = x.shape[:2]
    gen = (None if seed is None
           else torch.Generator(device=x.device).manual_seed(seed))
    with torch.inference_mode():
        perm = make_permutation(gen, B, N, mask,
                                seed is not None and conf.shuffle,
                                conf.shuffle_style, x.device)
        n_pad = M + -(-(N - M) // I) * I - N
        perm = torch.cat([perm, perm.new_zeros((B, n_pad))], dim=1)
        valid = (torch.arange(N + n_pad, device=x.device)[None]
                 < mask.sum(dim=1, keepdim=True))
        mem_idx, mem_valid = perm[:, :M], valid[:, :M]
        mem_emb = embed(mem_idx)
        for s in range(M, N + n_pad, I):
            idx = torch.cat([mem_idx, perm[:, s:s + I]], dim=1)
            ok = torch.cat([mem_valid, valid[:, s:s + I]], dim=1)
            emb = torch.cat([mem_emb, embed(perm[:, s:s + I])], dim=1)
            e = emb if pos_table is None else emb + pos_table[idx]
            k = torch.where(ok, model.scores(e, ok), NEG_INF)
            o = torch.where(ok, other(idx, e, ok), NEG_INF)
            ks = torch.sort(k, dim=1, descending=True, stable=True)
            os_ = torch.sort(o, dim=1, descending=True, stable=True)[1]
            diff = (ks[1][:, :M].sort(1)[0] != os_[:, :M].sort(1)[0]).any(1)
            if diff.any():
                r = int(diff.nonzero()[0])
                return {"row": r, "step": (s - M) // I,
                        "gap_at_M": float(ks[0][r, M - 1] - ks[0][r, M]),
                        "max_score_diff": float((k[r] - o[r]).abs().max())}
            mem_emb, mem_idx, mem_valid = select_top_m(
                emb, e, idx, ok, M, model.scores)
    return None


def _check_near_tie(report, what):
    """Two selections may part only at a near-tie: a gap at the M-th
    place within twice the largest difference of the two scorings."""
    log(f"  {what} differs; first differing step: {report}")
    if report is None or report["gap_at_M"] > 2 * report["max_score_diff"]:
        raise AssertionError(f"{what} differs away from a near-tie")


def check_plain_selection(torch, np, model, conf, pos_table, x, mask, idx,
                          seed=None, preencode=False, encode=None):
    """Selection scored by the plain version on the card, in the same
    schedule and with the same ``encode`` (the model's by default), gives
    the kernel's indices ``idx``, or parts from them only at a near-tie.
    With a ``seed``, both shuffle from generators of that seed."""
    from ips_tpu_torch.ops import score_kernel as sk
    encode = encode or model.encode
    res = _plain_select(
        torch, model, conf, pos_table, x, mask,
        lambda e, m: sk.fast_scores(e, model.score_weights(), m), seed,
        preencode, encode)
    plain_idx = res.mem_idx.cpu().numpy()
    if np.array_equal(plain_idx, idx):
        log("  plain-scorer selection: identical indices")
        return
    rows = torch.arange(x.shape[0], device=x.device)[:, None]
    with torch.inference_mode():
        table = _table(torch, model, conf, x) if preencode else None
    embed = ((lambda i: table[rows, i]) if preencode
             else (lambda i: encode(x[rows, i])))
    report = tie_report(
        torch, model, conf, pos_table, x, mask, seed, embed,
        lambda i, e, v: sk.fast_scores(e, model.score_weights(), v))
    _check_near_tie(report, f"plain-scorer selection (in "
                    f"{int((plain_idx != idx).any(1).sum())} rows)")


def check_preencode(torch, trainer, x, mask, what):
    """The pre-encoded selection of ``x`` keeps the per-chunk selection's
    indices (shuffled from generators of one seed), or parts from them
    only at a near-tie; logs what 'auto' resolves to for ``x`` alone."""
    model, conf = trainer.model, trainer.conf
    outs = {}
    for pe in (False, True):
        with torch.no_grad():
            outs[pe] = trainer._select_impl(
                x, mask, trainer.new_generator(SEED), return_emb=True,
                preencode=pe)
    # the kept sets, and the buffers' embeddings of the same patches
    kept = {pe: out[2].sort(dim=1) for pe, out in outs.items()}
    same = torch.equal(kept[True].values, kept[False].values)
    emb = {pe: torch.take_along_dim(outs[pe][4], kept[pe].indices[..., None],
                                    dim=1) for pe in outs}
    auto = trainer._resolve_preencode(x.shape, x.dtype)
    order = ("the same" if torch.equal(outs[True][2], outs[False][2])
             else "another")
    log(f"  preencode=True on {what} {tuple(x.shape)} {x.dtype} "
        f"({x.numel() * x.element_size() / 2**20:.1f} MiB): "
        + (f"the same kept set as per-chunk selection, in {order} order; "
           f"their embeddings max |diff| "
           f"{(emb[True] - emb[False]).abs().max().item():.3e}"
           if same else "another kept set than per-chunk selection")
        + f"; 'auto' on this tensor alone resolves to {auto}")
    if same:
        return
    rows = torch.arange(x.shape[0], device=x.device)[:, None]
    with torch.inference_mode():
        xin = x.to(torch.bfloat16) if (
            conf.input_dtype == "bfloat16" and x.dtype != torch.uint8) else x
        table = _table(torch, model, conf, xin)
    pos = trainer.pos_table

    def table_scores(i, e, v):
        t = table[rows, i]
        return model.scores(t if pos is None else t + pos[i], v)
    report = tie_report(torch, model, conf, pos, xin, mask, SEED,
                        lambda i: model.encode(xin[rows, i]), table_scores)
    _check_near_tie(report, f"pre-encoded selection of {what}")


def phase_predict(torch, np, device, card):
    from ips_tpu_torch.config import config_from_dict
    from ips_tpu_torch.infer import Predictor
    from ips_tpu_torch.ops import score_kernel as sk

    conf = config_from_dict(MNIST_CONFIG)
    pred = Predictor(conf)                 # the card, by default
    if pred.device.type != "cuda":
        raise AssertionError(f"Predictor defaulted to {pred.device}")
    patches = make_patches(np, conf)
    n_iter = math.ceil((conf.N - conf.M) / conf.I)
    log(f"  config: B={conf.B} N={conf.N} patch={conf.patch_size} "
        f"M={conf.M} I={conf.I} D={conf.D} H={conf.H} T={conf.n_token} "
        f"{conf.enc_type}/{conf.n_res_blocks} blocks, "
        f"{conf.compute_dtype} compute, score_impl={conf.score_impl}")

    torch.cuda.reset_peak_memory_stats()
    sk.logits.launches = 0
    outs, times = [], []
    for i in range(N_REQUESTS):
        before = sk.logits.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = pred.predict(patches)        # ends in a device->host copy
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        launched = sk.logits.launches - before
        if launched != n_iter:
            raise AssertionError(f"request {i}: score kernel launched "
                                 f"{launched} times, expected {n_iter}")
        outs.append(out)
        log(f"  request {i}: {times[-1] * 1e3:.2f} ms, {launched} kernel "
            "launches")
    launches = sk.logits.launches
    peak = torch.cuda.max_memory_allocated()

    out = outs[-1]
    for task in conf.task_list:
        p = out[task.name]
        if p.shape != (conf.B, conf.n_class) or not np.isfinite(p).all():
            raise AssertionError(f"{task.name}: bad output {p.shape}")
        if task.act_fn == "softmax":
            np.testing.assert_allclose(p.sum(-1), 1.0, rtol=0, atol=1e-5)
    idx = out["selected_idx"]
    if idx.shape != (conf.B, conf.M):
        raise AssertionError(f"selected_idx shape {idx.shape}")
    if idx.min() < 0 or idx.max() >= conf.N:
        raise AssertionError("selected_idx out of range")
    if any(len(np.unique(r)) != conf.M for r in idx):
        raise AssertionError("selected_idx not unique per row")
    for o in outs[1:]:
        np.testing.assert_array_equal(o["selected_idx"], idx)

    # the same selection with the plain scorer
    x = torch.from_numpy(patches).to(device).to(torch.bfloat16)
    mask = torch.ones((conf.B, conf.N), dtype=torch.bool, device=device)
    check_plain_selection(torch, np, pred.trainer.model, conf,
                          pred.trainer.pos_table, x, mask, idx)

    steady = sorted(times[1:])
    median = steady[len(steady) // 2]
    log(f"  predict: first {times[0] * 1e3:.2f} ms, steady median "
        f"{median * 1e3:.2f} ms over {len(steady)} "
        f"requests, peak memory {peak / 2**20:.1f} MiB "
        f"(max_memory_allocated), card {card}")
    breakdown(torch, lambda: pred.predict(patches), median)
    return pred, patches, launches


def _category(name: str) -> str:
    n = name.lower()
    for cat, keys in (("score_logits kernel", ("score_logits",
                                               "logits_f32", "logits_bf16")),
                      ("scatter (densify, gather backward)", ("scatter",)),
                      ("optimizer (AdamW)", ("multi_tensor", "adam")),
                      ("memcpy/memset", ("memcpy", "memset")),
                      ("convolution", ("conv", "cudnn", "fprop", "dgrad",
                                       "wgrad", "implicit")),
                      ("gemm", ("gemm", "cutlass", "cublas", "xmma",
                                "nvjet")),
                      ("sort (top-M)", ("sort", "radix")),
                      ("gather/index", ("gather", "index")),
                      ("reduce (softmax, mean, pool)", ("reduce", "softmax",
                                                        "pool", "mean"))):
        if any(k in n for k in keys):
            return cat
    return "elementwise/other"


def breakdown(torch, request, wall_s, what="request"):
    """Device time of one profiled call of ``request``, by kernel
    category; the idle share is against the unprofiled steady time.
    A profile is whole only if it holds one score_logits record for each
    launch the wrapper counted in it (a profile can lose kernel records);
    one that is not is taken again, up to ``PROFILE_TRIES`` in all.
    Returns the device's busy ms, None if the profiler saw nothing or no
    whole profile."""
    from ips_tpu_torch.ops import score_kernel as sk
    from ips_tpu_torch.utils.timing import PROFILE_TRIES, device_kernels
    for _ in range(PROFILE_TRIES):
        before = sk.logits.launches
        kernels = device_kernels(request)
        launched = sk.logits.launches - before
        if not kernels:
            log("  breakdown: the profiler saw no device kernels")
            return None
        seen = sum(n for name, (_, n) in kernels.items()
                   if _category(name) == "score_logits kernel")
        if seen == launched:
            break
        log(f"  breakdown: refused a profile with {seen} score_logits "
            f"records of {launched} launches")
    else:
        log("  breakdown: no whole profile; device busy not measured")
        return None
    busy_ms = sum(us for us, _ in kernels.values()) / 1e3
    cats = {}
    for name, (us, n) in kernels.items():
        c = cats.setdefault(_category(name), [0.0, 0])
        c[0] += us / 1e3
        c[1] += n
    log(f"  device busy {busy_ms:.2f} ms of a {wall_s * 1e3:.2f} ms {what}"
        f" (idle share {1 - busy_ms / (wall_s * 1e3):.3f}); "
        f"{sum(n for _, n in kernels.values())} device ops")
    for cat, (ms, n) in sorted(cats.items(), key=lambda kv: -kv[1][0]):
        log(f"    {cat}: {ms:.3f} ms, {n} ops")
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])
    for name, (us, n) in top[:8]:
        log(f"    top: {us / 1e3:.3f} ms x{n} {name[:90]}")
    # kernels of no category that PyTorch's own elementwise code did not
    # launch (a library's kernel under a name the table lacks)
    for name, (us, n) in [kv for kv in top if "at::native" not in kv[0]
                          and _category(kv[0]) == "elementwise/other"][:6]:
        log(f"    uncategorised: {us / 1e3:.3f} ms x{n} {name[:90]}")
    return busy_ms


def train_batches(torch, np, conf, K, device):
    """K stacked training batches on the card: patches as make_patches
    makes them (another seed per batch, stored bf16 as the config asks),
    random labels for the softmax tasks, random 0/1 for the sigmoid ones,
    weights all 1."""
    rng = np.random.default_rng(SEED + 3)
    patches = torch.stack([
        torch.from_numpy(make_patches(np, conf, SEED + 10 + k)).to(
            device, torch.bfloat16) for k in range(K)])
    labels = {}
    for task in conf.task_list:
        labels[task.name] = torch.from_numpy(
            rng.integers(0, conf.n_class, (K, conf.B)) if task.act_fn ==
            "softmax" else (rng.random((K, conf.B, conf.n_class)) < 0.5
                            ).astype(np.float32)).to(device)
    mask = torch.ones((K, conf.B, conf.N), dtype=torch.bool, device=device)
    weights = torch.ones((K, conf.B), dtype=torch.float32, device=device)
    return patches, mask, labels, weights


def check_finite(torch, conf, losses, task_losses, preds, lead):
    """Every loss finite, every prediction finite with its shape."""
    if not bool(torch.isfinite(losses).all()):
        raise AssertionError(f"non-finite loss: {losses.tolist()}")
    for task in conf.task_list:
        if not bool(torch.isfinite(task_losses[task.name]).all()):
            raise AssertionError(f"non-finite {task.name} loss")
        p = preds[task.name]
        if tuple(p.shape) != lead + (conf.B, conf.n_class) or not bool(
                torch.isfinite(p).all()):
            raise AssertionError(f"{task.name}: bad preds {tuple(p.shape)}")


def train_step_parity(torch, device):
    """The kernel held against its plain version inside training
    (``ips_tpu_torch.scripts.train_parity``): for each input seed, one
    small fp32 fused_step from the same seeded weights, scored by the
    kernel on the card, against the same step scored by the plain version
    on the card and on the CPU; equal kept indices, loss, ReLU inputs,
    gradients and updated params within the script's bounds, a flipped
    ReLU gate only where its inputs straddle 0 within rounding."""
    from ips_tpu_torch.scripts import train_parity as tp
    results = [tp.parity(device, seed) for seed in tp.SEEDS]
    for res in results:
        for side in ("vs_device_plain", "vs_cpu"):
            r = res[side]
            flips = {k: f"{f['n']} at {f['gap']:.1e} of RMS"
                     for k, f in r["gate_flips"].items()}
            log(f"  seed {res['seed']} kernel step {side} (fp32, "
                f"{res['launches']} launches): same kept indices "
                f"{r['same_idx']}, loss {r['loss_rel']:.1e} relative, ReLU "
                f"inputs {r['pre_dist']:.1e} (bound {tp.PRE_DIST}); gates "
                f"flipped {flips or 0}; over {r['n_held']} of "
                f"{r['n_params']} tensors gradients {r['grad_dist']:.3e} "
                f"(bound {tp.GRAD_DIST}), params {r['param_dist']:.3e} "
                f"(bound {tp.PARAM_DIST})")
    tp.check(results)


def phase_train(torch, np, device, card):
    """The training path at full width; returns score_logits' launches
    in the timed and warm-up fused_multi_step calls."""
    from ips_tpu_torch.config import config_from_dict
    from ips_tpu_torch.ops import score_kernel as sk
    from ips_tpu_torch.train.schedule import warmup_cosine_lr
    from ips_tpu_torch.train.steps import IPSTrainer

    conf = config_from_dict(MNIST_CONFIG)
    K = conf.steps_per_dispatch
    n_iter = math.ceil((conf.N - conf.M) / conf.I)
    steps_per_epoch = math.ceil(MNIST_TRAIN_IMAGES / conf.B)
    warmup = int(conf.n_epoch_warmup * steps_per_epoch)
    lr = warmup_cosine_lr(warmup + 1, steps_per_epoch, conf.n_epoch,
                          conf.n_epoch_warmup, conf.lr)
    tr = IPSTrainer(conf)                  # the card, by default
    if tr.device.type != "cuda":
        raise AssertionError(f"IPSTrainer defaulted to {tr.device}")
    batches = train_batches(torch, np, conf, K, device)
    log(f"  config: B={conf.B} N={conf.N} M={conf.M} I={conf.I}, "
        f"{conf.compute_dtype} compute, dropout {conf.dropout}/"
        f"{conf.attn_dropout}, shuffle={conf.shuffle}, K={K} steps a "
        f"call, lr {lr:.6g} (step {warmup + 1}, just past warmup)")

    # (a) the config as shipped: one warm-up call, then timed calls
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sk.logits.launches = 0
    times = []
    for r in range(1 + N_TIMED_DISPATCHES):
        gens = [tr.new_generator(1000 * r + k) for k in range(K)]
        before = sk.logits.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses, task_losses, preds = tr.fused_multi_step(
            *batches, gens, [lr] * K)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launched = sk.logits.launches - before
        check_finite(torch, conf, losses, task_losses, preds, (K,))
        if launched != n_iter * K:
            raise AssertionError(f"call {r}: score kernel launched "
                                 f"{launched} times, expected {n_iter * K}")
        log(f"  fused_multi_step {'warm-up' if r == 0 else r}: "
            f"{dt * 1e3:.2f} ms ({dt / K * 1e3:.2f} ms a step), "
            f"{launched / K:g} kernel launches a step, losses "
            f"{[round(v, 4) for v in losses.tolist()]}")
        if r:
            times.append(dt / K)
    launches = sk.logits.launches
    peak = torch.cuda.max_memory_allocated()
    median = sorted(times)[len(times) // 2]
    log(f"  train: median {median * 1e3:.2f} ms per optimizer step over "
        f"{len(times)} calls of {K} steps, peak memory "
        f"{peak / 2**20:.1f} MiB (max_memory_allocated), "
        f"{launches / ((1 + N_TIMED_DISPATCHES) * K):g} score_logits "
        f"launches per step, trainer step {tr.step}, card {card}")

    # (b) overfit one fixed batch from fresh weights
    tr = IPSTrainer(conf)
    one = [b[0] for b in batches[:2]] + [
        {k: v[0] for k, v in batches[2].items()}, batches[3][0]]
    curve = []
    for k in range(N_OVERFIT_STEPS):
        loss = tr.fused_step(*one, tr.new_generator(k), lr)[0].item()
        if not math.isfinite(loss):
            raise AssertionError(f"overfit step {k}: loss {loss}")
        curve.append(loss)
    first, last = sum(curve[:5]) / 5, sum(curve[-5:]) / 5
    log(f"  overfit: {N_OVERFIT_STEPS} steps on one batch, loss "
        f"{[round(v, 4) for v in curve]}; mean of the first 5 "
        f"{first:.4f}, of the last 5 {last:.4f}")
    if not last < first:
        raise AssertionError("the loss did not fall on a fixed batch")

    # (c) the kernel held against its plain version inside training
    train_step_parity(torch, device)

    # (d) where one full-width step's device time goes, and how much of it
    # is the no-grad selection
    from ips_tpu_torch.utils.timing import device_kernels
    breakdown(torch, lambda: tr.fused_step(*one, tr.new_generator(0), lr),
              median, what="training step")
    sel = device_kernels(lambda: tr.select(one[0], one[1],
                                           tr.new_generator(0)))
    log(f"  selection alone: device busy "
        f"{sum(us for us, _ in sel.values()) / 1e3:.2f} ms, "
        f"{sum(n for _, n in sel.values())} device ops")

    # (e) the chunked pre-encode (a conv encoder) on one batch
    check_preencode(torch, tr, one[0], one[1], "an MNIST batch")
    return launches


def phase_cli(torch, np, pred, patches):
    from ips_tpu_torch.infer import main as infer_main
    tmp = tempfile.mkdtemp(prefix="ips_tpu_torch_smoke_")
    try:
        cfg = os.path.join(tmp, "config.json")
        with open(cfg, "w") as f:
            json.dump(MNIST_CONFIG, f)
        ckpt = os.path.join(tmp, "weights.pt")
        torch.save(pred.trainer.model.state_dict(), ckpt)
        inputs = []
        for i in range(2):
            p = os.path.join(tmp, f"image{i}.npy")
            np.save(p, patches[i])
            inputs.append(p)
        out = os.path.join(tmp, "preds.json")
        infer_main(["--config", cfg, "--checkpoint", ckpt, "--input",
                    *inputs, "--output", out])
        with open(out) as f:
            rows = json.load(f)
        direct = pred.predict(patches[:2])
        if [r["input"] for r in rows] != ["image0.npy", "image1.npy"]:
            raise AssertionError(f"CLI rows {[r['input'] for r in rows]}")
        for i, r in enumerate(rows):
            np.testing.assert_array_equal(r["selected_patches"],
                                          direct["selected_idx"][i])
            np.testing.assert_allclose(r["majority"]["probs"],
                                       direct["majority"][i], atol=1e-5)
        log(f"  CLI: {len(rows)} rows, selection and probabilities match "
            "the Predictor")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def metrics_rows(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def check_metrics_rows(np, conf, rows, epochs):
    """One train and one test line per epoch, each loss finite and >= 0,
    each metric in [0, 1]."""
    want = [(e, s) for e in epochs for s in ("train", "test")]
    if [(r["epoch"], r["split"]) for r in rows] != want:
        raise AssertionError(f"metrics lines {rows}, expected {want}")
    for r in rows:
        for t in conf.task_list:
            loss, metric = r[f"{t.name}_loss"], r[f"{t.name}_{t.metric}"]
            if not (np.isfinite(loss) and loss >= 0 and 0 <= metric <= 1):
                raise AssertionError(f"epoch {r['epoch']} {r['split']} "
                                     f"{t.name}: loss {loss}, {metric}")


def check_restore(torch, trainer, conf, ckpt, epoch):
    """The checkpoint of ``epoch`` under ``ckpt`` restores into a fresh
    trainer (another seed) bitwise: weights, AdamW's state and step."""
    from ips_tpu_torch.train.steps import IPSTrainer
    from ips_tpu_torch.utils.checkpoint import CheckpointManager
    fresh = IPSTrainer(conf.replace(seed=conf.seed + 1))
    if CheckpointManager(ckpt).restore(fresh) != epoch:
        raise AssertionError("restored the wrong epoch")
    live, back = trainer.model.state_dict(), fresh.model.state_dict()
    bad = [k for k in live if not torch.equal(live[k], back[k])]
    s_live, s_back = (trainer.opt.state_dict()["state"],
                      fresh.opt.state_dict()["state"])
    bad += [f"opt {i}.{k}" for i in s_live for k in s_live[i]
            if not torch.equal(s_live[i][k], s_back[i][k])]
    if bad or fresh.step != trainer.step:
        raise AssertionError(f"checkpoint round trip differs: {bad[:5]}")
    log(f"  checkpoint epoch {epoch}: {len(live)} tensors and AdamW's "
        "state restored bitwise into a fresh trainer")


def mnist_store(tmp, n_train, n_test):
    """A megapixel-MNIST store at 1500x1500 in ``tmp`` (synthetic digits,
    the seed); returns its directory."""
    from ips_tpu_torch.data.mnist import generate_megapixel_mnist
    data = os.path.join(tmp, "mnist")
    t0 = time.perf_counter()
    generate_megapixel_mnist(data, n_train=n_train, n_test=n_test,
                             width=1500, height=1500, n_noise=50, seed=SEED,
                             digit_source="synthetic")
    log(f"  generated {n_train} + {n_test} images at 1500x1500 in "
        f"{time.perf_counter() - t0:.2f} s")
    return data


def phase_driver(torch, np, device, card, tmp):
    """The training driver at the shipped config, its store and files in
    ``tmp``; returns score_logits' launches in its 2-epoch run, the
    store's directory and the run's metrics lines."""
    from ips_tpu_torch import main as driver
    from ips_tpu_torch.config import config_from_dict
    from ips_tpu_torch.data.loader import DataLoader
    from ips_tpu_torch.data.mnist import MegapixelMNIST
    from ips_tpu_torch.ops import score_kernel as sk
    from ips_tpu_torch.ops.densify import densify_patches
    from ips_tpu_torch.train.loop import train_one_epoch
    from ips_tpu_torch.train.metrics import MetricsLogger
    from ips_tpu_torch.utils.timing import bound_ms, device_ms
    data = mnist_store(tmp, DRIVER_TRAIN_IMAGES, DRIVER_TEST_IMAGES)
    ckpt = os.path.join(tmp, "ckpt")
    metrics = os.path.join(tmp, "metrics.jsonl")
    conf_d = dict(MNIST_CONFIG, data_dir=data, n_epoch=DRIVER_EPOCHS,
                  n_epoch_warmup=1, checkpoint_dir=ckpt,
                  checkpoint_every=1, metrics_path=metrics)
    cfg = os.path.join(tmp, "config.json")
    with open(cfg, "w") as f:
        json.dump(conf_d, f)
    conf = config_from_dict(conf_d)
    n_iter = math.ceil((conf.N - conf.M) / conf.I)
    steps = math.ceil(DRIVER_TRAIN_IMAGES / conf.B)
    evals = math.ceil(DRIVER_TEST_IMAGES / conf.B)

    # (a) two epochs through the CLI entry point, on the card by default
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sk.logits.launches = 0
    t0 = time.perf_counter()
    trainer, _, _ = driver.main(["--config", cfg])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = sk.logits.launches
    peak = torch.cuda.max_memory_allocated()
    if trainer.device.type != "cuda":
        raise AssertionError(f"the driver ran on {trainer.device}")
    want = n_iter * DRIVER_EPOCHS * (steps + evals)
    if launches != want:
        raise AssertionError(f"score kernel launched {launches} times, "
                             f"expected {want}")
    rows = metrics_rows(metrics)
    check_metrics_rows(np, conf, rows, range(DRIVER_EPOCHS))
    epoch_s = [r["train_seconds"] for r in rows if r["split"] == "train"]
    log(f"  driver: {DRIVER_EPOCHS} epochs of {steps} steps (K = "
        f"{conf.steps_per_dispatch}) and {evals} eval batches in "
        f"{wall:.2f} s; {launches} score_logits launches "
        f"({launches / (DRIVER_EPOCHS * (steps + evals)):g} per step and "
        f"per eval batch); trainer step {trainer.step}")
    log(f"  driver: epoch wall {epoch_s[0]:.4f} s (epoch 0, warm-up), "
        f"{epoch_s[1]:.4f} s (epoch 1): {epoch_s[1] / steps * 1e3:.2f} ms "
        f"per optimizer step; peak memory {peak / 2**20:.1f} MiB "
        f"(max_memory_allocated); card {card}")
    for r in rows:
        log(f"    {r['split']} epoch {r['epoch']}: " + ", ".join(
            f"{t.name} {r[f'{t.name}_loss']:.4f}/"
            f"{r[f'{t.name}_{t.metric}']:.3f}" for t in conf.task_list))

    # (b) densify on the card against the CPU on one real batch
    batch = next(iter(DataLoader(MegapixelMNIST(conf, train=True),
                                 batch_size=conf.B)))
    hw = tuple(int(v) for v in batch["img_hw"][0])
    on_card = trainer.densify(batch["input_idx"], batch["input_val"], hw)
    on_cpu = densify_patches(torch.from_numpy(batch["input_idx"]),
                             torch.from_numpy(batch["input_val"]), hw,
                             conf.patch_size, conf.n_chan_in,
                             torch.bfloat16)
    if not torch.equal(on_card.cpu(), on_cpu):
        raise AssertionError("densify on the card differs from the CPU")
    idx_d = torch.from_numpy(batch["input_idx"]).to(device)
    val_d = torch.from_numpy(batch["input_val"]).to(device)
    dens_ms = device_ms(lambda: densify_patches(
        idx_d, val_d, hw, conf.patch_size, conf.n_chan_in,
        torch.bfloat16))
    # the (int32, fp32) pairs read once, the bf16 patches written once;
    # one add a pair
    dens_bound, dens_by = bound_ms(
        idx_d.numel() * 8 + on_card.numel() * 2, idx_d.numel(),
        "float32")
    log(f"  densify {tuple(on_card.shape)} {on_card.dtype} from "
        f"{batch['input_idx'].shape[1]} padded pixels a row: bitwise "
        f"equal to the CPU's; device "
        + ("not measured" if dens_ms is None else f"{dens_ms:.4f} ms")
        + f" (bound {dens_bound:.4f} ms, {dens_by})")

    # (c) the last checkpoint into a fresh trainer, bitwise
    check_restore(torch, trainer, conf, ckpt, DRIVER_EPOCHS)

    # (d) resume with one more epoch: only epoch 2 trains (a second
    # JSON config, since key=value overrides need pyyaml)
    cfg_resume = os.path.join(tmp, "config_resume.json")
    with open(cfg_resume, "w") as f:
        json.dump(dict(conf_d, resume=True, n_epoch=DRIVER_EPOCHS + 1), f)
    before = sk.logits.launches
    driver.main(["--config", cfg_resume])
    more = metrics_rows(metrics)[len(rows):]
    check_metrics_rows(np, conf, more, [DRIVER_EPOCHS])
    if sk.logits.launches - before != n_iter * (steps + evals):
        raise AssertionError("the resumed run did not train one epoch")
    log(f"  resume=true n_epoch={DRIVER_EPOCHS + 1}: trained epoch "
        f"{DRIVER_EPOCHS} only ({more[0]['train_seconds']:.4f} s)")

    # (e) where one epoch's time goes: loader, copies, densify, steps
    loader, _ = driver.build_loaders(conf, *driver.build_datasets(
        conf, "mnist"))
    t0 = time.perf_counter()
    n_batches = sum(1 for _ in loader)
    log(f"  loader alone (host, {conf.n_worker} threads): "
        f"{(time.perf_counter() - t0) * 1e3:.2f} ms for {n_batches} "
        "batches of sparse pixels")
    busy = breakdown(torch, lambda: train_one_epoch(
        trainer, loader, 1, MetricsLogger(conf.task_list), conf),
        epoch_s[1], what=f"driver epoch of {steps} steps (epoch 1)")
    if busy is not None:
        log(f"  driver step: device busy {busy / steps:.2f} ms of "
            f"{epoch_s[1] / steps * 1e3:.2f} ms (idle share "
            f"{1 - busy / (epoch_s[1] * 1e3):.3f}); card {card}")
    return launches, data, rows


# ------------------------------------------------------------ mnist_shipped
def shipped_store(tmp):
    """Starts writing phase mnist_shipped's store under ``tmp`` in two
    spawned processes, one a split; returns (directory, writers)."""
    from ips_tpu_torch.data.mnist import SplitWriters
    data = os.path.join(tmp, "mnist")
    return data, SplitWriters(data, n_train=SHIPPED_TRAIN_IMAGES,
                              n_test=SHIPPED_TEST_IMAGES)


def store_digest(train, test):
    """sha256 over the first SHIPPED_DIGEST_SAMPLES train and test samples
    of a megapixel-MNIST store (each field's dtype, shape and bytes)."""
    import hashlib

    import numpy as np
    h = hashlib.sha256()
    n_train, n_test = SHIPPED_DIGEST_SAMPLES
    for s in list(train[:n_train]) + list(test[:n_test]):
        for a in (*s["input"], s["majority"], s["max"], s["top"],
                  s["multi"]):
            a = np.asarray(a)
            h.update(f"{a.dtype.str}{a.shape}".encode())
            h.update(a.tobytes())
    return h.hexdigest()


def _rss_mib():
    """This process's resident and peak resident memory in MiB (the peak
    from getrusage: the card's machine reports no VmHWM)."""
    import resource
    with open("/proc/self/status") as f:
        kv = dict(line.split(":", 1) for line in f)
    return (int(kv["VmRSS"].split()[0]) / 1024,
            resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024)


class DispatchTimer:
    """Host wall (synchronised) of every fused sparse train and eval
    dispatch the loop makes while active, by kind (a dispatch's own calls
    of another, as the eval group's of single steps, are not counted):
    the loop moves each dispatch's results to the host at once, so the
    sync adds no wait."""

    KINDS = {"fused_sparse_multi_step": "train_group",
             "fused_sparse_step": "train_single",
             "fused_sparse_eval_multi_step": "eval_group",
             "fused_sparse_eval_step": "eval_single"}

    def __init__(self, torch):
        self.torch = torch
        self.calls = {k: [] for k in self.KINDS.values()}
        self.depth = 0

    def __enter__(self):
        from ips_tpu_torch.train.steps import IPSTrainer
        self._saved = {m: getattr(IPSTrainer, m) for m in self.KINDS}
        for method, kind in self.KINDS.items():
            setattr(IPSTrainer, method, self._timed(self._saved[method],
                                                    kind))
        return self

    def _timed(self, fn, kind):
        torch, calls = self.torch, self.calls[kind]

        def timed(trainer, *a, **kw):
            if self.depth:
                return fn(trainer, *a, **kw)
            t0 = time.perf_counter()
            self.depth += 1
            try:
                out = fn(trainer, *a, **kw)
            finally:
                self.depth -= 1
            torch.cuda.synchronize()
            calls.append(time.perf_counter() - t0)
            return out
        return timed

    def __exit__(self, *exc):
        from ips_tpu_torch.train.steps import IPSTrainer
        for method, fn in self._saved.items():
            setattr(IPSTrainer, method, fn)
        return False


def phase_mnist_shipped(torch, np, device, card, tmp, data, writers):
    """The driver at the shipped config on the shipped store: one epoch
    through the CLI entry; returns score_logits' launches in it."""
    from ips_tpu_torch import main as driver
    from ips_tpu_torch.config import config_from_dict
    from ips_tpu_torch.data.loader import Dataset, DataLoader
    from ips_tpu_torch.ops import score_kernel as sk
    from ips_tpu_torch.train.loop import train_one_epoch
    from ips_tpu_torch.train.metrics import MetricsLogger
    t0 = time.perf_counter()
    seconds = writers.wait(SHIPPED_STORE_WAIT)
    log(f"  store: {SHIPPED_TRAIN_IMAGES} + {SHIPPED_TEST_IMAGES} images "
        f"at 1500x1500 (sklearn digits, n_noise 50, seed {SEED}) written "
        f"by two spawned processes in {seconds['train']:.2f} s (train) and "
        f"{seconds['test']:.2f} s (test), beside the phases before; this "
        f"phase waited {time.perf_counter() - t0:.2f} s for it; "
        + ", ".join(f"{f} {os.path.getsize(os.path.join(data, f)) / 1e6:.1f}"
                    " MB" for f in ("train.npy", "test.npy")))
    metrics = os.path.join(tmp, "shipped.jsonl")
    conf_d = dict(MNIST_CONFIG, data_dir=data, n_epoch=1,
                  metrics_path=metrics)
    cfg = os.path.join(tmp, "shipped.json")
    with open(cfg, "w") as f:
        json.dump(conf_d, f)
    conf = config_from_dict(conf_d)
    n_iter = math.ceil((conf.N - conf.M) / conf.I)
    steps = math.ceil(SHIPPED_TRAIN_IMAGES / conf.B)
    evals = math.ceil(SHIPPED_TEST_IMAGES / conf.B)

    # the store as the run loads it: seconds, host memory, digest
    loaded = {}
    build = driver.build_datasets

    def timed_build(c, name):
        loaded["rss0"] = _rss_mib()
        t = time.perf_counter()
        out = build(c, name)
        loaded["s"] = time.perf_counter() - t
        loaded["rss"] = _rss_mib()
        loaded["train"] = out[0]
        loaded["digest"] = store_digest(out[0]._data, out[1]._data)
        return out

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sk.logits.launches = 0
    driver.build_datasets = timed_build
    t0 = time.perf_counter()
    try:
        with DispatchTimer(torch) as timer:
            trainer, _, _ = driver.main(["--config", cfg])
    finally:
        driver.build_datasets = build
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = sk.logits.launches
    peak = torch.cuda.max_memory_allocated()
    rss, hwm = _rss_mib()
    log(f"  loaded the store in {loaded['s']:.2f} s: host RSS "
        f"{loaded['rss0'][0]:.1f} MiB before loading, "
        f"{loaded['rss'][0]:.1f} MiB after, {rss:.1f} MiB after the run, "
        f"peak RSS {hwm:.1f} MiB (this process, CUDA's host memory "
        "included)")
    log(f"  store digest {loaded['digest']} (first "
        f"{SHIPPED_DIGEST_SAMPLES[0]} train, {SHIPPED_DIGEST_SAMPLES[1]} "
        f"test samples); expected {SHIPPED_DIGEST}")
    if loaded["digest"] != SHIPPED_DIGEST:
        raise AssertionError("the store differs from the JAX package's")
    if trainer.device.type != "cuda":
        raise AssertionError(f"the driver ran on {trainer.device}")
    if trainer.step != steps:
        raise AssertionError(f"{trainer.step} optimizer steps, expected "
                             f"{steps}")
    K = conf.steps_per_dispatch
    calls = {k: len(v) for k, v in timer.calls.items()}
    want_calls = {"train_group": steps // K, "train_single": steps % K,
                  "eval_group": evals // K, "eval_single": evals % K}
    if calls != want_calls:
        raise AssertionError(f"dispatches {calls}, expected {want_calls}")
    want = n_iter * (steps + evals)
    if launches != want:
        raise AssertionError(f"score kernel launched {launches} times, "
                             f"expected {want}")
    rows = metrics_rows(metrics)
    check_metrics_rows(np, conf, rows, [0])
    epoch_s = rows[0]["train_seconds"]
    groups = timer.calls["train_group"]
    eval_s = sum(timer.calls["eval_group"]) + sum(timer.calls["eval_single"])
    log(f"  mnist_shipped: 1 epoch of {trainer.step} optimizer steps "
        f"({calls['train_group']} K = {K} groups and {calls['train_single']}"
        f" one-step group on the padded batch of "
        f"{SHIPPED_TRAIN_IMAGES % conf.B} rows) and {evals} eval batches "
        f"({calls['eval_group']} groups, {calls['eval_single']} single) in "
        f"{wall:.2f} s through main.main; {launches} score_logits launches"
        f" ({launches / (steps + evals):g} per step and per eval batch)")
    log(f"  mnist_shipped: epoch wall {epoch_s:.4f} s: "
        f"{epoch_s / steps * 1e3:.2f} ms per optimizer step, loader and "
        f"copies included; K-groups {min(groups) * 1e3 / K:.2f}-"
        f"{max(groups) * 1e3 / K:.2f} ms a step (first group "
        f"{groups[0] * 1e3:.2f} ms, median "
        f"{sorted(groups)[len(groups) // 2] * 1e3:.2f} ms); the last, "
        f"one-step group {timer.calls['train_single'][-1] * 1e3:.2f} ms; "
        f"eval {eval_s / evals * 1e3:.2f} ms per batch; peak memory "
        f"{peak / 2**20:.1f} MiB (max_memory_allocated); card {card}")
    for r in rows:
        log(f"    {r['split']} epoch {r['epoch']}: " + ", ".join(
            f"{t.name} {r[f'{t.name}_loss']:.4f}/"
            f"{r[f'{t.name}_{t.metric}']:.3f}" for t in conf.task_list))

    # the idle share over a window of the store that ends as the epoch
    # does (SHIPPED_WINDOW_IMAGES), as phase driver takes it: the window's
    # unprofiled wall, then the device's busy time in a profiled run
    class Window(Dataset):
        def __init__(self, inner, n):
            self.inner, self.n = inner, n

        def __len__(self):
            return self.n

        def __getitem__(self, i):
            return self.inner[i]

    loader = DataLoader(Window(loaded.pop("train"), SHIPPED_WINDOW_IMAGES),
                        batch_size=conf.B, shuffle=True,
                        num_workers=conf.n_worker, seed=conf.seed)
    w_steps = len(loader)

    def window():
        train_one_epoch(trainer, loader, 1, MetricsLogger(conf.task_list),
                        conf)
    t0 = time.perf_counter()
    window()
    torch.cuda.synchronize()
    w_wall = time.perf_counter() - t0
    busy = breakdown(torch, window, w_wall,
                     what=f"window of {w_steps} steps")
    if busy is not None:
        log(f"  mnist_shipped step: device busy {busy / w_steps:.2f} ms of "
            f"{w_wall / w_steps * 1e3:.2f} ms over the window (idle share "
            f"{1 - busy / (w_wall * 1e3):.3f}); the epoch's "
            f"{epoch_s / steps * 1e3:.2f} ms a step; card {card}")
    return launches


def _trained_line(line, card):
    """One phase-trained result for the log: without the per-image
    lists, with the card."""
    out = {k: v for k, v in line.items() if k != "predictions"}
    if "predictor" in out:
        out["predictor"] = {k: v for k, v in out["predictor"].items()
                            if k not in ("predictions", "kept")}
    return json.dumps(dict(out, card=card))


def phase_trained(torch, np, device, card, data):
    """The JAX package's TPU-trained MNIST checkpoints on the card, on the
    shipped store: (a) ``train.loop.evaluate`` of each TRAINED_EVAL file
    over the 1000 test images under its run's overrides against the TPU's
    line, and the first served through ``infer.Predictor`` batch by batch
    with the same predictions image by image; (b) the int8 probe on
    ``mnist40_e44`` against ``results/int8_trained_probe.json``; (c) the
    train state of TRAINED_RESUME written as the port's ``epoch_<n>.pt``
    and resumed through ``main.run`` for TRAINED_RESUME_EPOCHS epochs
    against the TPU's lines. Returns score_logits' launches."""
    from ips_tpu_torch import main as driver
    from ips_tpu_torch.ops import score_kernel as sk
    from ips_tpu_torch.scripts import trained_eval as te
    smoke = sys.modules[__name__]
    conf = te.file_config(smoke, TRAINED_EVAL[0], data)
    train, test = driver.build_datasets(conf, "mnist")
    n_iter = math.ceil((conf.N - conf.M) / conf.I)
    evals = math.ceil(len(test) / conf.B_seq)
    steps = math.ceil(len(train) / conf.B)
    sk.logits.launches = 0
    t0 = time.perf_counter()
    lines = [te.eval_file(smoke, name, test, data, device,
                          predictor=name == TRAINED_EVAL[0])
             for name in TRAINED_EVAL]
    lines.append(te.int8_probe(smoke, test, data, device,
                               bf16_eval=lines[-1]))
    lines.append(te.resume(smoke, TRAINED_RESUME, train, test, data, device,
                           epochs=TRAINED_RESUME_EPOCHS))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = sk.logits.launches
    for line in lines:
        log(f"  trained {_trained_line(line, card)}")
    jaccard_batches = len(test) // conf.B_seq
    want = n_iter * (evals * (len(TRAINED_EVAL) + 1 + 1)
                     + 2 * jaccard_batches
                     + TRAINED_RESUME_EPOCHS * (steps + evals))
    log(f"  trained: {wall:.2f} s, {launches} score_logits launches "
        f"(expected {want}); eval {lines[0]['ms_per_batch']:.2f} ms a "
        f"batch, Predictor {lines[0]['predictor']['ms_per_request']:.2f} ms"
        f" a request, int8 Jaccard pass {lines[2]['jaccard_seconds']:.2f} s,"
        f" resumed epoch {lines[3]['rows'][0].get('train_seconds', 0):.2f} s"
        f"; card {card}")
    if launches != want:
        raise AssertionError(f"score kernel launched {launches} times, "
                             f"expected {want}")
    if lines[3]["epochs"] != [te.manifest()[TRAINED_RESUME]["epoch"]]:
        raise AssertionError(f"the resumed run trained epochs "
                             f"{lines[3]['epochs']}")
    misses = [m for line in lines for m in line["misses"]]
    if misses:
        raise AssertionError(f"{len(misses)} bounds missed: {misses}")
    return launches


# ---------------------------------------------------------------- parallel
def parallel_conf(data, **over):
    """The shipped MNIST config on the driver's store, epoch 0 of its
    schedule (one warm-up epoch, as phase driver)."""
    from ips_tpu_torch.config import config_from_dict
    return config_from_dict(dict(MNIST_CONFIG, data_dir=data,
                                 n_epoch=DRIVER_EPOCHS, n_epoch_warmup=1,
                                 **over))


def parallel_batches(np, conf, data_rank=0, n_data=1):
    """The first K = steps_per_dispatch train batches of the driver's
    epoch 0: the seeded order, this data rank's rows of each."""
    from ips_tpu_torch.data.loader import DataLoader
    from ips_tpu_torch.data.mnist import MegapixelMNIST
    loader = DataLoader(MegapixelMNIST(conf, train=True), batch_size=conf.B,
                        shuffle=True, num_workers=conf.n_worker,
                        seed=conf.seed, process_index=data_rank,
                        process_count=n_data)
    batches = []
    for b in loader:
        batches.append(b)
        if len(batches) == conf.steps_per_dispatch:
            return batches
    raise AssertionError("the store holds fewer than K batches")


def parallel_group(torch, np, tr, conf, batches, seed, snapshots=None):
    """One K-step fused_sparse_multi_step on ``batches`` with the driver's
    epoch-0 lrs and generators seeded ``seed + k``; returns the per-step
    selection indices and (losses, task losses, preds). ``snapshots``
    collects the model's state before each selection."""
    from ips_tpu_torch.train.loop import _labels_from_batch, _lr
    K, dev = len(batches), tr.device

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    idxs, select = [], tr._select_impl

    def recorded(*a, **kw):
        if snapshots is not None:
            snapshots.append({k: v.detach().cpu().clone()
                              for k, v in tr.model.state_dict().items()})
        out = select(*a, **kw)
        idxs.append(out[2].cpu())
        return out

    tr._select_impl = recorded
    try:
        labels = [_labels_from_batch(conf, b) for b in batches]
        res = tr.fused_sparse_multi_step(
            torch.stack([put(b["input_idx"]) for b in batches]),
            torch.stack([put(b["input_val"]) for b in batches]),
            tuple(int(v) for v in batches[0]["img_hw"][0]),
            torch.ones((K, len(batches[0]["input_idx"]), conf.N),
                       dtype=torch.bool, device=dev),
            {t: torch.stack([put(lab[t]) for lab in labels])
             for t in labels[0]},
            torch.ones((K, len(batches[0]["input_idx"])), device=dev),
            [tr.new_generator(seed + k) for k in range(K)],
            [_lr(conf, 0, DRIVER_TRAIN_IMAGES // conf.B, k)
             for k in range(K)])
        torch.cuda.synchronize()
    finally:
        tr._select_impl = select
    return idxs, res


def _state(torch, tr):
    """Parameters, buffers and AdamW moments, on the CPU."""
    out = {f"model/{k}": v.detach().cpu()
           for k, v in tr.model.state_dict().items()}
    for i, st in enumerate(tr.opt.state.values()):
        out.update({f"opt/{i}/{k}": v.detach().cpu() for k, v in st.items()
                    if isinstance(v, torch.Tensor)})
    return out


def _event_ms(torch, fn, repeats=PARALLEL_REPEATS):
    """CUDA-event ms of one ``fn()`` over ``repeats`` after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeats):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / repeats


def parallel_rank(argv):
    """One rank of phase parallel (started by ``run_world``; gloo, every
    rank on cuda:0): for each mesh of PARALLEL_MESHES one checked K group
    from the seed's weights (its launches counted) and one timed group;
    the collectives' times; the local-merge selection of batch 0."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from ips_tpu_torch.ops import score_kernel as sk
    from ips_tpu_torch.parallel import distributed as pdist
    from ips_tpu_torch.parallel.ips_sharded import ShardedIPSTrainer
    tmp = argv[0]
    with open(os.path.join(tmp, "conf.json")) as f:
        conf_d = json.load(f)
    pdist.initialize(cpu_collectives="gloo")
    rank = dist.get_rank()
    out = {"device": str(pdist.local_device()), "launches": 0}
    for data, patch in PARALLEL_MESHES:
        tag = f"{data}x{patch}"
        conf = parallel_conf(**dict(conf_d, mesh_data=data,
                                    mesh_patch=patch))
        tr = ShardedIPSTrainer(conf)
        batches = parallel_batches(np, conf, tr.mesh.coords[0], data)
        snaps = [] if rank == 0 else None
        sk.logits.launches = 0
        idxs, (losses, _, _) = parallel_group(torch, np, tr, conf, batches,
                                              PARALLEL_SEED, snaps)
        out["launches"] += sk.logits.launches
        out[tag] = {"idx": idxs, "losses": losses.cpu(), "state": _state(torch, tr),
                    "snapshots": snaps, "rows": len(batches[0]["input_idx"])}
        t0 = time.perf_counter()
        parallel_group(torch, np, tr, conf, batches, PARALLEL_SEED + 100)
        out[tag]["step_ms"] = (time.perf_counter() - t0) * 1e3 / len(batches)
        if patch > 1:
            # the exact-CP gather of one chunk's embeddings
            half = torch.randn((len(batches[0]["input_idx"]),
                                conf.I // patch, conf.D), device=tr.device)
            out[tag]["gather_ms"] = _event_ms(torch, lambda: (
                pdist.all_gather_rows(half, tr.mesh.patch_group, dim=1)))
            out[tag]["gather_shape"] = (half.shape[0], conf.I, conf.D)
        if data > 1:
            grads = [p.grad for p in tr.model.parameters()
                     if p.grad is not None]
            out[tag]["allreduce_ms"] = _event_ms(
                torch, lambda: pdist.all_reduce_sum(grads))
            out[tag]["allreduce_elems"] = sum(g.numel() for g in grads)
    # local merge: one selection of batch 0 over the 2 ranks' shards
    conf = parallel_conf(**dict(conf_d, mesh_patch=2,
                                cp_select="local_merge"))
    tr = ShardedIPSTrainer(conf)
    b = parallel_batches(np, conf)[0]
    with torch.no_grad():
        x = tr.densify(b["input_idx"], b["input_val"],
                       tuple(int(v) for v in b["img_hw"][0]))
        out["merge_idx"] = tr.select(
            x, None, tr.new_generator(PARALLEL_SEED))[2].cpu()
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    dist.destroy_process_group()


def nccl_rank(argv):
    """A world of one rank on NCCL: a ShardedIPSTrainer over a 1 x 1 mesh
    and an IPSTrainer take the same fused sparse step from the seed's
    weights (cuDNN deterministic in both); both results, saved."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from ips_tpu_torch.parallel import distributed as pdist
    from ips_tpu_torch.parallel.ips_sharded import ShardedIPSTrainer
    from ips_tpu_torch.train.steps import IPSTrainer
    tmp = argv[0]
    with open(os.path.join(tmp, "conf.json")) as f:
        conf_d = json.load(f)
    pdist.initialize()
    torch.backends.cudnn.deterministic = True
    out = {"backend": dist.get_backend()}
    conf = parallel_conf(**conf_d)
    batches = parallel_batches(np, conf)[:1]
    for name, tr in (("sharded", ShardedIPSTrainer(conf)),
                     ("single", IPSTrainer(conf))):
        idxs, (losses, _, preds) = parallel_group(
            torch, np, tr, conf, batches, PARALLEL_SEED)
        out[name] = {"idx": idxs, "losses": losses.cpu(),
                     "preds": {k: v.cpu() for k, v in preds.items()},
                     "state": _state(torch, tr)}
    torch.save(out, os.path.join(tmp, "nccl.pt"))
    dist.destroy_process_group()


def _explain(torch, conf, x, mask, seed, single, other, what):
    """A step whose kept sets differ between one process and the ranks:
    replay it with each side's weights (``single``, ``other``: model,
    embed) and hold the difference to a near tie."""
    model, embed = single
    o_model, o_embed = other
    pos = model.pos_table if hasattr(model, "pos_table") else None
    report = tie_report(
        torch, model, conf, pos, x, mask, seed, embed,
        lambda i, e, v: o_model.scores(
            o_embed(i) + (pos[i] if pos is not None else 0), v))
    _check_near_tie(report, what)


def phase_parallel(torch, np, device, card, data, driver_rows):
    """Data and exact context parallelism at the shipped config's full
    width, two ranks sharing cuda:0 (gloo), against one process; the
    local merge; the CLI as two ranks against phase driver's epoch 0; a
    one-rank NCCL world. Returns rank 0's score_logits launches over the
    meshes' checked and timed groups and the local merge."""
    from ips_tpu_torch.models.ips_net import IPSModel
    from ips_tpu_torch.ops import score_kernel as sk
    from ips_tpu_torch.parallel.ips_sharded import ips_select_cp
    from ips_tpu_torch.parallel.launch import run_world
    from ips_tpu_torch.train.steps import IPSTrainer
    repo = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="ips_tpu_torch_parallel_")
    try:
        conf_d = {"data": data}
        with open(os.path.join(tmp, "conf.json"), "w") as f:
            json.dump(conf_d, f)
        conf = parallel_conf(data)
        K, n_iter = conf.steps_per_dispatch, math.ceil(
            (conf.N - conf.M) / conf.I)

        # (a) two-rank world: 2x1 and 1x2 groups, collectives, local merge
        t0 = time.perf_counter()
        run_world("chip_smoke:parallel_rank", 2, [tmp],
                  timeout=PARALLEL_TIMEOUT, python_path=[repo])
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                            weights_only=False) for r in range(2)]
        log(f"  2 ranks on {ranks[0]['device']} and {ranks[1]['device']} "
            f"(gloo): {time.perf_counter() - t0:.2f} s for the world")

        # one process: the same group from the same weights
        single = IPSTrainer(conf)
        batches = parallel_batches(np, conf)
        snaps = []
        idx1, (loss1, _, _) = parallel_group(torch, np, single, conf,
                                             batches, PARALLEL_SEED, snaps)
        loss1 = loss1.cpu()
        xs = [single.densify(b["input_idx"], b["input_val"],
                             tuple(int(v) for v in b["img_hw"][0]))
              for b in batches]
        mask = torch.ones((conf.B, conf.N), dtype=torch.bool, device=device)
        rows_all = torch.arange(conf.B, device=device)[:, None]

        def model_from(state):
            m = IPSModel(conf).to(device)
            m.load_state_dict(state)
            m.pos_table = single.pos_table
            return m

        for data_ax, patch_ax in PARALLEL_MESHES:
            tag = f"{data_ax}x{patch_ax}"
            r0, r1 = ranks[0][tag], ranks[1][tag]
            bad = [k for k in r0["state"]
                   if not torch.equal(r0["state"][k], r1["state"][k])]
            if bad:
                raise AssertionError(f"{tag}: ranks differ in {bad[:5]}")
            if not torch.equal(r0["losses"], r1["losses"]):
                raise AssertionError(f"{tag}: ranks report other losses")
            k_rows = r0["rows"]
            n_same = n_order = 0
            for k in range(K):
                for r, rk in enumerate(ranks):
                    d = r // patch_ax
                    rows = slice(d * k_rows, (d + 1) * k_rows)
                    got, ref = rk[tag]["idx"][k], idx1[k][rows]
                    if torch.equal(got, ref):
                        n_same += 1
                        continue
                    if torch.equal(got.sort(1).values, ref.sort(1).values):
                        n_order += 1        # the same kept set
                        continue
                    # replay step k with each side's weights
                    m1 = model_from(snaps[k])
                    mr = model_from(r0["snapshots"][k])
                    x = xs[k]

                    def e1(i, m=m1, x=x):
                        return m.encode(x[rows_all, i])

                    def er(i, m=mr, x=x):
                        # the ranks' encodes: I / n_cp patches a call
                        h = conf.I // patch_ax
                        if patch_ax > 1 and i.shape[1] % h == 0:
                            return torch.cat([m.encode(x[rows_all,
                                                         i[:, j:j + h]])
                                              for j in range(0, i.shape[1],
                                                             h)], 1)
                        if data_ax > 1:
                            return torch.cat([m.encode(
                                x[rows_all[s], i[s]]) for s in (
                                slice(j * k_rows, (j + 1) * k_rows)
                                for j in range(data_ax))])
                        return m.encode(x[rows_all, i])

                    with torch.inference_mode():
                        _explain(torch, conf, x, mask, PARALLEL_SEED + k,
                                 (m1, e1), (mr, er),
                                 f"{tag} step {k} rank {r} selection")
            diff = (r0["losses"] - loss1).abs().max().item()
            diff0 = (r0["losses"][0] - loss1[0]).abs().item()
            log(f"  {tag}: {K} steps of {k_rows} rows a rank; selections "
                f"equal to one process's in {n_same} of {2 * K} rank-steps, "
                f"the same sets in another order in {n_order}; "
                f"losses {[round(v, 5) for v in r0['losses'].tolist()]} "
                f"against {[round(v, 5) for v in loss1.tolist()]} (|diff| "
                f"{diff0:.3e} at the first step, bound {PARALLEL_STEP0_TOL}; "
                f"{diff:.3e} at most, bound {PARALLEL_LOSS_TOL}); params, "
                f"AdamW moments and running statistics bitwise equal on "
                f"both ranks ({len(r0['state'])} tensors)")
            if diff > PARALLEL_LOSS_TOL or diff0 > PARALLEL_STEP0_TOL:
                raise AssertionError(f"{tag}: losses off by {diff:.3e}")

        # the local merge against one process's ips_select_cp(n_shards=2)
        merge = IPSTrainer(conf)
        encode, score = merge._enc_score_fns()
        with torch.no_grad():
            ref = ips_select_cp(
                encode, score, xs[0], M=conf.M, I=conf.I, n_shards=2,
                pos_table=merge.pos_table, mask=None,
                generator=merge.new_generator(PARALLEL_SEED),
                shuffle=conf.shuffle,
                shuffle_style=conf.shuffle_style).mem_idx.cpu()
        for r, rk in enumerate(ranks):
            if not torch.equal(rk["merge_idx"], ref):
                raise AssertionError(f"local merge: rank {r} differs")
        log("  local_merge (n_shards = 2 over the 2 ranks): indices "
            "bitwise equal to one process's ips_select_cp")

        # times: two ranks share one card, so these are no multi-card speed
        r0 = ranks[0]
        log(f"  ms a step (host clock, K = {K} group): 2x1 "
            f"{r0['2x1']['step_ms']:.2f}, 1x2 {r0['1x2']['step_ms']:.2f}; "
            f"exact-CP all-gather of {tuple(r0['1x2']['gather_shape'])} "
            f"fp32 {r0['1x2']['gather_ms']:.4f} ms, gradient all-reduce of "
            f"{r0['2x1']['allreduce_elems']} fp32 "
            f"{r0['2x1']['allreduce_ms']:.4f} ms (CUDA events, gloo); two "
            f"ranks share one card: not multi-card speeds; card {card}")
        launches = r0["launches"]
        want = len(PARALLEL_MESHES) * K * n_iter
        if launches != want:
            raise AssertionError(f"rank 0 launched score_logits {launches} "
                                 f"times, expected {want}")

        # (b) the CLI as two ranks, one epoch, against phase driver's
        cfg = os.path.join(tmp, "cli.json")
        metrics = os.path.join(tmp, "cli.jsonl")
        with open(cfg, "w") as f:
            json.dump(dict(MNIST_CONFIG, data_dir=data, n_epoch=1,
                           n_epoch_warmup=1, metrics_path=metrics,
                           multihost=True, cpu_collectives="gloo",
                           mesh_data=2), f)
        t0 = time.perf_counter()
        # --standalone: the agent hosts the rendezvous on a port the
        # system picks and holds it for the run
        cmd = [sys.executable, "-m", "torch.distributed.run",
               "--standalone", "--nproc_per_node", "2",
               "-m", "ips_tpu_torch.main", "--config", cfg]
        proc = subprocess.run(cmd, cwd=repo, capture_output=True, text=True,
                              timeout=PARALLEL_TIMEOUT)
        if proc.returncode:
            raise AssertionError("the 2-rank CLI failed:\n"
                                 + proc.stdout[-3000:] + proc.stderr[-3000:])
        rows = metrics_rows(metrics)
        check_metrics_rows(np, conf, rows, [0])
        one = driver_rows[:2]
        diffs = [abs(a[f"{t.name}_loss"] - b[f"{t.name}_loss"])
                 for a, b in zip(rows, one) for t in conf.task_list]
        log(f"  CLI, 2 ranks (torch.distributed.run, mesh_data = 2, "
            f"{time.perf_counter() - t0:.2f} s): {len(rows)} metrics lines "
            f"from rank 0 alone; epoch-0 losses against phase driver's "
            f"max |diff| {max(diffs):.3e} (bound {PARALLEL_CLI_TOL})")
        for a, b in zip(rows, one):
            log(f"    {a['split']}: " + ", ".join(
                f"{t.name} {a[f'{t.name}_loss']:.5f}/"
                f"{b[f'{t.name}_loss']:.5f}" for t in conf.task_list))
        if max(diffs) > PARALLEL_CLI_TOL:
            raise AssertionError("the 2-rank CLI's losses are off")

        # (c) NCCL wiring: one rank, a 1x1 mesh, bitwise the IPSTrainer
        run_world("chip_smoke:nccl_rank", 1, [tmp],
                  timeout=PARALLEL_TIMEOUT, python_path=[repo])
        nc = torch.load(os.path.join(tmp, "nccl.pt"), weights_only=False)
        a, b = nc["sharded"], nc["single"]
        same = (all(torch.equal(x, y) for x, y in zip(a["idx"], b["idx"]))
                and torch.equal(a["losses"], b["losses"])
                and all(torch.equal(a["preds"][k], b["preds"][k])
                        for k in a["preds"])
                and all(torch.equal(a["state"][k], b["state"][k])
                        for k in a["state"]))
        log(f"  {nc['backend']} world of one rank: ShardedIPSTrainer (1x1) "
            f"step bitwise equal to IPSTrainer's: {same}")
        if nc["backend"] != "nccl" or not same:
            raise AssertionError("the NCCL step differs from IPSTrainer's")
        return launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def n_chunks(conf, bucket):
    """score_logits launches of one slide padded to ``bucket``: one per
    I-row chunk beyond the first M, none on the M >= N shortcut."""
    return max(0, math.ceil((bucket - conf.M) / conf.I))


def run_driver(torch, conf, dataset, datasets):
    """``main.run`` on in-memory datasets, on the card by default, with
    the ``score_logits`` launches of each ``evaluate`` counted apart;
    returns (trainer, wall s, launches, [launches of each eval], peak
    bytes)."""
    from ips_tpu_torch import main as driver
    from ips_tpu_torch.ops import score_kernel as sk
    eval_launches = []
    evaluate = driver.evaluate

    def counted_evaluate(*a, **kw):
        before = sk.logits.launches
        evaluate(*a, **kw)
        eval_launches.append(sk.logits.launches - before)
    driver.evaluate = counted_evaluate
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sk.logits.launches = 0
    t0 = time.perf_counter()
    try:
        trainer, _, _ = driver.run(conf, dataset, datasets=datasets)
        torch.cuda.synchronize()
    finally:
        driver.evaluate = evaluate
    wall = time.perf_counter() - t0
    if trainer.device.type != "cuda":
        raise AssertionError(f"the driver ran on {trainer.device}")
    for name, p in trainer.model.named_parameters():
        if not bool(torch.isfinite(p).all()):
            raise AssertionError(f"non-finite parameter {name}")
    return (trainer, wall, sk.logits.launches, eval_launches,
            torch.cuda.max_memory_allocated())


def phase_camelyon(torch, np, device, card):
    """The camelyon feature-mode path through the driver at full width;
    returns score_logits' launches in its 2-epoch run."""
    from ips_tpu_torch import main as driver
    from ips_tpu_torch.config import config_from_dict
    from ips_tpu_torch.data.camelyon.dataset import (CamelyonFeatures,
                                                     synth_slides)
    from ips_tpu_torch.infer import Predictor
    from ips_tpu_torch.ops import score_kernel as sk
    from ips_tpu_torch.train.loop import train_one_epoch
    from ips_tpu_torch.train.metrics import MetricsLogger
    tmp = tempfile.mkdtemp(prefix="ips_tpu_torch_camelyon_")
    try:
        metrics = os.path.join(tmp, "metrics.jsonl")
        conf = config_from_dict(dict(
            CAMELYON_CONFIG, n_epoch=CAMELYON_EPOCHS, n_epoch_warmup=1,
            metrics_path=metrics))
        # the card has no h5py: the slides stay in memory, made by the
        # generator make_synth_features writes out
        t0 = time.perf_counter()
        train_ds, test_ds = (
            CamelyonFeatures(conf, train, slides=dict(synth_slides(
                n, conf.n_chan_in, n_range, seed=seed)))
            for train, (n, n_range), seed in (
                (True, CAMELYON_TRAIN, SEED), (False, CAMELYON_TEST,
                                              SEED + 1)))
        train_b = [train_ds.bucket_of(i) for i in range(len(train_ds))]
        test_b = [test_ds.bucket_of(i) for i in range(len(test_ds))]
        # the M >= N shortcut, one chunk and two chunks beyond the first M
        buckets = [conf.M + k * conf.I for k in range(3)]
        log(f"  corpus: {len(train_ds)} train + {len(test_ds)} test slides "
            f"of {conf.n_chan_in} fp32 features, "
            f"{sum(train_ds._ns) + sum(test_ds._ns)} rows, in memory, made "
            f"in {time.perf_counter() - t0:.2f} s; train buckets "
            f"{dict(Counter(train_b))}, test buckets "
            f"{dict(sorted(Counter(test_b).items()))}")
        if set(train_b) != {buckets[1]} or set(test_b) != set(buckets):
            raise AssertionError("the corpus misses its buckets")
        r = conf.B // conf.B_seq
        steps = len(train_ds) // conf.B
        eval_want = sum(n_chunks(conf, b) for b in test_b)
        train_want = sum(n_chunks(conf, b) for b in train_b)

        # (a) two epochs through the driver, on the card by default;
        # evaluate's launches counted apart
        trainer, wall, launches, eval_launches, peak = run_driver(
            torch, conf, "camelyon", (train_ds, test_ds))
        train_launches = launches - sum(eval_launches)
        if (train_launches != CAMELYON_EPOCHS * train_want
                or eval_launches != [eval_want] * CAMELYON_EPOCHS):
            raise AssertionError(
                f"score kernel launched {train_launches} times in training "
                f"and {eval_launches} in eval, expected "
                f"{CAMELYON_EPOCHS * train_want} and {eval_want} an epoch")
        if trainer.step != CAMELYON_EPOCHS * steps:
            raise AssertionError(f"trainer step {trainer.step}")
        rows = metrics_rows(metrics)
        check_metrics_rows(np, conf, rows, range(CAMELYON_EPOCHS))
        epoch_s = [r["train_seconds"] for r in rows if r["split"] == "train"]
        log(f"  camelyon driver: {CAMELYON_EPOCHS} epochs of {steps} steps "
            f"(B = {conf.B} from {r} slots of B_seq = {conf.B_seq}, K = "
            f"{conf.steps_per_dispatch}) and {len(test_ds)} eval slides in "
            f"{wall:.2f} s; score_logits launches: {train_launches} in "
            f"training ({train_launches / (CAMELYON_EPOCHS * steps):g} per "
            f"optimizer step), {eval_launches} in eval (none, one and two "
            f"per slide of bucket {buckets}); trainer step {trainer.step}")
        log(f"  camelyon driver: epoch wall {epoch_s[0]:.4f} s (epoch 0, "
            f"warm-up), {epoch_s[1]:.4f} s (epoch 1): "
            f"{epoch_s[1] / steps * 1e3:.2f} ms per optimizer step; peak "
            f"memory {peak / 2**20:.1f} MiB (max_memory_allocated); card "
            f"{card}")
        for row in rows:
            t = conf.task_list[0]
            log(f"    {row['split']} epoch {row['epoch']}: {t.name} loss "
                f"{row[f'{t.name}_loss']:.4f}, {t.metric} "
                f"{row[f'{t.name}_{t.metric}']:.3f}")

        # (b) one two-chunk slide selected with the kernel and with the
        # plain scorer, from the trained weights
        pred = Predictor(conf, trainer=trainer)
        i = test_b.index(buckets[2])
        item = test_ds[i]
        x = torch.from_numpy(item["input"][None]).to(device)
        mask = torch.from_numpy(item["mask"][None]).to(device)
        before = sk.logits.launches
        idx = pred.predict(item["input"][None], item["mask"][None])[
            "selected_idx"]
        if sk.logits.launches - before != 2:
            raise AssertionError("a two-chunk slide did not take 2 "
                                 "launches")
        log(f"  slide {test_ds.slide_names[i]} ({test_ds._ns[i]} rows, "
            f"bucket {buckets[2]}): kernel selection of {idx.shape[1]}")
        check_plain_selection(torch, np, trainer.model, conf,
                              trainer.pos_table, x, mask, idx,
                              preencode=trainer._resolve_preencode(
                                  x.shape, x.dtype))
        check_preencode(torch, trainer, x, mask, "a camelyon slide")
        del pred, x, mask

        # (c) where one epoch's time goes: one slide's host work step by
        # step, the loader alone, then a profiled train epoch
        from ips_tpu_torch.data.loader import _collate
        from ips_tpu_torch.train.loop import _to_device
        t0 = time.perf_counter()
        item = train_ds[0]
        t1 = time.perf_counter()
        batch = _collate([item])
        t2 = time.perf_counter()
        _to_device(batch["input"], device)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        log(f"  one slide on the host ({batch['input'].nbytes / 1e6:.1f} "
            f"MB): pad {(t1 - t0) * 1e3:.2f} ms, collate "
            f"{(t2 - t1) * 1e3:.2f} ms, pinned copy and transfer "
            f"{(t3 - t2) * 1e3:.2f} ms")
        del item, batch
        loader, _ = driver.build_loaders(conf, train_ds, test_ds)
        t0 = time.perf_counter()
        n_batches = sum(1 for _ in loader)
        log(f"  loader alone (host, {conf.n_worker} threads, one batch of "
            f"B_seq = {conf.B_seq} at a time): "
            f"{(time.perf_counter() - t0) * 1e3:.2f} ms for {n_batches} "
            "padded fp32 slides")
        # (d) the assembled step's selection schedule: what 'auto' resolves
        # to on the stacked table, and an epoch with each schedule
        table = (r * conf.B_seq, buckets[1], conf.n_chan_in)
        log(f"  preencode_select='auto' on the assembled step's stacked "
            f"table {table} fp32 resolves to "
            f"{trainer._resolve_preencode(table, torch.float32)}")
        for pe in (False, "auto", "auto", False):
            trainer.conf = conf.replace(preencode_select=pe)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            train_one_epoch(trainer, loader, 1,
                            MetricsLogger(conf.task_list), trainer.conf)
            torch.cuda.synchronize()
            log(f"  epoch with preencode_select={pe!r}: "
                f"{(time.perf_counter() - t0) / steps * 1e3:.2f} ms per "
                f"optimizer step (synchronised); card {card}")
        trainer.conf = conf
        busy = breakdown(torch, lambda: train_one_epoch(
            trainer, loader, 1, MetricsLogger(conf.task_list), conf),
            epoch_s[1], what=f"camelyon epoch of {steps} steps "
            "(epoch 1's wall)")
        if busy is not None:
            log(f"  camelyon step: device busy {busy / steps:.2f} ms of "
                f"{epoch_s[1] / steps * 1e3:.2f} ms (idle share "
                f"{1 - busy / (epoch_s[1] * 1e3):.3f}); card {card}")
        return launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def e2e_corpus(conf):
    """Phase camelyon_e2e's corpus, which scripts/e2e_learning.py trains
    on too: the train slides' tile counts, the train and test sets."""
    import numpy as np
    from ips_tpu_torch.data.camelyon.patches import (CamelyonPatches,
                                                     synth_tile_slides)
    counts = np.random.default_rng(SEED).integers(
        *E2E_TRAIN_TILES, E2E_TRAIN_SLIDES).tolist()
    tile_hw = tuple(conf.patch_size)
    return (counts,
            CamelyonPatches(conf, True, slides=synth_tile_slides(
                counts, tile_hw, seed=SEED)),
            CamelyonPatches(conf, False, slides=synth_tile_slides(
                E2E_TEST_TILES, tile_hw, seed=SEED + 1)))


def phase_camelyon_e2e(torch, np, device, card):
    """The camelyon_e2e path (raw tiles, streaming selection) through the
    driver at full width; returns score_logits' launches in its run."""
    from ips_tpu_torch import main as driver
    from ips_tpu_torch.config import config_from_dict
    from ips_tpu_torch.ops import score_kernel as sk
    from ips_tpu_torch.train.loop import train_one_epoch
    from ips_tpu_torch.train.metrics import MetricsLogger
    from ips_tpu_torch.train.streaming import StreamingSelector
    tmp = tempfile.mkdtemp(prefix="ips_tpu_torch_e2e_")
    try:
        metrics = os.path.join(tmp, "metrics.jsonl")
        conf = config_from_dict(dict(
            CAMELYON_E2E_CONFIG, grad_encode_chunk=E2E_GRAD_ENCODE_CHUNK,
            n_epoch=E2E_EPOCHS, n_epoch_warmup=1, metrics_path=metrics))
        t0 = time.perf_counter()
        counts, train_ds, test_ds = e2e_corpus(conf)
        tile_hw = tuple(conf.patch_size)
        train_b = [train_ds.bucket_of(i) for i in range(len(train_ds))]
        test_b = [test_ds.bucket_of(i) for i in range(len(test_ds))]
        n_tiles = sum(train_ds._ns) + sum(test_ds._ns)
        log(f"  corpus: {len(train_ds)} train slides of {counts} tiles "
            f"and {len(test_ds)} test slides of {list(E2E_TEST_TILES)}, "
            f"{tile_hw[0]}x{tile_hw[1]}x3 uint8, {n_tiles} tiles "
            f"({n_tiles * tile_hw[0] * tile_hw[1] * 3 / 1e9:.2f} GB) in "
            f"host memory, made in {time.perf_counter() - t0:.2f} s; "
            f"buckets {set(train_b)} and {test_b}")
        if set(train_b) != {2304} or test_b != [256, 768, 1280, 2304]:
            raise AssertionError("the corpus misses its buckets")
        steps = math.ceil(len(train_ds) / conf.B)
        per_slide = n_chunks(conf, 2304)
        eval_want = sum(n_chunks(conf, b) for b in test_b)

        # (a) two epochs through the driver
        trainer, wall, launches, eval_launches, peak = run_driver(
            torch, conf, "camelyon_e2e", (train_ds, test_ds))
        train_launches = launches - sum(eval_launches)
        if (train_launches != E2E_EPOCHS * len(train_ds) * per_slide
                or eval_launches != [eval_want] * E2E_EPOCHS):
            raise AssertionError(
                f"score kernel launched {train_launches} times in training "
                f"and {eval_launches} in eval, expected "
                f"{E2E_EPOCHS * len(train_ds) * per_slide} and {eval_want} "
                "an epoch")
        if trainer.step != E2E_EPOCHS * steps:
            raise AssertionError(f"trainer step {trainer.step}")
        rows = metrics_rows(metrics)
        check_metrics_rows(np, conf, rows, range(E2E_EPOCHS))
        epoch_s = [r["train_seconds"] for r in rows if r["split"] == "train"]
        log(f"  camelyon_e2e driver: {E2E_EPOCHS} epochs of {steps} "
            f"optimizer step(s) (B = {conf.B} slides of B_seq = "
            f"{conf.B_seq}, streamed in stages of G = "
            f"{conf.stream_chunk_group} chunks of I = {conf.I}) and "
            f"{len(test_ds)} eval slides in {wall:.2f} s; score_logits "
            f"launches: {train_launches} in training "
            f"({train_launches / (E2E_EPOCHS * steps):g} per optimizer "
            f"step), {eval_launches} in eval (0/2/4/8 per test slide); "
            f"trainer step {trainer.step}")
        log(f"  camelyon_e2e driver: epoch wall {epoch_s[0]:.4f} s (epoch 0, "
            f"warm-up), {epoch_s[1]:.4f} s (epoch 1): "
            f"{epoch_s[1] / steps * 1e3:.2f} ms per optimizer step; peak "
            f"memory {peak / 2**20:.1f} MiB (max_memory_allocated); card "
            f"{card}")
        for row in rows:
            t = conf.task_list[0]
            log(f"    {row['split']} epoch {row['epoch']}: {t.name} loss "
                f"{row[f'{t.name}_loss']:.4f}, {t.metric} "
                f"{row[f'{t.name}_{t.metric}']:.3f}")
        # the test predictions behind the last AUC (eval mode: the same
        # as the driver's last evaluation): tied, or ranked?
        from ips_tpu_torch.train.loop import evaluate
        logger = MetricsLogger(conf.task_list)
        _, test_loader = driver.build_loaders(conf, train_ds, test_ds)
        evaluate(trainer, test_loader, logger, conf)
        t = conf.task_list[0]
        probs = np.asarray(logger.y_preds[t.name], np.float64).ravel()
        log(f"  test probabilities after epoch {E2E_EPOCHS - 1}: "
            f"{probs.tolist()} for labels {logger.y_trues[t.name]}, "
            f"{np.unique(probs).size} distinct")

        # (b) the two-group test slide: the kernel's streamed selection
        # against the plain scorer's eager one, from generators of one seed
        item = test_ds[3]
        xh, mh = item["input"][None], item["mask"][None]
        before = sk.logits.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sel = trainer.select_streaming(xh, mh, trainer.new_generator(SEED))
        torch.cuda.synchronize()
        sel_s = time.perf_counter() - t0
        if sk.logits.launches - before != per_slide:
            raise AssertionError("a 2304-bucket slide did not take "
                                 f"{per_slide} launches")
        idx = sel[2].cpu().numpy()
        log(f"  slide of {test_ds._ns[3]} tiles (bucket 2304): streamed "
            f"selection of {idx.shape[1]} in {sel_s * 1e3:.2f} ms "
            "(synchronised)")
        x = torch.from_numpy(xh).to(device)
        mask = torch.from_numpy(mh).to(device)
        check_plain_selection(torch, np, trainer.model, conf, None, x, mask,
                              idx, seed=SEED)
        del x, mask, sel

        # (c) G = 4 against G = 1 on the same slide, bitwise
        one_by_one = StreamingSelector(trainer)
        one_by_one.group = 1
        with torch.no_grad():
            g4 = trainer.select_streaming(xh, mh, trainer.new_generator(SEED),
                                          return_emb=True)
            g1 = one_by_one.select(xh, mh, trainer.new_generator(SEED),
                                   return_emb=True)
        if not all(torch.equal(a, b) for a, b in zip(g4[2:], g1[2:])):
            raise AssertionError("G = 4 and G = 1 select differently")
        log("  G = 4 and G = 1: bitwise equal indices, mask and buffer "
            "embeddings")
        del g4, g1

        # (d) streaming selection's peak memory does not grow with N
        peaks = {}
        for i in (2, 3):
            item = test_ds[i]
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            out = trainer.select_streaming(item["input"][None],
                                           item["mask"][None],
                                           trainer.new_generator(SEED))
            torch.cuda.synchronize()
            peaks[test_b[i]] = torch.cuda.max_memory_allocated() - base
            del out
        log(f"  select_streaming peak above its start: "
            + ", ".join(f"bucket {b}: {v / 2**20:.1f} MiB"
                        for b, v in peaks.items())
            + f" (tolerance {E2E_PEAK_TOL / 2**20:.0f} MiB)")
        if abs(peaks[2304] - peaks[1280]) > E2E_PEAK_TOL:
            raise AssertionError("streaming selection's peak memory grows "
                                 "with the slide")

        # (e) where an epoch's time goes: one slide's host work and its
        # selection's device time, the loader alone, then a profiled train
        # epoch against epoch 1's wall
        from ips_tpu_torch.data.loader import _collate
        from ips_tpu_torch.utils.timing import device_kernels
        t0 = time.perf_counter()
        item = train_ds[0]
        t1 = time.perf_counter()
        batch = _collate([item])
        t2 = time.perf_counter()
        sel = device_kernels(lambda: trainer.select_streaming(
            batch["input"], batch["mask"], trainer.new_generator(SEED)))
        log(f"  one train slide ({train_ds._ns[0]} tiles, "
            f"{batch['input'].nbytes / 1e6:.1f} MB padded): pad "
            f"{(t1 - t0) * 1e3:.2f} ms, collate {(t2 - t1) * 1e3:.2f} ms on "
            f"the host; its selection: device busy "
            f"{sum(us for us, _ in sel.values()) / 1e3:.2f} ms, "
            f"{sum(n for _, n in sel.values())} device ops")
        del item, batch
        loader, _ = driver.build_loaders(conf, train_ds, test_ds)
        t0 = time.perf_counter()
        n_batches = sum(1 for _ in loader)
        log(f"  loader alone (host, {conf.n_worker} threads, one slide at a "
            f"time): {(time.perf_counter() - t0) * 1e3:.2f} ms for "
            f"{n_batches} padded uint8 slides")
        busy = breakdown(torch, lambda: train_one_epoch(
            trainer, loader, 1, MetricsLogger(conf.task_list), conf),
            epoch_s[1], what=f"camelyon_e2e epoch of {steps} step(s) "
            "(epoch 1's wall)")
        if busy is not None:
            log(f"  camelyon_e2e step: device busy {busy / steps:.2f} ms of "
                f"{epoch_s[1] / steps * 1e3:.2f} ms (idle share "
                f"{1 - busy / (epoch_s[1] * 1e3):.3f}); card {card}")
        return launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# --------------------------------------------------------------------------
# phase parallel_camelyon: streaming under a mesh and B_seq < B over data
# ranks at the full width of both camelyon configs
def slot_loaders(conf, train, test):
    """One process's loaders fed the 2-rank run's optimizer batches: the
    bucketed loaders of B rows (``drop_last``, as a data-rank-sharded
    loader forces) handed out one B_seq-row loader batch at a time."""
    from ips_tpu_torch.data.loader import DataLoader

    class SlotLoader:
        def __init__(self, inner):
            self.inner = inner

        def __len__(self):
            return len(self.inner) * (conf.B // conf.B_seq)

        def __iter__(self):
            for b in self.inner:
                for j in range(0, conf.B, conf.B_seq):
                    yield {k: v[j:j + conf.B_seq] for k, v in b.items()}

    return tuple(SlotLoader(DataLoader(
        ds, batch_size=conf.B, shuffle=shuffle, num_workers=conf.n_worker,
        seed=conf.seed, bucket_fn=ds.bucket_of, drop_last=True))
        for ds, shuffle in ((train, True), (test, False)))


class StepRecorder:
    """Every ``MetricsLogger.update`` (train steps, then eval batches) and
    every streamed selection's kept indices, in order, while active."""

    def __init__(self):
        self.updates, self.kept = [], []

    def __enter__(self):
        import numpy as np
        from ips_tpu_torch.train.metrics import MetricsLogger
        from ips_tpu_torch.train.steps import IPSTrainer
        self._saved = MetricsLogger.update, IPSTrainer.select_streaming
        update, select = self._saved
        rec = self

        def recorded_update(logger, losses, preds, labels, weights=None):
            rec.updates.append((
                {k: float(v) for k, v in losses.items()},
                {k: [float(x) for x in np.ravel(v)]
                 for k, v in preds.items()}))
            return update(logger, losses, preds, labels, weights=weights)

        def recorded_select(trainer, *a, **kw):
            out = select(trainer, *a, **kw)
            rec.kept.append(out[2].cpu())
            return out

        MetricsLogger.update = recorded_update
        IPSTrainer.select_streaming = recorded_select
        return self

    def __exit__(self, *exc):
        from ips_tpu_torch.train.metrics import MetricsLogger
        from ips_tpu_torch.train.steps import IPSTrainer
        MetricsLogger.update, IPSTrainer.select_streaming = self._saved
        return False


def camelyon_corpus(conf):
    """Phase camelyon's corpus, made from the seed: the train and test
    ``CamelyonFeatures`` in memory."""
    from ips_tpu_torch.data.camelyon.dataset import (CamelyonFeatures,
                                                     synth_slides)
    return tuple(
        CamelyonFeatures(conf, train, slides=dict(synth_slides(
            n, conf.n_chan_in, n_range, seed=seed)))
        for train, (n, n_range), seed in (
            (True, CAMELYON_TRAIN, SEED), (False, CAMELYON_TEST, SEED + 1)))


def pc_e2e_conf(**over):
    """Phase camelyon_e2e's config for one epoch (one optimizer step of
    B = 8 on its 8 train slides)."""
    from ips_tpu_torch.config import config_from_dict
    return config_from_dict(dict(
        CAMELYON_E2E_CONFIG, grad_encode_chunk=E2E_GRAD_ENCODE_CHUNK,
        n_epoch=1, n_epoch_warmup=1, **over))


def pc_camelyon_conf(**over):
    from ips_tpu_torch.config import config_from_dict
    return config_from_dict(dict(CAMELYON_CONFIG, n_epoch=1,
                                 n_epoch_warmup=1, **over))


def _peak_of(torch, fn):
    """``fn()``'s result, its synchronised ms and its peak allocation
    above the allocation it started from."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (out, (time.perf_counter() - t0) * 1e3,
            torch.cuda.max_memory_allocated() - base)


def parallel_camelyon_rank(argv):
    """One rank of phase parallel_camelyon (``run_world``; gloo, every rank
    on cuda:0): (a) the streamed selection of the 2304-tile train slide at
    1x2, its stages and peak; (b) ``main.run`` of camelyon_e2e at 2x1 for
    one epoch, the 8 train slides as the test set too; (c) ``main.run`` of
    camelyon features at 2x1 for one epoch. Saves what each computed."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from ips_tpu_torch import main as driver
    from ips_tpu_torch.ops import score_kernel as sk
    from ips_tpu_torch.parallel import distributed as pdist
    from ips_tpu_torch.parallel.ips_sharded import ShardedIPSTrainer
    from ips_tpu_torch.train.streaming import StreamingSelector
    tmp = argv[0]
    pdist.initialize(cpu_collectives="gloo")
    rank = dist.get_rank()
    mh = dict(multihost=True, cpu_collectives="gloo")
    out = {"device": str(pdist.local_device()), "launches": {}}

    # (a) the streamed selection at 1x2
    conf = pc_e2e_conf(mesh_patch=2, **mh)
    _, train_ds, _ = e2e_corpus(conf)
    item = train_ds[PC_SLIDE]
    staged = []
    host_tiles = StreamingSelector._host_tiles

    def recorded(self, patches, idx):
        staged.append(tuple(idx.shape))
        return host_tiles(self, patches, idx)

    StreamingSelector._host_tiles = recorded
    tr = ShardedIPSTrainer(conf)
    sk.logits.launches = 0
    try:
        sel, ms, peak = _peak_of(torch, lambda: tr.select_streaming(
            item["input"][None], item["mask"][None],
            tr.new_generator(SEED)))
    finally:
        StreamingSelector._host_tiles = host_tiles
    out["launches"]["a"] = sk.logits.launches
    out["a"] = {"idx": sel[2].cpu(), "ms": ms, "peak": peak,
                "staged": staged}
    del tr, sel
    torch.cuda.empty_cache()

    # (b) camelyon_e2e through the driver at 2x1, one optimizer step
    conf = pc_e2e_conf(mesh_data=2, metrics_path=os.path.join(
        tmp, "e2e.jsonl"), **mh)
    sk.logits.launches = 0
    with StepRecorder() as rec:
        trainer, _, _ = driver.run(conf, "camelyon_e2e",
                                   datasets=(train_ds, train_ds))
    torch.cuda.synchronize()
    out["launches"]["b"] = sk.logits.launches
    out["b"] = {"updates": rec.updates, "kept": rec.kept,
                "state": _state(torch, trainer), "step": trainer.step,
                "peak": torch.cuda.max_memory_allocated()}
    del trainer, train_ds, item
    torch.cuda.empty_cache()

    # (c) camelyon features through the driver at 2x1, one K = 4 group
    conf = pc_camelyon_conf(mesh_data=2, metrics_path=os.path.join(
        tmp, "camelyon.jsonl"), **mh)
    datasets = camelyon_corpus(conf)
    torch.cuda.reset_peak_memory_stats()
    sk.logits.launches = 0
    with StepRecorder() as rec:
        trainer, _, _ = driver.run(conf, "camelyon", datasets=datasets)
    torch.cuda.synchronize()
    out["launches"]["c"] = sk.logits.launches
    out["c"] = {"updates": rec.updates, "state": _state(torch, trainer),
                "step": trainer.step,
                "peak": torch.cuda.max_memory_allocated()}
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    dist.destroy_process_group()


def _model_from(torch, conf, state, device):
    from ips_tpu_torch.models.ips_net import IPSModel
    m = IPSModel(conf).to(device)
    m.load_state_dict(state)
    return m


def phase_parallel_camelyon(torch, np, device, card):
    """Streaming under a mesh and B_seq < B over data ranks at the full
    width of both camelyon configs, two ranks sharing cuda:0 (gloo),
    against one process on the same slides and batches. Returns rank 0's
    score_logits launches in (a), (b) and (c)."""
    from ips_tpu_torch import main as driver
    from ips_tpu_torch.data.loader import DataLoader
    from ips_tpu_torch.parallel.launch import run_world
    from ips_tpu_torch.train.loop import (eval_base_seed, fold_seed,
                                          train_base_seed, train_one_epoch)
    from ips_tpu_torch.train.metrics import MetricsLogger
    from ips_tpu_torch.train.steps import IPSTrainer
    repo = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="ips_tpu_torch_parallel_camelyon_")
    try:
        t0 = time.perf_counter()
        run_world("chip_smoke:parallel_camelyon_rank", 2, [tmp],
                  timeout=PC_TIMEOUT, python_path=[repo])
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                            weights_only=False) for r in range(2)]
        log(f"  2 ranks on {ranks[0]['device']} and {ranks[1]['device']} "
            f"(gloo): {time.perf_counter() - t0:.2f} s for the world; two "
            "ranks share one card: no number below is a multi-card speed")
        for part in "bc":
            bad = [k for k in ranks[0][part]["state"] if not torch.equal(
                ranks[0][part]["state"][k], ranks[1][part]["state"][k])]
            if bad:
                raise AssertionError(f"({part}) ranks differ in {bad[:5]}")
        for part, path in (("b", "e2e.jsonl"), ("c", "camelyon.jsonl")):
            rows = metrics_rows(os.path.join(tmp, path))
            if [(r["epoch"], r["split"]) for r in rows] != [
                    (0, "train"), (0, "test")]:
                raise AssertionError(f"({part}) metrics lines {rows}: rank 0 "
                                     "alone writes one train and one test "
                                     "line")

        # (a) the streamed selection at 1x2 against one process's
        conf = pc_e2e_conf()
        counts, train_ds, _ = e2e_corpus(conf)
        item = train_ds[PC_SLIDE]
        xh, mh = item["input"][None], item["mask"][None]
        single = IPSTrainer(conf)
        sel, ms, peak = _peak_of(torch, lambda: single.select_streaming(
            xh, mh, single.new_generator(SEED)))
        ref = sel[2].cpu()
        del sel
        bucket = train_ds.bucket_of(PC_SLIDE)
        per = n_chunks(conf, bucket)
        half = conf.I // 2
        x = mask = None
        for r, rk in enumerate(ranks):
            a = rk["a"]
            *chunks, kept = a["staged"]
            if (any(s[-1] != half for s in chunks)
                    or kept[-1] != conf.M):
                raise AssertionError(f"(a) rank {r} staged {a['staged']}")
            if rk["launches"]["a"] != per:
                raise AssertionError(f"(a) rank {r} launched score_logits "
                                     f"{rk['launches']['a']} times, "
                                     f"expected {per}")
            if a["peak"] > peak:
                raise AssertionError(
                    f"(a) rank {r}'s selection peaks at "
                    f"{a['peak'] / 2**20:.1f} MiB, above one process's "
                    f"{peak / 2**20:.1f} MiB")
            if torch.equal(a["idx"], ref):
                continue
            if x is None:
                x = torch.from_numpy(xh).to(device)
                mask = torch.from_numpy(mh).to(device)
            m = single.model
            rows_all = torch.arange(1, device=device)[:, None]

            def whole(i, m=m):
                return m.encode(x[rows_all, i])

            def halves(i, m=m):
                h = i.shape[1] // 2
                if i.shape[1] % 2:
                    return m.encode(x[rows_all, i])
                return torch.cat([m.encode(x[rows_all, i[:, :h]]),
                                  m.encode(x[rows_all, i[:, h:]])], 1)

            with torch.inference_mode():
                _explain(torch, conf, x, mask, SEED, (m, whole), (m, halves),
                         f"(a) rank {r} selection")
        same = sum(torch.equal(rk["a"]["idx"], ref) for rk in ranks)
        log(f"  (a) streamed selection of train slide {PC_SLIDE} "
            f"({train_ds._ns[PC_SLIDE]} tiles, bucket {bucket}) at 1x2: every "
            f"stage of each rank holds {half} of each chunk's {conf.I} "
            f"tiles ({ranks[0]['a']['staged']}); kept indices equal to one "
            f"process's on {same} of 2 ranks; {per} score_logits launches "
            f"a rank; peak above its start: rank 0 "
            f"{ranks[0]['a']['peak'] / 2**20:.1f} MiB, rank 1 "
            f"{ranks[1]['a']['peak'] / 2**20:.1f} MiB, one process "
            f"{peak / 2**20:.1f} MiB; ms (synchronised): ranks "
            f"{ranks[0]['a']['ms']:.2f} / {ranks[1]['a']['ms']:.2f}, one "
            f"process {ms:.2f}; card {card}")
        del single, x, mask
        torch.cuda.empty_cache()

        # (b) one process fed the same optimizer batch, from the seed
        order = [int(i) for b in DataLoader(
            train_ds, batch_size=conf.B, shuffle=True, seed=conf.seed,
            bucket_fn=train_ds.bucket_of, drop_last=True)._batch_indices()
            for i in b]
        seq = [int(i) for b in DataLoader(
            train_ds, batch_size=conf.B_seq, shuffle=True,
            seed=conf.seed)._batch_indices() for i in b]
        log(f"  (b) epoch 0's slide order: the bucketed loader of B = "
            f"{conf.B} rows {order}, phase camelyon_e2e's of B_seq = "
            f"{conf.B_seq} {seq}: {'the same' if order == seq else 'not the same'}")
        with StepRecorder() as rec:
            saved = driver.build_loaders
            driver.build_loaders = lambda c, tr, te, *a: slot_loaders(
                c, tr, te)
            try:
                torch.cuda.reset_peak_memory_stats()
                single, _, _ = driver.run(
                    conf.replace(metrics_path=os.path.join(
                        tmp, "e2e_one.jsonl")), "camelyon_e2e",
                    datasets=(train_ds, train_ds))
                torch.cuda.synchronize()
            finally:
                driver.build_loaders = saved
        peak_b = torch.cuda.max_memory_allocated()
        wall_b = metrics_rows(os.path.join(tmp, "e2e_one.jsonl"))[0][
            "train_seconds"]
        r0 = ranks[0]["b"]
        n_sel = len(train_ds) // 2
        train_u, test_u = rec.updates[:1], rec.updates[1:]
        name = conf.task_list[0].name
        diff = abs(r0["updates"][0][0][name] - train_u[0][0][name])
        preds = np.asarray(sum((u[1][name] for u in test_u), []))
        r_preds = np.asarray(sum((u[1][name] for u in
                                  r0["updates"][1:]), []))
        pdiff = float(np.abs(preds - r_preds).max())
        n_same = n_order = 0
        ebase = eval_base_seed(conf.seed)
        tbase = train_base_seed(conf.seed, 0)
        for r, rk in enumerate(ranks):
            model_r = None
            for j, got in enumerate(rk["b"]["kept"]):
                train_sel = j < n_sel
                g = r * n_sel + (j % n_sel)
                want = rec.kept[g if train_sel else len(train_ds) + g]
                if torch.equal(got, want):
                    n_same += 1
                    continue
                if torch.equal(got.sort(1).values, want.sort(1).values):
                    n_order += 1
                    continue
                slide = train_ds[order[g] if train_sel else g]
                xs = torch.from_numpy(slide["input"][None]).to(device)
                ms_ = torch.from_numpy(slide["mask"][None]).to(device)
                if train_sel:       # both select from the seed's weights
                    m1 = mr = IPSTrainer(conf).model
                else:
                    m1 = single.model
                    if model_r is None:
                        model_r = _model_from(torch, conf, {
                            k[len("model/"):]: v for k, v in
                            rk["b"]["state"].items()
                            if k.startswith("model/")}, device)
                    mr = model_r
                rows_all = torch.arange(1, device=device)[:, None]
                seed = fold_seed(tbase if train_sel else ebase, g)
                with torch.inference_mode():
                    _explain(torch, conf, xs, ms_, seed,
                             (m1, lambda i, m=m1: m.encode(xs[rows_all, i])),
                             (mr, lambda i, m=mr: m.encode(xs[rows_all, i])),
                             f"(b) rank {r} slide {g} "
                             f"{'train' if train_sel else 'eval'} selection")
        e2e_rows = metrics_rows(os.path.join(tmp, "e2e.jsonl"))
        log(f"  (b) camelyon_e2e at 2x1 through main.run (B = {conf.B} "
            f"slides, {conf.B // 2} a rank, one optimizer step, the train "
            f"slides as the test set): train loss "
            f"{r0['updates'][0][0][name]:.6f} against one process's "
            f"{train_u[0][0][name]:.6f} on the same batch (|diff| "
            f"{diff:.3e}, bound {PC_E2E_LOSS_TOL}); eval of {len(preds)} "
            f"slides after the step: predictions max |diff| {pdiff:.3e} "
            f"(bound {PC_PRED_TOL}); kept sets equal to one process's in "
            f"{n_same} of {sum(len(rk['b']['kept']) for rk in ranks)} "
            f"rank-selections, the "
            f"same sets in another order in {n_order}; params, AdamW "
            f"moments and running statistics bitwise equal on both ranks "
            f"({len(r0['state'])} tensors); rank 0 alone wrote "
            f"{len(e2e_rows)} metrics lines")
        log(f"  (b) ms a step (the epoch's wall: selection of the rank's "
            f"slides and one train step): 2 ranks "
            f"{e2e_rows[0]['train_seconds'] * 1e3:.2f}, one process "
            f"{wall_b * 1e3:.2f}; peak: rank 0 "
            f"{r0['peak'] / 2**20:.1f} MiB, rank 1 "
            f"{ranks[1]['b']['peak'] / 2**20:.1f} MiB, one process "
            f"{peak_b / 2**20:.1f} MiB; card {card}")
        if diff > PC_E2E_LOSS_TOL or pdiff > PC_PRED_TOL:
            raise AssertionError("(b) the ranks' step is off one process's")
        del single, train_ds, item
        torch.cuda.empty_cache()

        # (c) camelyon features: one process on the same K = 4 group
        conf = pc_camelyon_conf()
        train_c, test_c = camelyon_corpus(conf)
        loader, _ = slot_loaders(conf, train_c, test_c)
        single = IPSTrainer(conf)
        with StepRecorder() as rec:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            train_one_epoch(single, loader, 0,
                            MetricsLogger(conf.task_list), conf)
            torch.cuda.synchronize()
            wall_c = time.perf_counter() - t1
        r0 = ranks[0]["c"]
        steps = len(train_c) // conf.B
        name = conf.task_list[0].name
        got = np.array([u[0][name] for u in r0["updates"][:steps]])
        want = np.array([u[0][name] for u in rec.updates])
        cdiff = np.abs(got - want)
        cam_rows = metrics_rows(os.path.join(tmp, "camelyon.jsonl"))
        log(f"  (c) camelyon features at 2x1 through main.run (B = "
            f"{conf.B} from {conf.B // conf.B_seq} slots, 8 a rank, K = "
            f"{conf.steps_per_dispatch}): per-step losses "
            f"{[round(float(v), 6) for v in got]} against one process's "
            f"{[round(float(v), 6) for v in want]} on the same batches "
            f"(|diff| {cdiff[0]:.3e} at the first step, bound "
            f"{PARALLEL_STEP0_TOL}; {cdiff.max():.3e} at most, bound "
            f"{PARALLEL_LOSS_TOL}); state bitwise equal on both ranks "
            f"({len(r0['state'])} tensors); the test set's "
            f"{len(test_c)} slides lie in buckets of fewer than B = "
            f"{conf.B}, so the sharded loader (drop_last) evaluates "
            f"{len(r0['updates']) - steps} batches (test loss "
            f"{cam_rows[1][f'{name}_loss']})")
        log(f"  (c) ms a step: 2 ranks "
            f"{cam_rows[0]['train_seconds'] / steps * 1e3:.2f} (epoch "
            f"wall), one process {wall_c / steps * 1e3:.2f}; peak: rank 0 "
            f"{r0['peak'] / 2**20:.1f} MiB, rank 1 "
            f"{ranks[1]['c']['peak'] / 2**20:.1f} MiB; card {card}")
        if cdiff[0] > PARALLEL_STEP0_TOL or cdiff.max() > PARALLEL_LOSS_TOL:
            raise AssertionError("(c) the ranks' losses are off")
        launches = ranks[0]["launches"]
        want_l = {"a": per, "b": 2 * (len(counts) // 2) * per,
                  "c": steps * (conf.B // 2) * n_chunks(
                      conf, train_c.bucket_of(0))}
        if launches != want_l:
            raise AssertionError(f"rank 0 launched score_logits {launches} "
                                 f"times, expected {want_l}")
        log(f"  rank 0's score_logits launches: {launches}")
        return sum(launches.values())
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def traffic_corpus(conf, n_per_set=TRAFFIC_IMAGES, sets=None):
    """Phase traffic's corpus, which scripts/traffic_learning.py makes at
    a larger count: both STS sets in memory at 1200x1600 from the port's
    synthetic generator (the images before JPEG), read as the train and
    test ``TrafficSigns`` of ``conf``; ``sets`` reads images made
    before."""
    from ips_tpu_torch.data.traffic import TrafficSigns
    from ips_tpu_torch.data.traffic_synth import synth_sts_sets
    if sets is None:
        sets = synth_sts_sets(n_per_set, *TRAFFIC_HW, seed=SEED)
    return (TrafficSigns(conf, True, images=sets),
            TrafficSigns(conf, False, images=sets))


def check_traffic_draws(np, conf, sets):
    """The loader's draw rule at full width, on the host: after
    ``skip_epochs(1)``, the first train batch of ``n_worker`` threads
    equals that of no threads, and data ranks 0 and 1 of 2 load their
    rows of one drop_last process's, all at ``n_worker`` threads,
    bitwise. Each loader reads a train set of its own, so that each
    starts from draw 0. Returns the host seconds."""
    from ips_tpu_torch.data.loader import DataLoader
    t0 = time.perf_counter()

    def first(workers, **kw):
        ld = DataLoader(traffic_corpus(conf, sets=sets)[0],
                        batch_size=conf.B_seq, shuffle=True, seed=conf.seed,
                        num_workers=workers, **kw)
        ld.skip_epochs(1)
        it = iter(ld)
        batch = next(it)
        it.close()
        return batch

    # the threaded loaders first: each leaves a producer finishing a
    # batch it reserved, which ends while the unthreaded one loads
    threaded = first(conf.n_worker)
    one = first(conf.n_worker, drop_last=True)
    ranks = [first(conf.n_worker, process_index=p, process_count=2)
             for p in range(2)]
    unthreaded = first(0)
    k = conf.B_seq // 2
    pairs = [(f"{conf.n_worker} threads against none", threaded,
              unthreaded)] + [
        (f"rank {p} of 2 against rows {p * k}:{(p + 1) * k} of one "
         "drop_last process", r, {n: v[p * k:(p + 1) * k]
                                  for n, v in one.items()})
        for p, r in enumerate(ranks)]
    for what, got, want in pairs:
        for n in want:
            if got[n].shape != want[n].shape or not np.array_equal(
                    got[n], want[n]):
                raise AssertionError(f"traffic draws: {what}: {n} differs")
    return time.perf_counter() - t0


def phase_traffic(torch, np, device, card):
    """The traffic-sign path through the driver at the full width of
    config/traffic_config.yml; returns score_logits' launches in its
    run."""
    from ips_tpu_torch import main as driver
    from ips_tpu_torch.config import config_from_dict
    from ips_tpu_torch.infer import Predictor
    from ips_tpu_torch.ops import score_kernel as sk
    from ips_tpu_torch.train.loop import train_one_epoch
    from ips_tpu_torch.train.metrics import MetricsLogger
    tmp = tempfile.mkdtemp(prefix="ips_tpu_torch_traffic_")
    try:
        metrics = os.path.join(tmp, "metrics.jsonl")
        ckpt = os.path.join(tmp, "ckpt")
        conf = config_from_dict(dict(
            TRAFFIC_CONFIG, n_epoch=TRAFFIC_EPOCHS, n_epoch_warmup=1,
            metrics_path=metrics, checkpoint_dir=ckpt))
        t0 = time.perf_counter()
        from ips_tpu_torch.data.traffic_synth import synth_sts_sets
        sets = synth_sts_sets(TRAFFIC_IMAGES, *TRAFFIC_HW, seed=SEED)
        train_ds, test_ds = traffic_corpus(conf, sets=sets)
        n_train, n_test = len(train_ds), len(test_ds)
        steps, evals = (math.ceil(n / conf.B) for n in (n_train, n_test))
        n_iter = math.ceil((conf.N - conf.M) / conf.I)
        classes = [dict(Counter(c for _, c in ds._data))
                   for ds in (train_ds, test_ds)]
        log(f"  corpus: {TRAFFIC_IMAGES} images a set at "
            f"{TRAFFIC_HW[0]}x{TRAFFIC_HW[1]} RGB uint8 in memory, made in "
            f"{time.perf_counter() - t0:.2f} s; after the filter {n_train} "
            f"train and {n_test} test images (classes {classes}): {steps} "
            f"train and {evals} eval batches of B = {conf.B}, the last of "
            "each padded")
        if n_train % conf.B == 0 or n_test % conf.B == 0 or steps < 2:
            raise AssertionError("the corpus misses a padded tail batch")
        log(f"  config: N={conf.N} patches of {conf.patch_size} x "
            f"{conf.n_chan_in}, M={conf.M}, I={conf.I} ({n_iter} chunks, "
            f"{conf.M + n_iter * conf.I - conf.N} padded slots), "
            f"{conf.enc_type}/{conf.n_res_blocks} blocks, D={conf.D}, "
            f"H={conf.H}, D_inner={conf.D_inner}, {conf.compute_dtype}, "
            f"fp32 host normalization, {conf.n_worker} loader threads")

        # (0) the draw rule: threads and data ranks load one process's
        # batches without threads
        draw_s = check_traffic_draws(np, conf, sets)
        log(f"  draws (host, after skip_epochs(1) on each loader): the "
            f"first train batch of B = {conf.B_seq} at {conf.n_worker} "
            "threads equals the unthreaded one, and ranks 0 and 1 of 2 at "
            f"{conf.n_worker} threads their rows of one drop_last "
            f"process's, bitwise; {draw_s:.2f} s on the host")

        # (a) two epochs through the driver, on the card by default
        trainer, wall, launches, eval_launches, peak = run_driver(
            torch, conf, "traffic", (train_ds, test_ds))
        train_launches = launches - sum(eval_launches)
        if (train_launches != n_iter * steps * TRAFFIC_EPOCHS
                or eval_launches != [n_iter * evals] * TRAFFIC_EPOCHS):
            raise AssertionError(
                f"score kernel launched {train_launches} times in training "
                f"and {eval_launches} in eval, expected "
                f"{n_iter * steps * TRAFFIC_EPOCHS} and {n_iter * evals} "
                "an epoch")
        if trainer.step != TRAFFIC_EPOCHS * steps:
            raise AssertionError(f"trainer step {trainer.step}")
        rows = metrics_rows(metrics)
        check_metrics_rows(np, conf, rows, range(TRAFFIC_EPOCHS))
        epoch_s = [r["train_seconds"] for r in rows if r["split"] == "train"]
        log(f"  traffic driver: {TRAFFIC_EPOCHS} epochs of {steps} steps "
            f"and {evals} eval batches in {wall:.2f} s; {launches} "
            f"score_logits launches at ({conf.B}, {conf.M + conf.I}, "
            f"{conf.D})x({conf.D}, {conf.n_token * conf.H}) "
            f"({launches / (TRAFFIC_EPOCHS * (steps + evals)):g} per step "
            f"and per eval batch); trainer step {trainer.step}")
        log(f"  traffic driver: epoch wall {epoch_s[0]:.4f} s (epoch 0, "
            f"warm-up), {epoch_s[1]:.4f} s (epoch 1): "
            f"{epoch_s[1] / steps * 1e3:.2f} ms per optimizer step, loader "
            f"and copies included; peak memory {peak / 2**20:.1f} MiB "
            f"(max_memory_allocated); card {card}")
        for row in rows:
            t = conf.task_list[0]
            log(f"    {row['split']} epoch {row['epoch']}: {t.name} loss "
                f"{row[f'{t.name}_loss']:.4f}, {t.metric} "
                f"{row[f'{t.name}_{t.metric}']:.3f}")

        # (b) the checkpoint the run saved at its end
        check_restore(torch, trainer, conf, ckpt, TRAFFIC_EPOCHS)

        # (c) one augmented train batch: the kernel's selection and
        # predictions, and the same selection with the plain scorer
        loader, _ = driver.build_loaders(conf, train_ds, test_ds)
        batch = next(iter(loader))
        pred = Predictor(conf, trainer=trainer)
        before = sk.logits.launches
        out = pred.predict(batch["input"])
        if sk.logits.launches - before != n_iter:
            raise AssertionError("a batch did not take one launch a chunk")
        p = out["sign"]
        if p.shape != (conf.B, conf.n_class) or not np.isfinite(p).all():
            raise AssertionError(f"bad predictions {p.shape}")
        np.testing.assert_allclose(p.sum(-1), 1.0, rtol=0, atol=1e-5)
        idx = out["selected_idx"]
        x = torch.from_numpy(batch["input"]).to(device)
        mask = torch.ones((conf.B, conf.N), dtype=torch.bool, device=device)
        log(f"  one train batch {tuple(x.shape)} {x.dtype} "
            f"({batch['input'].nbytes / 1e6:.1f} MB): finite predictions; "
            f"kernel selection of {idx.shape[1]}")
        check_plain_selection(torch, np, trainer.model, conf,
                              trainer.pos_table, x, mask, idx)
        del pred, x, mask, batch

        # (d) where an epoch's time goes: a train item's host work step by
        # step, the loader alone, then a profiled train epoch
        t_aug = t_patch = 0.0
        for i in range(TRAFFIC_HOST_ITEMS):
            img = train_ds._load_image(train_ds._data[i][0])
            t0 = time.perf_counter()
            # an explicit draw: the counter the loaders read stays put
            img = train_ds.augment(img, i, i)
            t1 = time.perf_counter()
            train_ds.to_patches(img)
            t_aug += t1 - t0
            t_patch += time.perf_counter() - t1
        log(f"  one train item on the host (one thread, mean of "
            f"{TRAFFIC_HOST_ITEMS}): augment (color jitter, shift) "
            f"{t_aug / TRAFFIC_HOST_ITEMS:.4f} s, normalize+patchify "
            f"{t_patch / TRAFFIC_HOST_ITEMS:.4f} s")
        t0 = time.perf_counter()
        n_batches = sum(1 for _ in loader)
        log(f"  loader alone (host, {conf.n_worker} threads): "
            f"{(time.perf_counter() - t0) * 1e3:.2f} ms for {n_batches} "
            "augmented fp32 batches")
        busy = breakdown(torch, lambda: train_one_epoch(
            trainer, loader, 1, MetricsLogger(conf.task_list), conf),
            epoch_s[1], what=f"traffic epoch of {steps} steps (epoch 1's "
            "wall)")
        if busy is not None:
            log(f"  traffic step: device busy {busy / steps:.2f} ms of "
                f"{epoch_s[1] / steps * 1e3:.2f} ms (idle share "
                f"{1 - busy / (epoch_s[1] * 1e3):.3f}); card {card}")
        return launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _host_ms(fn, repeats=HOSTOPS_REPEATS):
    """Median host ms of ``fn()`` over ``repeats`` calls after one."""
    fn()
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[len(times) // 2]


def phase_hostops(torch, np, card):
    """The g++ host library built on this machine, its three functions
    held bitwise against their numpy versions at the MNIST shapes, and
    each one's host time against numpy's."""
    from ips_tpu_torch import native
    from ips_tpu_torch.utils.cuda_build import build_library, library_path
    t0 = time.perf_counter()
    fresh = not os.path.exists(library_path("hostops"))
    path, _ = build_library("hostops")
    log(f"  {'built' if fresh else 'found (built earlier)'} "
        f"{os.path.relpath(path)} with g++ in "
        f"{time.perf_counter() - t0:.2f} s")
    tmp = tempfile.mkdtemp(prefix="ips_tpu_torch_hostops_")
    try:
        data = mnist_store(tmp, HOSTOPS_IMAGES, 1)
        samples = np.load(os.path.join(data, "train.npy"),
                          allow_pickle=True)
        shape, ps = (1500, 1500, 1), (50, 50)

        def compare(name, fast, plain, what):
            got, want = fast(), plain()
            if not np.array_equal(got, want):
                raise AssertionError(f"{name}: C++ and numpy differ")
            ms, plain_ms = _host_ms(fast), _host_ms(plain)
            log(f"  {name} {what}: bitwise equal to numpy; host "
                f"{ms:.3f} ms, numpy {plain_ms:.3f} ms (median of "
                f"{HOSTOPS_REPEATS}, one thread; card {card})")
            return got

        pairs = [s["input"] for s in samples]
        nnz = [len(i) for i, _ in pairs]
        batch = compare(
            "densify_patchify",
            lambda: np.stack([native.densify_patchify(i, v, shape, ps, ps)
                              for i, v in pairs]),
            lambda: np.stack([native.plain_densify_patchify(i, v, shape, ps,
                                                            ps)
                              for i, v in pairs]),
            f"of {len(pairs)} images ({min(nnz)}..{max(nnz)} pixels each) "
            f"to ({len(pairs)}, 900, 50, 50, 1)")
        dense = [native.plain_densify_patchify(
            i, v, shape, (1500, 1500), (1500, 1500))[0] for i, v in pairs]
        compare("patchify_dense",
                lambda: np.stack([native.patchify_dense(d, ps, ps)
                                  for d in dense]),
                lambda: np.stack([native.plain_patchify_dense(d, ps, ps)
                                  for d in dense]),
                f"of {len(dense)} dense 1500x1500 images")
        idx = np.random.default_rng(SEED).permutation(900)[None, :100]
        idx = np.repeat(idx, len(pairs), 0).astype(np.int32)
        compare("gather_patches", lambda: native.gather_patches(batch, idx),
                lambda: native.plain_gather_patches(batch, idx),
                f"of a chunk {idx.shape} from {batch.shape}")
        pinned = torch.empty(idx.shape + batch.shape[2:], pin_memory=True)
        out = pinned.numpy()
        compare("gather_patches(out=pinned)",
                lambda: native.gather_patches(batch, idx, out=out),
                lambda: native.plain_gather_patches(batch, idx),
                "into a pinned buffer")
        if not np.array_equal(pinned.numpy(),
                              native.plain_gather_patches(batch, idx)):
            raise AssertionError("the pinned buffer misses the gather")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _select_ms(torch, tr, x, mask):
    """Wall ms of one synchronised selection and its CUDA-event ms over 5
    back-to-back calls (the selection keeps the card busy: its idle share
    in a request is 0.03, phase predict)."""
    from ips_tpu_torch.utils.timing import cuda_ms

    def run():
        return tr.select(x, mask, tr.new_generator(SEED))
    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    return wall, cuda_ms(run, iters=5, warmup=1)


def phase_int8(torch, np, device, card):
    """int8 selection (``select_dtype: int8``) at the full MNIST width:
    one select against the plain scorer's, serving, the driver on dense
    host-densified input, and a streamed bottleneck selection at the full
    camelyon_e2e width; returns score_logits' launches in its counted
    runs."""
    from ips_tpu_torch.config import config_from_dict
    from ips_tpu_torch.data.camelyon.patches import (CamelyonPatches,
                                                     synth_tile_slides)
    from ips_tpu_torch.infer import Predictor
    from ips_tpu_torch.ops import score_kernel as sk
    from ips_tpu_torch.train.loop import train_one_epoch
    from ips_tpu_torch.train.metrics import MetricsLogger
    from ips_tpu_torch.train.steps import IPSTrainer
    from ips_tpu_torch import main as driver

    conf = config_from_dict(dict(MNIST_CONFIG, select_dtype="int8"))
    n_iter = math.ceil((conf.N - conf.M) / conf.I)
    counted = 0

    # (a) one int8 selection against the plain scorer's int8 selection
    tr = IPSTrainer(conf)
    x = torch.from_numpy(make_patches(np, conf)).to(device, torch.bfloat16)
    mask = torch.ones((conf.B, conf.N), dtype=torch.bool, device=device)
    torch.cuda.reset_peak_memory_stats()
    sk.logits.launches = 0
    idx = tr.select(x, mask, tr.new_generator(SEED))[2]
    torch.cuda.synchronize()
    if sk.logits.launches != n_iter:
        raise AssertionError(f"int8 select launched {sk.logits.launches}")
    counted += sk.logits.launches
    peak = torch.cuda.max_memory_allocated()
    encode, _ = tr._enc_score_fns()
    if encode.__module__ != "ips_tpu_torch.models.quant":
        raise AssertionError("select_dtype=int8 did not take the int8 "
                             "encode")
    check_plain_selection(torch, np, tr.model, conf, tr.pos_table, x, mask,
                          idx.cpu().numpy(), seed=SEED, encode=encode)
    bf16 = IPSTrainer(config_from_dict(MNIST_CONFIG))
    bf16.model.load_state_dict(tr.model.state_dict())
    same = torch.equal(idx.sort(1)[0], bf16.select(
        x, mask, bf16.new_generator(SEED))[2].sort(1)[0])
    times = {name: _select_ms(torch, t, x, mask)
             for name, t in (("int8", tr), ("bf16", bf16))}
    for name, (wall, ev) in times.items():
        log(f"  {name} selection of {tuple(x.shape)}: "
            f"{wall:.2f} ms wall (synchronised), {ev:.2f} ms by CUDA "
            f"events (5 back-to-back); card {card}")
    log(f"  int8 selection peak memory {peak / 2**20:.1f} MiB; kept set "
        f"{'equal to' if same else 'other than'} the bf16 selection's")
    del bf16

    # (b) serving: four requests, the survivors re-encoded in full
    # precision (no embedding reuse under int8)
    pred = Predictor(conf, trainer=tr)
    patches = make_patches(np, conf)
    sk.logits.launches = 0
    lat = []
    for r in range(N_REQUESTS):
        before = sk.logits.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = pred.predict(patches)
        lat.append((time.perf_counter() - t0) * 1e3)
        if sk.logits.launches - before != n_iter:
            raise AssertionError(f"int8 request {r}: "
                                 f"{sk.logits.launches - before} launches")
        for task in conf.task_list:
            if not np.isfinite(out[task.name]).all():
                raise AssertionError(f"int8 request {r}: non-finite "
                                     f"{task.name}")
    counted += sk.logits.launches
    log(f"  int8 Predictor: {N_REQUESTS} requests of B = {conf.B}, "
        f"{n_iter} score_logits launches each, finite outputs; "
        f"{[round(t, 2) for t in lat]} ms")

    # (c) the driver on dense input densified on the host (C++), 2 epochs
    tmp = tempfile.mkdtemp(prefix="ips_tpu_torch_int8_")
    try:
        data = mnist_store(tmp, DRIVER_TRAIN_IMAGES, DRIVER_TEST_IMAGES)
        ckpt = os.path.join(tmp, "ckpt")
        metrics = os.path.join(tmp, "metrics.jsonl")
        conf_d = config_from_dict(dict(
            MNIST_CONFIG, select_dtype="int8", sparse_input=False,
            data_dir=data, n_epoch=DRIVER_EPOCHS, n_epoch_warmup=1,
            checkpoint_dir=ckpt, checkpoint_every=1, metrics_path=metrics))
        steps = DRIVER_TRAIN_IMAGES // conf_d.B
        evals = math.ceil(DRIVER_TEST_IMAGES / conf_d.B)
        trainer, wall, launches, _, dpeak = run_driver(torch, conf_d,
                                                       "mnist", None)
        want = n_iter * DRIVER_EPOCHS * (steps + evals)
        if launches != want:
            raise AssertionError(f"int8 driver launched {launches}, "
                                 f"expected {want}")
        counted += launches
        rows = metrics_rows(metrics)
        check_metrics_rows(np, conf_d, rows, range(DRIVER_EPOCHS))
        check_restore(torch, trainer, conf_d, ckpt, DRIVER_EPOCHS)
        epoch_s = [r["train_seconds"] for r in rows if r["split"] == "train"]
        log(f"  int8 driver (dense input, host densify in C++): "
            f"{DRIVER_EPOCHS} epochs of {steps} steps and {evals} eval "
            f"batches in {wall:.2f} s, {launches} launches; epoch 1 "
            f"{epoch_s[1] / steps * 1e3:.2f} ms per optimizer step; peak "
            f"{dpeak / 2**20:.1f} MiB; card {card}")
        for r in rows:
            log(f"    {r['split']} epoch {r['epoch']}: " + ", ".join(
                f"{t.name} {r[f'{t.name}_loss']:.4f}" for t in
                conf_d.task_list))
        loader, _ = driver.build_loaders(conf_d, *driver.build_datasets(
            conf_d, "mnist"))
        busy = breakdown(torch, lambda: train_one_epoch(
            trainer, loader, 1, MetricsLogger(conf_d.task_list), conf_d),
            epoch_s[1], what=f"int8 driver epoch of {steps} steps")
        if busy is not None:
            log(f"  int8 driver step: device busy {busy / steps:.2f} ms of "
                f"{epoch_s[1] / steps * 1e3:.2f} ms (idle share "
                f"{1 - busy / (epoch_s[1] * 1e3):.3f}); card {card}")
        del trainer, loader
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # (d) bottleneck blocks, streamed: one camelyon_e2e slide at full width
    conf_e = config_from_dict(dict(CAMELYON_E2E_CONFIG, select_dtype="int8"))
    counts = np.random.default_rng(SEED).integers(
        *E2E_TRAIN_TILES, E2E_TRAIN_SLIDES).tolist()[:E2E_INT8_SLIDE + 1]
    ds = CamelyonPatches(conf_e, True, slides=synth_tile_slides(
        counts, tuple(conf_e.patch_size), seed=SEED))
    item = ds[E2E_INT8_SLIDE]
    tr_e = IPSTrainer(conf_e)
    per_slide = n_chunks(conf_e, ds.bucket_of(E2E_INT8_SLIDE))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    sk.logits.launches = 0
    t0 = time.perf_counter()
    sel = tr_e.select_streaming(item["input"][None], item["mask"][None],
                                tr_e.new_generator(SEED))
    torch.cuda.synchronize()
    sel_s = time.perf_counter() - t0
    if sk.logits.launches != per_slide:
        raise AssertionError(f"streamed int8 select launched "
                             f"{sk.logits.launches}, expected {per_slide}")
    counted += sk.logits.launches
    kept = sel[2].cpu().numpy()
    if not (kept.shape == (1, conf_e.M) and kept.max() < counts[-1]):
        raise AssertionError(f"streamed int8 selection kept {kept.shape}")
    log(f"  int8 select_streaming of a {counts[-1]}-tile slide (bucket "
        f"{ds.bucket_of(E2E_INT8_SLIDE)}, {conf_e.enc_type}/"
        f"{conf_e.n_res_blocks} bottleneck blocks, "
        f"{conf_e.patch_size[0]}x{conf_e.patch_size[1]}x3 uint8): "
        f"{per_slide} launches, {sel_s * 1e3:.2f} ms "
        f"(synchronised, first call), peak above its start "
        f"{(torch.cuda.max_memory_allocated() - base) / 2**20:.1f} MiB; "
        f"card {card}")
    return counted


EXPORT_CHILD = r'''
import json, sys, time
import numpy as np, torch
import ips_tpu_torch.ops.score_kernel as sk
path, inp, out = sys.argv[1:4]
t0 = time.perf_counter()
torch.zeros(1, device="cuda")             # the CUDA context, timed apart
init_s = time.perf_counter() - t0
t0 = time.perf_counter()
ep = torch.export.load(path)
mod = ep.module()
load_s = time.perf_counter() - t0
x = np.load(inp)
lat, launches = [], []
for _ in range(int(sys.argv[4])):
    before = sk.logits.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    # host input to host output, as Predictor.predict
    xd = torch.from_numpy(x).cuda()
    m = torch.ones(xd.shape[:2], dtype=torch.bool, device=xd.device)
    with torch.no_grad():
        res = {k: v.cpu().numpy() for k, v in mod(xd, m).items()}
    lat.append((time.perf_counter() - t0) * 1e3)
    launches.append(sk.logits.launches - before)
np.savez(out, **res)
print(json.dumps({"init_s": init_s, "load_s": load_s, "ms": lat,
                  "launches": launches,
                  "modules": sorted(k for k in sys.modules
                                    if k.startswith("ips_tpu_torch"))}))
'''


def phase_export(torch, np, device, card, pred, patches):
    """The full-width MNIST Predictor exported on the card through the CLI
    (with its selftest), then loaded and run in a fresh process that
    imports only the op's module; returns score_logits' launches there."""
    from ips_tpu_torch import export
    from ips_tpu_torch.ops import score_kernel as sk
    conf = pred.conf
    n_iter = math.ceil((conf.N - conf.M) / conf.I)
    tmp = tempfile.mkdtemp(prefix="ips_tpu_torch_export_")
    try:
        cfg = os.path.join(tmp, "config.json")
        with open(cfg, "w") as f:
            json.dump(MNIST_CONFIG, f)
        ckpt = os.path.join(tmp, "weights.pt")
        torch.save(pred.trainer.model.state_dict(), ckpt)
        art = os.path.join(tmp, "model.pt2")
        t0 = time.perf_counter()
        export.main(["--config", cfg, "--checkpoint", ckpt, "--output", art,
                     "--batch", str(conf.B), "--selftest"])
        log(f"  exported and self-tested in "
            f"{time.perf_counter() - t0:.2f} s; artifact "
            f"{os.path.getsize(art) / 1e6:.2f} MB")
        inp, out = os.path.join(tmp, "x.npy"), os.path.join(tmp, "out.npz")
        np.save(inp, patches)
        root = os.path.dirname(os.path.abspath(__file__))
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [root] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
        proc = subprocess.run(
            [sys.executable, "-c", EXPORT_CHILD, art, inp, out,
             str(EXPORT_REQUESTS)], cwd=tmp, env=env, capture_output=True,
            text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"the fresh process failed:\n"
                               f"{proc.stdout[-3000:]}{proc.stderr[-3000:]}")
        child = json.loads(proc.stdout.strip().splitlines()[-1])
        if child["launches"] != [n_iter] * EXPORT_REQUESTS:
            raise AssertionError(f"exported program launched "
                                 f"{child['launches']}, expected {n_iter} "
                                 "a request")
        if "ips_tpu_torch.infer" in child["modules"]:
            raise AssertionError("the fresh process imported the model code")
        live = pred.predict(patches)
        with np.load(out) as f:
            got = dict(f)
        np.testing.assert_array_equal(got["selected_idx"],
                                      live["selected_idx"])
        bitwise = all(np.array_equal(got[t.name], live[t.name])
                      for t in conf.task_list)
        for t in conf.task_list:
            np.testing.assert_allclose(got[t.name], live[t.name], rtol=0,
                                       atol=1e-5)
        live_ms = []
        for _ in range(EXPORT_REQUESTS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pred.predict(patches)
            live_ms.append((time.perf_counter() - t0) * 1e3)
        med = sorted(child["ms"][1:])[len(child["ms"][1:]) // 2]
        live_med = sorted(live_ms[1:])[len(live_ms[1:]) // 2]
        log(f"  fresh process (imports {child['modules']}): CUDA context "
            f"{child['init_s']:.2f} s, then loaded (torch.export.load and "
            f".module()) in {child['load_s']:.2f} s; {EXPORT_REQUESTS} "
            f"requests "
            f"{[round(v, 2) for v in child['ms']]} ms, {child['launches']} "
            f"score_logits launches; selected_idx equal to the live "
            f"Predictor's, probabilities within 1e-5 ("
            + ("bitwise equal" if bitwise else "not bitwise equal") + ")")
        log(f"  request latency: exported {med:.2f} ms, live Predictor "
            f"{live_med:.2f} ms (medians after the first; card {card})")

        # the op's dispatch against the direct ctypes call, per call on
        # the host, at the MNIST selection shape
        x = torch.randn((conf.B, conf.M + conf.I, conf.D), device=device,
                        dtype=torch.float32)
        w = torch.randn((conf.D, conf.n_token * conf.H), device=device)
        calls = {"op": lambda: torch.ops.ips_tpu_torch.score_logits(x, w),
                 "ctypes": lambda: sk._launch(x, w)}
        per = {}
        for name in ("op", "ctypes", "ctypes", "op"):
            for _ in range(50):
                calls[name]()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(2000):
                calls[name]()
            torch.cuda.synchronize()
            per.setdefault(name, []).append(
                (time.perf_counter() - t0) / 2000 * 1e6)
        log(f"  score_logits per call (2000 back-to-back, fp32 "
            f"{tuple(x.shape)}x{tuple(w.shape)}): through the op "
            f"{[round(v, 2) for v in per['op']]} us, direct ctypes "
            f"{[round(v, 2) for v in per['ctypes']]} us (in turns op, "
            f"ctypes, ctypes, op); card {card}")
        return sum(child["launches"])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


class Synchronous:
    """An encoder's dispatch/fetch with no overlap: each batch is fetched
    as soon as it is dispatched (phase preprocess's reference loop)."""

    def __init__(self, enc):
        self.enc = enc

    def dispatch(self, tiles):
        return self.enc.fetch(self.enc.dispatch(tiles))

    def fetch(self, feats):
        return feats


def _otsu_and_tiles(name, img, polygon):
    """Worker process (phase preprocess): one slide's otsu threshold and
    foreground tiles, with the host seconds of each."""
    from ips_tpu_torch.data.camelyon.foreground import slide_tiles
    from ips_tpu_torch.data.camelyon.otsu import otsu_thresholds
    from ips_tpu_torch.data.camelyon.slide import Slide
    t0 = time.perf_counter()
    [(_, _, threshold)] = otsu_thresholds({name: img})
    t1 = time.perf_counter()
    slide = Slide.from_array(name, img, polygon,
                             otsu_thresholds={0: threshold})
    xs, ys = slide_tiles(slide, tile_size=PRE_TILE, fg_perc_thresh=PRE_FG)
    return threshold, xs, ys, t1 - t0, time.perf_counter() - t1


def phase_preprocess(torch, np, device, card):
    """Synthetic slides -> otsu -> foreground -> extract_feat with a
    converted ResNet-50 checkpoint -> one evaluation of the camelyon
    feature config."""
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor
    from ips_tpu_torch.config import config_from_dict
    from ips_tpu_torch.data.camelyon import extract_feat as ex
    from ips_tpu_torch.data.camelyon.dataset import CamelyonFeatures
    from ips_tpu_torch.data.camelyon.foreground import tables_from_tiles
    from ips_tpu_torch.data.camelyon.slide import Slide
    from ips_tpu_torch.data.camelyon.synth import synth_camelyon_slides
    from ips_tpu_torch.models import pretrained as pt
    from ips_tpu_torch.models.encoders import ConvPatchEncoder
    from ips_tpu_torch.train.loop import evaluate
    from ips_tpu_torch.train.metrics import MetricsLogger
    from ips_tpu_torch.train.steps import IPSTrainer
    tmp = tempfile.mkdtemp(prefix="ips_tpu_torch_pre_")
    try:
        # (a) the corpus, each slide handed to a worker for its otsu
        # threshold and foreground tiles while the next one is made
        slides, synth_s, futures = {}, {}, {}
        t_all = time.perf_counter()
        with ProcessPoolExecutor(PRE_WORKERS,
                                 mp.get_context("spawn")) as pool:
            t0 = time.perf_counter()
            for s in synth_camelyon_slides(*PRE_COUNTS, PRE_HW, PRE_HW,
                                           seed=SEED):
                synth_s[s.name] = time.perf_counter() - t0
                slides[s.name] = s
                futures[s.name] = pool.submit(_otsu_and_tiles, s.name,
                                              s.img, s.polygon)
                t0 = time.perf_counter()
            done = {n: f.result() for n, f in futures.items()}
        host_s = time.perf_counter() - t_all
        mem = {n: Slide.from_array(n, s.img, s.polygon,
                                   otsu_thresholds={0: done[n][0]})
               for n, s in slides.items()}
        subsets = {sub: [n for n in slides if ("test" in n) == (sub == "test")]
                   for sub in ("train", "test")}
        tables = {sub: tables_from_tiles(names, [done[n][1:3]
                                                 for n in names])
                  for sub, names in subsets.items()}
        for n, s in slides.items():
            th, xs, _, otsu_s, fg_s = done[n]
            log(f"  {n} ({PRE_HW}x{PRE_HW}, label {s.label}): synth "
                f"{synth_s[n]:.2f} s, otsu {otsu_s:.2f} s (threshold "
                f"{th:.3f}), foreground {fg_s:.2f} s: {len(xs)} tiles")
        n_tiles = sum(len(t[0]["x"]) for t in tables.values())
        log(f"  corpus host time {host_s:.2f} s for {len(slides)} slides "
            f"({PRE_WORKERS} worker processes for otsu and foreground); "
            f"{n_tiles} foreground tiles of {PRE_TILE} px")
        if any(len(done[n][1]) == 0 for n in slides):
            raise AssertionError("a slide has no foreground tiles")

        # (b) weights: a seeded torchvision ResNet-50 state dict, converted
        # and saved as the CLI would, loaded with full cover
        npz = os.path.join(tmp, "r50.npz")
        pt.save_npz(npz, pt.torch_resnet_to_flat(
            pt.seeded_state_dict("resnet50", SEED), "resnet50",
            verify="full"))
        cpu_enc = pt.load_encoder_npz(
            npz, ConvPatchEncoder("resnet50", 3, 4, dtype=torch.bfloat16),
            expect_cover=True).eval()
        enc = ex.PipelinedEncoder(pretrained_path=npz, batch_size=PRE_BATCH)
        for (k, a), b in zip(cpu_enc.state_dict().items(),
                             enc.model.state_dict().values()):
            if not torch.equal(a, b.cpu()):
                raise AssertionError(f"the card's encoder differs at {k}")
        log(f"  {npz.rsplit(os.sep, 1)[1]}: ResNet-50 state dict converted "
            f"and loaded with full cover ({len(cpu_enc.state_dict())} "
            "tensors)")

        # (c) extraction, after one warm-up batch, synchronised
        def extract(encoder, sub):
            coords, bounds = tables[sub]
            return ex.extract_slide_features(
                mem, coords, bounds, tile_size=PRE_TILE,
                batch_size=PRE_BATCH, encoder=encoder)
        first = subsets["train"][0]
        xy0 = np.stack([tables["train"][0]["x"][:PRE_BATCH],
                        tables["train"][0]["y"][:PRE_BATCH]], 1)
        crop = slice((PRE_TILE - ex.TILE_CROP) // 2,
                     (PRE_TILE - ex.TILE_CROP) // 2 + ex.TILE_CROP)
        warm = mem[first].read_tiles(xy0, 0, (PRE_TILE, PRE_TILE))[
            :, crop, crop]
        enc(warm)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        feats, walls = {}, {}
        for sub in ("train", "test"):
            t0 = time.perf_counter()
            feats[sub] = extract(enc, sub)
            torch.cuda.synchronize()
            walls[sub] = time.perf_counter() - t0
        wall = sum(walls.values())
        peak = torch.cuda.max_memory_allocated()
        log(f"  extract_feat: {n_tiles} tiles in {wall:.3f} s, "
            f"{n_tiles / wall:.1f} tiles/s (224x224 crops, batch "
            f"{PRE_BATCH}, ResNet-50/4 bf16, 2048-d; host reads pipelined, "
            f"synchronised, after one warm-up batch); peak memory "
            f"{peak / 2**20:.1f} MiB (max_memory_allocated), "
            f"{(peak - base) / 2**20:.1f} MiB above the extraction's start; "
            f"card {card}")

        # (d) gates: shapes, pos and labels, the synchronous loop bitwise,
        # the first 8 tiles against the CPU
        for sub, (coords, bounds) in tables.items():
            for n, s_id, e_id in zip(bounds["name"], bounds["start_id"],
                                     bounds["end_id"]):
                f = feats[sub][n]
                if (f["img"].shape != (e_id - s_id + 1, 2048)
                        or f["img"].dtype != np.float32
                        or not np.isfinite(f["img"]).all()):
                    raise AssertionError(f"{n}: features {f['img'].shape} "
                                         f"{f['img'].dtype}, or not finite")
                if (not np.array_equal(f["pos"],
                                       coords["pos_id"][s_id:e_id + 1])
                        or f["label"] != slides[n].label):
                    raise AssertionError(f"{n}: pos or label differ from "
                                         "the foreground table and slide")
            sync = extract(Synchronous(enc), sub)
            for n in feats[sub]:
                if not np.array_equal(sync[n]["img"], feats[sub][n]["img"]):
                    raise AssertionError(f"{n}: the pipelined features "
                                         "differ from the synchronous loop")
        log("  features finite, (n, 2048) fp32, pos and labels as the "
            "foreground tables and slides; pipelined = synchronous loop, "
            "bitwise")
        x8 = torch.from_numpy(np.ascontiguousarray(warm[:8])).float() / 255.0
        with torch.inference_mode():
            want = cpu_enc(x8).numpy()
        got = feats["train"][first]["img"][:8]
        # the control: the same weights in fp32 on the card, as a forward
        # that ignored the encoder's dtype would run, must fail the gate
        fp32_enc = pt.load_encoder_npz(
            npz, ConvPatchEncoder("resnet50", 3, 4, dtype=torch.float32),
            expect_cover=True).eval().to(device)
        with torch.inference_mode():
            ctl = fp32_enc(x8.to(device)).cpu().numpy()
        del fp32_enc
        rel = float(np.linalg.norm(got - want) / np.linalg.norm(want))
        rel_ctl = float(np.linalg.norm(ctl - want) / np.linalg.norm(want))
        log(f"  first 8 tiles, card against CPU (same bf16 encoder): "
            f"relative Frobenius distance {rel:.3e} (tolerance "
            f"{PRE_FEAT_REL}), max|err| {np.abs(got - want).max():.3e} of "
            f"max|feature| {np.abs(want).max():.3e}; control, the card's "
            f"fp32 forward against the CPU's bf16: {rel_ctl:.3e}")
        if not rel < PRE_FEAT_REL:
            raise AssertionError("the card's features are not the CPU's")
        if not rel_ctl >= PRE_FEAT_REL:
            raise AssertionError("the tolerance passes an fp32 forward")

        # (e) where the extraction's time goes: the train set profiled,
        # against its unprofiled wall
        n_train = len(tables["train"][0]["x"])
        busy = breakdown(torch, lambda: extract(enc, "train"),
                         walls["train"], what=f"extraction of {n_train} "
                         "train tiles")
        if busy is not None:
            log(f"  extraction: device busy {busy:.2f} ms of "
                f"{walls['train'] * 1e3:.2f} ms for {n_train} tiles (idle "
                f"share {1 - busy / (walls['train'] * 1e3):.3f}); card "
                f"{card}")

        # (f) the features feed the camelyon trainer: one evaluation
        conf = config_from_dict(dict(CAMELYON_CONFIG, n_worker=2))
        ds = {sub: CamelyonFeatures(conf, sub == "train", slides={
            n: (f["img"], f["label"]) for n, f in feats[sub].items()})
            for sub in ("train", "test")}
        item = ds["train"][0]
        if item["input"].shape[1] != 2048:
            raise AssertionError("a feature slide is not 2048-wide")
        from ips_tpu_torch import main as driver
        _, test_loader = driver.build_loaders(conf, ds["train"], ds["test"])
        trainer = IPSTrainer(conf)
        logger = MetricsLogger(conf.task_list)
        evaluate(trainer, test_loader, logger, conf)
        logger.compute_metric()
        t = conf.task_list[0]
        loss, metric = (logger.losses_epoch[t.name][-1],
                        logger.metrics[t.name][-1])
        if not (np.isfinite(loss) and 0.0 <= metric <= 1.0):
            raise AssertionError(f"camelyon eval on the features: loss "
                                 f"{loss}, {t.metric} {metric}")
        log(f"  camelyon feature config on the extracted features: "
            f"{len(ds['train'])} train and {len(ds['test'])} test slides "
            f"load; one evaluation: {t.name} loss {loss:.4f}, {t.metric} "
            f"{metric:.3f}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_conv_probe(torch, np, device, card, pred, times):
    """conv_block against its plain version, its times from phase
    kernels' ``times``, the main path's own layer1 timed at the same
    shape, then the layer1 probe with the kernel's launches counted;
    returns the kernel's JSON entry at the unpaired layer1 shape."""
    from ips_tpu_torch.ops import conv_block as cb
    from ips_tpu_torch.scripts import probe_conv as pc
    from ips_tpu_torch.scripts.kernel_times import BLOCK_CASES, block_bound
    from ips_tpu_torch.utils.timing import cuda_ms, device_ms
    # the timed shapes, layer1's first, and a ragged one (checked only)
    cases = BLOCK_CASES + (("ragged", 37, 7, 64, False),)
    entry = None
    for name, n, s, c, paired in cases:
        rng = np.random.default_rng(SEED + 2)
        x = torch.from_numpy(0.5 * rng.standard_normal((n, s, s, c),
                                                        np.float32))
        x = x.to(device, torch.bfloat16)
        p = pc.make_block_params(SEED + 2, c // 2 if paired else c, device)
        if paired:
            p = pc.pair_params(p, c // 2)
        q = cb.kernel_params(p)
        got = cb.fused_block(x, q)
        want = cb.plain_fused_block(x, q)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        torch.testing.assert_close(got.float(), want.float(),
                                   rtol=BLOCK_RTOL, atol=BLOCK_ATOL)
        if not torch.equal(cb.fused_block(x, q), got):
            raise AssertionError(f"conv_block {name}: two launches differ")
        bound, bound_by = block_bound(n, s, c)
        log(f"  conv_block {name} ({n}, {s}, {s}, {c}): max|err| {err:.3e} "
            f"(rtol {BLOCK_RTOL}, atol {BLOCK_ATOL}), two launches "
            f"bitwise equal; bound "
            f"{bound * 1e3:.2f} us ({bound_by})")
        if name == "ragged":
            continue
        # library_ms: the block by cuDNN convs, its epilogue in PyTorch
        fields = timing_fields(times["conv_block", name, "bfloat16"], bound)
        if name == "layer1":
            # the main path's layer1 as the encoder runs it: fp32
            # activations in, bf16 cuDNN convs, fp32 BatchNorm and ReLU
            enc = pred.trainer.model.encoder
            x32 = x.float().permute(0, 3, 1, 2)     # channels_last view

            def encoder_layer1():
                with torch.inference_mode():
                    return enc.layer1_block1(enc.layer1_block0(x32))
            refused = []
            enc_ms = device_ms(encoder_layer1, iters=20, warmup=5,
                               rejected=refused)
            enc_ev = cuda_ms(encoder_layer1, iters=20, warmup=5)
            log("    main path's encoder layer1 (two blocks): device "
                + (f"not measured ({len(refused)} profiles refused)"
                   if enc_ms is None else f"{enc_ms * 1e3:.2f} us")
                + f", per call in a back-to-back loop {enc_ev * 1e3:.2f} us")
        if entry is None:
            entry = dict({
                "name": "conv_block", "route": "cuda",
                "source": "ips_tpu_torch/csrc/conv_block.cu",
                "replaces": "scripts/probe_conv.py:177",
                "launches": None, "max_abs_err": err, "bound_ms": bound,
                "bound_by": bound_by, "shape": [n, s, s, c]}, **fields)

    # the probe at its real shape: the path whose launches are counted
    cb.fused_block.launches = 0
    out = pc.main(["--device", str(device)])
    launches = cb.fused_block.launches
    if launches == 0:
        raise AssertionError("the probe never launched the fused kernel")
    log(f"  probe {out['shape']}: layer1 bound {out['bound_ms'] * 1e3:.2f} "
        f"us ({out['bound_by']}), paired {out['paired_bound_ms'] * 1e3:.2f}"
        f" us; {launches} kernel launches; card {card}")
    for vname, row in out["variants"].items():
        log(f"    {vname}: device {row['ms']} ms, events "
            f"{row['event_ms']:.4f} ms, {row['tf_s']} TF/s useful, max|err| "
            f"{row['max_abs_err']:.3e} (replaces {row['replaces']})")
    entry["launches"] = launches
    entry["launches_by_path"] = {"conv_probe": launches}
    return entry


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    from ips_tpu_torch.utils.device import fp32_matmuls
    # stated numerics: fp32 products in full fp32 (the main path's convs
    # and projections compute in bf16)
    fp32_matmuls()
    device = torch.device("cuda", 0)
    t_start = time.perf_counter()
    # phase mnist_shipped's store, written beside the phases before it
    shipped_tmp = tempfile.mkdtemp(prefix="ips_tpu_torch_shipped_")
    shipped_data, writers = shipped_store(shipped_tmp)
    try:
        return _phases(torch, np, device, t_start, shipped_tmp,
                       shipped_data, writers)
    finally:
        writers.close()
        shutil.rmtree(shipped_tmp, ignore_errors=True)


def _phases(torch, np, device, t_start, shipped_tmp, shipped_data,
            writers):
    with Phase("device"):
        kind, card = phase_device(torch)
    with Phase("build"):
        phase_build()
    with Phase("kernels"):
        entry, times = phase_kernels(torch, np, device)
    with Phase("predict"):
        pred, patches, launches = phase_predict(torch, np, device, card)
    with Phase("train"):
        train_launches = phase_train(torch, np, device, card)
    with Phase("cli"):
        phase_cli(torch, np, pred, patches)
    store = tempfile.mkdtemp(prefix="ips_tpu_torch_driver_")
    try:
        with Phase("driver"):
            driver_launches, data, driver_rows = phase_driver(
                torch, np, device, card, store)
        with Phase("parallel"):
            parallel_launches = phase_parallel(torch, np, device, card,
                                               data, driver_rows)
    finally:
        shutil.rmtree(store, ignore_errors=True)
    with Phase("camelyon"):
        camelyon_launches = phase_camelyon(torch, np, device, card)
    with Phase("camelyon_e2e"):
        e2e_launches = phase_camelyon_e2e(torch, np, device, card)
    with Phase("mnist_shipped"):
        shipped_launches = phase_mnist_shipped(
            torch, np, device, card, shipped_tmp, shipped_data, writers)
    with Phase("trained"):
        trained_launches = phase_trained(torch, np, device, card,
                                         shipped_data)
    with Phase("parallel_camelyon"):
        pc_launches = phase_parallel_camelyon(torch, np, device, card)
    with Phase("traffic"):
        traffic_launches = phase_traffic(torch, np, device, card)
    with Phase("hostops"):
        phase_hostops(torch, np, card)
    with Phase("int8"):
        int8_launches = phase_int8(torch, np, device, card)
    with Phase("export"):
        export_launches = phase_export(torch, np, device, card, pred,
                                       patches)
    entry["launches_by_path"] = {"predict": launches,
                                 "train": train_launches,
                                 "driver": driver_launches,
                                 "parallel": parallel_launches,
                                 "camelyon": camelyon_launches,
                                 "camelyon_e2e": e2e_launches,
                                 "mnist_shipped": shipped_launches,
                                 "trained": trained_launches,
                                 "parallel_camelyon": pc_launches,
                                 "traffic": traffic_launches,
                                 "int8": int8_launches,
                                 "export": export_launches}
    entry["launches"] = sum(entry["launches_by_path"].values())
    with Phase("preprocess"):
        phase_preprocess(torch, np, device, card)
    with Phase("conv_probe"):
        conv_entry = phase_conv_probe(torch, np, device, card, pred,
                                      times)
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [entry, conv_entry]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
