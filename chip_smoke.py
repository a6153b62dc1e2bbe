#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``recognizer3d_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. require CUDA and print the card's name and power limit (nvidia-smi);
2. build the CUDA kernels from ``recognizer3d_tpu_torch/csrc`` into
   ``build/torch_kernels/`` and print the build seconds and the compiler's
   registers, shared memory and spills for the culled exact KNN kernel
   (B1) and its box pass, the window kernel (B6), the 1-NN kernel and its
   ordering kernel (B4), the tiled round-1 kernel (B2), the tiled pool-2 kernel (B3, B5),
   the bfloat16 forms of B2, B3 and B5, the bitonic stage kernel (B7)
   and the selection's one cluster kernel (B8), and the count of HMMA (tensor-core) instructions in the SASS of each
   compiled bfloat16 LFA kernel, which fails the run where it is 0;
3. the app path: ``Predictor(pretrained/mock_fingertip)`` answers mock
   frames of 60,000 points with every launch count set to 0 just before
   each frame; each kernel must have been launched its expected number of
   times per frame. One frame's confidences on the card are held against
   the same ``Model.predict`` on the CPU;
4. the reference-default ``knn="approximate"`` path at 65,536 points
   (``bench.py``'s ``settings64a``): the bundled weights are loaded with
   those settings and saved under ``build/``, and ``Predictor`` of that
   archive answers mock frames of 150,000 points, launch counts checked per
   frame as in 3. The session recall guard is reset before the path, and
   ``Predictor`` keeps its warm-up out of it, so the guard probes the first
   (seeded) frame, answered before the counted ones: the window it settles
   on is the same in every process. It prints the recall guard's result,
   the session window and exact fallback after that frame, the window's
   sampled recall on the first frame, the frame p50, the card against the
   CPU on one frame, and the sampled recall of the default window on the
   gaussian probe ``0.2·randn(65536, 3)`` (seed 0) that ``bench.py``
   reports;
4b. the bfloat16 compute mode (``compute_dtype="bfloat16"``) on both
   configurations: the bundled weights loaded with it (app-bf16), and with
   it and ``settings64a`` (approx64k-bf16, the config of
   ``benchmarks/validate_bf16.py``), saved under ``build/``; ``Predictor`` of
   each archive answers the frames of 3 and 4 (approx64k-bf16 after the
   guard was reset and has probed its first frame, as in 4), launch counts checked per
   frame (the LFA kernels' bfloat16 forms 2 and 2, their float32 forms 0,
   the KNN kernels as in float32), frame p50 printed. On every frame the
   card is held against the CPU port in bfloat16 by
   ``benchmarks/bf16_card_vs_cpu.logits_agree`` (the largest |Δ logit| in
   bfloat16 ulps of the frame's largest |logit| and the mean |Δ| relative
   to the mean |logit|), which the card's float32 model, the control, must
   miss on every frame; and on every frame the bfloat16
   mask's foreground IoU against the float32 mask (the same frame and
   permutation, float16 upload) is printed and held to
   ``BF16_MASK_IOU_FLOOR``;
5. the live depth path: ``LivePredictor(Model.load(pretrained/mock_fingertip))``
   at the L515's 1024×768 intrinsics and 16,384 display points answers
   z16 depth frames made from 60,000-point mock frames, launch counts
   checked per frame as in 3 (the z-band selection on B8 once a frame),
   frame p50 printed. On one frame the card is held against the CPU port
   given the same uniform draw and permutation: selected indices equal (B8
   on the card, its plain version, the stable sort, on the CPU), the float32 cloud within one ulp, packed xyz
   within one float16 ulp, masks equal away from the threshold;
5b. the app entry point, ``recognizer3d_tpu_torch.app.App``, under the
   repository's tkinter and vispy stubs (``tests/_tk_stub.py``,
   ``tests/_vispy_stub.py``; a headless GPU machine need not have vispy), run from
   ``build/app/``, whose ``data/mock`` holds seeded mock frames of 60,000
   points and whose ``models/`` holds a copy of the bundled archive. The
   cloud branch (``MockRealsenseCamera``, ``Predictor``) and then the depth
   branch (``RECOGNIZER3D_MOCK_DEPTH=1``: ``DepthReplayCamera``,
   ``LivePredictor`` at the camera's intrinsics): Predict toggled on at the
   control bar, 10 predicting ticks, each made due at once with every
   launch count set to 0 before it; each tick must launch its branch's
   path (the app path's kernels, or the live path's), and the tick wall's
   p50 is printed. The cloud branch's last tick (numpy seed 3) is held
   against the CPU port's ``Predictor`` on its frame and seed: masks equal
   where the CPU's class-1 confidence lies more than 1e-4 from the
   threshold, confidences within 1e-4. Escape must exit the app and stop
   its camera;
5c. ``knn="kdtree"``: the bundled weights loaded with it and saved under
   ``build/``; ``Predictor`` answers 3 frames of 3's, each launching B1 0
   times (the host KD-tree searches every encoder level and decoder
   upsampling), B2 2, B3 2 and B4 1 (the final upsample takes the exact
   "naive" route); the host tree's calls and host time a frame and the
   frame p50 are printed, and one frame on the card is held against the CPU
   port as in 3 (the same host tree on both sides);
5d. batch serving (BASELINE.json config 2): seeded mock captures under
   ``build/serve/`` (``make_frame``: 16 clouds of 60,000 points and 3 of
   50,000, so two size groups and a partial batch), served by the port's CLI
   (``recognizer3d_tpu_torch.serve.main``) with the bundled archive at batch
   8 on the card, launch counts set to 0 before it: every batch (the warm-up
   batches included) launches the app path's kernels once. One mask a
   cloud; the card's masks and confidences (``--confidences``) held against
   the CPU port's ``serve.main`` on the same directory and numpy seed:
   confidences within 1e-4, masks equal where the CPU's class-1 confidence
   lies more than 1e-4 from the threshold. Prints the CLI's
   ``clouds_per_sec`` line;
5e. the large-scene forward (BASELINE.json config 5): the first
   ``0.2·randn(1, 1048576, 3)`` cloud of ``benchmarks/bench_large.py``
   (seed 0) and its permutation, the bundled weights loaded at that
   n_points with ``knn="naive"``, then ``knn="approximate"`` (the session
   recall guard reset first, its window printed after the first call):
   ``Model.predict(cloud, prepostprocess=False)``, the chunked forward
   (``models/large.py``), with the launch counts set to 0 before each of 3
   calls and held to ``PER_CALL_LARGE`` (no streaming kernel on either
   route; the approximate route's guard must settle on window 16,384); wall
   p50 and peak memory printed; the chunked forward against the in-model
   forward on the card (atol 2e-4, rtol 1e-3); and the card against the CPU
   port, chunk 4,096 (``forward_eval_large`` called directly), at 16,384
   points on the exact route and at 32,768 on the approximate route, at
   the session window of 16,384 points on both sides, the logits within
   1e-4 of their largest magnitude;
5f. data-parallel serving (BASELINE.json config 2): ``DPServing`` of the
   bundled archive on ``["cuda:0", "cuda:0"]`` (two ranks, one process
   each, sharing the card; ``parallel/serving.py``) over 5d's captures at
   batch 8 (a ragged batch of 3 and two of 8), the launch counts set to 0
   on every rank before each batch and each rank's held to the app path's
   (its block of the batch is one forward); confidences held against the
   single-process ``Model.predict`` on the card with the same numpy seed
   (within 1e-4, masks equal away from the threshold); the clouds/s of
   the two ranks and of one (``DPServing`` on ``["cuda:0"]``), in turns,
   and the ranks' peak memory printed; then the serve CLI with ``--devices
   -1`` (one rank: the one card), whose masks must equal 5d's, and its
   ``clouds_per_sec`` line;
5g. point-sharded serving (BASELINE.json config 5): ``SPServing`` of the
   bundled weights on ``["cuda:0"] * 4`` over 5e's 1,048,576-point cloud
   (no padding: it is its own bucket and a multiple of the 1,024-point
   granule), one untimed call and 3 timed ones, the launch counts set to 0
   on every rank before each and each rank's held to ``PER_CALL_SP`` (B1 at
   every ring step of the encoder, B4 at the decoder's); wall p50 and each
   rank's peak memory printed; the first call's confidences held against
   ``forward_eval_large`` on the card on the exact route with the server's
   permutation replayed (atol 5e-4, rtol 1e-3, masks equal away from the
   threshold), that call's kernel calls in rank 0 (this process) recorded
   for phase 8; then the serve CLI with ``--point-shards -1`` (one rank) on
   a 60,000-point capture. The workers are joined before each phase ends;
6. B7's entry point: the table of
   ``recognizer3d_tpu_torch.benchmarks.bench_roll_stages`` at
   (512, 128, 1024), with the launch counts set to 0 before it;
7. a reference-layout torch archive of the bundled weights, written under
   ``build/``, loaded on the card: the same state and the same predictions
   as the msgpack archive;
7b. the train path: an annotated mock dataset (12 clouds of 20,000 points,
   ``bin/make_mock_data``'s ``make_frame``) written under ``build/``, and
   the port's ``run_training`` at the app config on the card for 2 epochs
   (the app's augmentation, batches assembled on the card), with the
   launch counts set to 0 before it: B1 4 and B8 1 (the batch's selection)
   a train step, B1 4, B2 2 and B3 2 a validation forward, summed over its
   steps and forwards. Every loss
   finite; every parameter and running statistic moved from the seed-0
   init; the saved archive reloaded on the card answers one frame. Then,
   on the trained weights: the launches of one step and of one validation
   forward (the validation sweep's own batch of 3 clouds), the train
   step's wall p50 over 20 steps (synchronised), and one step on the card
   against the CPU from the same weights, batch, permutation and dropout
   mask. In float64 (the module in double; the geometry and the neighbour
   search stay float32, B1 included): the loss within 1e-5 relative, every
   gradient within 1e-4 × its tensor's largest |g| (a Dense bias before a
   BatchNorm, whose exact gradient is 0, at its weight's scale:
   ``benchmarks/train_precision.grad_distance``), the running statistics
   within 1e-5 of their tensor's largest value. In float32, the loss within
   1e-5, and, on 3 batches, the smallest median over the gradient tensors
   of the card's distance from the float64 step within
   ``FP32_GRAD_MEDIAN_LIMIT`` (5e-4), which the same steps with TF32
   matmuls allowed, the control, must exceed;
7c. the bfloat16 train path: ``run_training(compute_dtype="bfloat16")`` on
   7b's dataset for 2 epochs, launch counts as in 7b but for the
   validation forwards' bfloat16 LFA forms (B1 4 a step; B1 4, B2-bf16 2,
   B3-bf16 2 a validation forward; the float32 LFA forms 0). Every loss
   finite; every parameter and running statistic float32 and moved; the
   archive reloaded in bfloat16 and in float32, each answering a frame.
   Then, on the trained weights: every parameter's gradient float32, the
   launches of one step and of one validation forward, the wall p50 over 20
   bfloat16 steps beside 20 float32 steps (in turns, same weights and
   batches), and one bfloat16 step on each of 3 batches on the card against
   the CPU port under ``benchmarks/train_precision.bf16_steps_agree`` (every
   loss within ``BF16_LOSS_ULPS`` bfloat16 ulps; the middle of the 3
   batches' medians over the gradient tensors of the mean distance within
   ``BF16_GRAD_MEDIAN``), which the card's float32 steps from the same
   weights and batches, the control, must miss;
7d. checkpoints and resume: ``Model.train`` at the app config on 7b's
   dataset for 2 epochs with ``checkpoint_every=1`` under ``build/``; the
   ``latest`` marker must read 2, and the blob, decoded by
   ``utils/msgpack_lite``, must have flax's layout of the JAX trainer's
   state (``params``, ``batch_stats``, ``opt_state`` ``{count, mu, nu}``
   shaped like ``params``, ``epoch``, ``step``). A fresh model (seed 1) with
   ``resume=True, epochs=3`` must run only epoch 3, from a restored state
   (weights, running statistics, Adam's count, mu and nu, step) equal to
   the checkpoint bit for bit;
7e. data-parallel training: ``Model.train`` at the app config on 7b's
   dataset for 2 epochs (batch 4, the device pipeline, the app's
   augmentation) on ``RankPool(["cuda:0"] * 2)`` (two ranks sharing the
   card) and on one rank, under one numpy seed: every loss finite, the
   first step's loss at 2 ranks within 1e-5 relative of one rank's, both
   ranks' parameters and statistics bit-identical at the end (the trainer's
   digests); then 4 training clouds for one epoch (one step) at 2 ranks and
   at 1, the parameters inside JAX's envelope (95% quantile of |Δ| < 1e-4,
   max < 2.1·lr, under 2% beyond 1e-3). On the trained weights, through
   ``training/data_parallel.py``: one step with the launch counts set to 0
   on every rank before it, each rank's held to PER_STEP_ASSEMBLED (its
   block of the batch assembled on the rank: B8 once) and rank 0's
   kernel calls recorded for phase 8; the step's wall over 20 steps at 2
   ranks and at 1, in turns (2, 1, 1, 2); one step in float64 at 2 ranks
   against 1 from the same weights, batch, permutation and mask: both
   ranks' summed gradients equal, the loss within F64_LOSS_REL, every
   gradient within F64_GRAD (``train_precision.grad_distance``), the running
   statistics within F64_STATS;
7f. the point-sharded train step: the bundled weights at settings64a's
   widths with ``knn="naive"``, one seeded 65,536-point mock cloud, its
   labels and a seeded keep mask, over ``["cuda:0"] * 4`` (each rank its
   block of the cloud permuted on the host, the labels and mask permuted
   alike; ``RandLANet(..., backend=SPBackend())`` in train mode, the ring
   backward) against one rank's step on the unpermuted cloud: the launch
   counts set to 0 on every rank before each step and each rank's held to
   PER_SP_STEP, rank 0's kernel calls of the float32 step recorded for
   phase 8; in float64 the limits of 7e, in float32 the loss within 1e-5
   relative; the step's wall (forward, backward, gradient sum) at 4 ranks
   and at 1, in turns;
5h. (run after 7f, on its pool) the DP×SP grid: ``SPServing.
   confidences_permuted`` of 2 seeded 65,536-point clouds with
   ``batch_shards=2`` (2 rows of 2 ranks: each row a cloud, its ring over
   the cloud's points) at the bundled weights with ``knn="naive"``, the
   launch counts set to 0 on every rank before the timed call and each
   rank's held to PER_GRID_CALL; the confidences against the one-rank
   forward on the card within SP_ATOL + SP_RTOL·|ref| (5g's rule);
8. run one frame of each path, one call of each large path, one train
   step and one validation forward (batch 3) in each dtype while recording
   the inputs it hands to each kernel wrapper,
   then hold every kernel against its plain PyTorch version on those
   inputs (B5, which no path runs, on the inputs of B3's level-0 calls; B7 bit-exact at (512, 128, 1024) for S in 1, 5, 15, 45,
   the kernels line reporting S = 45), the LFA kernels' bfloat16 forms
   on the inputs of one frame of each bfloat16 path (``_lfa_error``)
   and time the kernel, the plain version and (where one exists) a PyTorch
   library call computing the same function (device time from
   torch.profiler). B1 must equal its plain version with the indices in
   order, as the window kernel must, and B4 the first entry of the stable
   sort (``knn_topk_plain(support, query, 1)``), ties included; a call of
   over 2^30 distances (the large paths' biggest) is held on 8,192 seeded
   query rows (whole query blocks of the window search), its plain version
   and library call timed on them and scaled to all rows (the kernels line
   says so in the row's ``note``), and its work counted by the CPU model on
   every eighth of them (on 1,024 seeded query rows, scaled, for any other
   call of over 8,192 queries); B1's box pass (its global-memory form, above
   2,048 support points) must write the boxes PyTorch's ``amin``/``amax``
   compute, bit for bit, and such a call's time is the route's span (the
   box pass's start to the walk's end: the walk is a programmatic
   dependent launch whose recorded time includes its wait for the box
   pass, so the two kernels' sum, printed beside it, counts the overlap
   twice), with the device time of a one-element ``fill_``, the launch
   floor, once; each LFA call is held, and the
   first of each shape timed; their
   bounds count the distances their culled walks evaluate at those inputs
   (the CPU models in ``benchmarks/knn_cull.py`` and
   ``benchmarks/argmin_cull.py``), not every pair; the bfloat16 LFA forms'
   bounds take their dots at the tensor cores' bfloat16 rate
   (``_lfa_bound``); B8 bit-equal to its plain version (the stable sort)
   on the live frame's and a data-parallel step's recorded calls, timed
   beside ``torch.sort`` (its library call). B8 again on the live shape
   (786,432 priorities -> 16,384) under a seeded draw and under the same
   draw rounded to 1/256, and at the train shape (4 x 20,000 -> 2,500, one
   row of 1,800 valid points), each bit-equal to the plain version and
   timed beside ``torch.sort`` and ``torch.topk``; and the exact k = 32
   self-KNN of the approx64k frame's Morton-sorted 65,536-point level 0
   (the recall guard's exact fallback) on B1 and on the brute-force
   streaming kernel that B1 replaced, both held against the plain version;
   and B1 at the large-scene exact route's level 0 (1,048,576 points):
   bit-equal to the streaming kernel on every row, the box pass, the walk,
   the route's span and the streaming kernel (once) timed; then every kernel call rank 0
   made in 5g's recorded call (B1 at the 16 ring steps of the encoder on
   unsorted blocks, with its box pass; B4 at the 12 of the decoder, with
   its ordering launch where it has one), by the rules above, each call
   timed, B1's bound counted on the same blocks Morton-sorted (its walk on
   these unsorted blocks is the algorithm failing, not the work the
   function needs; B4 bins its support itself, so its walk does not
   depend on the order); and at one level-0 ring step (262,144 unsorted
   queries against a 262,144-point block), the share of the M·N distances
   the walk evaluates on the unsorted blocks (the work the culling fails
   to skip) beside B1 on the same blocks Morton-sorted, held to its plain
   version on sampled rows and timed; then rank 0's calls of one 7e step
   and of one 7f step by the same rules (7f's B1 bounds counted on its
   unsorted ring blocks Morton-sorted, as 5g's);
9. print the ``{"kernels": [...]}`` line (its launches count every rank's),
   then the result line. The
   ``knn_topk`` row is B1 (in its global-memory form, box pass and walk);
   the ``knn_topk_boxes`` row is the global form's box pass alone, held
   against ``amin``/``amax``.

It imports nothing of JAX or of the JAX package.
"""

import importlib.machinery
import importlib.util
import json
import math
import shutil
import statistics
import subprocess
import sys
import time
from datetime import datetime, timedelta
from pathlib import Path
from types import SimpleNamespace

import numpy as np

ROOT = Path(__file__).resolve().parent
ARCHIVE = ROOT / "pretrained" / "mock_fingertip"
FRAME_POINTS = 60_000
# frames of each predict path (app, approx64k, their bf16 forms, live; every
# bf16 frame also runs twice on the CPU): 3, so that the whole script keeps
# well inside its time limit (at 5 it took 796 s of 1,200 on an H100 80GB
# HBM3 whose host built the kernels in 37 s)
N_FRAMES = 3
# launches of each kernel per live frame at the app config: the four
# encoder self-KNNs (the 2,500-point one in B1's global-memory form, after
# its box pass), the fused LFA at encoder levels 0 and 1, and the final
# 2,500 -> full-cloud 1-NN upsample
PER_FRAME = {"knn_topk": 4, "knn_topk_boxes": 1, "lfa_round1": 2, "lfa_pool2_res": 2,
             "argmin_1nn": 1}

# the approximate path: bench.py's settings64a on the bundled weights, frames
# of the size of a depth-camera capture (bucket 163,840)
APPROX_SETTINGS = dict(knn="approximate", n_points=65_536)
APPROX_ARCHIVE = ROOT / "build" / "approx64k" / "mock_fingertip_approx64k"
APPROX_FRAME_POINTS = 150_000
# launches per frame: the Morton-window self-KNNs of levels 0 and 1 and the
# window 1-NN of the final 65,536 -> 163,840 upsample; the exact self-KNNs
# of levels 2 and 3 (the 4,096-point one after a box pass); the fused LFA at levels 0 and 1; the 1-NN kernel for
# the decoder's 4,096 -> 16,384 and 16,384 -> 65,536 upsamples, the latter
# after the launch that orders its 16,384-point support into global memory
PER_FRAME_64K = {
    "knn_window_topk": 3, "knn_topk": 2, "knn_topk_boxes": 1, "lfa_round1": 2,
    "lfa_pool2_res": 2, "argmin_1nn": 2, "argmin_1nn_order": 1,
}

# the bfloat16 compute mode: the app archive and the approx64k settings
# loaded with compute_dtype="bfloat16" and saved under build/; per frame the
# LFA kernels' bfloat16 forms take the float32 forms' launches
BF16_ARCHIVE = ROOT / "build" / "bf16" / "mock_fingertip_bf16"
APPROX_BF16_ARCHIVE = ROOT / "build" / "bf16" / "mock_fingertip_approx64k_bf16"
_TO_BF16 = {"lfa_round1": "lfa_round1_bf16", "lfa_pool2_res": "lfa_pool2_res_bf16"}
PER_FRAME_BF16 = {_TO_BF16.get(k, k): v for k, v in PER_FRAME.items()}
PER_FRAME_64K_BF16 = {_TO_BF16.get(k, k): v for k, v in PER_FRAME_64K.items()}
# the bfloat16 mask's foreground IoU against the float32 mask, every frame.
# On an H100 (80GB HBM3, 700 W) it read 1.0 on each of the 5 frames of both
# bfloat16 paths (the mock frames' confidences lie far from the threshold);
# the JAX package's TPU gate saw 0.91-1.0 on real captures
# (benchmarks/bf16_validation.json), which these frames are not
BF16_MASK_IOU_FLOOR = 0.99

# the live depth path: the app archive at the L515's default intrinsics, 16,384
# display points (main.py's LivePredictor), depth frames made from mock frames
# of 60,000 points; per frame the four encoder self-KNNs, the fused LFA at
# levels 0 and 1, the 2,500 -> 16,384 1-NN upsample, and B8's selection of the
# 16,384 display points from the frame's 786,432 pixels
LIVE_DISPLAY = 16_384
PER_FRAME_LIVE = {"knn_topk": 4, "knn_topk_boxes": 1, "lfa_round1": 2, "lfa_pool2_res": 2,
                  "argmin_1nn": 1, "select_smallest": 1}

# B7 at the TPU benchmark's shape, and its entry point's launches: five runs
# (the 1-stage base and S = 1, 5, 15, 45), each an untimed and a timed chain
# of 5 calls
ROLL_SHAPE = (512, 128, 1024)
ROLL_STAGES = (1, 5, 15, 45)
ROLL_TABLE_LAUNCHES = 5 * 2 * 5

TORCH_ARCHIVE = ROOT / "build" / "torch_archive" / "mock_fingertip_reference"

# the app entry point (recognizer3d_tpu_torch.app.App) under the repository's
# tkinter and vispy stubs, run from APP_DIR: its data/mock holds APP_CLOUDS
# seeded mock frames of FRAME_POINTS points, its models/ a copy of the bundled
# archive. Each branch is timed over APP_TICKS predicting ticks, each made due
# at once; a tick launches the kernels of the branch's path
APP_DIR = ROOT / "build" / "app"
APP_CLOUDS = 4
APP_TICKS = 10
APP_MODEL = "2026_01_01__00_00_00_000000000"

# knn="kdtree": the bundled weights with the host KD-tree in every encoder
# level and decoder upsampling, the final upsample on the exact "naive" route
KDTREE_ARCHIVE = ROOT / "build" / "kdtree" / "mock_fingertip_kdtree"
KDTREE_FRAMES = 3
PER_FRAME_KDTREE = {"lfa_round1": 2, "lfa_pool2_res": 2, "argmin_1nn": 1}

# batch serving (BASELINE.json config 2): the port's serve CLI with the bundled
# archive at batch 8 over seeded mock captures under SERVE_DIR, two size
# groups and a partial batch; every batch (the warm-up batches included, one
# per distinct (B, bucket)) launches the app path's kernels once
SERVE_DIR = ROOT / "build" / "serve"
SERVE_CLOUDS = ((16, 60_000), (3, 50_000))
SERVE_BATCH = 8

# the large-scene forward (BASELINE.json config 5): benchmarks/bench_large.py's
# first 0.2·randn cloud of 1,048,576 points and its permutation, through
# Model.predict(prepostprocess=False) with the bundled weights at that
# n_points: the chunked forward (models/large.py), levels 1,048,576 / 262,144
# / 65,536 / 16,384 / 4,096, chunk 65,536. Per call, exact route: B1 at the
# four encoder levels and the 262,144 -> 1,048,576 1-NN at k = 1, each in
# the global-memory form (a box pass and a walk); B4 for the supports of 4,096, 16,384 and 65,536 (the last
# two ordered by a launch of their own); B2 and B3 on 16 chunks of level 0
# and 4 of level 1; no streaming kernel. Approximate route, at the session
# window the recall guard settles on for this cloud, LARGE_WINDOW (the run
# fails on another): the window search at encoder levels 0-2 (k = 32) and for
# the supports of 65,536 and 262,144 (k = 1); B1 at level 3, whose 16,384
# points take knn_window's exact branch; B4 for 4,096 and 16,384; B2 and B3
# as above
LARGE_POINTS = 1_048_576
LARGE_CALLS = 3
LARGE_WINDOW = 16_384
PER_CALL_LARGE = {
    "naive": {"knn_topk": 5, "knn_topk_boxes": 5, "argmin_1nn": 3, "argmin_1nn_order": 2,
              "lfa_round1": 20, "lfa_pool2_res": 20},
    "approximate": {"knn_window_topk": 5, "knn_topk": 1, "knn_topk_boxes": 1, "argmin_1nn": 2,
                    "argmin_1nn_order": 1, "lfa_round1": 20, "lfa_pool2_res": 20},
}
# the card against the CPU port at reduced size: forward_eval_large called
# directly, chunk 4,096 (levels 0 and 1 fused, in 4 and 1 chunks at the
# exact route's size; the levels below on the chunked branch), at 16,384
# points on the exact route and at 32,768 on the approximate route, whose
# level 0 then searches windows of LARGE_WINDOW points (at no more points it
# would take the exact branch); logits held to within 1e-4 of the largest
# |logit| (they reach about 70 there)
LARGE_CPU_POINTS = {"naive": 16_384, "approximate": 32_768}
LARGE_CPU_CHUNK = 4_096
LARGE_CPU_REL_TOL = 1e-4
# phase 8 holds a call with over this many (query, support) distances, or
# (query, window point) distances, against the plain version on
# LARGE_KNN_SAMPLE seeded query rows (whole query blocks of the window
# search), its plain version and library call timed on them and scaled to
# all rows, and its CPU work model run on every eighth of them; the work
# model of any other call of over 8 * WORK_MODEL_ROWS queries walks
# WORK_MODEL_ROWS seeded rows, scaled to all (the walk of a query does not
# depend on the others'; every row of a 65,536-query 1-NN call took 14 s)
LARGE_CHECK_DISTANCES = 1 << 30
LARGE_KNN_SAMPLE = 8_192
WORK_MODEL_ROWS = LARGE_KNN_SAMPLE // 8

# data-parallel serving (phase 5f, BASELINE.json config 2): DPServing of the
# bundled archive on DP_DEVICES, two ranks sharing the one card, over 5d's
# captures at batch 8 (one ragged batch of 3, two full batches of 8); each
# rank's block of a batch is one forward that launches PER_FRAME
DP_DEVICES = ["cuda:0", "cuda:0"]
DP_TOL = 1e-4

# point-sharded serving (phase 5g, BASELINE.json config 5): SPServing of the
# bundled weights on SP_DEVICES, four ranks on the one card, over the 5e
# cloud (1,048,576 points: its bucket, and a multiple of the granule
# 4 * 4^4 = 1,024). Per rank and call: the ring passes of the four encoder
# levels, 4 steps each, each step B1 in its global-memory form (its support
# blocks of 262,144 / 65,536 / 16,384 / 4,096 points are over 2,048: a box
# pass and a walk); the decoder's ring 1-NN passes onto levels 2, 1 and 0,
# 4 steps each, on B4 (supports of 4,096, 16,384 and 65,536 points, the last
# two ordered by a launch of their own), the 1,024 -> 4,096 one on the plain
# 1-NN route; no fused LFA (the point-sharded block runs unfused, as JAX's)
SP_DEVICES = ["cuda:0"] * 4
SP_CALLS = 3
PER_CALL_SP = {"knn_topk": 16, "knn_topk_boxes": 16, "argmin_1nn": 12, "argmin_1nn_order": 8}
# the confidences against forward_eval_large on the exact route (JAX's own
# SP-against-single-device tolerance, tests/test_parallel.py)
SP_ATOL, SP_RTOL = 5e-4, 1e-3
# phase 8 runs the CPU model of B1's walk on one level-0 ring step's
# unsorted inputs (rank 0's block of 262,144 permuted points against the
# block of rank 3, the one that visits it at step 1) on every
# SP_MODEL_STRIDE-th of LARGE_KNN_SAMPLE sampled rows (unsorted blocks
# defeat the culling, so the model walks nearly every tile: about 5 s for
# 32 rows)
SP_MODEL_STRIDE = 256
SP_CLI_POINTS = 60_000

# the train path: the app's recipe (recognizer3d_tpu_torch.train.run_training)
# on an annotated mock dataset, 2 epochs; 12 clouds split 9 / 3, so 3 steps
# of batch 4 and 10 validation forwards (10 seeds, one batch) an epoch
TRAIN_DIR = ROOT / "build" / "train_mock"
TRAIN_OUT = ROOT / "build" / "train_run"
TRAIN_CLOUDS = 12
TRAIN_POINTS = 20_000
TRAIN_EPOCHS = 2
STEP_REPS = 20
# launches per train step (B1 at each encoder level) and per validation
# forward (eval mode under inference_mode, as predict); a step whose batch
# is assembled on the card (DeviceDatasetCache: the trainer's epochs, the
# data-parallel rank's steps) launches B8 once more, to select the batch's
# points (the validation batches come from the host loader)
PER_STEP = {"knn_topk": 4, "knn_topk_boxes": 1}
PER_STEP_ASSEMBLED = {**PER_STEP, "select_smallest": 1}
PER_VAL_FORWARD = {"knn_topk": 4, "knn_topk_boxes": 1, "lfa_round1": 2, "lfa_pool2_res": 2}
# the bfloat16 train path (phase 7c): run_training(compute_dtype="bfloat16")
# on the same dataset. A step launches what the float32 step launches (the
# train forward is unfused in both dtypes, its geometry float32); a
# validation forward the LFA kernels' bfloat16 forms in place of the float32
TRAIN_OUT_BF16 = ROOT / "build" / "train_run_bf16"
PER_VAL_FORWARD_BF16 = {_TO_BF16.get(k, k): v for k, v in PER_VAL_FORWARD.items()}
# checkpoints and resume (phase 7d): Model.train's log_dir
CKPT_RUN = ROOT / "build" / "train_ckpt"
# data-parallel training (phase 7e): Model.train at the app config on 7b's
# dataset (9 training clouds: 2 steps of batch 4 an epoch over 2 ranks, the
# ragged remainder dropped, 3 on one rank) on DP_TRAIN_DEVICES, two ranks
# sharing the card, against one rank under one numpy seed; JAX's envelope on
# the parameters after one step (DP_ENVELOPE_CLOUDS training clouds, one
# epoch); a step launches PER_STEP_ASSEMBLED on every rank (its block of 2
# clouds, assembled on the rank)
DP_TRAIN_DEVICES = ["cuda:0"] * 2
DP_TRAIN_SEED = 11
DP_ENVELOPE_CLOUDS = 4
# one step over ranks in float64 against one rank (the geometry and the
# search float32 on both sides, B1 included): the loss relative, every
# gradient to its tensor's largest |g| (a Dense bias before a BatchNorm to
# its weight's: ``train_precision.grad_distance``), the running statistics
# to their tensor's largest value
F64_LOSS_REL, F64_GRAD, F64_STATS = 1e-10, 1e-8, 1e-10
# the point-sharded train step (phase 7f): settings64a's widths (K 32,
# decimation 4, layers [16, 64, 128, 256]) with knn="naive" and the bundled
# weights, one cloud of SP_TRAIN_POINTS points over SP_TRAIN_DEVICES. Per rank
# and step: B1 at the 4 steps of each encoder level's ring (blocks of
# 16,384 / 4,096 / 1,024 / 256 points, the first two after a box pass); the
# decoder's ring 1-NN onto level 0 on B4 (support blocks of 4,096 points, no
# ordering launch), the three coarser ones on the plain 1-NN route; the
# backward searches nothing (the indices are saved)
SP_TRAIN_DEVICES = ["cuda:0"] * 4
SP_TRAIN_POINTS = 65_536
PER_SP_STEP = {"knn_topk": 16, "knn_topk_boxes": 8, "argmin_1nn": 4}
# the DP×SP grid's forward (phase 5h): GRID_CLOUDS clouds of SP_TRAIN_POINTS
# points on the four ranks as GRID_ROWS rows of 2 (each row a cloud, its ring
# of 2 ranks over the cloud's points). Per rank: B1 at the 2 steps of each
# encoder level (blocks of 32,768 / 8,192 / 2,048 / 512 points, the first
# two after a box pass); B4 onto levels 0 (support blocks of 8,192: an
# ordering launch each) and 1 (2,048), 2 steps each; the rest plain
GRID_ROWS = 2
GRID_CLOUDS = 2
PER_GRID_CALL = {"knn_topk": 8, "knn_topk_boxes": 4, "argmin_1nn": 4, "argmin_1nn_order": 2}
# a float32 step's distance from the float64 step: per batch the median
# over the gradient tensors of ``benchmarks/train_precision.grad_distances``,
# then the smallest over PRECISION_BATCHES batches. On an H100 (80GB HBM3,
# 700 W), one batch's median read 3.9e-6 to 4.5e-4 on the card over 12
# app-config steps, and 3.0e-3 to 6.8e-3 with TF32 matmuls; it is
# heavy-tailed (BatchNorm over nearly constant channels amplifies a
# rounding now and then), as the largest tensor's distance is more so (up
# to 1.7e-2 in float32, from 5.6e-2 with TF32), which takes no limit. The
# smallest of 3 consecutive batches of that script's 10 read at most
# 2.2e-5 in float32 and at least 3.0e-3 with TF32.
PRECISION_BATCHES = 3
FP32_GRAD_MEDIAN_LIMIT = 5e-4

# kernels whose registers, shared memory and spills the build report prints
PTXAS_KERNELS = ("knn_cull_kernel", "knn_box_kernel", "knn_window_kernel", "argmin_cull_kernel",
                 "argmin_order_kernel", "lfa_round1_tile_kernel", "lfa_pool2_tile_kernel",
                 "lfa_round1_mma_kernel", "lfa_pool2_mma_kernel", "roll_stages_kernel",
                 "select_cluster_kernel")
# the bfloat16 LFA kernels, whose dots run on the tensor cores: every compiled
# instance must hold HMMA instructions in its SASS
MMA_KERNELS = ("lfa_round1_mma_kernel", "lfa_pool2_mma_kernel")

# kernel -> (source, the TPU kernel it replaces), in the order of the line
KERNELS = {
    "knn_topk": ("recognizer3d_tpu_torch/csrc/knn.cu",
                 "recognizer3d_tpu/ops/knn_pallas.py:109"),
    # B1's box pass, knn_box_kernel, counted on its own: the boxes of the TPU
    # kernel's hbm=True form (knn_pallas.py:641), which B1's walk reads from
    # global memory above 2,048 support points
    "knn_topk_boxes": ("recognizer3d_tpu_torch/csrc/knn.cu",
                       "recognizer3d_tpu/ops/knn_pallas.py:109"),
    "argmin_1nn": ("recognizer3d_tpu_torch/csrc/knn.cu",
                   "recognizer3d_tpu/ops/knn_pallas.py:402"),
    "lfa_round1": ("recognizer3d_tpu_torch/csrc/lfa.cu",
                   "recognizer3d_tpu/ops/lfa_pallas.py:138"),
    "lfa_pool2_res": ("recognizer3d_tpu_torch/csrc/lfa.cu",
                      "recognizer3d_tpu/ops/lfa_pallas.py:221"),
    "lfa_pool2": ("recognizer3d_tpu_torch/csrc/lfa.cu",
                  "recognizer3d_tpu/ops/lfa_pallas.py:192"),
    "knn_window_topk": ("recognizer3d_tpu_torch/csrc/knn.cu",
                        "recognizer3d_tpu/ops/knn.py:348"),
    "roll_stages": ("recognizer3d_tpu_torch/csrc/bitonic.cu",
                    "benchmarks/bench_roll_stages.py:56"),
    # the bfloat16 forms of B2, B3, B5 (the TPU kernels under io = bfloat16:
    # lfa_pallas.py:322, :509, :445), on the tensor cores
    "lfa_round1_bf16": ("recognizer3d_tpu_torch/csrc/lfa.cu",
                        "recognizer3d_tpu/ops/lfa_pallas.py:138"),
    "lfa_pool2_res_bf16": ("recognizer3d_tpu_torch/csrc/lfa.cu",
                           "recognizer3d_tpu/ops/lfa_pallas.py:221"),
    "lfa_pool2_bf16": ("recognizer3d_tpu_torch/csrc/lfa.cu",
                       "recognizer3d_tpu/ops/lfa_pallas.py:192"),
    # B8: the n smallest priorities (the TPU's approx_min_k), the live
    # path's z-band selection and every train batch's on the card
    "select_smallest": ("recognizer3d_tpu_torch/csrc/select.cu",
                        "recognizer3d_tpu/data/pipeline.py:115"),
}

# published H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, float32
# operations/s outside the tensor cores, and bfloat16 products summed in
# float32 on the tensor cores (a bfloat16 product is exact in float32, so
# that is the bfloat16 dot's contract; the float32 dots have no tensor-core
# rate of their own, TF32 rounds their operands)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
PEAK_BF16_TENSOR_OPS_PER_S = 989e12
# float32 lane instructions/s: the 67 TFLOP/s count an FMA as two
# operations; a compare or a select is one instruction, executed at the
# FMA's instruction rate, so work made of them is bounded at half the flop
# rate
PEAK_F32_INSTR_PER_S = PEAK_F32_OPS_PER_S / 2


def _make_frame():
    loader = importlib.machinery.SourceFileLoader(
        "make_mock_data", str(ROOT / "bin" / "make_mock_data")
    )
    spec = importlib.util.spec_from_loader("make_mock_data", loader)
    module = importlib.util.module_from_spec(spec)
    loader.exec_module(module)
    return module.make_frame


def _gpu_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return res.stdout.strip().splitlines()[0]


def _device_ms(torch, fn, reps: int, kernel=""):
    """Device time per call of ``fn``: torch.profiler's CUDA activity over
    ``reps`` back-to-back calls after one warm-up call
    (``utils/profiling.device_ms`` and ``kernel_ms``). With ``kernel``,
    only the kernels whose name contains it count (a wrapper's own small
    PyTorch operators and the host's launch gaps stay out); without, every
    kernel and copy the calls ran; with a tuple of names of kernels that
    ``fn`` launches once each, the time of each launch, the mean over the
    launches the session recorded. The card's profiler now and then drops
    a session's device activity: a session with fewer device events than
    calls (with a tuple, with no event of a name) is taken again, up to
    three sessions. If none records them, the run fails: the recorded
    kernel is the only proof on the device's side that the named kernel
    ran while it was timed. (Late in a long process, sessions kept 2 to 4
    of 5 launches of B1's box pass, and none of one launch of the streaming
    kernel; ``_event_ms`` times the long calls of the large paths.)"""
    from recognizer3d_tpu_torch.utils import profiling

    if isinstance(kernel, tuple):
        return profiling.kernel_ms(fn, reps, kernel)
    return profiling.device_ms(fn, reps, kernel)


def _event_ms(torch, fn) -> float:
    """Time of one call of ``fn`` between two CUDA events on the current
    stream: for the plain versions and library calls of the sampled large
    calls, thousands of kernels that keep the card busy for a second or
    more, so the gaps between kernels are a small part of the time (a
    profiler session of them, tens of thousands of events, was followed by
    sessions that dropped launches)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def _plain_library_ms(torch, plain, library, reps: int, scale: float):
    """(ms of ``plain``, ms of ``library``) for a call: profiler device time
    over ``reps`` calls; for a sampled call (``scale`` > 1, the rows' share
    of the call), one call of each between CUDA events (``_event_ms``; the
    library warmed by one call first), scaled to all rows."""
    if scale == 1:
        return _device_ms(torch, plain, reps), _device_ms(torch, library, reps)
    library()
    return _event_ms(torch, plain) * scale, _event_ms(torch, library) * scale


def _bound(nbytes: float, nops: float, ops_per_s: float = PEAK_F32_OPS_PER_S):
    """Least time (ms) the card could take: the larger of bytes over the
    memory rate and float32 operations over ``ops_per_s`` (the flop rate,
    or the instruction rate for work that is no FMA)."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = nops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _lfa_bound(nbytes: float, dots: float, rest: float, bf16: bool):
    """``_bound`` of a fused LFA kernel's work: in bfloat16 its dots at the
    tensor cores' bfloat16 rate and the rest (distances, RPE, BatchNorm,
    softmax, activations, the weighted sums over K) at the float32 rate,
    their times added; in float32 all of it at the float32 rate."""
    if not bf16:
        return _bound(nbytes, dots + rest)
    return _bound(nbytes, dots / PEAK_BF16_TENSOR_OPS_PER_S * PEAK_F32_OPS_PER_S + rest)


# --- work counts (each input read once, each output written once) ----------


def _knn_work(m: int, n: int, k: int):
    # 3 subtractions, 3 multiplications, 2 additions and a compare per
    # (query, support) pair, no FMA (the kernels forbid contraction): lane
    # instructions, bounded at PEAK_F32_INSTR_PER_S
    return 4 * 3 * (m + n) + 8 * m * k, 9 * m * n


def _cull_work(support, query, k: int, rows=None):
    # B1 reads each input once and writes (idx, d2) once (its boxes are its
    # own, neither input nor output), and spends 9 lane instructions (as in
    # _knn_work) on each distance the culled selection evaluates, counted by
    # its CPU model
    # (benchmarks/knn_cull.py) at these inputs with one query a warp: the
    # fewest the walk evaluates (two queries a warp visit a tile either
    # needs). With ``rows`` (numpy), the model walks those query rows only,
    # and their count is scaled to all rows
    from recognizer3d_tpu_torch.benchmarks import knn_cull

    b, m, n = query.shape[0], query.shape[1], support.shape[1]
    distances = sum(
        int(knn_cull.select(s, q, k, 1, rows=rows)[2]["distances"].sum())
        for s, q in zip(support.cpu().numpy(), query.cpu().numpy())
    )
    scale = 1 if rows is None else m / len(rows)
    return b * (4 * 3 * (m + n) + 8 * m * k), 9 * distances * scale


def _argmin_work(support, query, rows=None):
    # B4 reads each input once and writes (idx, d2) once, and spends 9 lane
    # instructions (as in _knn_work) on each distance its walk evaluates,
    # counted by its CPU model (benchmarks/argmin_cull.py) at these inputs
    # (with ``rows``, at those query rows, scaled to all rows: the walk of
    # a query does not depend on the others)
    from recognizer3d_tpu_torch.benchmarks import argmin_cull

    b, m, n = query.shape[0], query.shape[1], support.shape[1]
    q_np = query.cpu().numpy() if rows is None else query[:, rows].cpu().numpy()
    distances = sum(
        int(argmin_cull.select(s, q)[2]["distances"].sum())
        for s, q in zip(support.cpu().numpy(), q_np)
    )
    scale = 1 if rows is None else m / len(rows)
    return b * (4 * 3 * (m + n) + 8 * m), 9 * distances * scale


def _window_work(m: int, n: int, w: int, k: int):
    # the window search evaluates w distances per query, 9 lane
    # instructions each as in _knn_work
    return 4 * 3 * (m + n) + 4 * m * 2 * k, 9 * m * w


def _round1_work(rows: int, k: int, h: int, elem: int = 4):
    # (bytes, dot operations, other operations); elem: bytes of a row
    # element (gathered, pooled, rpe2): 4, or 2 in bfloat16; d2, the centre
    # term and the constants stay float32
    c2 = 2 * h
    nbytes = rows * (elem * (k * c2 + h + k * h) + 4 * (k + h)) + 4 * (5 * h + 7 * h * h)
    dots = (
        2 * k * c2 * c2        # scores
        + 2 * c2 * h           # pool MLP
        + 2 * k * h * h        # mlp_rpe2
    )
    rest = (
        k                      # sqrt of the distances
        + 5 * k * h            # RPE sum, w9 term, BN affine, relu
        + 5 * k * c2           # softmax over K
        + 2 * k * c2           # weighted sum
        + 2 * h                # pool MLP's offset, relu
        + 2 * k * h            # mlp_rpe2's offset, relu
    )
    return nbytes, rows * dots, rows * rest


def _pool2_work(rows: int, k: int, h: int, f: int, residual: bool = True, elem: int = 4):
    # (bytes, dot operations, other operations); elem: bytes of a row
    # element (rpe2, g2, f_in, out): 4, or 2 in bfloat16
    c2, c4 = 2 * h, 4 * h
    dots = 2 * k * c2 * c2 + 2 * c2 * c2           # scores, pool MLP
    rest = 5 * k * c2 + 2 * k * c2 + 2 * c2         # softmax, sum, offset, relu
    if not residual:
        nbytes = elem * rows * (2 * k * h + c2) + 4 * (2 * c2 * c2 + c2)
        return nbytes, rows * dots, rows * rest
    nbytes = elem * rows * (2 * k * h + f + c4) + 4 * (
        2 * c2 * c2 + c2 + c2 * c4 + f * c4 + c4
    )
    dots += 2 * c2 * c4 + 2 * f * c4                # mlp2, shortcut
    rest += 3 * c4                                  # offset, lrelu
    return nbytes, rows * dots, rows * rest


def _roll_work(n_elem: int, stages: int):
    # each element read and written once; per stage a compare and two
    # selects (value and payload: which side keeps the minimum is a function
    # of the position, not of the data), then the epilogue's conversion,
    # multiply and add: lane instructions, bounded at PEAK_F32_INSTR_PER_S
    return 8 * n_elem, n_elem * (3 * stages + 3)


class _Recorder:
    """Swap the kernel wrappers the model calls for recording ones, so one
    frame yields the exact inputs the main path hands each kernel."""

    def __init__(self, targets):
        self.targets = targets  # (module, attribute name, kernel name)
        self.calls = {name: [] for _, _, name in targets}
        self._saved = []

    def __enter__(self):
        for module, attr, name in self.targets:
            original = getattr(module, attr)
            self._saved.append((module, attr, original))

            def record(*args, _fn=original, _name=name, **kwargs):
                self.calls[_name].append((args, kwargs))
                return _fn(*args, **kwargs)

            setattr(module, attr, record)
        return self

    def __exit__(self, *exc):
        for module, attr, original in self._saved:
            setattr(module, attr, original)


def _drive(torch, build, predictor, frames, per_frame, label):
    """Answer ``frames`` with every launch count set to 0 before each frame;
    each frame must launch exactly ``per_frame``. Returns the latencies (ms),
    the masks and the launches summed over the frames."""
    n_points = frames[0].shape[0]
    latencies, masks, totals = [], [], {}
    for frame in frames:
        torch.cuda.synchronize()
        build.reset_launches()
        t = time.perf_counter()
        masks.append(predictor.predict(frame))
        latencies.append((time.perf_counter() - t) * 1e3)
        launches = dict(build.LAUNCHES)
        if launches != per_frame:
            raise RuntimeError(f"{label}: launches {launches} in a frame, expected {per_frame}")
        for name, count in launches.items():
            totals[name] = totals.get(name, 0) + count
    for mask in masks:
        if mask.shape != (n_points,) or mask.dtype != np.bool_:
            raise RuntimeError(f"{label}: mask of shape {mask.shape} and dtype {mask.dtype}")
        if not 0 < mask.sum() < n_points:
            raise RuntimeError(f"{label}: degenerate mask: {int(mask.sum())} positives")
    print(f"{label}: {len(frames)} frames of {n_points} points, launches {totals}",
          flush=True)
    print(f"{label}: per-frame latency ms: {[round(x, 3) for x in latencies]}; "
          f"p50 {statistics.median(latencies):.3f} ms; positives "
          f"{[int(m.sum()) for m in masks]}", flush=True)
    return latencies, masks, totals


def _probe_first_frame(torch, port_knn, predictor, frame, label):
    """The first frame of an approximate path, after the guard was reset:
    ``Predictor`` keeps its warm-up out of the session recall guard, so the
    guard probes this (seeded) frame, and the window it settles on is the
    same in every process. Prints the window and the exact fallback."""
    predictor.predict(frame)
    torch.cuda.synchronize()
    print(f"{label}: recall guard on the first frame: {predictor.model.recall_guard_result}; "
          f"session window {port_knn.session_window_points()}, exact fallback "
          f"{port_knn.session_exact_fallback()}", flush=True)


def _card_vs_cpu(Model, archive, frame, label):
    """One frame's confidences on the card against the same Model.predict
    on the CPU (float32): within 1e-4, masks equal where the CPU's class-1
    confidence lies more than 1e-4 from the threshold 0.5. Returns the
    card's model."""
    conf_tol = band = 1e-4
    model = Model.load(archive, device="cuda", transfer_dtype="float32")
    cpu_model = Model.load(archive, device="cpu", transfer_dtype="float32")
    np.random.seed(7)
    conf_gpu = model.predict(frame)
    np.random.seed(7)
    conf_cpu = cpu_model.predict(frame)
    if conf_gpu.shape != (2, frame.shape[0]) or not np.isfinite(conf_gpu).all():
        raise RuntimeError(f"{label}: confidences of shape {conf_gpu.shape}, or not finite")
    diff = np.abs(conf_gpu - conf_cpu)
    conf_err = float(diff.max())
    near = np.abs(conf_cpu[1] - 0.5) <= band
    mask_diff = int(((conf_gpu[1] > 0.5) != (conf_cpu[1] > 0.5))[~near].sum())
    if conf_err > conf_tol or mask_diff:
        raise RuntimeError(
            f"{label}: card vs CPU: max abs conf err {conf_err}, {mask_diff} mask points differ"
        )
    print(f"{label}: card vs CPU confidences: max abs err {conf_err:.3g}, mean "
          f"{float(diff.mean()):.3g}, masks equal ({int(near.sum())} points within {band} of "
          f"the threshold)", flush=True)
    return model


def _bf16_card_vs_cpu(Model, archive32, archive, frames, label):
    """Every frame of a bfloat16 path on the card against the same
    Model.predict on the CPU (frame i after ``np.random.seed(i)``), judged on
    the logits by ``bf16_card_vs_cpu.logits_agree``; the control, the card's
    float32 model of the same settings against the CPU's bfloat16 model,
    must fail that rule on every frame. Returns the card's bfloat16 model."""
    from recognizer3d_tpu_torch.benchmarks.bf16_card_vs_cpu import (
        describe, logits_agree, predict_logits)

    model = Model.load(archive, device="cuda", transfer_dtype="float32")
    cpu_model = Model.load(archive, device="cpu", transfer_dtype="float32")
    model32 = Model.load(archive32, device="cuda", transfer_dtype="float32")
    for i, frame in enumerate(frames):
        conf, logits = predict_logits(model, frame, i)
        _, logits_cpu = predict_logits(cpu_model, frame, i)
        _, logits32 = predict_logits(model32, frame, i)
        if conf.shape != (2, frame.shape[0]) or not np.isfinite(conf).all():
            raise RuntimeError(f"{label}: confidences of shape {conf.shape}, or not finite")
        ok, reading = logits_agree(logits, logits_cpu)
        control_ok, control = logits_agree(logits32, logits_cpu)
        print(f"{label}: frame {i} card vs CPU: {describe(reading)}; control (the card's "
              f"float32 model): {describe(control)}", flush=True)
        if not ok or control_ok:
            raise RuntimeError(f"{label}: frame {i}: the card's bfloat16 logits "
                               f"{'meet' if ok else 'miss'} the rule against the CPU's, the "
                               f"float32 control {'meets' if control_ok else 'misses'} it")
    return model


def _bf16_mask_iou(Model, archive32, archive16, frames, label):
    """The bfloat16 model's foreground mask against the float32 model's on
    each frame (the same permutation, float16 upload as ``Predictor``):
    the IoU per frame, held to ``BF16_MASK_IOU_FLOOR``."""
    m32 = Model.load(archive32, device="cuda", transfer_dtype="float16")
    m16 = Model.load(archive16, device="cuda", transfer_dtype="float16")
    ious = []
    for i, frame in enumerate(frames):
        np.random.seed(i)
        a = m32.predict_mask(frame)
        np.random.seed(i)
        b = m16.predict_mask(frame)
        ious.append(float((a & b).sum() / max(int((a | b).sum()), 1)))
    print(f"{label}: foreground IoU of the bfloat16 mask against the float32 mask per frame "
          f"{[round(x, 5) for x in ious]}; min {min(ious):.5f}, mean "
          f"{statistics.mean(ious):.5f} (floor {BF16_MASK_IOU_FLOOR})", flush=True)
    if min(ious) < BF16_MASK_IOU_FLOOR:
        raise RuntimeError(f"{label}: bfloat16 mask IoU {min(ious)} below {BF16_MASK_IOU_FLOOR}")


def _lfa_error(torch, outs, refs, label, refs64=None):
    """Max abs error of an LFA kernel's outputs against its plain version's.
    float32: at most 1e-5 (the same arithmetic summed in another order);
    where that is exceeded (the large paths' level 1, whose outputs reach
    40-65, where one float32 ulp is 4-8e-6), ``refs64()``, the plain
    version in float64, decides: the kernel's largest error against it at
    most twice the float32 plain version's, plus 1e-6 (a fault of the
    kernel is orders of magnitude beyond either).
    bfloat16 (rows of the last axis): at least 99.9% of the elements within
    one bfloat16 ulp, |Δ| ≤ 2⁻⁷·|ref| + 1e-6, and every element within one
    ulp of itself plus one ulp of its row's largest magnitude (where the two
    round an intermediate to different sides of a midpoint, the outputs it
    feeds move by one ulp of it). Returns (error, a note with the shares
    within one ulp and bit-identical)."""
    err = max((o.float() - r.float()).abs().max().item() for o, r in zip(outs, refs))
    if outs[0].dtype == torch.float32:
        if err <= 1e-5:
            return err, ""
        if refs64 is None:
            raise RuntimeError(f"{label}: max abs err {err}")
        exact = refs64()
        e_kernel = max((o.double() - r).abs().max().item() for o, r in zip(outs, exact))
        e_plain = max((o.double() - r).abs().max().item() for o, r in zip(refs, exact))
        if e_kernel > 2 * e_plain + 1e-6:
            raise RuntimeError(f"{label}: max abs err {err}; against float64 the kernel "
                               f"{e_kernel}, the float32 plain version {e_plain}")
        return err, (f" (beyond 1e-5; against the plain version in float64: kernel "
                     f"{e_kernel:.3g}, float32 plain version {e_plain:.3g})")
    n = within = same = 0
    for o, r in zip(outs, refs):
        d, ref = (o.float() - r.float()).abs(), r.float().abs()
        if not bool((d <= 2.0**-7 * (ref + ref.amax(-1, keepdim=True)) + 1e-6).all()):
            raise RuntimeError(f"{label}: an element beyond one ulp of itself and its row's "
                               f"largest: max abs err {err}")
        n += d.numel()
        within += int((d <= 2.0**-7 * ref + 1e-6).sum())
        same += int((d == 0).sum())
    if within / n < 0.999:
        raise RuntimeError(f"{label}: {within / n:.6f} of the elements within one bfloat16 ulp")
    return err, (f" ({within / n:.6f} within one bfloat16 ulp, {n - within} of {n} beyond; "
                 f"{same / n:.6f} bit-identical)")


def _f64(consts):
    """An LFA plain version's constants in float64."""
    return {key: v.double() for key, v in consts.items()}


def _record_frame(run_frame, targets, per_frame, label):
    """One frame (``run_frame()``) with the wrappers recording their inputs."""
    import torch

    np.random.seed(0)
    with _Recorder(targets) as rec, torch.inference_mode():
        run_frame()
    torch.cuda.synchronize()
    for name, recorded in rec.calls.items():
        if len(recorded) != per_frame.get(name, 0):
            raise RuntimeError(f"{label}: {name} recorded {len(recorded)} calls, expected "
                               f"{per_frame.get(name, 0)}")
    return rec.calls


class _Results:
    """Per-kernel sums over the recorded calls: max error, device ms of the
    kernel, its plain version and the library call, and the bound."""

    def __init__(self):
        self.rows = {}

    def add(self, name, err, ms, plain_ms, bound, library_ms):
        r = self.rows.setdefault(
            name, dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0,
                       t_bytes=0.0, t_ops=0.0, library_ms=None),
        )
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r["ms"] += ms
        r["plain_ms"] += plain_ms
        r["bound_ms"] += bound[0]
        r["t_" + ("bytes" if bound[1] == "bytes" else "ops")] += bound[0]
        if library_ms is not None:
            r["library_ms"] = (r["library_ms"] or 0.0) + library_ms

    def sampled(self, name):
        self.rows[name]["note"] = (
            f"plain_ms and library_ms of calls over {LARGE_CHECK_DISTANCES} distances timed on "
            f"{LARGE_KNN_SAMPLE} sampled query rows and scaled to all rows")


def _sample_rows(torch, m: int, span: int, block: int = 1):
    """None where a call of ``m`` queries, ``span`` support (or window)
    points each, has no more than LARGE_CHECK_DISTANCES distances; else
    LARGE_KNN_SAMPLE seeded query rows, sorted, in whole blocks of ``block``
    rows (the window search's full query blocks), on the card."""
    if m * span <= LARGE_CHECK_DISTANCES:
        return None
    blocks = np.sort(np.random.RandomState(0).choice(m // block, LARGE_KNN_SAMPLE // block,
                                                     replace=False))
    return torch.from_numpy((blocks[:, None] * block + np.arange(block)).ravel()).cuda()


def _work_rows(torch, m: int, rows):
    """The query rows (sorted, on the card) whose walks a call's CPU work
    model counts: every eighth of a sampled call's ``rows``; else, for a
    call of over 8 * WORK_MODEL_ROWS queries, WORK_MODEL_ROWS seeded rows;
    else None (all)."""
    if rows is not None:
        return rows[::8]
    if m <= 8 * WORK_MODEL_ROWS:
        return None
    picked = np.sort(np.random.RandomState(1).choice(m, WORK_MODEL_ROWS, replace=False))
    return torch.from_numpy(picked).cuda()


def _morton_sorted(torch, x):
    """(B, N, 3) points in their Morton order."""
    from recognizer3d_tpu_torch.ops import morton

    return morton.sort_rows(x, morton.morton_order(x)).contiguous()


def _check_kernels(torch, calls, results, label, plain_reps, sorted_bound=False):
    """Hold each recorded call's kernel against its plain version and time
    both (and the library call where there is one). A call with over
    LARGE_CHECK_DISTANCES distances is held on sampled query rows
    (``_sample_rows``); of the LFA kernels' calls, each is held, and the
    first of each shape timed. ``sorted_bound``: B1's work is counted on
    its support and queries Morton-sorted (for calls on unsorted blocks,
    whose walk culls almost nothing: the bound is the function's, not what
    the walk spends on that order)."""
    from recognizer3d_tpu_torch.ops import _build, knn_kernels, lfa_kernels
    from recognizer3d_tpu_torch.utils import profiling

    # B1: exact k-NN; in its global-memory form (the wrapper's scratch
    # query says where) its box pass (knn_box_kernel) and walk
    # (knn_cull_kernel), the box pass held and timed on its own, and the
    # call timed as the route's span: the walk is a programmatic dependent
    # launch whose recorded time includes its wait for the box pass, so
    # the sum of the two counts the overlap twice
    for (support, query, k), _ in calls.get("knn_topk", []):
        b, m, n = query.shape[0], query.shape[1], support.shape[1]
        boxed = _build.library().r3d_knn_topk_scratch_bytes(b, n) > 0
        rows = _sample_rows(torch, m, n)
        q = query if rows is None else query[:, rows].contiguous()
        scale = m / q.shape[1]
        idx, d2 = knn_kernels.knn_topk(support, query, k)
        ref_i, ref_d = knn_kernels.knn_topk_plain(support, q, k)
        if rows is not None:
            idx, d2 = idx[:, rows], d2[:, rows]
        torch.cuda.synchronize()
        if not (torch.equal(idx, ref_i) and torch.equal(d2, ref_d)):
            raise RuntimeError(
                f"{label} knn_topk M={m} N={n} k={k} on {q.shape[1]} rows: indices equal "
                f"{torch.equal(idx, ref_i)}, d2 equal {torch.equal(d2, ref_d)}"
            )
        del idx, d2, ref_i, ref_d
        if boxed:
            boxes = knn_kernels.cull_boxes(support)
            ref_boxes = knn_kernels.cull_boxes_plain(support)
            torch.cuda.synchronize()
            if not torch.equal(boxes, ref_boxes):
                raise RuntimeError(f"{label} knn_topk_boxes N={n}: "
                                   f"{int((boxes != ref_boxes).sum())} box components differ")
            del boxes, ref_boxes
        reps = 50 if rows is None else 5
        if boxed:  # box pass and walk, and the route's span from their timestamps
            (box_ms, walk_ms), ms = profiling.kernel_ms(
                lambda: knn_kernels.knn_topk(support, query, k), reps,
                ("knn_box_kernel", "knn_cull_kernel"), span=True)
        else:
            box_ms, ms = 0.0, _device_ms(torch, lambda: knn_kernels.knn_topk(support, query, k),
                                         reps, ("knn_cull_kernel",))[0]
        step = max(1, (1 << 28) // n)  # cdist blocks of at most 1 GB

        def library():
            for lo in range(0, q.shape[1], step):
                torch.cdist(q[:, lo:lo + step], support).topk(k, -1, largest=False)

        plain, lib = _plain_library_ms(
            torch, lambda: knn_kernels.knn_topk_plain(support, q, k), library, plain_reps, scale)
        work_rows = _work_rows(torch, m, rows)
        work_rows = None if work_rows is None else work_rows.cpu().numpy()
        work_in = ((_morton_sorted(torch, support), _morton_sorted(torch, query))
                   if sorted_bound else (support, query))
        bound = _bound(*_cull_work(*work_in, k, work_rows), PEAK_F32_INSTR_PER_S)
        del work_in
        results.add("knn_topk", 0.0, ms, plain, bound, lib)
        if rows is not None:
            results.sampled("knn_topk")
        held = "all rows" if rows is None else f"{q.shape[1]} sampled rows, times scaled"
        boxes_note = ""
        if boxed:
            box_plain = _device_ms(torch, lambda: knn_kernels.cull_boxes_plain(support),
                                   plain_reps)
            nt = -(-n // 32)
            # the box pass: the support read once, the boxes written once, a
            # min and a max a coordinate
            box_bound = _bound(b * (4 * 3 * n + 4 * 6 * (nt + -(-nt // 32))), b * 6 * n,
                               PEAK_F32_INSTR_PER_S)
            results.add("knn_topk_boxes", 0.0, box_ms, box_plain, box_bound, None)
            boxes_note = (f"; global-memory form, boxes equal to amin/amax: box pass "
                          f"{box_ms:.4f} ms of the kernel's, plain {box_plain:.4f} ms, bound "
                          f"{box_bound[0]:.5f} ms; kernel time = the route's span (box "
                          f"start to walk end), against the sum box + walk "
                          f"{box_ms + walk_ms:.4f} ms")
        print(f"{label} knn_topk M={m} N={n} k={k}: indices (in order) and d2 equal on "
              f"{held}; kernel {ms:.4f} ms, plain {plain:.4f} ms, cdist+topk {lib:.4f} ms, "
              f"bound {bound[0]:.5f} ms ({bound[1]}"
              f"{', counted on the inputs Morton-sorted' if sorted_bound else ''})"
              f"{boxes_note}", flush=True)

    # B4: exact 1-NN upsample, held to the first entry of the stable sort,
    # ties included; timed with its ordering launch where it has one
    for (support, query), _ in calls.get("argmin_1nn", []):
        m, n = query.shape[1], support.shape[1]
        rows = _sample_rows(torch, m, n)
        q = query if rows is None else query[:, rows].contiguous()
        scale = m / q.shape[1]
        idx, d2 = knn_kernels.argmin_1nn(support, query)
        if rows is not None:
            idx, d2 = idx[:, rows], d2[:, rows]
        ref_i, ref_d = knn_kernels.knn_topk_plain(support, q, 1)
        torch.cuda.synchronize()
        if not (torch.equal(idx, ref_i) and torch.equal(d2, ref_d)):
            raise RuntimeError(
                f"{label} argmin_1nn M={m} N={n}: {int((idx != ref_i).sum())} indices and "
                f"{int((d2 != ref_d).sum())} distances differ from the stable sort's first"
            )
        ties = int((knn_kernels.knn_topk_plain(support, q, 2)[1].diff(dim=-1) == 0).sum())
        # the walk, after the launch that orders a support too large for a
        # block's shared memory (the wrapper's scratch query says which)
        ordered = _build.library().r3d_argmin_scratch_bytes(support.shape[0], n) > 0
        ms = sum(_device_ms(torch, lambda: knn_kernels.argmin_1nn(support, query),
                            50 if rows is None else 5,
                            ("argmin_order_kernel", "argmin_cull_kernel") if ordered
                            else ("argmin_cull_kernel",)))
        plain, lib = _plain_library_ms(
            torch, lambda: knn_kernels.argmin_1nn_plain(support, q),
            lambda: torch.cdist(q, support).argmin(-1), max(1, plain_reps // 2), scale)
        bound = _bound(*_argmin_work(support, query, _work_rows(torch, m, rows)),
                       PEAK_F32_INSTR_PER_S)
        brute = _knn_work(m, n, 1)[1] / PEAK_F32_INSTR_PER_S * 1e3
        results.add("argmin_1nn", 0.0, ms, plain, bound, lib)
        if rows is not None:
            results.sampled("argmin_1nn")
        held = "" if rows is None else f" on {q.shape[1]} sampled rows, times scaled"
        print(f"{label} argmin_1nn M={m} N={n}: indices and d2 equal{held} ({ties} queries "
              f"with a tied second); kernel {ms:.4f} ms, plain {plain:.4f} ms, cdist+argmin "
              f"{lib:.4f} ms, bound {bound[0]:.5f} ms ({bound[1]}); reference, not a bound: "
              f"9*M*N brute-force lane instructions take {brute:.5f} ms", flush=True)

    # B6: the Morton-window search (k = 32 self-KNN, k = 1 upsample)
    for (support, query, k, starts, w, qb), _ in calls.get("knn_window_topk", []):
        m, n = query.shape[1], support.shape[1]
        rows = _sample_rows(torch, m, w, qb)
        q, st = (query, starts) if rows is None else (query[:, rows].contiguous(),
                                                      starts[rows[::qb] // qb].contiguous())
        scale = m / q.shape[1]
        idx, d2 = knn_kernels.knn_window_topk(support, query, k, starts, w, qb)
        if rows is not None:
            idx, d2 = idx[:, rows], d2[:, rows]
        ref_i, ref_d = knn_kernels.knn_window_topk_plain(support, q, k, st, w, qb)
        torch.cuda.synchronize()
        if not (torch.equal(idx, ref_i) and torch.equal(d2, ref_d)):
            raise RuntimeError(
                f"{label} knn_window_topk M={m} N={n} w={w} k={k}: indices equal "
                f"{torch.equal(idx, ref_i)}, d2 equal {torch.equal(d2, ref_d)}"
            )
        del idx, d2, ref_i, ref_d
        n_blocks = st.shape[0]
        offsets = torch.arange(w, device=support.device)

        def library():
            win = support[0, st.long()[:, None] + offsets]  # (blocks, w, 3)
            qq = q[0]
            pad = n_blocks * qb - qq.shape[0]
            if pad:
                qq = torch.cat([qq, qq[-1:].expand(pad, 3)])
            d = torch.cdist(qq.reshape(n_blocks, qb, 3), win)
            return d.argmin(-1) if k == 1 else d.topk(k, -1, largest=False)

        ms, = _device_ms(
            torch, lambda: knn_kernels.knn_window_topk(support, query, k, starts, w, qb),
            20 if rows is None else 5, ("argmin_kernel" if k == 1 else "knn_window_kernel",),
        )
        plain, lib = _plain_library_ms(
            torch, lambda: knn_kernels.knn_window_topk_plain(support, q, k, st, w, qb), library,
            plain_reps, scale)
        bound = _bound(*_window_work(m, n, w, k), PEAK_F32_INSTR_PER_S)
        results.add("knn_window_topk", 0.0, ms, plain, bound, lib)
        if rows is not None:
            results.sampled("knn_window_topk")
        held = "" if rows is None else f" on {q.shape[1]} sampled rows, times scaled"
        print(f"{label} knn_window_topk M={m} N={n} w={w} qb={qb} k={k}: indices and "
              f"d2 equal{held}; kernel {ms:.4f} ms, plain {plain:.4f} ms, window cdist+"
              f"{'argmin' if k == 1 else 'topk'} {lib:.4f} ms, bound {bound[0]:.5f} ms "
              f"({bound[1]})", flush=True)

    # the LFA kernels' calls of a shape timed already: (count, max abs err)
    repeats = {}

    def timed_before(name, shape, err):
        if (name, shape) not in repeats:
            repeats[(name, shape)] = [0, 0.0]
            return False
        repeats[(name, shape)][0] += 1
        repeats[(name, shape)][1] = max(repeats[(name, shape)][1], err)
        results.add(name, err, 0.0, 0.0, (0.0, "bytes"), None)
        return True

    # B2: fused LFA round 1 at encoder levels 0 and 1, in either form
    for name in ("lfa_round1", "lfa_round1_bf16"):
        for args, _ in calls.get(name, []):
            gathered, d2, center = args[:3]
            b, rows, k, c2 = gathered.shape
            h, dt = c2 // 2, gathered.dtype
            pooled, rpe2 = lfa_kernels.lfa_round1(*args)
            consts = lfa_kernels.round1_constants(*args[3:], dtype=dt)
            ref_p, ref_r = lfa_kernels.lfa_round1_plain(gathered, d2, center, consts)
            torch.cuda.synchronize()
            def round1_f64():
                p64, r64 = lfa_kernels.lfa_round1_plain(gathered.double(), d2.double(),
                                                        center.double(), _f64(consts))
                return [p64, r64.reshape(b, rows, k, h)]

            err, note = _lfa_error(torch, [pooled, rpe2.reshape(b, rows, k, h)],
                                   [ref_p, ref_r.reshape(b, rows, k, h)], f"{label} {name} h={h}",
                                   round1_f64)
            if timed_before(name, tuple(gathered.shape), err):
                continue
            ms, = _device_ms(torch, lambda: lfa_kernels.lfa_round1(*args), 50,
                             ("lfa_round1_mma_kernel" if dt == torch.bfloat16
                              else "lfa_round1_tile_kernel",))
            plain = _device_ms(
                torch,
                lambda: lfa_kernels.lfa_round1_plain(
                    gathered, d2, center, lfa_kernels.round1_constants(*args[3:], dtype=dt)
                ),
                2 * plain_reps,
            )
            bound = _lfa_bound(*_round1_work(b * rows, k, h, gathered.element_size()),
                               dt == torch.bfloat16)
            results.add(name, err, ms, plain, bound, None)
            print(f"{label} {name} B={b} N={rows} K={k} h={h}: max abs err {err:.3g}{note}; "
                  f"kernel {ms:.4f} ms, plain {plain:.4f} ms, bound {bound[0]:.5f} ms "
                  f"({bound[1]})", flush=True)

    # B3: fused attentive pool 2 + residual at encoder levels 0 and 1, and
    # B5 (pool 2 alone, which no path runs) on the level-0 inputs, in either
    # form
    for name in ("lfa_pool2_res", "lfa_pool2_res_bf16"):
        bf16 = name.endswith("_bf16")
        kernel = "lfa_pool2_mma_kernel" if bf16 else "lfa_pool2_tile_kernel"
        for args, kwargs in calls.get(name, []):
            rpe2, g2 = args[:2]
            f_in = args[7]
            b, rows, k, h = g2.shape
            f, dt, elem = f_in.shape[-1], rpe2.dtype, rpe2.element_size()
            out = lfa_kernels.attentive_pool2_residual(*args, **kwargs)
            consts = lfa_kernels.pool2_constants(*args[2:7], *args[8:], dtype=dt)
            ref = lfa_kernels.attentive_pool2_residual_plain(rpe2, g2, f_in, consts, k)
            torch.cuda.synchronize()
            err, note = _lfa_error(
                torch, [out], [ref], f"{label} {name} h={h}",
                lambda: [lfa_kernels.attentive_pool2_residual_plain(
                    rpe2.double(), g2.double(), f_in.double(), _f64(consts), k)])
            shape = tuple(g2.shape) + (f,)
            if not timed_before(name, shape, err):
                ms, = _device_ms(
                    torch, lambda: lfa_kernels.attentive_pool2_residual(*args, **kwargs), 50,
                    (kernel,),
                )
                plain = _device_ms(
                    torch,
                    lambda: lfa_kernels.attentive_pool2_residual_plain(
                        rpe2, g2, f_in,
                        lfa_kernels.pool2_constants(*args[2:7], *args[8:], dtype=dt), k,
                    ),
                    2 * plain_reps,
                )
                bound = _lfa_bound(*_pool2_work(b * rows, k, h, f, elem=elem), bf16)
                results.add(name, err, ms, plain, bound, None)
                print(f"{label} {name} B={b} N={rows} K={k} h={h} F={f}: max abs err "
                      f"{err:.3g}{note}; kernel {ms:.4f} ms, plain {plain:.4f} ms, bound "
                      f"{bound[0]:.5f} ms ({bound[1]})", flush=True)
            if h != 8:
                continue
            b5 = "lfa_pool2_bf16" if bf16 else "lfa_pool2"
            head = args[2:7]
            out = lfa_kernels.attentive_pool2(rpe2, g2, *head, k=k)
            ref = lfa_kernels.attentive_pool2_plain(
                rpe2, g2, lfa_kernels.pool2_constants(*head, dtype=dt), k
            )
            torch.cuda.synchronize()
            err, note = _lfa_error(
                torch, [out], [ref], f"{label} {b5} h={h}",
                lambda: [lfa_kernels.attentive_pool2_plain(
                    rpe2.double(), g2.double(),
                    _f64(lfa_kernels.pool2_constants(*head, dtype=dt)), k)])
            if timed_before(b5, shape, err):
                continue
            ms, = _device_ms(torch, lambda: lfa_kernels.attentive_pool2(rpe2, g2, *head, k=k),
                             50, (kernel,))
            plain = _device_ms(
                torch,
                lambda: lfa_kernels.attentive_pool2_plain(
                    rpe2, g2, lfa_kernels.pool2_constants(*head, dtype=dt), k
                ),
                2 * plain_reps,
            )
            bound = _lfa_bound(*_pool2_work(b * rows, k, h, 0, residual=False, elem=elem),
                               bf16)
            results.add(b5, err, ms, plain, bound, None)
            print(f"{label} {b5} (B5, on B3's level-0 inputs) B={b} N={rows} K={k} h={h}: "
                  f"max abs err {err:.3g}{note}; kernel {ms:.4f} ms, plain {plain:.4f} ms, "
                  f"bound {bound[0]:.5f} ms ({bound[1]})", flush=True)
    for (name, shape), (count, err) in repeats.items():
        if count:
            print(f"{label} {name} {shape}: {count} more calls of this shape held, max abs err "
                  f"{err:.3g} (timed on the first)", flush=True)

    # B8: the n smallest priorities of each row, bit-equal to the stable sort
    for (priority, n_out), _ in calls.get("select_smallest", []):
        ms, plain, sort_ms, bound = _select_once(torch, priority, n_out, label)
        results.add("select_smallest", 0.0, ms, plain, bound, sort_ms)


def _exact_64k(torch, morton, knn_kernels, cloud):
    """The exact k = 32 self-KNN of a Morton-sorted 65,536-point level (the
    recall guard's exact fallback at approx64k) on B1 and on the brute-force
    streaming kernel it replaced (reached through the window route with the whole
    support as one window, which takes that kernel above 19,370 points),
    both bit-identical to the plain version, timed in the same process."""
    k = 32
    x = torch.tensor(cloud[None], device="cuda")
    x = morton.sort_rows(x, morton.morton_order(x)).contiguous()
    n = x.shape[1]
    starts = torch.zeros(1, dtype=torch.int32, device="cuda")
    ref_i, ref_d = knn_kernels.knn_topk_plain(x, x, k)
    for name, fn in (("B1", lambda: knn_kernels.knn_topk(x, x, k)),
                     ("streaming", lambda: knn_kernels.knn_window_topk(x, x, k, starts, n, n))):
        idx, d2 = fn()
        torch.cuda.synchronize()
        if not (torch.equal(idx, ref_i) and torch.equal(d2, ref_d)):
            raise RuntimeError(f"exact 64k self-KNN on the {name} kernel: indices equal "
                               f"{torch.equal(idx, ref_i)}, d2 equal {torch.equal(d2, ref_d)}")
    del ref_i, ref_d
    new_ms = sum(_device_ms(torch, lambda: knn_kernels.knn_topk(x, x, k), 10,
                            ("knn_box_kernel", "knn_cull_kernel")))  # the global form
    old_ms = _device_ms(torch, lambda: knn_kernels.knn_window_topk(x, x, k, starts, n, n), 3,
                        "knn_topk_kernel")
    # the bound is the bytes (the culled selection's distance count is out
    # of the CPU model's reach at this size); the brute-force instruction
    # count, the streaming kernel's work, is printed beside it as a reference
    nbytes, brute = _knn_work(n, n, k)
    bound = _bound(nbytes, 0)
    print(f"exact self-KNN M=N={n} k={k} (Morton-sorted approx64k level 0): B1 and the streaming "
          f"kernel equal the plain version (indices in order, d2); B1 {new_ms:.4f} ms, "
          f"streaming kernel {old_ms:.4f} ms, bound {bound[0]:.5f} ms ({bound[1]}); reference, "
          f"not a bound: 9*M*N brute-force lane instructions take "
          f"{brute / PEAK_F32_INSTR_PER_S * 1e3:.5f} ms", flush=True)


def _exact_1m(torch, knn_kernels, x):
    """B1 at the large-scene exact route's level 0 (the support phase 8
    recorded there: 1,048,576 Morton-sorted points, self-KNN at k = 32)
    against the brute-force streaming kernel that would otherwise search it
    (reached through the window route with the whole support as one
    window): bit-equal, indices in order, on every row. B1's box pass and
    walk timed apart; the streaming kernel, one launch of over a second,
    timed once between CUDA events (``_event_ms``), on the call whose result
    is compared. The bound is the bytes; the brute-force instruction count
    is printed beside it as a reference."""
    from recognizer3d_tpu_torch.utils import profiling

    k = 32
    n = x.shape[1]
    starts = torch.zeros(1, dtype=torch.int32, device="cuda")
    idx, d2 = knn_kernels.knn_topk(x, x, k)
    out = []
    stream_ms = _event_ms(
        torch, lambda: out.append(knn_kernels.knn_window_topk(x, x, k, starts, n, n)))
    s_i, s_d = out[-1]
    torch.cuda.synchronize()
    if not (torch.equal(idx, s_i) and torch.equal(d2, s_d)):
        raise RuntimeError(f"exact 1M self-KNN, B1 vs the streaming kernel: "
                           f"{int((idx != s_i).sum())} indices and {int((d2 != s_d).sum())} "
                           f"distances differ")
    del idx, d2, s_i, s_d, out
    (box_ms, walk_ms), span = profiling.kernel_ms(
        lambda: knn_kernels.knn_topk(x, x, k), 10, ("knn_box_kernel", "knn_cull_kernel"),
        span=True)
    nbytes, brute = _knn_work(n, n, k)
    bound = _bound(nbytes, 0)
    print(f"exact self-KNN M=N={n} k={k} (the large-scene exact route's level 0): B1 equal to "
          f"the streaming kernel on all rows (indices in order, d2); box pass {box_ms:.4f} ms "
          f"+ walk {walk_ms:.4f} ms = {box_ms + walk_ms:.4f} ms (span, box start to walk end, "
          f"{span:.4f} ms), streaming kernel "
          f"{stream_ms:.4f} ms; bound {bound[0]:.5f} ms ({bound[1]}); reference, not a bound: "
          f"9*M*N brute-force lane instructions take {brute / PEAK_F32_INSTR_PER_S * 1e3:.3f} ms",
          flush=True)


def _check_roll_stages(torch, results):
    """B7 against its plain version, bit-exact, at the TPU benchmark's
    shape for each stage count, with both timed. The kernels line takes
    the largest stage count, the TPU benchmark's S = 45."""
    from recognizer3d_tpu_torch.ops import bitonic_kernels

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    x = torch.rand(ROLL_SHAPE, generator=gen, device="cuda")
    for stages in ROLL_STAGES:
        out = bitonic_kernels.roll_stages(x, stages)
        ref = bitonic_kernels.roll_stages_plain(x, stages)
        torch.cuda.synchronize()
        if not torch.equal(out, ref):
            n_diff = int((out != ref).sum())
            raise RuntimeError(f"roll_stages S={stages}: {n_diff} elements differ")
        del out, ref
        ms = _device_ms(torch, lambda: bitonic_kernels.roll_stages(x, stages), 20,
                        "roll_stages_kernel")
        plain = _device_ms(torch, lambda: bitonic_kernels.roll_stages_plain(x, stages), 3)
        bound = _bound(*_roll_work(x.numel(), stages), PEAK_F32_INSTR_PER_S)
        if stages == ROLL_STAGES[-1]:
            results.add("roll_stages", 0.0, ms, plain, bound, None)
        # the earlier count of 7 instructions a stage (the position tests
        # evaluated per element), which a kernel that resolves them at
        # compile time beats: a reference, not a bound
        seven = x.numel() * (7 * stages + 3) / PEAK_F32_INSTR_PER_S * 1e3
        print(f"roll_stages {tuple(x.shape)} S={stages}: bit-exact; kernel {ms:.4f} ms, "
              f"plain {plain:.4f} ms, bound {bound[0]:.5f} ms ({bound[1]}); reference, not a "
              f"bound: 7 instructions a stage take {seven:.5f} ms", flush=True)


def _select_once(torch, priority, n_out, label, reps=20):
    """B8 on one (priority, n_out): held bit-equal to its plain version (the
    stable sort), then the device ms of the kernel (its one launch), of
    the plain version, of ``torch.sort``
    (stable; the library call) and of ``torch.topk``, and the bound: the
    priorities read once and the int64 indices written once. Returns (ms,
    plain ms, sort ms, bound)."""
    from recognizer3d_tpu_torch.ops import select_kernels

    b, n = priority.shape
    got = select_kernels.select_smallest(priority, n_out)
    ref = select_kernels.select_smallest_plain(priority, n_out)
    torch.cuda.synchronize()
    if not torch.equal(got, ref):
        raise RuntimeError(f"{label} B={b} N={n} n_out={n_out}: {int((got != ref).sum())} "
                           f"indices differ from the stable sort's")
    del got, ref
    # its one launch a call, timed by name: the mean over the launches the
    # profiler kept (late in a long process it drops a few)
    ms = _device_ms(torch, lambda: select_kernels.select_smallest(priority, n_out), reps,
                    ("select_cluster_kernel",))[0]
    plain = _device_ms(torch, lambda: select_kernels.select_smallest_plain(priority, n_out), reps)
    sort_ms = _device_ms(torch, lambda: torch.sort(priority, dim=-1, stable=True), reps)
    topk_ms = _device_ms(
        torch, lambda: torch.topk(priority, n_out, dim=-1, largest=False), reps)
    bound = _bound(4 * b * n + 8 * b * n_out, 0)
    plan = select_kernels.select_plan(
        b, n, n_out, torch.cuda.get_device_properties(0).multi_processor_count)
    print(f"{label} select_smallest B={b} N={n} n_out={n_out} ({plan.cluster} blocks a row, "
          f"{'staged' if plan.staged else 'streamed'}): indices equal; kernel "
          f"{ms:.4f} ms, plain {plain:.4f} ms, torch.sort {sort_ms:.4f} ms, torch.topk "
          f"{topk_ms:.4f} ms, bound {bound[0]:.5f} ms ({bound[1]})", flush=True)
    return ms, plain, sort_ms, bound


def _check_selection(torch, pipeline, depth):
    """B8 at the live and the train shape (``_select_once``): the priorities
    of a z16 frame (786,432 pixels, +inf outside the z band) -> 16,384 under
    a seeded draw (``torch.rand`` ties about 18,000 of the values, as JAX's
    key-3 draw ties 36,000) and under the same draw rounded to 1/256 (every
    valid value tied: the threshold's ties decide); then 4 rows of
    TRAIN_POINTS seeded priorities, one with 1,800 valid points (its tail
    the lowest-indexed +inf), -> 2,500. Also the whole ``subsample_order``
    (band test, priorities, B8)."""
    intr = pipeline.DepthIntrinsics()
    z = pipeline.depth_to_cloud(torch.from_numpy(depth).cuda(), intr)[None, :, 2].contiguous()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    uniform = torch.rand(z.shape, generator=gen, device="cuda")
    valid = (z > pipeline.Z_MIN) & (z < pipeline.Z_MAX)
    for draw, u in (("seeded", uniform), ("rounded to 1/256", torch.floor(uniform * 256) / 256)):
        priority = torch.where(valid, u, torch.full_like(u, float("inf")))
        _select_once(torch, priority, LIVE_DISPLAY,
                     f"live selection ({draw} draw, {int(valid.sum())} valid)")
    order_ms = _device_ms(
        torch, lambda: pipeline.subsample_order(uniform, z, LIVE_DISPLAY), 20
    )
    print(f"live selection: subsample_order (band test, priorities, B8) {order_ms:.4f} ms",
          flush=True)
    priority = torch.rand((4, TRAIN_POINTS), generator=gen, device="cuda")
    priority[1, 1_800:] = float("inf")
    _select_once(torch, priority, 2_500, "train selection (a row of 1,800 valid points)")


def _live_path(torch, build, Model, pipeline, LivePredictor, make_frame):
    """The depth-camera tick at the app config; returns the launches summed
    over its frames and a function running one recorded frame."""
    intr = pipeline.DepthIntrinsics()
    depths = [
        pipeline.cloud_to_depth(
            make_frame(np.random.RandomState(500 + i), 0.45 * i, FRAME_POINTS)[0], intr
        )
        for i in range(N_FRAMES)
    ]
    t0 = time.perf_counter()
    live = LivePredictor(Model.load(ARCHIVE, device="cuda"), n_display=LIVE_DISPLAY,
                         intrinsics=intr)
    torch.cuda.synchronize()
    print(f"live: LivePredictor at {intr.width}x{intr.height}, {LIVE_DISPLAY} display "
          f"points, ready in {time.perf_counter() - t0:.3f} s", flush=True)
    latencies, totals = [], {}
    for depth in depths:
        torch.cuda.synchronize()
        build.reset_launches()
        t = time.perf_counter()
        cloud, mask = live.predict_depth(depth)
        latencies.append((time.perf_counter() - t) * 1e3)
        launches = dict(build.LAUNCHES)
        if launches != PER_FRAME_LIVE:
            raise RuntimeError(f"live: launches {launches} in a frame, expected {PER_FRAME_LIVE}")
        for name, count in launches.items():
            totals[name] = totals.get(name, 0) + count
        valid = (cloud != 0).any(-1)
        if cloud.shape != (LIVE_DISPLAY, 3) or cloud.dtype != np.float32 or mask.dtype != np.bool_:
            raise RuntimeError(f"live: cloud {cloud.shape} {cloud.dtype}, mask {mask.dtype}")
        if not np.isfinite(cloud).all() or valid.sum() < LIVE_DISPLAY // 2:
            raise RuntimeError(f"live: {int(valid.sum())} valid display points, or not finite")
        if not 0 < mask.sum() < valid.sum() or (mask & ~valid).any():
            raise RuntimeError(f"live: degenerate mask: {int(mask.sum())} positives")
    print(f"live: {len(depths)} depth frames, launches {totals}", flush=True)
    print(f"live: per-frame latency ms: {[round(x, 3) for x in latencies]}; p50 "
          f"{statistics.median(latencies):.3f} ms", flush=True)
    _live_card_vs_cpu(torch, Model, pipeline, LivePredictor, live, intr, depths[1])
    return totals, lambda: live.predict_depth(depths[0])


def _live_card_vs_cpu(torch, Model, pipeline, LivePredictor, live, intr, depth):
    """The card's live program against the CPU port's on one frame, both
    given the same uniform draw and permutation. Tolerances: the selected
    indices equal; the float32 cloud within one ulp (the dewarp divides by
    tensors, so it should be exact); packed xyz within one float16 ulp;
    masks equal where the CPU's class-1 confidence lies more than 1e-4
    from the threshold (read off its masks at 0.5 ± 1e-4)."""
    thr = 0.5
    cpu_model = Model.load(ARCHIVE, device="cpu")
    cpu_live = LivePredictor(cpu_model, n_display=LIVE_DISPLAY, intrinsics=intr)
    gen = torch.Generator()
    gen.manual_seed(11)
    uniform = torch.rand((1, depth.size), generator=gen)
    perm = np.random.RandomState(7).permutation(cpu_model.settings.n_points)
    perm = torch.from_numpy(perm.astype(np.int32))
    depth_bits = torch.from_numpy(depth)
    with torch.inference_mode():
        cloud_cpu = pipeline.depth_to_cloud(depth_bits, intr)
        cloud_gpu = pipeline.depth_to_cloud(depth_bits.cuda(), intr)
        order_cpu, _ = pipeline.subsample_order(uniform, cloud_cpu[None, :, 2], LIVE_DISPLAY)
        order_gpu, _ = pipeline.subsample_order(
            uniform.cuda(), cloud_gpu[None, :, 2], LIVE_DISPLAY
        )
        if not torch.equal(order_gpu.cpu(), order_cpu):
            n_diff = int((order_gpu.cpu() != order_cpu).sum())
            raise RuntimeError(f"live: {n_diff} selected indices differ between card and CPU")
        cloud_gpu = cloud_gpu.cpu()
        ulp = torch.from_numpy(np.spacing(np.abs(cloud_cpu.numpy())))
        cloud_diff = int((cloud_gpu != cloud_cpu).sum())
        if bool(((cloud_gpu - cloud_cpu).abs() > ulp).any()):
            raise RuntimeError(f"live: dewarp differs by more than one ulp ({cloud_diff} coords)")
        packed_gpu = live.program_fn(
            depth_bits.cuda(), uniform.cuda(), perm.cuda(), thr
        ).cpu().numpy()
        packed_cpu = cpu_live.program_fn(depth_bits, uniform, perm, thr).numpy()
        near = (
            (cpu_live.program_fn(depth_bits, uniform, perm, thr - 1e-4).numpy()[:, 3] > 0)
            != (cpu_live.program_fn(depth_bits, uniform, perm, thr + 1e-4).numpy()[:, 3] > 0)
        )
    xyz_gpu = packed_gpu[:, :3].astype(np.float32)
    xyz_cpu = packed_cpu[:, :3].astype(np.float32)
    if (np.abs(xyz_gpu - xyz_cpu) > np.spacing(np.abs(packed_cpu[:, :3]))).any():
        raise RuntimeError("live: packed xyz differ by more than one float16 ulp")
    mask_gpu, mask_cpu = packed_gpu[:, 3] > 0, packed_cpu[:, 3] > 0
    mask_diff = int((mask_gpu != mask_cpu)[~near].sum())
    if mask_diff:
        raise RuntimeError(f"live: {mask_diff} mask points differ away from the threshold")
    print(f"live: card vs CPU on one frame: {LIVE_DISPLAY} selected indices equal (B8 "
          f"against its plain version), "
          f"{cloud_diff} of {cloud_cpu.numel()} dewarped coordinates differ (at most one "
          f"ulp), packed xyz {int((xyz_gpu != xyz_cpu).sum())} differ (at most one float16 "
          f"ulp), masks equal ({int(near.sum())} points within 1e-4 of the threshold; "
          f"{int(mask_cpu.sum())} positives)", flush=True)


def _write_app_dir(make_frame) -> None:
    """The app's working directory: seeded mock frames in ``data/mock`` and
    the bundled archive in ``models/``."""
    from recognizer3d_tpu_torch.data.dataset import Dataset

    if APP_DIR.exists():
        shutil.rmtree(APP_DIR)
    ds = Dataset(APP_DIR / "data" / "mock", only_annotated=False)
    t0 = datetime(2026, 1, 1, 12, 0, 0)
    for i in range(APP_CLOUDS):
        ds[t0 + timedelta(seconds=i)] = make_frame(np.random.RandomState(900 + i), 0.45 * i,
                                                   FRAME_POINTS)[0]
    (APP_DIR / "models").mkdir()
    shutil.copy(ARCHIVE, APP_DIR / "models" / APP_MODEL)


def _app_entry_point(torch, build, Predictor, depth):
    """``recognizer3d_tpu_torch.app.App`` on the card under the tkinter and
    vispy stubs, from ``APP_DIR``: a mock camera over its frames (with
    ``RECOGNIZER3D_MOCK_DEPTH=1`` for the depth branch), Predict toggled on
    at the control bar, then APP_TICKS predicting ticks, each made due at
    once, with every launch count set to 0 before each. Each tick must
    launch the branch path's kernels (the app's tick prints an error and
    goes on, so a tick that failed shows here as missing launches or an
    unchanged prediction panel). The cloud branch's last tick runs after
    ``np.random.seed(3)``: its mask must equal the CPU port's
    ``Predictor`` on that frame and seed where the CPU's class-1
    confidence lies more than 1e-4 from the threshold, and the card's
    confidences must lie within 1e-4 of the CPU's. Returns the launches
    summed over the ticks."""
    import importlib

    import pytest

    from tests import _tk_stub, _vispy_stub

    label = "app entry point, " + ("depth branch" if depth else "cloud branch")
    per_tick = PER_FRAME_LIVE if depth else PER_FRAME
    patch = pytest.MonkeyPatch()
    try:
        _vispy_stub.install(patch)
        tk = _tk_stub.install(patch)
        for name in ("recognizer3d_tpu_torch.app", "recognizer3d_tpu_torch.ui.scene",
                     "recognizer3d_tpu_torch.ui.controls"):
            patch.delitem(sys.modules, name, raising=False)
        app_module = importlib.import_module("recognizer3d_tpu_torch.app")
        camera_pkg = importlib.import_module("recognizer3d_tpu_torch.camera")
        patch.setattr(camera_pkg, "MOCK_DATA_SEARCH_PATH", (str(APP_DIR / "data" / "mock"),))
        if depth:
            patch.setenv("RECOGNIZER3D_MOCK_DEPTH", "1")
        else:
            patch.delenv("RECOGNIZER3D_MOCK_DEPTH", raising=False)
        patch.chdir(APP_DIR)
        window = tk.Tk()
        app = app_module.App(window)
        app.controls.refresh_model_name()
        _tk_stub.run_scheduled()  # the first tick: the live panel, no prediction
        t0 = time.perf_counter()
        app.controls._predict_button.invoke()  # Predict on: builds and warms the predictor
        torch.cuda.synchronize()
        predictor = app._live_predictor if depth else app._predictor
        if predictor is None or app.controls._predict_button.config("relief")[-1] != "sunken":
            raise RuntimeError(f"{label}: Predict was not toggled on")
        print(f"{label}: App on {app.device} over {type(app.camera).__name__}, model "
              f"{app.controls.model_name}, {type(predictor).__name__} ready in "
              f"{time.perf_counter() - t0:.3f} s", flush=True)
        walls, totals, shown = [], {}, None
        for tick in range(APP_TICKS):
            app._next_prediction_due = 0.0
            if tick == APP_TICKS - 1:
                np.random.seed(3)
            torch.cuda.synchronize()
            build.reset_launches()
            t = time.perf_counter()
            _tk_stub.run_scheduled()
            walls.append((time.perf_counter() - t) * 1e3)
            launches = dict(build.LAUNCHES)
            mask = app.scene.prediction.get_overlay("prediction")
            if launches != per_tick or mask is shown or app._next_prediction_due == 0.0:
                raise RuntimeError(f"{label}: tick {tick}: launches {launches}, expected "
                                   f"{per_tick}, or no new prediction")
            shown = mask
            for name, count in launches.items():
                totals[name] = totals.get(name, 0) + count
        cloud = app.scene.prediction.cloud
        n = LIVE_DISPLAY if depth else FRAME_POINTS
        if cloud.shape != (n, 3) or mask.shape != (n,) or mask.dtype != np.bool_:
            raise RuntimeError(f"{label}: panel cloud {cloud.shape}, mask {mask.shape} {mask.dtype}")
        if not 0 < mask.sum() < n:
            raise RuntimeError(f"{label}: degenerate mask: {int(mask.sum())} positives")
        print(f"{label}: {APP_TICKS} predicting ticks, launches {totals}; tick wall ms "
              f"{[round(x, 3) for x in walls]}; p50 {statistics.median(walls):.3f} ms; "
              f"positives of the last {int(mask.sum())} of {n}", flush=True)
        if not depth:
            _app_tick_vs_cpu(Predictor, app, cloud, mask, label)
        try:
            window.fire_event("<Escape>", None)
        except SystemExit:
            pass  # Escape exits the app
        else:
            raise RuntimeError(f"{label}: Escape did not exit the app")
        if app.camera._running or not window.withdrawn:
            raise RuntimeError(f"{label}: Escape left the camera running or the window shown")
    finally:
        patch.undo()
        for name in ("recognizer3d_tpu_torch.app", "recognizer3d_tpu_torch.ui.scene",
                     "recognizer3d_tpu_torch.ui.controls"):
            sys.modules.pop(name, None)
    return totals


def _app_tick_vs_cpu(Predictor, app, frame, mask, label):
    """The cloud branch's last tick (``np.random.seed(3)``) against the CPU
    port's ``Predictor`` of the same archive on the same frame and seed."""
    archive = APP_DIR / "models" / APP_MODEL
    cpu = Predictor(archive, device="cpu", warmup_points=FRAME_POINTS)
    np.random.seed(3)
    conf_cpu = cpu.model.predict(frame)
    np.random.seed(3)
    conf_gpu = app._predictor.model.predict(frame)
    near = np.abs(conf_cpu[1] - 0.5) <= 1e-4
    conf_err = float(np.abs(conf_gpu - conf_cpu).max())
    mask_diff = int((mask != (conf_cpu[1] > 0.5))[~near].sum())
    if conf_err > 1e-4 or mask_diff:
        raise RuntimeError(f"{label}: card vs CPU: max abs conf err {conf_err}, {mask_diff} mask "
                           f"points of the tick differ")
    print(f"{label}: the last tick's mask equals the CPU port's Predictor on its frame and seed "
          f"({int(near.sum())} points within 1e-4 of the threshold); confidences max abs err "
          f"{conf_err:.3g}", flush=True)


def _kdtree_path(torch, build, Model, Predictor, frames):
    """``knn="kdtree"``: the bundled weights loaded with it and saved under
    ``build/``; ``Predictor`` of that archive answers KDTREE_FRAMES frames on
    the card, launch counts checked per frame (B1 0: the host tree searches
    the encoder levels and decoder upsamplings; B4 1: the final upsample
    takes "naive"), and the host tree's calls and seconds counted per frame.
    One frame on the card against the CPU port. Returns the launches."""
    from recognizer3d_tpu_torch.ops import knn_cpp

    Model.load(ARCHIVE, device="cuda", knn="kdtree").save(KDTREE_ARCHIVE)
    predictor = Predictor(KDTREE_ARCHIVE, warmup_points=FRAME_POINTS)
    host = []  # per frame, the seconds of each host tree call
    tree = knn_cpp.knn_kdtree

    def timed(*args):
        t = time.perf_counter()
        out = tree(*args)
        host[-1].append(time.perf_counter() - t)
        return out

    def predict(frame):
        host.append([])
        return predictor.predict(frame)

    knn_cpp.knn_kdtree = timed
    try:
        _, _, launches = _drive(torch, build, SimpleNamespace(predict=predict),
                                frames[:KDTREE_FRAMES], PER_FRAME_KDTREE, "kdtree")
    finally:
        knn_cpp.knn_kdtree = tree
    calls = [len(h) for h in host]
    host_ms = [sum(h) * 1e3 for h in host]
    if min(calls) < 1:
        raise RuntimeError(f"kdtree: the host tree ran {calls} times a frame")
    print(f"kdtree: host KD-tree calls a frame {calls}; their host time a frame (the copies to "
          f"and from the card included) ms {[round(x, 3) for x in host_ms]}, p50 "
          f"{statistics.median(host_ms):.3f}", flush=True)
    _card_vs_cpu(Model, KDTREE_ARCHIVE, frames[1], "kdtree")
    return launches


def _write_serve_dir(make_frame) -> Path:
    """Seeded mock captures (``<ts>_data.npy``) of SERVE_CLOUDS under
    ``SERVE_DIR/captures``."""
    captures = SERVE_DIR / "captures"
    shutil.rmtree(SERVE_DIR, ignore_errors=True)
    captures.mkdir(parents=True)
    i = 0
    for count, n in SERVE_CLOUDS:
        for _ in range(count):
            cloud = make_frame(np.random.RandomState(700 + i), 0.3 * i, n)[0]
            np.save(captures / f"2026_01_01__12_00_{i:02d}_000000000_data.npy", cloud)
            i += 1
    return captures


def _serve_path(torch, build, captures):
    """Batch serving: the port's ``serve.main`` with the bundled archive at
    batch 8 on the card, launch counts set to 0 before it: each batch, the
    warm-up batches included, must launch the app path's kernels once. One
    mask a cloud; the card's masks and confidences held against the CPU
    port's ``serve.main`` (``--device cpu --confidences``) on the same
    directory and numpy seed: confidences within 1e-4, masks equal where the
    CPU's class-1 confidence lies more than 1e-4 from the threshold. Returns
    the launches of the masks' run."""
    import contextlib
    import io

    from recognizer3d_tpu_torch import serve
    from recognizer3d_tpu_torch.models.facade import _bucket

    tol = band = 1e-4

    seconds = {}

    def run(out, *flags):
        np.random.seed(0)
        buf = io.StringIO()
        t = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = serve.main(["-m", str(ARCHIVE), "-d", str(captures), "-o", str(out),
                             "--batch", str(SERVE_BATCH), *flags])
        seconds[out.name] = round(time.perf_counter() - t, 1)
        if rc != 0:
            raise RuntimeError(f"serve {' '.join(flags)}: exit code {rc}")
        return buf.getvalue().strip().splitlines()[-1]

    shapes = serve.distinct_batch_shapes(captures, SERVE_BATCH)
    n_batches = len({(b, _bucket(n)) for b, n in shapes}) + sum(
        -(-count // SERVE_BATCH) for count, _ in SERVE_CLOUDS)
    torch.cuda.synchronize()
    build.reset_launches()
    line = run(SERVE_DIR / "masks")
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    expected = {name: n_batches * count for name, count in PER_FRAME.items()}
    if launches != expected:
        raise RuntimeError(f"serve: launches {launches}, expected {expected} ({n_batches} "
                           f"batches of {PER_FRAME})")
    print(f"serve: {line}", flush=True)
    print(f"serve: launches {launches} = {n_batches} batches (the warm-up ones included) of "
          f"{PER_FRAME}", flush=True)
    stems = sorted(f.name[: -len("_data.npy")] for f in captures.glob("*_data.npy"))
    run(SERVE_DIR / "confidences", "--confidences")
    run(SERVE_DIR / "cpu", "--confidences", "--device", "cpu")
    worst, near = 0.0, 0
    for stem in stems:
        n = np.load(captures / f"{stem}_data.npy", mmap_mode="r").shape[0]
        mask = np.load(SERVE_DIR / "masks" / f"{stem}_prediction.npy")
        conf = np.load(SERVE_DIR / "confidences" / f"{stem}_confidences.npy")
        ref = np.load(SERVE_DIR / "cpu" / f"{stem}_confidences.npy")
        if mask.shape != (n,) or mask.dtype != np.bool_ or conf.shape != (2, n):
            raise RuntimeError(f"serve {stem}: mask {mask.shape} {mask.dtype}, confidences "
                               f"{conf.shape}")
        away = np.abs(ref[1] - 0.5) > band
        worst = max(worst, float(np.abs(conf - ref).max()))
        near += int((~away).sum())
        if worst > tol or (mask != (ref[1] > 0.5))[away].any():
            raise RuntimeError(f"serve {stem}: card vs CPU: confidences max abs err {worst}, "
                               f"{int((mask != (ref[1] > 0.5))[away].sum())} mask points differ")
    if len(list((SERVE_DIR / "masks").glob("*_prediction.npy"))) != len(stems):
        raise RuntimeError("serve: not one mask a cloud")
    print(f"serve: {len(stems)} masks, one a cloud; card vs CPU confidences max abs err "
          f"{worst:.3g}, masks equal ({near} points within {band} of the threshold); seconds "
          f"of each serve.main run (warm-ups included) {seconds}", flush=True)
    return launches


def _large_path(torch, build, Model, port_knn, approach):
    """The large-scene forward on one route: ``Model.predict(cloud,
    prepostprocess=False)`` on bench_large.py's first 1,048,576-point cloud
    with the bundled weights at that n_points. The first call (after the
    session recall guard was reset; on the approximate route the guard
    probes it and must settle on LARGE_WINDOW) is untimed; then LARGE_CALLS
    calls, each with the launch counts set to 0 before it and held to
    ``PER_CALL_LARGE``; wall p50 and peak memory printed. Then the chunked
    forward against the in-model forward on the card, on the cloud and its
    permutation (atol 2e-4, rtol 1e-3, as tests/test_large.py; on the
    approximate route both at the session's window). Returns the model, the
    cloud and the launches of the timed calls; the session window stays
    for phase 8."""
    from recognizer3d_tpu_torch.benchmarks import bench_large
    from recognizer3d_tpu_torch.models.large import forward_eval_large

    label = "large-exact" if approach == "naive" else "large-approx"
    t0 = time.perf_counter()
    _, clouds = bench_large.inputs(LARGE_POINTS)
    cloud, perm = clouds["approximate"]
    port_knn.reset_window_guard()
    model = Model.load(ARCHIVE, device="cuda", n_points=LARGE_POINTS, knn=approach)
    np.random.seed(0)
    conf = model.predict(cloud, prepostprocess=False)
    if conf.shape != (1, 2, LARGE_POINTS) or not np.isfinite(conf).all():
        raise RuntimeError(f"{label}: confidences of shape {conf.shape}, or not finite")
    if approach == "approximate":
        window, fallback = port_knn.session_window_points(), port_knn.session_exact_fallback()
        print(f"{label}: recall guard on the first cloud: {model.recall_guard_result}; session "
              f"window {window}, exact fallback {fallback}", flush=True)
        if window != LARGE_WINDOW or fallback:
            raise RuntimeError(f"{label}: the guard settled on window {window} (exact fallback "
                               f"{fallback}), expected {LARGE_WINDOW}")
    per_call = PER_CALL_LARGE[approach]
    walls, totals = [], {}
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    for _ in range(LARGE_CALLS):
        torch.cuda.synchronize()
        build.reset_launches()
        t = time.perf_counter()
        model.predict(cloud, prepostprocess=False)
        walls.append((time.perf_counter() - t) * 1e3)
        launches = dict(build.LAUNCHES)
        if launches != per_call:
            raise RuntimeError(f"{label}: launches {launches} in a call, expected {per_call}")
        for name, count in launches.items():
            totals[name] = totals.get(name, 0) + count
    peak = torch.cuda.max_memory_allocated() / 1e9
    t2 = time.perf_counter()
    print(f"{label}: {LARGE_CALLS} calls of Model.predict(prepostprocess=False) on "
          f"{LARGE_POINTS} points, launches a call {per_call} (the streaming "
          f"kernel knn_topk_stream {launches.get('knn_topk_stream', 0)}); wall ms "
          f"{[round(w, 3) for w in walls]}, p50 {statistics.median(walls):.3f}; peak memory "
          f"{peak:.3f} GB", flush=True)
    with torch.inference_mode():
        x = torch.from_numpy(cloud).cuda()
        p = torch.from_numpy(perm).cuda()
        chunked = forward_eval_large(model.module, x, p)
        torch.cuda.reset_peak_memory_stats()
        in_model = model.module(x, p)
        torch.cuda.synchronize()
        in_model_peak = torch.cuda.max_memory_allocated() / 1e9
        diff = (chunked - in_model).abs()
        ok = bool((diff <= 2e-4 + 1e-3 * in_model.abs()).all()) and bool(chunked.isfinite().all())
        err = float(diff.max())
    if not ok:
        raise RuntimeError(f"{label}: chunked forward vs in-model forward: max abs err {err}")
    print(f"{label}: chunked forward against the in-model forward (peak memory "
          f"{in_model_peak:.3f} GB) on the card: max abs err {err:.3g} (atol 2e-4, rtol 1e-3); "
          f"seconds: load and first call {t1 - t0:.1f}, timed calls {t2 - t1:.1f}, in-model "
          f"check {time.perf_counter() - t2:.1f}", flush=True)
    return model, cloud, totals


def _large_card_vs_cpu(torch, Model, port_knn, approach):
    """The chunked forward called directly at LARGE_CPU_POINTS[approach]
    points, chunk LARGE_CPU_CHUNK, on the card and on the CPU port
    (bench_large.py's first cloud at that size, the bundled weights; the
    approximate route at the session window, LARGE_WINDOW, on both sides):
    the largest |Δ logit| within LARGE_CPU_REL_TOL of the largest |logit|
    (the logits reach about 70, so an absolute 1e-4 would ask for less than
    float32's rounding of them)."""
    from recognizer3d_tpu_torch.benchmarks import bench_large
    from recognizer3d_tpu_torch.models.large import forward_eval_large

    label = "large-exact" if approach == "naive" else "large-approx"
    n = LARGE_CPU_POINTS[approach]
    if approach == "approximate" and port_knn.session_window_points() != LARGE_WINDOW:
        raise RuntimeError(f"{label}: session window {port_knn.session_window_points()} before "
                           f"the card-against-CPU check, expected {LARGE_WINDOW}")
    _, clouds = bench_large.inputs(n)
    cloud, perm = clouds["approximate"]
    logits, seconds = {}, {}
    for device in ("cuda", "cpu"):
        model = Model.load(ARCHIVE, device=device, n_points=n, knn=approach)
        t = time.perf_counter()
        with torch.inference_mode():
            logits[device] = forward_eval_large(
                model.module, torch.from_numpy(cloud).to(device),
                torch.from_numpy(perm).to(device), chunk=LARGE_CPU_CHUNK,
            ).cpu()
        seconds[device] = time.perf_counter() - t
    err = float((logits["cuda"] - logits["cpu"]).abs().max())
    scale = float(logits["cpu"].abs().max())
    if not bool(logits["cuda"].isfinite().all()) or err > LARGE_CPU_REL_TOL * scale:
        raise RuntimeError(f"{label}: card vs CPU at {n} points: max abs err {err} against the "
                           f"largest |logit| {scale}")
    window = f", window {port_knn.session_window_points()}" if approach == "approximate" else ""
    print(f"{label}: forward_eval_large at {n} points, chunk {LARGE_CPU_CHUNK}{window}, card vs "
          f"CPU: logits max abs err {err:.3g}, {err / scale:.3g} of the largest |logit| "
          f"{scale:.4g} (limit {LARGE_CPU_REL_TOL}); seconds: card {seconds['cuda']:.1f}, CPU "
          f"{seconds['cpu']:.1f}", flush=True)


def _rank_launches(pool, label, expected):
    """Each rank's launch counts since they were set to 0, held to
    ``expected`` on every rank; returns their sum."""
    from recognizer3d_tpu_torch.parallel import mesh

    per_rank = pool.run(mesh.launches)
    for r, launches in enumerate(per_rank):
        if launches != expected:
            raise RuntimeError(f"{label}: rank {r} launched {launches}, expected {expected}")
    total = {}
    for launches in per_rank:
        for name, count in launches.items():
            total[name] = total.get(name, 0) + count
    return total


def _dp_serve_path(torch, Model, captures):
    """Phase 5f: ``DPServing`` of the bundled archive on DP_DEVICES (two ranks
    sharing the card) over 5d's captures at batch 8. Per batch, the launch
    counts set to 0 on every rank before it, and each rank's held to
    PER_FRAME (its block of clouds is one forward); the confidences held
    against the single-process ``Model.predict`` on the card with the same
    numpy seed (within DP_TOL, masks equal where that confidence lies more
    than DP_TOL from the threshold). Then the clouds/s over the batches
    (masks, after one untimed pass) of the two ranks and of one, in turns
    (2, 1, 1, 2), each rank's peak memory,
    and the CLI with ``--devices -1`` (one rank: the one card), whose masks
    must equal 5d's. Returns the ranks' launches of the checked batches."""
    import contextlib
    import io

    from recognizer3d_tpu_torch import serve
    from recognizer3d_tpu_torch.ops import _build
    from recognizer3d_tpu_torch.parallel import mesh
    from recognizer3d_tpu_torch.parallel.serving import DPServing

    t0 = time.perf_counter()
    model = Model.load(ARCHIVE, device="cuda")
    batches = list(serve.iter_batches(captures, SERVE_BATCH))
    totals, worst, near = {}, 0.0, 0
    with DPServing(model, DP_DEVICES) as server:
        pool = server.pool
        t1 = time.perf_counter()
        for i, (_, clouds) in enumerate(batches):
            pool.run(_build.reset_launches)
            np.random.seed(10 + i)
            conf = server.predict(clouds)
            for name, count in _rank_launches(pool, f"dp-serve batch {i}", PER_FRAME).items():
                totals[name] = totals.get(name, 0) + count
            np.random.seed(10 + i)
            mask = server.predict_mask(clouds)
            np.random.seed(10 + i)
            ref = model.predict(clouds)
            if conf.shape != ref.shape or mask.shape != ref[:, 1].shape:
                raise RuntimeError(f"dp-serve batch {i}: confidences {conf.shape}, masks "
                                   f"{mask.shape}, expected {ref.shape}")
            away = np.abs(ref[:, 1] - 0.5) > DP_TOL
            worst = max(worst, float(np.abs(conf - ref).max()))
            near += int((~away).sum())
            if worst > DP_TOL or (mask != (ref[:, 1] > 0.5))[away].any():
                raise RuntimeError(f"dp-serve batch {i}: against Model.predict: confidences max "
                                   f"abs err {worst}, "
                                   f"{int((mask != (ref[:, 1] > 0.5))[away].sum())} mask points "
                                   f"differ")
        t2 = time.perf_counter()
        pool.run(mesh.reset_peak_memory)
        n_clouds = sum(len(c) for _, c in batches)
        rates = {len(DP_DEVICES): [], 1: []}
        with DPServing(model, DP_DEVICES[:1]) as one:  # one rank: no group, no worker
            for _, clouds in batches:
                one.predict_mask(clouds)
            for srv in (server, one, one, server):
                t = time.perf_counter()
                for _, clouds in batches:
                    srv.predict_mask(clouds)
                rates[srv.n_devices].append(n_clouds / (time.perf_counter() - t))
        peaks = [b / 1e9 for b in pool.run(mesh.peak_memory_bytes)]
    print(f"dp-serve: DPServing on {DP_DEVICES}, batches of {[len(c) for _, c in batches]} "
          f"clouds: each rank launched {PER_FRAME} a batch; against Model.predict on the card: "
          f"confidences max abs err {worst:.3g}, masks equal ({near} points within {DP_TOL} of "
          f"the threshold)", flush=True)
    print(f"dp-serve: predict_mask over the {n_clouds} clouds, in turns (2, 1, 1, 2 ranks; "
          f"after one untimed pass): {len(DP_DEVICES)} ranks on one card "
          f"{[round(r, 3) for r in rates[len(DP_DEVICES)]]} clouds/s, one rank "
          f"{[round(r, 3) for r in rates[1]]}; peak memory a rank "
          f"{[round(x, 3) for x in peaks]} GB; seconds: start and replicate {t1 - t0:.1f}, "
          f"checked batches {t2 - t1:.1f}", flush=True)

    out = SERVE_DIR / "dp_masks"
    buf = io.StringIO()
    np.random.seed(0)
    t = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = serve.main(["-m", str(ARCHIVE), "-d", str(captures), "-o", str(out), "--batch",
                         str(SERVE_BATCH), "--devices", "-1"])
    line = buf.getvalue().strip().splitlines()[-1]
    if rc != 0 or json.loads(line)["devices"] != 1:
        raise RuntimeError(f"serve --devices -1: exit code {rc}, line {line}")
    for f in sorted((SERVE_DIR / "masks").glob("*_prediction.npy")):
        if not np.array_equal(np.load(f), np.load(out / f.name)):
            raise RuntimeError(f"serve --devices -1: {f.name} differs from the one-card CLI's")
    print(f"dp-serve: serve --devices -1 (one rank): {line}; masks equal to 5d's; "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    return totals


def _sp_serve_path(torch, Model, captures, targets):
    """Phase 5g: ``SPServing`` of the bundled weights on SP_DEVICES (four
    ranks on the card) over the 5e cloud. One untimed call, with rank 0's
    (this process's) kernel wrappers recording their inputs (``targets``;
    each wrapper's calls held to its PER_CALL_SP count), then SP_CALLS
    calls, each with the launch counts set to 0 on every rank before it and
    each rank's held to PER_CALL_SP; wall p50 and each rank's peak memory.
    The first call's confidences (its permutation replayed from a
    ``RandomState(0)``, as the server drew it) against ``forward_eval_large``
    on the card on the exact route (within SP_ATOL + SP_RTOL·|ref|, masks
    equal where the reference lies further than that from the threshold).
    Then the CLI with ``--point-shards -1`` (one rank) on one capture of
    SP_CLI_POINTS points. Returns the ranks' launches of the timed calls and
    rank 0's recorded kernel calls for phase 8."""
    import contextlib
    import io

    from recognizer3d_tpu_torch import serve
    from recognizer3d_tpu_torch.benchmarks import bench_large
    from recognizer3d_tpu_torch.models.facade import _bucket
    from recognizer3d_tpu_torch.models.large import forward_eval_large
    from recognizer3d_tpu_torch.ops import _build
    from recognizer3d_tpu_torch.parallel import mesh
    from recognizer3d_tpu_torch.parallel.serving import SPServing
    from recognizer3d_tpu_torch.parallel.sp_model import pad_for_sharding, sharding_multiple

    t0 = time.perf_counter()
    _, clouds = bench_large.inputs(LARGE_POINTS)
    cloud = clouds["approximate"][0]
    torch.cuda.empty_cache()
    model = Model.load(ARCHIVE, device="cuda")
    granule = sharding_multiple(model.settings, len(SP_DEVICES))
    if _bucket(LARGE_POINTS) != LARGE_POINTS or LARGE_POINTS % granule:
        raise RuntimeError(f"sp-1M: {LARGE_POINTS} points would be padded (bucket "
                           f"{_bucket(LARGE_POINTS)}, granule {granule})")
    totals, walls = {}, []
    with SPServing(model, SP_DEVICES) as server:
        pool = server.pool
        t1 = time.perf_counter()
        with _Recorder(targets) as rec:
            conf = server.predict(cloud)
        t2 = time.perf_counter()
        for name, recorded in rec.calls.items():
            if len(recorded) != PER_CALL_SP.get(name, 0):
                raise RuntimeError(f"sp-1M: rank 0 recorded {len(recorded)} calls of {name}, "
                                   f"expected {PER_CALL_SP.get(name, 0)}")
        pool.run(mesh.reset_peak_memory)
        for i in range(SP_CALLS):
            pool.run(_build.reset_launches)
            t = time.perf_counter()
            server.predict(cloud)
            walls.append((time.perf_counter() - t) * 1e3)
            for name, count in _rank_launches(pool, f"sp-1M call {i}", PER_CALL_SP).items():
                totals[name] = totals.get(name, 0) + count
        peaks = [b / 1e9 for b in pool.run(mesh.peak_memory_bytes)]
    if conf.shape != (1, 2, LARGE_POINTS) or not np.isfinite(conf).all():
        raise RuntimeError(f"sp-1M: confidences of shape {conf.shape}, or not finite")
    print(f"sp-1M: SPServing on {SP_DEVICES}, {LARGE_POINTS} points: each rank launched "
          f"{PER_CALL_SP} a call; wall ms {[round(w, 3) for w in walls]}, p50 "
          f"{statistics.median(walls):.3f}; first call {(t2 - t1) * 1e3:.3f} ms; peak memory "
          f"a rank {[round(x, 3) for x in peaks]} GB; start and replicate {t1 - t0:.1f} s",
          flush=True)

    rng = np.random.RandomState(0)
    padded, _ = pad_for_sharding(cloud[0], model.settings, len(SP_DEVICES),
                                 n_target=_bucket(LARGE_POINTS), rng=rng)
    perm = rng.permutation(padded.shape[0])
    ref_model = Model.load(ARCHIVE, device="cuda", n_points=LARGE_POINTS, knn="naive")
    with torch.inference_mode():
        x = torch.from_numpy(padded[None]).cuda()
        ref = torch.softmax(forward_eval_large(ref_model.module, x, torch.from_numpy(perm).cuda()),
                            dim=-2).cpu().numpy()
        del x
    del ref_model
    torch.cuda.empty_cache()
    diff = np.abs(conf - ref)
    limit = SP_ATOL + SP_RTOL * np.abs(ref)
    away = np.abs(ref[:, 1] - 0.5) > SP_ATOL + SP_RTOL * 0.5
    flipped = int(((conf[:, 1] > 0.5) != (ref[:, 1] > 0.5))[away].sum())
    if (diff > limit).any() or flipped:
        raise RuntimeError(f"sp-1M against forward_eval_large: {int((diff > limit).sum())} "
                           f"confidences beyond atol {SP_ATOL} rtol {SP_RTOL} (max abs err "
                           f"{diff.max()}), {flipped} mask points differ")
    print(f"sp-1M: the first call against forward_eval_large (exact route, the replayed "
          f"permutation) on the card: confidences max abs err {diff.max():.3g} (atol {SP_ATOL}, "
          f"rtol {SP_RTOL}); masks equal ({int((~away).sum())} points within the tolerance of "
          f"the threshold)", flush=True)

    cli_dir = ROOT / "build" / "sp_serve"
    shutil.rmtree(cli_dir, ignore_errors=True)
    (cli_dir / "captures").mkdir(parents=True)
    src = next(f for f in sorted(captures.glob("*_data.npy"))
               if np.load(f, mmap_mode="r").shape[0] == SP_CLI_POINTS)
    shutil.copy(src, cli_dir / "captures" / src.name)
    buf = io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = serve.main(["-m", str(ARCHIVE), "-d", str(cli_dir / "captures"), "-o",
                         str(cli_dir / "out"), "--point-shards", "-1", "--confidences"])
    line = buf.getvalue().strip().splitlines()[-1]
    out = np.load(cli_dir / "out" / src.name.replace("_data.npy", "_confidences.npy"))
    if rc != 0 or json.loads(line)["point_shards"] != 1 or out.shape != (2, SP_CLI_POINTS) \
            or not np.isfinite(out).all() or np.abs(out.sum(0) - 1).max() > 1e-5:
        raise RuntimeError(f"serve --point-shards -1: exit code {rc}, line {line}, confidences "
                           f"{out.shape}")
    print(f"sp-1M: serve --point-shards -1 (one rank) on a capture of {SP_CLI_POINTS} points: "
          f"{line}; {time.perf_counter() - t:.1f} s", flush=True)
    return totals, rec.calls


def _sp_ring_step(torch, knn_kernels, support, query):
    """One level-0 ring step's inputs (unsorted blocks of the permuted
    cloud; phase 8 held and timed B1 on them with the other recorded calls):
    the share of the M·N distances B1's walk evaluates there, by the CPU
    model on every SP_MODEL_STRIDE-th of the LARGE_KNN_SAMPLE sampled rows
    (the work the culling fails to skip on this order), beside B1 on the
    same two blocks Morton-sorted: bit-equal to its plain version on the
    sampled rows, its box pass and walk timed, and its walk's share by the
    model on the same number of rows."""
    from recognizer3d_tpu_torch.benchmarks import knn_cull

    k = 32
    m, n = query.shape[1], support.shape[1]
    if not m == n == LARGE_POINTS // len(SP_DEVICES):
        raise RuntimeError(f"sp ring step: M={m} N={n}, not a level-0 step")
    rows = _sample_rows(torch, m, n)
    model_rows = rows[::SP_MODEL_STRIDE].cpu().numpy()

    def walked(s, q):
        counts = knn_cull.select(s[0].cpu().numpy(), q[0].cpu().numpy(), k, 1,
                                 rows=model_rows)[2]
        return float(counts["distances"].sum()) / (len(model_rows) * n)

    unsorted_share = walked(support, query)
    s_sorted, q_sorted = _morton_sorted(torch, support), _morton_sorted(torch, query)
    idx, d2 = knn_kernels.knn_topk(s_sorted, q_sorted, k)
    ref_i, ref_d = knn_kernels.knn_topk_plain(s_sorted, q_sorted[:, rows].contiguous(), k)
    torch.cuda.synchronize()
    if not (torch.equal(idx[:, rows], ref_i) and torch.equal(d2[:, rows], ref_d)):
        raise RuntimeError(f"sp ring step, Morton-sorted: knn_topk M={m} N={n}: "
                           f"{int((idx[:, rows] != ref_i).sum())} indices and "
                           f"{int((d2[:, rows] != ref_d).sum())} distances differ")
    del idx, d2, ref_i, ref_d
    box_ms, walk_ms = _device_ms(torch, lambda: knn_kernels.knn_topk(s_sorted, q_sorted, k),
                                 10, ("knn_box_kernel", "knn_cull_kernel"))
    print(f"sp ring step knn_topk M={m} N={n} k={k} (rank 0's level-0 block against rank 3's): "
          f"on the unsorted blocks the walk evaluates {unsorted_share:.4f} of the M*N "
          f"distances (CPU model, {len(model_rows)} rows); on the same blocks Morton-sorted it "
          f"evaluates {walked(s_sorted, q_sorted):.4f}, and B1 (indices in order and d2 equal to "
          f"the plain version on {len(rows)} sampled rows) takes box pass {box_ms:.4f} ms + "
          f"walk {walk_ms:.4f} ms = {box_ms + walk_ms:.4f} ms", flush=True)


def _torch_archive(torch, Model, model, frame):
    """The bundled weights re-saved as a reference-layout torch archive and
    loaded on the card: the same state and the same predictions."""
    from recognizer3d_tpu_torch.models import torch_compat
    from recognizer3d_tpu_torch.models.weights import to_flax_variables

    state = model.module.state_dict()
    torch_compat.save_reference_archive(
        TORCH_ARCHIVE, model.settings,
        torch_compat.variables_to_torch_state_dict(to_flax_variables(state), model.settings),
    )
    loaded = Model.load(TORCH_ARCHIVE, device="cuda", transfer_dtype="float32")
    other = loaded.module.state_dict()
    if sorted(other) != sorted(state) or not all(torch.equal(state[k], other[k]) for k in state):
        raise RuntimeError("torch archive: the loaded state differs from the msgpack archive's")
    np.random.seed(7)
    ref = model.predict(frame)
    np.random.seed(7)
    conf = loaded.predict(frame)
    if not np.array_equal(conf, ref):
        raise RuntimeError(
            f"torch archive: predictions differ by {float(np.abs(conf - ref).max())}"
        )
    print(f"torch archive: {TORCH_ARCHIVE.relative_to(ROOT)} loaded on the card; state and "
          f"predictions on a {frame.shape[0]}-point frame equal the msgpack archive's",
          flush=True)


def _write_train_dataset(make_frame) -> None:
    """The annotated mock dataset of the train phase, under ``build/``."""
    from recognizer3d_tpu_torch.data.dataset import Dataset

    if TRAIN_DIR.exists():
        shutil.rmtree(TRAIN_DIR)
    ds = Dataset(TRAIN_DIR)
    t0 = datetime(2026, 1, 1, 12, 0, 0)
    for i in range(TRAIN_CLOUDS):
        cloud, annotation = make_frame(np.random.RandomState(700 + i), 0.45 * i, TRAIN_POINTS)
        ds[t0 + timedelta(seconds=i)] = cloud
        ds.set_annotation(t0 + timedelta(seconds=i), annotation)


def _train_path(torch, build, Model, make_frame, compute_dtype="float32"):
    """The port's run_training at the app config in ``compute_dtype`` for
    TRAIN_EPOCHS on the card (the dataset written first in float32); returns
    the trained Model, the launches of the run and one validation batch
    (inputs, permutation)."""
    from recognizer3d_tpu_torch.train import app_model_config, app_training_config, run_training
    from recognizer3d_tpu_torch.training.trainer import Trainer

    label = "train" if compute_dtype == "float32" else "train-bf16"
    out = TRAIN_OUT if compute_dtype == "float32" else TRAIN_OUT_BF16
    per_val = PER_VAL_FORWARD if compute_dtype == "float32" else PER_VAL_FORWARD_BF16
    if compute_dtype == "float32":
        _write_train_dataset(make_frame)
    training = app_training_config()
    training.epochs = TRAIN_EPOCHS
    # run_training's fresh model: Model's default seed 0
    init = {k: v.clone()
            for k, v in Model(app_model_config(compute_dtype)).module.state_dict().items()}
    if out.exists():
        shutil.rmtree(out)
    np.random.seed(0)
    torch.cuda.synchronize()
    build.reset_launches()
    t0 = time.perf_counter()
    path, model, trainer = run_training([TRAIN_DIR], training=training,
                                        models_dir=out / "models", log_root=out / "log",
                                        compute_dtype=compute_dtype)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    n_val = TRAIN_CLOUDS - int(0.8 * TRAIN_CLOUDS)
    val_forwards = 10 * math.ceil(n_val / training.batch_size)
    steps = sum(h["steps"] for h in trainer.history)
    expected = {
        name: steps * PER_STEP_ASSEMBLED.get(name, 0)
        + TRAIN_EPOCHS * val_forwards * per_val.get(name, 0)
        for name in {**per_val, **PER_STEP_ASSEMBLED}
    }
    if len(trainer.history) != TRAIN_EPOCHS or launches != expected:
        raise RuntimeError(f"{label}: {len(trainer.history)} epochs, launches {launches}, "
                           f"expected {expected} ({steps} steps, {val_forwards} validation "
                           f"forwards an epoch)")
    for h in trainer.history:
        bad = [k for k, v in h["metrics"].items() if not math.isfinite(float(v))]
        if bad:
            raise RuntimeError(f"{label}: epoch {h['epoch']}: not finite: {bad}")
        m = h["metrics"]
        print(f"{label}: epoch {h['epoch']}: {h['steps']} steps in {h['train_s'] * 1e3:.1f} ms, "
              f"validation ({val_forwards} forwards) {h['validate_s'] * 1e3:.1f} ms; loss "
              f"{m['loss']:.4f}, val_loss {m['val_loss']:.4f}, mIoU {m['mIoU']:.4f}, "
              f"val_mIoU {m['val_mIoU']:.4f}", flush=True)
    state = model.module.state_dict()
    still = [k for k, v in state.items() if torch.equal(v, init[k])]
    if still:
        raise RuntimeError(f"{label}: tensors that did not move from the init: {still}")
    wide = [k for k, v in state.items() if v.dtype != torch.float32]
    if wide:
        raise RuntimeError(f"{label}: parameters or statistics not float32: {wide}")
    print(f"{label}: run_training at the app config (compute_dtype={compute_dtype}), "
          f"{TRAIN_EPOCHS} epochs on {TRAIN_CLOUDS} clouds of {TRAIN_POINTS} points, {wall:.3f} s "
          f"end to end (dataset load, broadened annotations and device cache included); "
          f"launches {launches}; all {len(state)} parameters and running statistics float32 "
          f"and moved", flush=True)
    frame = make_frame(np.random.RandomState(800), 0.2, FRAME_POINTS)[0]
    for dtype in dict.fromkeys((compute_dtype, "float32")):
        loaded = Model.load(path, device="cuda", transfer_dtype="float32", compute_dtype=dtype)
        other = loaded.module.state_dict()
        if not all(torch.equal(state[k], other[k]) for k in state):
            raise RuntimeError(f"{label}: the saved archive's state differs from the trained "
                               f"model's")
        conf = loaded.predict(frame)
        if conf.shape != (2, FRAME_POINTS) or not np.isfinite(conf).all():
            raise RuntimeError(f"{label}: reloaded model answered {conf.shape}, or not finite")
        print(f"{label}: {path.relative_to(ROOT)} reloaded on the card in {dtype}: same state; "
              f"one {FRAME_POINTS}-point frame answered ({int((conf[1] > 0.5).sum())} "
              f"positives)", flush=True)
    # the validation sweep's batch and its seed-0 permutation, as the
    # trainer kept them on the card
    inputs, _, perms = Trainer._device_eval_batches(trainer._validation_dataloader, 10,
                                                  model.device)[0]
    return model, launches, (inputs, perms[0])


def _train_batches(torch, n: int, seed: int = 0):
    """``n`` app-config train batches assembled on the card from the train
    phase's dataset: (inputs, labels, permutation, dropout mask)."""
    from recognizer3d_tpu_torch.data.dataset import Dataset
    from recognizer3d_tpu_torch.data.pipeline import DeviceDatasetCache
    from recognizer3d_tpu_torch.train import app_augmentation
    from recognizer3d_tpu_torch.training.trainer import dropout_mask

    ds = Dataset(TRAIN_DIR, broaden_annotations=True)
    cache = DeviceDatasetCache([ds[i] for i in range(len(ds))], 2500,
                               augmentation_settings=app_augmentation(), device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    out = []
    for _ in range(n):
        ids = torch.randperm(cache.n_samples, generator=gen, device="cuda")[:4]
        inputs, labels = cache.sample_batch(ids, gen)
        perm = torch.randperm(inputs.shape[1], generator=gen, device="cuda")
        out.append((inputs, labels, perm, dropout_mask(gen, inputs)))
    return out


def _train_step_checks(torch, build, Model, model, val_batch):
    """On the trained weights: launches of a step and of a validation
    forward, the step's wall p50, and one step on the card against the
    CPU. Returns a step's module, optimizer, criterion and batch for the
    kernel checks."""
    from recognizer3d_tpu_torch.benchmarks.train_precision import grad_distance, step_gradients
    from recognizer3d_tpu_torch.train import app_model_config
    from recognizer3d_tpu_torch.training import losses
    from recognizer3d_tpu_torch.training.trainer import make_optimizer, train_step

    criterion = losses.get_loss("dice")
    batches = _train_batches(torch, STEP_REPS + 1)
    weights = {k: v.detach().cpu().clone() for k, v in model.module.state_dict().items()}
    settings = app_model_config()
    steps = {}
    for dtype in (torch.float64, torch.float32):
        for device in ("cuda", "cpu"):
            m = Model(settings, weights=weights, device=device)
            module = m.module.to(dtype)
            module.train()
            opt = make_optimizer(module, 1e-2)
            inputs, labels, perm, keep = (t.to(device) for t in batches[0])
            build.reset_launches()
            loss, _ = train_step(module, opt, criterion, inputs.to(dtype), labels, perm, keep)
            if device == "cuda":
                torch.cuda.synchronize()
                if dict(build.LAUNCHES) != PER_STEP:
                    raise RuntimeError(f"train step: launches {dict(build.LAUNCHES)}, expected "
                                       f"{PER_STEP}")
            steps[device, dtype] = (
                float(loss),
                {n: p.grad.detach().cpu().double() for n, p in module.named_parameters()},
                {n: b.detach().cpu().double() for n, b in module.named_buffers()},
            )

    def gaps(a, b):
        """(loss, gradients, running statistics) of a against b, each
        relative: the gradients as ``grad_distance``, the statistics to the
        largest value of b's tensor."""
        stats = max(float((a[2][n] - b[2][n]).abs().max()) / float(b[2][n].abs().max())
                    for n in b[2])
        return abs(a[0] - b[0]) / abs(b[0]), grad_distance(a[1], b[1]), stats

    exact = steps["cpu", torch.float64]
    loss_err, (grad_err, _, at), bs_err = gaps(steps["cuda", torch.float64], exact)
    if not math.isfinite(exact[0]) or loss_err > 1e-5 or grad_err > 1e-4 or bs_err > 1e-5:
        raise RuntimeError(f"train step card vs CPU in float64: loss rel {loss_err:.3g}, "
                           f"gradients {grad_err:.3g} of max |g| at {at}, running statistics "
                           f"{bs_err:.3g}")
    print(f"train step: card vs CPU in float64 (geometry and neighbour search in float32) on "
          f"one batch of 4 x 2500 points: loss {exact[0]:.9f} (rel {loss_err:.3g}), gradients "
          f"within {grad_err:.3g} of each tensor's max |g| ({at}), running statistics within "
          f"{bs_err:.3g}", flush=True)
    f32 = {d: steps[d, torch.float32] for d in ("cuda", "cpu")}
    loss_err, (grad_err, _, at), bs_err = gaps(f32["cuda"], f32["cpu"])
    if not math.isfinite(f32["cuda"][0]) or loss_err > 1e-5:
        raise RuntimeError(f"train step card vs CPU in float32: loss {f32['cuda'][0]} vs "
                           f"{f32['cpu'][0]} (rel {loss_err:.3g})")
    floor = {d: gaps(f32[d], exact) for d in f32}
    tf32 = grad_distance(step_gradients(settings, weights, batches[0], "cuda", tf32=True),
                         exact[1])
    print(f"train step: card vs CPU in float32: loss rel {loss_err:.3g}, gradients "
          f"{grad_err:.3g} of max |g| ({at}), running statistics {bs_err:.3g}; against the "
          f"float64 step, gradients (max at / median over the tensors) and statistics: card "
          f"{floor['cuda'][1][0]:.3g} ({floor['cuda'][1][2]}) / {floor['cuda'][1][1]:.3g} and "
          f"{floor['cuda'][2]:.3g}, CPU {floor['cpu'][1][0]:.3g} ({floor['cpu'][1][2]}) / "
          f"{floor['cpu'][1][1]:.3g} and {floor['cpu'][2]:.3g}; the card with TF32 matmuls "
          f"{tf32[0]:.3g} ({tf32[2]}) / {tf32[1]:.3g}", flush=True)
    medians = {"card": [floor["cuda"][1][1]], "TF32": [tf32[1]]}
    for batch in batches[1:PRECISION_BATCHES]:
        ref = step_gradients(settings, weights, batch, "cpu", torch.float64)
        medians["card"].append(grad_distance(step_gradients(settings, weights, batch, "cuda"),
                                             ref)[1])
        medians["TF32"].append(grad_distance(
            step_gradients(settings, weights, batch, "cuda", tf32=True), ref)[1])
    card_m, tf32_m = min(medians["card"]), min(medians["TF32"])
    print(f"train step in float32 on the card, the median over the tensors of the gradients' "
          f"distance from the float64 step on {PRECISION_BATCHES} batches: "
          f"{[float(f'{m:.3g}') for m in medians['card']]}, with TF32 matmuls "
          f"{[float(f'{m:.3g}') for m in medians['TF32']]}; the smallest {card_m:.3g} and "
          f"{tf32_m:.3g} against the limit {FP32_GRAD_MEDIAN_LIMIT}", flush=True)
    if not card_m <= FP32_GRAD_MEDIAN_LIMIT < tf32_m:
        raise RuntimeError(f"train step in float32: the card's smallest median gradient distance "
                           f"from the float64 step {card_m:.3g} and the TF32 control's "
                           f"{tf32_m:.3g} do not stand either side of {FP32_GRAD_MEDIAN_LIMIT}")

    # the step's wall and a validation forward's launches on the card
    m = Model(settings, weights=weights, device="cuda")
    module = m.module
    module.train()
    opt = make_optimizer(module, 1e-2)
    walls = []
    for inputs, labels, perm, keep in batches:
        torch.cuda.synchronize()
        t = time.perf_counter()
        train_step(module, opt, criterion, inputs, labels, perm, keep)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t) * 1e3)
    walls = walls[1:]
    module.eval()
    with torch.inference_mode():
        build.reset_launches()
        module(*val_batch)
        torch.cuda.synchronize()
    if dict(build.LAUNCHES) != PER_VAL_FORWARD:
        raise RuntimeError(f"validation forward: launches {dict(build.LAUNCHES)}, expected "
                           f"{PER_VAL_FORWARD}")
    print(f"train step (batch 4 x 2500 points, app config, synchronised): wall ms over "
          f"{len(walls)} steps p50 {statistics.median(walls):.3f}, min {min(walls):.3f}, "
          f"max {max(walls):.3f}; launches a step {PER_STEP}, a validation forward "
          f"(batch {val_batch[0].shape[0]}) {PER_VAL_FORWARD}", flush=True)
    module.train()
    return module, opt, criterion, batches[0]


def _train_bf16_step_checks(torch, build, Model, model, val_batch):
    """On the bfloat16-trained weights: launches of a bfloat16 step and of
    a bfloat16 validation forward, the step's wall p50 beside the float32
    step's (the same weights and batches, in turns), and a bfloat16 step on
    each of ``BF16_STEPS`` batches on the card against the CPU under
    ``train_precision.bf16_steps_agree``, which the card's float32 steps, the
    control, must miss. Returns a bfloat16 step's module, optimizer,
    criterion and batch for the kernel checks."""
    from recognizer3d_tpu_torch.benchmarks.train_precision import (
        BF16_GRAD_MEDIAN,
        BF16_STEPS,
        bf16_step_readings,
        bf16_steps_agree,
        describe_bf16,
    )
    from recognizer3d_tpu_torch.train import app_model_config
    from recognizer3d_tpu_torch.training import losses
    from recognizer3d_tpu_torch.training.trainer import make_optimizer, train_step

    criterion = losses.get_loss("dice")
    batches = _train_batches(torch, STEP_REPS + 1)
    weights = {k: v.detach().cpu().clone() for k, v in model.module.state_dict().items()}
    steppers = {}
    for dtype in ("bfloat16", "float32"):
        module = Model(app_model_config(dtype), weights=weights, device="cuda").module
        module.train()
        steppers[dtype] = (module, make_optimizer(module, 1e-2))
    walls = {dtype: [] for dtype in steppers}
    for i, (inputs, labels, perm, keep) in enumerate(batches):
        for dtype, (module, opt) in steppers.items():
            torch.cuda.synchronize()
            build.reset_launches()
            t = time.perf_counter()
            loss, _ = train_step(module, opt, criterion, inputs, labels, perm, keep)
            torch.cuda.synchronize()
            walls[dtype].append((time.perf_counter() - t) * 1e3)
            if dict(build.LAUNCHES) != PER_STEP or not math.isfinite(float(loss)):
                raise RuntimeError(f"train step in {dtype}: launches {dict(build.LAUNCHES)}, "
                                   f"expected {PER_STEP}; loss {float(loss)}")
    module, opt = steppers["bfloat16"]
    grads = [n for n, p in module.named_parameters() if p.grad is None
             or p.grad.dtype != torch.float32 or p.dtype != torch.float32]
    if grads:
        raise RuntimeError(f"train-bf16: parameters without a float32 gradient: {grads}")
    module.eval()
    with torch.inference_mode():
        build.reset_launches()
        module(*val_batch)
        torch.cuda.synchronize()
    if dict(build.LAUNCHES) != PER_VAL_FORWARD_BF16:
        raise RuntimeError(f"bf16 validation forward: launches {dict(build.LAUNCHES)}, "
                           f"expected {PER_VAL_FORWARD_BF16}")
    module.train()
    p50 = {dtype: statistics.median(w[1:]) for dtype, w in walls.items()}
    print(f"train step (batch 4 x 2500 points, app config, synchronised, the two dtypes in "
          f"turns on the same weights and batches): wall ms over {STEP_REPS} steps, bfloat16 "
          f"p50 {p50['bfloat16']:.3f} (min {min(walls['bfloat16'][1:]):.3f}, max "
          f"{max(walls['bfloat16'][1:]):.3f}), float32 p50 {p50['float32']:.3f} (min "
          f"{min(walls['float32'][1:]):.3f}, max {max(walls['float32'][1:]):.3f}); launches a "
          f"bfloat16 step {PER_STEP}, a bfloat16 validation forward (batch "
          f"{val_batch[0].shape[0]}) {PER_VAL_FORWARD_BF16}", flush=True)
    readings = [bf16_step_readings(app_model_config(), weights, tuple(t.cpu() for t in batch))
                for batch in batches[:BF16_STEPS]]
    for i, (card, control) in enumerate(readings):
        print(f"train step in bfloat16, card vs CPU, batch {i} of 4 x 2500 points: "
              f"{describe_bf16(card)}; control (the card's float32 step): "
              f"{describe_bf16(control)}", flush=True)
    ok, middle = bf16_steps_agree([r[0] for r in readings])
    control_ok, control_middle = bf16_steps_agree([r[1] for r in readings])
    print(f"train step in bfloat16, card vs CPU over {BF16_STEPS} batches: middle median "
          f"{middle:.3g}, control {control_middle:.3g}, limit {BF16_GRAD_MEDIAN}", flush=True)
    if not ok or control_ok:
        raise RuntimeError(f"train step in bfloat16: the card {'meets' if ok else 'misses'} "
                           f"the rule and the float32 control {'meets' if control_ok else 'misses'}"
                           f" it")
    return module, opt, criterion, batches[0]


def _checkpoint_resume(torch, build, Model):
    """Phase 7d: ``Model.train`` with ``checkpoint_every=1`` for
    TRAIN_EPOCHS, then a fresh model (seed 1) resuming with one more epoch;
    returns the launches of both runs."""
    from recognizer3d_tpu_torch.data.dataset import Dataset, DatasetMerged
    from recognizer3d_tpu_torch.train import CLASS_NAMES, app_augmentation, app_model_config
    from recognizer3d_tpu_torch.train import app_training_config
    from recognizer3d_tpu_torch.training import checkpoint as ckpt
    from recognizer3d_tpu_torch.utils import msgpack_lite

    if CKPT_RUN.exists():
        shutil.rmtree(CKPT_RUN)
    np.random.seed(0)
    train, val = DatasetMerged([Dataset(TRAIN_DIR, broaden_annotations=True)]).split()
    settings = app_training_config()
    settings.epochs, settings.checkpoint_every = TRAIN_EPOCHS, 1
    totals = {}

    def run(model, settings, callbacks=()):
        build.reset_launches()
        model.train(train, val, settings, app_augmentation(), CKPT_RUN, CLASS_NAMES,
                    callbacks=list(callbacks))
        torch.cuda.synchronize()
        for name, count in build.LAUNCHES.items():
            totals[name] = totals.get(name, 0) + count

    run(Model(app_model_config()), settings)
    ckpt_dir = CKPT_RUN / "checkpoints"
    latest = ckpt.latest_checkpoint(ckpt_dir)
    if latest != TRAIN_EPOCHS:
        raise RuntimeError(f"checkpoints: latest {latest}, expected {TRAIN_EPOCHS}")
    blob = (ckpt_dir / f"ckpt_{latest:05d}.msgpack").read_bytes()
    saved = msgpack_lite.msgpack_restore(blob)
    params = _flat_tree(saved["params"])
    layout = (sorted(saved) == ["batch_stats", "epoch", "opt_state", "params", "step"]
              and sorted(saved["opt_state"]) == ["count", "mu", "nu"]
              and all({k: v.shape for k, v in _flat_tree(saved["opt_state"][f]).items()}
                      == {k: v.shape for k, v in params.items()} for f in ("mu", "nu"))
              and saved["opt_state"]["count"].shape == () and saved["epoch"] == latest
              and int(saved["opt_state"]["count"]) == saved["step"] > 0
              and all(v.dtype == np.float32 for v in params.values()))
    if not layout:
        raise RuntimeError("checkpoints: the blob has not flax's layout of the JAX trainer's "
                           "state")

    restored, epochs_seen = {}, []
    load = ckpt.load_training_state

    def spy(state, module, optimizer):
        out = load(state, module, optimizer)
        restored["state"] = ckpt.training_state(module, optimizer, *out)
        return out

    ckpt.load_training_state = spy
    try:
        resume = app_training_config()
        resume.epochs, resume.checkpoint_every, resume.resume = TRAIN_EPOCHS + 1, 1, True
        run(Model(app_model_config(), seed=1), resume,
            [lambda epoch, metrics: epochs_seen.append(epoch)])
    finally:
        ckpt.load_training_state = load
    got, ref = _flat_tree(restored.get("state", {})), _flat_tree(saved)
    equal = sorted(got) == sorted(ref) and all(
        np.array_equal(np.asarray(got[k]), np.asarray(v)) for k, v in ref.items())
    if epochs_seen != [TRAIN_EPOCHS + 1] or not equal:
        raise RuntimeError(f"resume: epochs {epochs_seen}, expected [{TRAIN_EPOCHS + 1}]; "
                           f"restored state equal to the checkpoint: {equal}")
    after = ckpt.restore_checkpoint(ckpt_dir)
    print(f"checkpoints: {TRAIN_EPOCHS} epochs with checkpoint_every=1 under "
          f"{ckpt_dir.relative_to(ROOT)}: latest {latest}, blob of {len(blob)} bytes in flax's "
          f"layout (params, batch_stats, opt_state {{count, mu, nu}}, epoch, step {saved['step']}); "
          f"a seed-1 model with resume=True, epochs={TRAIN_EPOCHS + 1} ran epochs {epochs_seen} "
          f"from the restored state, equal to the checkpoint bit for bit ({len(ref)} leaves: "
          f"weights, running statistics, Adam's count, mu and nu, epoch, step); latest now "
          f"{ckpt.latest_checkpoint(ckpt_dir)} at step {after['step']}; launches {totals}",
          flush=True)
    return totals


def _f64_step_gaps(torch, label, many, one, grad_distance):
    """A float64 step over ranks (``many``: every rank's (loss, gradients,
    statistics, ms)) against the one-rank step ``one``: every rank's
    gradients equal rank 0's bit for bit, and rank 0's loss, gradients and
    running statistics within F64_LOSS_REL, F64_GRAD and F64_STATS."""
    loss, grads, stats = many[0][:3]
    for r, other in enumerate(many[1:], start=1):
        if not all(torch.equal(other[1][k], grads[k]) for k in grads):
            raise RuntimeError(f"{label}: rank {r}'s summed gradients differ from rank 0's")
    loss_err = abs(loss - one[0]) / abs(one[0])
    grad_err, _, at = grad_distance(grads, one[1])
    stats_err = max(float((stats[k] - v).abs().max()) / float(v.abs().max())
                    for k, v in one[2].items())
    if not math.isfinite(loss) or loss_err > F64_LOSS_REL or grad_err > F64_GRAD \
            or stats_err > F64_STATS:
        raise RuntimeError(f"{label}: in float64 against one rank: loss rel {loss_err:.3g}, "
                           f"gradients {grad_err:.3g} of max |g| at {at}, running statistics "
                           f"{stats_err:.3g}")
    return loss_err, grad_err, at, stats_err


def _dp_train_path(torch, build, Model, targets):
    """Phase 7e: data-parallel ``Model.train`` at the app config on 7b's
    dataset, DP_TRAIN_DEVICES (two ranks sharing the card) against one
    rank, and the step's checks. Returns the ranks' launches of the
    runs and of the timed steps, and rank 0's recorded kernel calls of one
    step for phase 8."""
    from recognizer3d_tpu_torch.benchmarks.train_precision import grad_distance
    from recognizer3d_tpu_torch.data.dataset import Dataset, DatasetMerged
    from recognizer3d_tpu_torch.parallel import mesh
    from recognizer3d_tpu_torch.train import (CLASS_NAMES, app_augmentation, app_model_config,
                                              app_training_config)
    from recognizer3d_tpu_torch.training import data_parallel

    t0 = time.perf_counter()
    train, val = DatasetMerged([Dataset(TRAIN_DIR, broaden_annotations=True)]).split()
    settings = app_model_config()
    totals = {}

    def add(launches):
        for name, count in launches.items():
            totals[name] = totals.get(name, 0) + count

    def run(train_set, epochs, pool):
        training = app_training_config()
        training.epochs = epochs
        model = Model(settings, device="cuda")  # seed 0
        np.random.seed(DP_TRAIN_SEED)
        if pool is not None:
            pool.run(build.reset_launches)
        build.reset_launches()
        t = time.perf_counter()
        trainer = model.train(train_set, val, training, app_augmentation(),
                              class_names=CLASS_NAMES, pool=pool)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        add(pool.run(mesh.launches)[1] if pool is not None else {})
        add(dict(build.LAUNCHES))
        return trainer, model, wall

    with mesh.RankPool(DP_TRAIN_DEVICES) as pool:
        t1 = time.perf_counter()
        runs = {n: run(train, TRAIN_EPOCHS, pool if n > 1 else None) for n in (2, 1)}
        for n, (trainer, _, wall) in runs.items():
            bad = [(h["epoch"], k) for h in trainer.history for k, v in h["metrics"].items()
                   if not math.isfinite(float(v))]
            losses = [x for h in trainer.history for x in h["step_losses"]]
            if bad or not all(math.isfinite(x) for x in losses):
                raise RuntimeError(f"dp-train at {n} ranks: not finite: {bad}, losses {losses}")
            print(f"dp-train: Model.train at {n} rank(s), {TRAIN_EPOCHS} epochs of "
                  f"{[h['steps'] for h in trainer.history]} steps, {wall:.3f} s; step losses "
                  f"{[round(x, 6) for x in losses]}; epoch train s "
                  f"{[round(h['train_s'], 3) for h in trainer.history]}, validate s "
                  f"{[round(h['validate_s'], 3) for h in trainer.history]}", flush=True)
        two, one = runs[2][0], runs[1][0]
        first2, first1 = two.history[0]["step_losses"][0], one.history[0]["step_losses"][0]
        if abs(first2 - first1) > 1e-5 * abs(first1):
            raise RuntimeError(f"dp-train: first-step loss {first2} at 2 ranks, {first1} at 1")
        if len(two.rank_digests) != 2 or len(set(two.rank_digests)) != 1:
            raise RuntimeError(f"dp-train: the ranks' parameters differ: {two.rank_digests}")
        print(f"dp-train: first-step loss {first2:.9f} at 2 ranks, {first1:.9f} at 1 (rel "
              f"{abs(first2 - first1) / abs(first1):.3g}); both ranks' parameters and "
              f"statistics bit-identical at the end (sha256 {two.rank_digests[0][:16]}); the "
              f"ragged remainder dropped at 2 ranks ({two.history[0]['steps']} steps an "
              f"epoch against {one.history[0]['steps']})", flush=True)

        # JAX's envelope after Adam's first step: DP_ENVELOPE_CLOUDS training
        # clouds, one epoch of one step
        sub = [train[i] for i in range(DP_ENVELOPE_CLOUDS)]
        params = {}
        for n in (2, 1):
            _, model, _ = run(sub, 1, pool if n > 1 else None)
            params[n] = {k: p.detach() for k, p in model.module.named_parameters()}
        diffs = torch.cat([(params[2][k] - params[1][k]).abs().flatten() for k in params[1]])
        q95, worst = float(diffs.quantile(0.95)), float(diffs.max())
        share = float((diffs > 1e-3).float().mean())
        lr = app_training_config().learning_rate
        if not (q95 < 1e-4 and worst < 2 * lr * 1.05 and share < 0.02):
            raise RuntimeError(f"dp-train: parameters after one step outside JAX's envelope: "
                               f"95% quantile {q95:.3g}, max {worst:.3g}, share beyond 1e-3 "
                               f"{share:.3g}")
        print(f"dp-train: parameters after one step ({DP_ENVELOPE_CLOUDS} clouds, batch 4) at 2 "
              f"ranks against 1: 95% quantile of |Δ| {q95:.3g} (< 1e-4), max {worst:.3g} (< "
              f"{2 * lr * 1.05:.3g}), share beyond 1e-3 {share:.3g} (< 0.02)", flush=True)

        # the trainer's step alone on the trained weights: launches, walls, float64
        trained = runs[2][1]
        cache_spec = ([train[i] for i in range(len(train))], settings.n_points,
                      app_augmentation())
        spec = data_parallel.payload(trained, "dice", seed=DP_TRAIN_SEED, cache_spec=cache_spec,
                                     batch_size=4)
        # rank 0 of both pools is this process: a key a pool
        with mesh.RankPool(DP_TRAIN_DEVICES[:1]) as single:
            for p in (pool, single):
                p.run(data_parallel.adopt, f"dp-time-{p.n_ranks}", spec)
            pool.run(build.reset_launches)
            with _Recorder(targets) as rec:
                pool.run(data_parallel.time_steps, "dp-time-2", 1)
            torch.cuda.synchronize()
            add(_rank_launches(pool, "dp-train step", PER_STEP_ASSEMBLED))
            for name, recorded in rec.calls.items():
                if len(recorded) != PER_STEP_ASSEMBLED.get(name, 0):
                    raise RuntimeError(f"dp-train step: rank 0 recorded {len(recorded)} calls of "
                                       f"{name}, expected {PER_STEP_ASSEMBLED.get(name, 0)}")
            walls = {2: [], 1: []}
            for p in (pool, single, single, pool):
                walls[p.n_ranks] += p.run(data_parallel.time_steps, f"dp-time-{p.n_ranks}",
                                          STEP_REPS // 2)[0]
            inputs, labels, perm, keep = (t.cpu() for t in _train_batches(torch, 1)[0])
            spec64 = data_parallel.payload(trained, "dice", dtype=torch.float64)
            for p in (pool, single):
                p.run(data_parallel.adopt, f"dp-64-{p.n_ranks}", spec64)
            many = pool.run(data_parallel.step, "dp-64-2", inputs, labels, perm, keep)
            ref = single.run(data_parallel.step, "dp-64-1", inputs, labels, perm, keep)[0]
            gaps = _f64_step_gaps(torch, "dp-train step", many, ref, grad_distance)
            for p in (pool, single):
                for key in ("dp-time", "dp-64"):
                    p.run(mesh.forget, f"{key}-{p.n_ranks}")
    print(f"dp-train step (batch 4 x 2500 points, 2 clouds a rank): each rank launched "
          f"{PER_STEP_ASSEMBLED} (its block of the batch assembled on the card); wall ms in "
          f"turns (2, 1, 1, 2 ranks, {STEP_REPS // 2} steps each, "
          f"synchronised): 2 ranks p50 {statistics.median(walls[2]):.3f} (min "
          f"{min(walls[2]):.3f}, max {max(walls[2]):.3f}), 1 rank p50 "
          f"{statistics.median(walls[1]):.3f} (min {min(walls[1]):.3f}, max "
          f"{max(walls[1]):.3f}); steps/s 2 ranks / 1 rank "
          f"{statistics.median(walls[1]) / statistics.median(walls[2]):.3f}", flush=True)
    print(f"dp-train step in float64 (geometry and search float32), 2 ranks against 1 from the "
          f"same weights, batch, permutation and mask: loss {ref[0]:.12f} (rel {gaps[0]:.3g}), "
          f"gradients within {gaps[1]:.3g} of each tensor's max |g| ({gaps[2]}), running "
          f"statistics within {gaps[3]:.3g}; both ranks' summed gradients equal; "
          f"{time.perf_counter() - t0:.1f} s (pool start {t1 - t0:.1f})", flush=True)
    return totals, rec.calls


def _sp_train_path(torch, build, Model, make_frame, targets):
    """Phase 7f: the point-sharded train step at settings64a's widths with
    knn="naive" on one SP_TRAIN_POINTS-point cloud, SP_TRAIN_DEVICES (four
    ranks on the card) against one rank; then 5h, the DP×SP grid's forward
    on the same pool. Returns the ranks' launches and rank 0's recorded
    kernel calls of one step for phase 8."""
    from recognizer3d_tpu_torch.benchmarks.train_precision import grad_distance
    from recognizer3d_tpu_torch.parallel import mesh
    from recognizer3d_tpu_torch.training import data_parallel

    t0 = time.perf_counter()
    model = Model.load(ARCHIVE, device="cuda", n_points=SP_TRAIN_POINTS, knn="naive")
    s = model.settings
    cloud, annotation = make_frame(np.random.RandomState(910), 0.3, SP_TRAIN_POINTS)
    rng = np.random.RandomState(911)
    perm = torch.from_numpy(rng.permutation(SP_TRAIN_POINTS))
    x = torch.from_numpy(np.ascontiguousarray(cloud[None], np.float32))
    y = torch.from_numpy(annotation[None].astype(np.int64))
    keep = torch.from_numpy(rng.rand(1, SP_TRAIN_POINTS, 32) < 0.5)
    permuted = (x[:, perm], y[:, perm], None, keep[:, perm])
    totals = {}
    with mesh.RankPool(SP_TRAIN_DEVICES) as pool, \
            mesh.RankPool(SP_TRAIN_DEVICES[:1]) as single:
        t1 = time.perf_counter()
        out = {}
        for dtype in (torch.float64, torch.float32):
            spec = data_parallel.payload(model, "dice", dtype=dtype)
            # rank 0 of both pools is this process: a key a pool
            for p in (pool, single):
                p.run(data_parallel.adopt, f"sp-step-{p.n_ranks}", spec)
            pool.run(build.reset_launches)
            rec = None
            if dtype == torch.float32:
                with _Recorder(targets) as rec:
                    out[dtype, 4] = pool.run(data_parallel.step, "sp-step-4", *permuted, axis=1)
                torch.cuda.synchronize()
            else:
                out[dtype, 4] = pool.run(data_parallel.step, "sp-step-4", *permuted, axis=1)
            for name, count in _rank_launches(pool, "sp-train step", PER_SP_STEP).items():
                totals[name] = totals.get(name, 0) + count
            out[dtype, 1] = single.run(data_parallel.step, "sp-step-1", x, y, perm, keep)
        for name, recorded in rec.calls.items():
            if len(recorded) != PER_SP_STEP.get(name, 0):
                raise RuntimeError(f"sp-train step: rank 0 recorded {len(recorded)} calls of "
                                   f"{name}, expected {PER_SP_STEP.get(name, 0)}")
        gaps = _f64_step_gaps(torch, "sp-train step", out[torch.float64, 4],
                              out[torch.float64, 1][0], grad_distance)
        l4, l1 = out[torch.float32, 4][0][0], out[torch.float32, 1][0][0]
        if not math.isfinite(l4) or abs(l4 - l1) > 1e-5 * abs(l1):
            raise RuntimeError(f"sp-train step in float32: loss {l4} at 4 ranks, {l1} at 1")
        walls = {4: [], 1: []}
        for p in (pool, single, single, pool):
            walls[p.n_ranks].append(p.run(data_parallel.step, f"sp-step-{p.n_ranks}",
                                          *(permuted if p is pool else (x, y, perm, keep)),
                                          axis=1 if p is pool else 0)[0][3])
        for p in (pool, single):
            p.run(mesh.forget, f"sp-step-{p.n_ranks}")
        print(f"sp-train: one {SP_TRAIN_POINTS}-point cloud, K {s.n_neighbors}, decimation "
              f"{s.decimation}, layers {s.layer_sizes}, knn={s.knn}, the bundled weights; 4 "
              f"ranks (each its block of the permuted cloud) against one rank's step: each rank "
              f"launched {PER_SP_STEP} a step; float64: loss {out[torch.float64, 1][0][0]:.12f} "
              f"(rel {gaps[0]:.3g}), gradients within {gaps[1]:.3g} of each tensor's max |g| "
              f"({gaps[2]}), running statistics within {gaps[3]:.3g}; float32: loss {l4:.9f} at "
              f"4 ranks, {l1:.9f} at 1 (rel {abs(l4 - l1) / abs(l1):.3g}); step wall ms "
              f"(forward, backward, gradient sum, Adam at lr 0; synchronised) 4 ranks "
              f"{[round(w, 3) for w in walls[4]]}, 1 rank {[round(w, 3) for w in walls[1]]}; "
              f"{time.perf_counter() - t0:.1f} s (pools {t1 - t0:.1f})", flush=True)
        for name, count in _grid_forward(torch, build, Model, make_frame, pool).items():
            totals[name] = totals.get(name, 0) + count
    return totals, rec.calls


def _grid_forward(torch, build, Model, make_frame, pool):
    """Phase 5h: the DP×SP grid's forward (``SPBackend(batch_shards=2)``
    through ``SPServing.confidences_permuted``) on the four ranks of
    ``pool`` as 2 rows of 2, GRID_CLOUDS seeded clouds of SP_TRAIN_POINTS
    points at the bundled weights (``knn="naive"``), the launch counts set
    to 0 on every rank before the timed call; the confidences against the
    one-rank forward on the card, within SP_ATOL + SP_RTOL·|ref|."""
    from recognizer3d_tpu_torch.parallel.serving import SPServing

    model = Model.load(ARCHIVE, device="cuda", n_points=SP_TRAIN_POINTS, knn="naive")
    clouds = np.stack([make_frame(np.random.RandomState(920 + i), 0.3 * i, SP_TRAIN_POINTS)[0]
                       for i in range(GRID_CLOUDS)])
    perm = np.random.RandomState(921).permutation(SP_TRAIN_POINTS)
    with SPServing(model, pool) as server:
        server.confidences_permuted(clouds[:, perm], batch_shards=GRID_ROWS)
        pool.run(build.reset_launches)
        t = time.perf_counter()
        conf_perm = server.confidences_permuted(clouds[:, perm], batch_shards=GRID_ROWS)
        wall = (time.perf_counter() - t) * 1e3
        totals = _rank_launches(pool, "dp-sp grid", PER_GRID_CALL)
    with torch.inference_mode():
        logits = model.module(torch.from_numpy(clouds).cuda(), torch.from_numpy(perm).cuda())
        ref = torch.softmax(logits, dim=-2)[..., torch.from_numpy(perm).cuda()].cpu().numpy()
    diff = np.abs(conf_perm - ref)
    limit = SP_ATOL + SP_RTOL * np.abs(ref)
    if conf_perm.shape != ref.shape or (diff > limit).any():
        raise RuntimeError(f"dp-sp grid: confidences {conf_perm.shape}, "
                           f"{int((diff > limit).sum())} beyond atol {SP_ATOL} rtol {SP_RTOL} "
                           f"of the one-rank forward (max abs err {diff.max()})")
    print(f"dp-sp grid: {GRID_CLOUDS} clouds of {SP_TRAIN_POINTS} points on {GRID_ROWS} rows of "
          f"{len(SP_TRAIN_DEVICES) // GRID_ROWS} ranks: each rank launched {PER_GRID_CALL}; "
          f"wall {wall:.3f} ms; against the one-rank forward on the card: confidences max abs "
          f"err {diff.max():.3g} (atol {SP_ATOL}, rtol {SP_RTOL})", flush=True)
    return totals


def _flat_tree(tree, prefix=""):
    out = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else key
        out.update(_flat_tree(value, path) if isinstance(value, dict) else {path: value})
    return out


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    from recognizer3d_tpu_torch import Model, Predictor
    from recognizer3d_tpu_torch.benchmarks import bench_roll_stages
    from recognizer3d_tpu_torch.utils import profiling
    from recognizer3d_tpu_torch.data import pipeline
    from recognizer3d_tpu_torch.data.preprocessing import consistent_sample_indices
    from recognizer3d_tpu_torch.models.live import LivePredictor
    from recognizer3d_tpu_torch.ops import _build, knn as port_knn
    from recognizer3d_tpu_torch.ops import knn_kernels, lfa_kernels, morton

    gpu = _gpu_line()
    print(f"gpu: {gpu}", flush=True)
    print(
        f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}",
        flush=True,
    )

    # seconds each phase took, printed as it ends
    marks = [time.perf_counter()]

    def phase_done(name):
        marks.append(time.perf_counter())
        print(f"phase {name}: {marks[-1] - marks[-2]:.1f} s", flush=True)

    # --- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    print(f"build: {time.perf_counter() - t0:.3f} s -> {lib_path}", flush=True)
    for line in _build.ptxas_report(PTXAS_KERNELS):
        print(f"ptxas: {line}", flush=True)
    hmma = _build.sass_counts(MMA_KERNELS, "HMMA")
    for kernel, count in hmma.items():
        print(f"sass: {kernel}: {count} HMMA", flush=True)
    if not hmma or not all(hmma.values()) or not all(
            any(n in k for k in hmma) for n in MMA_KERNELS):
        raise RuntimeError(f"bfloat16 LFA kernels without HMMA in their SASS: {hmma}")

    make_frame = _make_frame()
    frames = [
        make_frame(np.random.RandomState(100 + i), 0.45 * i, FRAME_POINTS)[0]
        for i in range(N_FRAMES)
    ]
    phase_done("2")

    # --- 3. the app path --------------------------------------------------------
    predictor = Predictor(ARCHIVE, warmup_points=FRAME_POINTS)
    _, _, launches = _drive(torch, _build, predictor, frames, PER_FRAME, "app path")
    model = _card_vs_cpu(Model, ARCHIVE, frames[1], "app path")
    del predictor
    phase_done("3")

    # --- 4. the approximate path at 64k points -------------------------------
    port_knn.reset_window_guard()
    derived = Model.load(ARCHIVE, device="cuda", **APPROX_SETTINGS)
    derived.save(APPROX_ARCHIVE)
    del derived
    frames64 = [
        make_frame(np.random.RandomState(300 + i), 0.45 * i, APPROX_FRAME_POINTS)[0]
        for i in range(N_FRAMES)
    ]
    t0 = time.perf_counter()
    predictor64 = Predictor(APPROX_ARCHIVE, warmup_points=APPROX_FRAME_POINTS)
    torch.cuda.synchronize()
    settings = predictor64.model.settings
    print(f"approx64k: Predictor of {APPROX_ARCHIVE.relative_to(ROOT)} (knn={settings.knn}, "
          f"n_points={settings.n_points}, K={settings.n_neighbors}, layers "
          f"{settings.layer_sizes}) ready in {time.perf_counter() - t0:.3f} s", flush=True)
    _probe_first_frame(torch, port_knn, predictor64, frames64[0], "approx64k")
    _, _, launches64 = _drive(torch, _build, predictor64, frames64, PER_FRAME_64K,
                              "approx64k")
    for name, count in launches64.items():
        launches[name] = launches.get(name, 0) + count
    window = port_knn.session_window_points()
    with torch.inference_mode():
        sample = frames64[0][consistent_sample_indices(APPROX_FRAME_POINTS, 65_536)]
        x = torch.tensor(sample[None], device="cuda")
        recall = float(port_knn.sampled_recall(
            x, x, 32, port_knn.knn_window(x, x, 32, window_points=window)
        ))
    print(f"approx64k: session window {window}, exact fallback "
          f"{port_knn.session_exact_fallback()}; sampled recall@32 of the window "
          f"search on frame 0: {recall:.4f}", flush=True)
    del predictor64
    model64 = _card_vs_cpu(Model, APPROX_ARCHIVE, frames64[1], "approx64k")
    phase_done("4")

    # --- 4b. the bfloat16 compute mode: app-bf16 and approx64k-bf16 ----------
    models_bf16 = {}
    for label, archive32, archive, settings, path_frames, per_frame in (
        ("app-bf16", ARCHIVE, BF16_ARCHIVE, {}, frames, PER_FRAME_BF16),
        ("approx64k-bf16", APPROX_ARCHIVE, APPROX_BF16_ARCHIVE, APPROX_SETTINGS, frames64,
         PER_FRAME_64K_BF16),
    ):
        port_knn.reset_window_guard()
        Model.load(ARCHIVE, device="cuda", compute_dtype="bfloat16", **settings).save(archive)
        predictor_bf = Predictor(archive, warmup_points=path_frames[0].shape[0])
        torch.cuda.synchronize()
        s_bf = predictor_bf.model.settings
        print(f"{label}: Predictor of {archive.relative_to(ROOT)} (compute_dtype="
              f"{s_bf.compute_dtype}, knn={s_bf.knn}, n_points={s_bf.n_points})", flush=True)
        if s_bf.knn == "approximate":
            _probe_first_frame(torch, port_knn, predictor_bf, path_frames[0], label)
        _, _, launches_bf = _drive(torch, _build, predictor_bf, path_frames, per_frame, label)
        for name, count in launches_bf.items():
            launches[name] = launches.get(name, 0) + count
        del predictor_bf
        models_bf16[label] = _bf16_card_vs_cpu(Model, archive32, archive, path_frames, label)
        _bf16_mask_iou(Model, archive32, archive, path_frames, label)
    phase_done("4b")

    # --- 5. the live depth path -----------------------------------------------
    port_knn.reset_window_guard()
    launches_live, live_frame = _live_path(
        torch, _build, Model, pipeline, LivePredictor, make_frame
    )
    for name, count in launches_live.items():
        launches[name] = launches.get(name, 0) + count
    phase_done("5")

    # --- 5b. the app entry point: cloud and depth branches ---------------------
    _write_app_dir(make_frame)
    for depth in (False, True):
        for name, count in _app_entry_point(torch, _build, Predictor, depth).items():
            launches[name] = launches.get(name, 0) + count
    phase_done("5b")

    # --- 5c. knn="kdtree" -------------------------------------------------------
    for name, count in _kdtree_path(torch, _build, Model, Predictor, frames).items():
        launches[name] = launches.get(name, 0) + count
    phase_done("5c")

    # --- 5d. batch serving (BASELINE.json config 2) ---------------------------
    captures = _write_serve_dir(make_frame)
    for name, count in _serve_path(torch, _build, captures).items():
        launches[name] = launches.get(name, 0) + count
    phase_done("5d")

    # --- 5e. the large-scene forward (BASELINE.json config 5) -----------------
    # (the approximate route's session window stays for phase 8: no phase
    # between runs the guard)
    large = {}
    for approach in ("naive", "approximate"):
        model_l, cloud_l, totals = _large_path(torch, _build, Model, port_knn, approach)
        large[approach] = (model_l, cloud_l)
        for name, count in totals.items():
            launches[name] = launches.get(name, 0) + count
        _large_card_vs_cpu(torch, Model, port_knn, approach)
    phase_done("5e")

    # --- 5f. data-parallel serving: two ranks on the card ----------------------
    for name, count in _dp_serve_path(torch, Model, captures).items():
        launches[name] = launches.get(name, 0) + count
    phase_done("5f")

    # --- 5g. point-sharded serving of the 1M cloud: four ranks on the card -----
    # (the wrappers phase 8 records the main paths' kernel calls through)
    targets = [
        (port_knn, "knn_topk", "knn_topk"),
        (port_knn, "argmin_1nn", "argmin_1nn"),
        (port_knn, "knn_window_topk", "knn_window_topk"),
        (lfa_kernels, "lfa_round1", "lfa_round1"),
        (lfa_kernels, "attentive_pool2_residual", "lfa_pool2_res"),
        (pipeline, "select_smallest", "select_smallest"),
    ]
    totals, calls_sp = _sp_serve_path(torch, Model, captures, targets)
    for name, count in totals.items():
        launches[name] = launches.get(name, 0) + count
    phase_done("5g")

    # --- 6. B7's entry point ------------------------------------------------
    _build.reset_launches()
    rows = bench_roll_stages.table()
    launches["roll_stages"] = _build.LAUNCHES["roll_stages"]
    if dict(_build.LAUNCHES) != {"roll_stages": ROLL_TABLE_LAUNCHES}:
        raise RuntimeError(f"bench_roll_stages: launches {dict(_build.LAUNCHES)}, expected "
                           f"{ROLL_TABLE_LAUNCHES} of roll_stages")
    for stages, total_ms, per_block, per_stage in rows:
        print(f"bench_roll_stages {ROLL_SHAPE}: stages={stages:3d}  total {total_ms:.4f} ms  "
              f"per-block {per_block:.4f} us  marginal/stage {per_stage:.4f} us", flush=True)
    phase_done("6")

    # --- 7. a reference torch archive -----------------------------------------
    _torch_archive(torch, Model, model, frames[1])
    phase_done("7")

    # --- 7b. the train path ----------------------------------------------------
    trained, launches_train, val_batch = _train_path(torch, _build, Model, make_frame)
    for name, count in launches_train.items():
        launches[name] = launches.get(name, 0) + count
    step_module, step_opt, step_criterion, step_batch = _train_step_checks(
        torch, _build, Model, trained, val_batch
    )
    del trained
    phase_done("7b")

    # --- 7c. the bfloat16 train path ----------------------------------------------
    trained, launches_train, val_batch_bf16 = _train_path(torch, _build, Model, make_frame,
                                                          "bfloat16")
    for name, count in launches_train.items():
        launches[name] = launches.get(name, 0) + count
    bf16_module, bf16_opt, _, bf16_batch = _train_bf16_step_checks(
        torch, _build, Model, trained, val_batch_bf16
    )
    del trained
    phase_done("7c")

    # --- 7d. checkpoints and resume ---------------------------------------------
    for name, count in _checkpoint_resume(torch, _build, Model).items():
        launches[name] = launches.get(name, 0) + count
    phase_done("7d")

    # --- 7e. data-parallel training: two ranks on the card ---------------------
    totals, calls_dp_train = _dp_train_path(torch, _build, Model, targets)
    for name, count in totals.items():
        launches[name] = launches.get(name, 0) + count
    phase_done("7e")

    # --- 7f, 5h. the point-sharded train step, the DP×SP grid: four ranks -------
    totals, calls_sp_train = _sp_train_path(torch, _build, Model, make_frame, targets)
    for name, count in totals.items():
        launches[name] = launches.get(name, 0) + count
    phase_done("7f, 5h")

    # --- 8. each kernel against its plain version ---------------------------
    # (after the paths: profiler sessions slow the launches that follow)
    # one call of each large path (the approximate route at the window its
    # guard settled on in 5e), held last; then the guard back at its default
    # for approx64k, whose guard settled there
    calls_large = {}
    for approach, label in (("naive", "large-exact"), ("approximate", "large-approx")):
        if port_knn.session_window_points() != LARGE_WINDOW:
            raise RuntimeError(f"{label}: session window {port_knn.session_window_points()}, "
                               f"expected {LARGE_WINDOW}")
        model_l, cloud_l = large.pop(approach)
        calls_large[label] = _record_frame(
            lambda: model_l.predict(cloud_l, prepostprocess=False), targets,
            PER_CALL_LARGE[approach], label)
        del model_l, cloud_l
    port_knn.reset_window_guard()
    calls = _record_frame(lambda: model.predict(frames[0]), targets, PER_FRAME, "app path")
    calls64 = _record_frame(lambda: model64.predict(frames64[0]), targets, PER_FRAME_64K,
                            "approx64k")
    calls_live = _record_frame(live_frame, targets, PER_FRAME_LIVE, "live")
    # the bfloat16 paths' LFA calls (their KNN kernels get the float32
    # paths' inputs: the geometry stays float32)
    targets_bf16 = [(lfa_kernels, "lfa_round1", "lfa_round1_bf16"),
                    (lfa_kernels, "attentive_pool2_residual", "lfa_pool2_res_bf16")]
    calls_bf16 = {
        label: _record_frame(lambda: models_bf16[label].predict(path_frames[0]), targets_bf16,
                             per_frame, label)
        for label, path_frames, per_frame in (("app-bf16", frames, PER_FRAME_BF16),
                                              ("approx64k-bf16", frames64, PER_FRAME_64K_BF16))
    }
    del models_bf16
    from recognizer3d_tpu_torch.training.trainer import train_step

    with _Recorder(targets) as rec:  # a train step needs autograd: no inference_mode
        train_step(step_module, step_opt, step_criterion, *step_batch)
    torch.cuda.synchronize()
    calls_train = rec.calls
    if any(len(v) != PER_STEP.get(k, 0) for k, v in calls_train.items()):
        raise RuntimeError(f"train step: recorded {[(k, len(v)) for k, v in calls_train.items()]}"
                           f", expected {PER_STEP}")
    step_module.eval()
    calls_val = _record_frame(lambda: step_module(*val_batch), targets, PER_VAL_FORWARD,
                              "train validation")
    del step_module, step_opt
    # the same for the bfloat16 train path: B1 on its float32 geometry, the
    # validation forward's bfloat16 LFA forms
    with _Recorder(targets) as rec:
        train_step(bf16_module, bf16_opt, step_criterion, *bf16_batch)
    torch.cuda.synchronize()
    calls_train_bf16 = rec.calls
    if any(len(v) != PER_STEP.get(k, 0) for k, v in calls_train_bf16.items()):
        raise RuntimeError(f"bf16 train step: recorded "
                           f"{[(k, len(v)) for k, v in calls_train_bf16.items()]}, expected "
                           f"{PER_STEP}")
    bf16_module.eval()
    calls_val_bf16 = _record_frame(lambda: bf16_module(*val_batch_bf16),
                                   targets[:1] + targets_bf16, PER_VAL_FORWARD_BF16,
                                   "train-bf16 validation")
    del bf16_module, bf16_opt

    # the gaussian probe bench.py reports, at the tuned default window
    port_knn.reset_window_guard()
    with torch.inference_mode():
        x64 = torch.tensor(
            np.random.RandomState(0).randn(1, 65536, 3).astype(np.float32) * 0.2,
            device="cuda",
        )
        probe = port_knn.measure_recall(x64, x64, 32, "approximate")
    print(f"gaussian probe 0.2*randn(65536, 3), seed 0: sampled recall@32 of "
          f"knn=\"approximate\" at window {port_knn.session_window_points()}: "
          f"{probe:.4f}", flush=True)

    results = _Results()
    with torch.inference_mode():
        print(f"launch floor: a one-element fill_ {profiling.launch_floor_ms():.4f} ms of device "
              f"time", flush=True)
        _check_kernels(torch, calls, results, "app path", plain_reps=10)
        _check_kernels(torch, calls64, results, "approx64k", plain_reps=3)
        _check_kernels(torch, calls_live, results, "live", plain_reps=10)
        _check_kernels(torch, calls_train, results, "train step", plain_reps=10)
        _check_kernels(torch, calls_val, results, "train validation", plain_reps=10)
        _check_kernels(torch, calls_train_bf16, results, "train-bf16 step", plain_reps=10)
        _check_kernels(torch, calls_val_bf16, results, "train-bf16 validation", plain_reps=10)
        _check_kernels(torch, calls_bf16["app-bf16"], results, "app-bf16", plain_reps=10)
        _check_kernels(torch, calls_bf16["approx64k-bf16"], results, "approx64k-bf16",
                       plain_reps=3)
        _check_roll_stages(torch, results)
        _check_selection(torch, pipeline, pipeline.cloud_to_depth(
            make_frame(np.random.RandomState(500), 0.0, FRAME_POINTS)[0],
            pipeline.DepthIntrinsics(),
        ))
        _exact_64k(torch, morton, knn_kernels, sample)
        # the large paths' calls (their records hold GB each)
        level0 = [s_ for (s_, q_, _), _ in calls_large["large-exact"]["knn_topk"]
                  if s_.shape[1] == q_.shape[1] == LARGE_POINTS][0]
        for label, calls_l in calls_large.items():
            t = time.perf_counter()
            _check_kernels(torch, calls_l, results, label, plain_reps=1)
            calls_large[label] = None
            print(f"{label}: kernels held on one call in {time.perf_counter() - t:.1f} s",
                  flush=True)
        del calls_l
        _exact_1m(torch, knn_kernels, level0)
        # rank 0's calls of 5g's recorded call; the level-0 ring step at
        # step 1 (the block of rank 3 visiting) again, sorted and not
        t = time.perf_counter()
        _check_kernels(torch, calls_sp, results, "sp-1M rank 0", plain_reps=1,
                       sorted_bound=True)
        print(f"sp-1M rank 0: kernels held on one call in {time.perf_counter() - t:.1f} s",
              flush=True)
        (support, query, _), _ = calls_sp["knn_topk"][1]
        _sp_ring_step(torch, knn_kernels, support, query)
        del calls_sp, support, query
        # rank 0's calls of one data-parallel step and of one point-sharded
        # train step (the backward searches nothing: no call of its own)
        _check_kernels(torch, calls_dp_train, results, "dp-train step rank 0", plain_reps=10)
        t = time.perf_counter()
        _check_kernels(torch, calls_sp_train, results, "sp-train step rank 0", plain_reps=3,
                       sorted_bound=True)
        print(f"sp-train step rank 0: kernels held on one step in "
              f"{time.perf_counter() - t:.1f} s", flush=True)
        del calls_dp_train, calls_sp_train
    del calls, calls64, calls_live, calls_train, calls_val, calls_bf16
    del calls_train_bf16, calls_val_bf16
    phase_done("8")

    # --- 9. result lines ------------------------------------------------------
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        r = results.rows[name]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": launches.get(name, 0),
            "max_abs_err": r["max_abs_err"],
            "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": "bytes" if r["t_bytes"] >= r["t_ops"] else "operations",
            "library_ms": r["library_ms"],
            **({"note": r["note"]} if "note" in r else {}),
        })
    print(f"gpu: {gpu}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)


if __name__ == "__main__":
    main()
