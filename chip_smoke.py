"""Smoke run of the PyTorch port (`mydetection_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each; any failure exits non-zero and prints no result:

  1. device   the card (nvidia-smi name, power limit), torch and CUDA;
  2. build    nvcc for every kernel source, all started at once;
  3. kernel   the CUDA NMS keep-mask bit-equal to its plain version on
              B=32, K=1024 hard cases (duplicates, tied scores, pairs
              within 1 ulp of iou_thres, an all-padding image, mixed
              classes through the float32 class offset), and on such
              cases at K=2048 (B=32) and at OLD_LARGEST_NMS_K (B=6),
              where the bitmask goes through a global scratch;
  4. gn       the CUDA bias+GroupNorm+ReLU against its plain version at
              the five FCOS@608 level shapes at B=32, a ragged 5x7 at
              B=3 and a 19x19 image its cluster does not split evenly
              (GN_EDGE_SHAPES), float32 and bf16, channels_last, inputs
              with a non-zero mean; two runs bit for bit;
  5. gn_train the forward-with-statistics kernel (y, mean, inv) and the
              fused backward kernel (dx, dbias, dscale, dshift) against
              their plain versions at the five FCOS@608 level shapes at
              B=16, the ragged 5x7 at B=3 and GN_EDGE_SHAPES, float32
              and bf16, with a live ReLU mask and once with an NCHW dy;
              each kernel twice, bit for bit;
  6. rotated  the CUDA rotated-NMS suppress kernel bit-equal to its plain
              version on B=32, K=512 IoU matrices (rotated person boxes
              with jittered duplicates, entries at iou_thres and one ulp
              around it, a deliberately asymmetric matrix, an
              all-padding image, fewer valid rows than 64), and on such
              matrices at K=2048 (banded) and OLD_LARGEST_ROTATED_K
              (B=12);
  7. tower    the CUDA conv chain (L = 4 x [3x3 conv + bias + ReLU])
              against its plain version at the five RetinaNet@608 level
              shapes at B=32, C=256, and a ragged 9x13 at B=2, C=64,
              float32 (TF32 off) and bf16, inputs with a non-zero mean
              and 0.1 N(0, 1) weights; two runs bit for bit; in bf16
              also against the kernel-order reference at L = 4 and,
              element by element, at L = 1;
  8. bottleneck the CUDA fused stride-1 bottleneck against its plain
              version at the six routed ResNet@608 block shapes at B=32
              (stage 0: 64->256 with the projection, 256->256; stage 1:
              512->512) and ragged 9x13 maps at B=2 with and without a
              projection, float32 (TF32 off) and bf16, inputs with a
              non-zero mean and BN statistics drawn as the TPU script
              draws them; two runs bit for bit;
  9. gather   the CUDA row gather bit-equal to its plain version on
              (32, 69354, 80) bf16 and f32 sources with K=1024 indices
              sorted with duplicates, in top-k order and all equal, and
              on C=7 rows that break 16-byte alignment;
 10. parity   Detector("yolov3", 416), Detector("yolov3_608", 608) (the
              golden image letterboxed), Detector("fcos", 320),
              Detector("rapid", 320), Detector("retinanet", 320) and
              Detector("retinanet_r101", 320), float32 with TF32 off, on
              the card against the same seeded weights on the CPU, on
              procedural canvases (for the RetinaNets a canvas of
              noise);
 11. parity bf16  fcos, retinanet and retinanet_r101 at 320 in bf16 on
              the card against bf16 on the CPU, on the same canvases,
              matched one to one and tie-aware (`match_bf16`); then the
              matched share with each kernel of the path (#3 GN, #6
              chain, #7 bottleneck) routed to its plain version in turn
              (`plain_kernel`) and with all of them, and each kernel's
              bf16 output on its inputs from that run against a float32
              computation beside its plain version's (a kernel further
              from float32 than its plain version by more than the plain
              version's own distance fails the phase);
 12. train parity  fcos, yolov3, rapid and retinanet at 64², batch 2,
              4 classes (rapid 1, with cxcywhθ GT), float32 with TF32
              off: `make_train_step` on the card against the CPU from
              the same seeded weights and batch (the first step's loss
              terms, gradients, update and BN statistics within the CPU
              tests' gates, the launch counts: fcos's GN kernels 40
              each, no kernel on the others), and the loss falling over
              four steps;
 13. main     each detect main path once — yolov3-416, yolov3_608-608,
              fcos-608, rapid-1024, retinanet-608, retinanet_r101-608 — bf16
              `detect_prepared` on 32 canvases, with every kernel launch
              count reset just before and read just after; then the
              batch's latency, img/s and device time; each kernel
              replayed on the path's own inputs for its row (the conv
              epilogue's on yolov3 and fcos, every call bit-equal to
              its plain version);
 13b. quant main  each int8 main path — yolov3-416, rapid-1024,
              fcos-608, retinanet-608, retinanet_r101-608 —
              `Detector(quantized=True)` calibrated on 8 of the canvases,
              bf16 `detect_prepared` on 32 canvases with every launch
              count reset just before and read just after (QUANT_MAINS:
              fcos's towers launch the GN kernel 40 times at float32; no
              conv chain, no fused bottleneck); the int8 img/s beside the
              float bf16 Detector's in the same run, both forwards'
              device ms, the int8 convs' share (im2col + `_int_mm`), the
              largest im2col, peak memory, the calibration's seconds;
 14. train main  fcos-608 at full width and depth, bf16, batch 16,
              `make_train_step` with `burn_in_lr` on a synthetic batch:
              2 warm-up and 5 timed steps, each with its launch counts
              reset before and read after; the step's latency, img/s,
              device time split into host (the batch to the card),
              forward, backward and optimizer, peak memory; then both
              trainable GN kernels replayed on the step's own inputs;
              then the same for yolov3-416, retinanet-608 and
              rapid-1024 at batch 16 (TRAIN_MAINS), whose steps launch
              no kernel;
 15. data     a synthetic COCO set in a temporary directory
              (`write_coco_set`: 96 JPEGs, quality 90, 320-800 x 240-640,
              1-6 filled rectangles on noise in categories 1, 3, 7, and a
              rotated copy of the annotations); the decoder
              `StreamingPipeline` picks (the port's native library, else
              its build error and PIL: a host choice, reported, not
              gated), the native first batch within 2 LSB (mean < 0.5)
              of the PIL path's; the pipeline's img/s alone (416, batch
              32, 4 threads, to the card) and `TrainLoader`'s (batch 16,
              320/416/512, augmented; epoch 0 twice, bit for bit);
 16. evaluate `mydetection_tpu_torch.evaluate.main` in process, bf16:
              yolov3-416, fcos-608, retinanet-608 at batch 32 and
              rapid-1024 `--rotated` at batch 16, twice each, every
              launch count reset before and read after (EVAL_MAINS, per
              batch times the batches), every stat finite; the CLI's
              img/s and the evaluator's scoring seconds; then yolov3-416
              float32 with TF32 off on 16 images, the card against
              `--device cpu` from one seeded .npz: rows matched one to
              one (`match_detections`), stats within EVAL_AP_GATE;
 16b. evaluate int8  the four paths `--quantized --calib-images 8` once
              each (EVAL_QUANT_MAINS), launch counts per batch (fcos
              also the calibration walk's 40), every stat finite;
 17. train cli `mydetection_tpu_torch.train.main` in process: yolov3 at
              the default buckets (320, 416, 512), batch 16, 40
              iterations, checkpoints at 20 and 40, validation at 40 (its
              NMS launch the only launch), finite rows, falling loss, a
              TensorBoard file, both checkpoints loaded into a Detector,
              a resume to 50; fcos-608 for 6 iterations, the trainable GN
              kernels 40 times a step each; each run's img/s beside the
              synthetic-batch train main line of its model.

 18. export   yolov3-416 (buckets 1 and 32), fcos-608, rapid-1024,
              retinanet-608 and the int8 yolov3-416 (batch 32) exported
              in bf16 on the card (`export.export_detector`: torch.export
              programs that call the kernels as `mydet::` custom ops),
              then loaded in a fresh process whose `registry.get_model`
              raises (`export_child`): each path's batch-32 outputs bit
              for bit the live Detector's, its launch counts the live
              path's (EXPORT_MAINS); the exported and live img/s timed
              in turn in one process (the artifact loaded there too);
 19. serve    the HTTP daemon (`serve.DetectionServer`) on 64 of phase
              15's JPEGs from 8 client threads: the yolov3-416 artifact
              (`from_artifact`, buckets 1 and 32) and a live rapid-1024
              Detector (`from_detector`, buckets 1, 8, 32); float32 with
              TF32 off, conv kernels x EVAL_F32_SCALE: every response
              matched one to one (`match_rows`) to the backend run at
              the batch shape the server gave it, within 1e-3 px, and
              to `detect_one` on the same bytes, within 3e-3 px; fewer
              batches than requests; then bf16:
              requests/s, p50 and p99 latency, batches by size;
 20. tools    `summary` of yolov3-416 (65.86 GFLOPs an image, darknet's
              figure, within 0.1%, and the CPU's count), fcos-608's FLOP
              count with the kernels equal to use_pallas=False's, a
              `trace()` of one batch, yolov3-416's `forward_dense`
              under the profiler beside its CUDA-event time, the demo
              CLI on 8 JPEGs, a
              data-parallel Detector on the one card equal to the plain
              one;
 21. train dp the data-parallel fcos-608 train step, batch 16, over two
              replicas on one card (one a card where there are more;
              `mesh.local_devices` patched, `dp_devices`), 8 images
              each: in float32 with TF32 off its first step against the
              one-device step from the same weights and batch (loss
              terms, gradients, update under the TRAIN_* gates, BN
              running statistics within TRAIN_DP_BN_GATE), the replicas
              bit-equal after it; in bf16 the trainable GN kernels 40
              times each a replica, the first step's distance from the
              one-device step (reported: bf16 roundings flip with the
              order of the BN sums), both steps' ms and img/s timed in
              turn, a cross-replica sum's host µs; then `train
              --data-parallel` on phase 15's files, which must say it
              runs over the replicas, launch the GN kernels 40 times a
              replica a step, and write a checkpoint that a second run
              resumes.

Then one JSON line with a row per kernel, the card's name and power
limit, and the result line `{"ok": true, "device": {...}}`. Needs no
network and runs in about eight minutes, the kernels' build included.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

IOU_THRES = 0.45
BATCH = 32
PRE_NMS = 1024
ROT_PRE_NMS = 512   # rapid's registered pre_nms
# the largest K the one-block-an-image NMS kernels took (21 bytes a box in
# shared memory; a K x ceil(K/32) word mask), which their cluster
# redesign must still take
OLD_LARGEST_NMS_K, OLD_LARGEST_ROTATED_K = 10971, 1348
OPS_PER_IOU = 12    # min/max x4, sub x2, clamp x2, mul, add, sub, div
# one Liang-Barsky rotated IoU, counted from ops/rotated.py: midpoint and
# shifts 8, pair-dependent corners 32, two edge-clip passes of ~430 each
# (per corner: frame 9, slab clips 32, clamps 8, endpoints 8, face test
# 28, back-rotation 16, cross 4), areas, union and divide ~11
OPS_PER_ROTATED_IOU = 915
# bias add, sum, square, sum; subtract mean, x inv, x scale, + shift, max
OPS_PER_GN_ELEMENT = 9
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, published
BF16_OPS_PER_S = 989e12     # H100 SXM dense bf16 tensor cores, published
SLEEP_CYCLES = 200_000_000  # ~0.1 s at the H100's 1.98 GHz SM clock
FP32_OPS_PER_S = 67e12      # H100 SXM fp32 outside the tensor cores
GN_GROUPS = 32
GN_F32_GATE = 1e-5          # max |kernel - plain| in float32
GN_NEAR_ZERO = 1e-5         # bf16: one ulp of the output, plus this
# (B, H, W) beside the FCOS levels: an image its cluster does not split
# evenly (kernels/gn.py::gn_plan)
GN_EDGE_SHAPES = [(1, 19, 19)]
# backward: xhat 3, the mask 1, dxhat 1, the two group sums 3, dx 4, the
# three channel sums 4 (counting each element's work once)
OPS_PER_GN_BWD_ELEMENT = 16
TRAIN_BATCH = 16            # the fcos-608 train main path
# the other train main paths, (name, input size, batch): the JAX
# trainer's default run (train.py: yolov3, batch 16) and retinanet-608
# at the same batch; rapid-1024 at batch 16 when its step fits the card
TRAIN_MAINS = (("yolov3", 416, 16), ("retinanet", 608, 16),
               ("rapid", 1024, 16))
TRAIN_WARMUP, TRAIN_TIMED = 2, 5
# the small train step held CUDA against CPU (and, in the CPU tests,
# the port against JAX): fcos at 64², batch 2, 4 classes, float32
PARITY_SIZE, PARITY_BATCH, PARITY_CLASSES, PARITY_LR = 64, 2, 4, 1e-3
# its gates; tests/test_torch_port_train.py's docstring has the
# measurements behind them
TRAIN_LOSS_RTOL = 5e-5      # each loss term, relative
TRAIN_HEAD_OUT_GATE = 3e-4  # max-scaled gradient of the convs next to the loss
TRAIN_COSINE_GATE = 0.995   # every parameter's gradient and update
TRAIN_L2_GATE = 0.1         # relative L2 over all parameters
TRAIN_BN_GATE = 1e-3        # max-scaled BN running statistics
HEAD_OUT = ("head.cls_out", "head.box_out", "head.ctr_out", "head.scales")
# the same small step for yolov3, rapid (1 class, cxcywhθ GT) and
# retinanet, under the same gates: each family's floor lies below them
# (tests/test_torch_port_train_<family>.py's docstrings); the gradients
# held max-scaled are those of each family's output convs
TRAIN_FAMILIES = ("fcos", "yolov3", "rapid", "retinanet")
_DARKNET_OUT = ("head.head5.out", "head.head4.out", "head.head3.out")
TRAIN_HEAD_OUT = {"fcos": HEAD_OUT, "yolov3": _DARKNET_OUT,
                  "rapid": _DARKNET_OUT,
                  "retinanet": ("head.cls.out", "head.box.out")}
TOWER_LAYERS = 4
# the conv chain against its plain version, max-scaled: the gates of
# the Pallas chain against the pure-jax loop (tests/test_retinanet.py).
# float32: the sums reassociate; bf16: the kernel rounds once per layer
# after the bias, the plain version (XLA's order) the conv before it
TOWER_F32_GATE = 2e-5
TOWER_BF16_GATE = 0.05
# the bf16 kernel against conv3x3_chain_reference (its own order of
# rounding; the f32 sums only reorder): at L = 1 every element within
# one bf16 ulp plus TOWER_REF_FLOOR of the max |value|; at L = 4,
# max-scaled, where a flipped rounding in one layer moves the next
# layers (PERF.md §2: the measurement behind the gate)
TOWER_REF_FLOOR = 1e-5
TOWER_REF_L4_GATE = 2e-2
GATHER_N, GATHER_C = 69354, 80  # RetinaNet-608's anchors and classes
# the fused bottleneck against its plain version, max-scaled: float32
# the tower's 2e-5 (the sums reassociate); bf16 0.02: the plain version
# rounds where the kernel rounds (each conv's result once, after its
# float32 bias), so only the order of the float32 sums differs and a
# rounding that flips in y1 or y2 moves the next conv; measured 0.00592
# and 0.00521 (PERF.md §2), the JAX test's 0.05 stays on the CPU
BOTTLENECK_F32_GATE = 2e-5
BOTTLENECK_BF16_GATE = 0.02
# (B, H, W, c_in, c_out): the routed blocks at 608, batch 32 — stage 0's
# block 0 (projection) and blocks 1-2, stage 1's blocks 1-3 — ragged maps
# with and without a projection, and for the persistent bf16 kernel and
# TMA's zero fill: one tile, a 1 x 1 map, fewer tiles than SMs at c_mid
# 128, a width that is not a multiple of the tile
BOTTLENECK_SHAPES = [(BATCH, 152, 152, 64, 256), (BATCH, 152, 152, 256, 256),
                     (BATCH, 76, 76, 512, 512), (2, 9, 13, 64, 256),
                     (2, 9, 13, 256, 256), (2, 9, 13, 512, 512),
                     (1, 8, 16, 256, 256), (1, 1, 1, 512, 512),
                     (1, 9, 13, 512, 512), (3, 17, 5, 256, 256)]
# the CUDA-vs-CPU detect parity gates (the goldens')
PARITY_SCORE_GATE, PARITY_BOX_GATE = 1e-4, 1e-2
# the bf16 card-vs-CPU detect check: a card detection matches a CPU one
# of its class within BF16_SCORE_TOL and BF16_BOX_TOL px (one to one,
# tie-aware); at least BF16_MIN_MATCHED of the larger count must match.
# Measured on an H100 (PERF.md §2): fcos 0.93, retinanet 0.81,
# retinanet_r101 0.99 matched, matched pairs' score deltas at most
# 4.77e-4; each gate is its measurement less a margin of 0.10
BF16_SCORE_TOL, BF16_BOX_TOL = 5e-3, 2.0
BF16_MIN_MATCHED = {"fcos": 0.83, "retinanet": 0.71, "retinanet_r101": 0.89}
# the synthetic COCO set of the data, evaluate and train cli phases:
# DATA_IMAGES JPEGs (quality 90, 320-800 x 240-640) of 1-6 filled
# rectangles on noise, in non-contiguous categories; the rotated copy's
# boxes at DATA_ANGLE degrees (tests/test_scripts.py's rotated sets)
DATA_IMAGES = 96
DATA_CATEGORIES = (1, 3, 7)
DATA_ANGLE = 20.0
# the native decoder against the PIL path (tests/test_native.py's gates)
NATIVE_MAX_LSB, NATIVE_MEAN_LSB = 2, 0.5
# the evaluate CLI's paths, bf16 at its default batch (rapid at 16):
# (name, input size, batch, rotated, kernel launches per batch)
EVAL_MAINS = (
    ("yolov3", 416, 32, False, {"nms_keep": 1, "conv_epilogue": 75}),
    ("fcos", 608, 32, False, {"bias_gn_relu": 40, "fused_bottleneck": 6,
                              "gather_rows": 1, "nms_keep": 1,
                              "conv_epilogue": 34}),
    ("retinanet", 608, 32, False, {"conv3x3_chain": 10, "fused_bottleneck": 6,
                                   "gather_rows": 1, "nms_keep": 1,
                                   "conv_epilogue": 34}),
    ("rapid", 1024, 16, True, {"nms_from_iou_keep": 1, "conv_epilogue": 75}),
)
# the evaluate CLI's int8 runs (`--quantized --calib-images
# EVAL_CALIB_IMAGES`, one calibration batch, whose walk launches the GN
# kernel 40 times on fcos and runs the float prologue once): (name,
# input size, batch, rotated, kernel launches per batch; the float
# prologue's conv epilogues: Darknet's stem to stage 1's downsample, 5,
# ResNet's stem, 1)
EVAL_QUANT_MAINS = (
    ("yolov3", 416, 32, False, {"nms_keep": 1, "conv_epilogue": 5}),
    ("fcos", 608, 32, False, {"bias_gn_relu": 40, "gather_rows": 1,
                              "nms_keep": 1, "conv_epilogue": 1}),
    ("retinanet", 608, 32, False, {"gather_rows": 1, "nms_keep": 1,
                                   "conv_epilogue": 1}),
    ("rapid", 1024, 16, True, {"nms_from_iou_keep": 1, "conv_epilogue": 5}),
)
EVAL_CALIB_IMAGES = 8
EVAL_F32_IMAGES = 16        # the float32 card-vs-CPU evaluate check
EVAL_AP_GATE = 1e-3         # its stats, absolute
EVAL_F32_SCALE = 0.7        # its weights: the seeded init's conv kernels x 0.7
# and its threshold: 8-17 rows an image, none at max_dets (100), where
# near-tied scores at the cut could swap rows between the two devices
EVAL_F32_CONF = 0.55
# the train CLI on files: yolov3 at the default buckets, then fcos-608;
# the burn-in of tests/test_torch_port_overfit.py's runs. Its lr, 2e-3,
# diverged here (yolov3 total 481, 3536, 18068, then NaN at iterations
# 10-40 on an H100): the darknet objectness loss sums over every cell,
# so at 320-512 a step is 25-64 times what it is at that test's 64².
# 2e-3 x (64/416)² is 5e-5; at 128² on the CPU (float32, batch 4) 1e-4
# fell steadily where 5e-4 and 2e-3 bounced, which is 1e-5 at 416
TRAIN_CLI_LR, TRAIN_CLI_BURN_IN = 1e-5, 10
# the int8 serving path's main runs (Detector(quantized=True)), bf16 at
# BATCH: (name, input size, conf, kernel launches of one detect); no
# int8 path launches the conv chain or the fused bottleneck; the float
# prologue launches the conv epilogue (Darknet 5, ResNet's stem 1)
QUANT_MAINS = (
    ("yolov3", 416, 0.25, {"nms_keep": 1, "conv_epilogue": 5}),
    ("rapid", 1024, 0.3, {"nms_from_iou_keep": 1, "conv_epilogue": 5}),
    ("fcos", 608, 0.005, {"nms_keep": 1, "bias_gn_relu": 40,
                          "gather_rows": 1, "conv_epilogue": 1}),
    ("retinanet", 608, 0.005, {"nms_keep": 1, "gather_rows": 1,
                               "conv_epilogue": 1}),
    ("retinanet_r101", 608, 0.005, {"nms_keep": 1, "gather_rows": 1,
                                    "conv_epilogue": 1}),
)
QUANT_CALIB_IMAGES = 8      # main_canvases' first, letterboxed: one batch
TRAIN_CLI_ITERS, TRAIN_CLI_RESUMED, TRAIN_CLI_FCOS_ITERS = 40, 50, 6
# the data-parallel train phase: the BN running statistics of its step
# against the one-device step's, max-scaled; the timed steps of each;
# the CLI's iterations before and after its resume
TRAIN_DP_BN_GATE = 1e-5
TRAIN_DP_SIZE, TRAIN_DP_TIMED = 608, 4
TRAIN_DP_CLI_ITERS, TRAIN_DP_CLI_RESUMED = 3, 5
# the exported paths, bf16 on the card: (label, model, input size, batch
# buckets, conf, int8, kernel launches of one batch-32 detect: the live
# path's, as phases 13 and 13b count them)
EXPORT_MAINS = (
    ("yolov3", "yolov3", 416, (1, BATCH), 0.25, False,
     {"nms_keep": 1, "conv_epilogue": 75}),
    ("fcos", "fcos", 608, (BATCH,), 0.005, False,
     {"nms_keep": 1, "bias_gn_relu": 40, "gather_rows": 1,
      "fused_bottleneck": 6, "conv_epilogue": 34}),
    ("rapid", "rapid", 1024, (BATCH,), 0.3, False,
     {"nms_from_iou_keep": 1, "conv_epilogue": 75}),
    ("retinanet", "retinanet", 608, (BATCH,), 0.005, False,
     {"nms_keep": 1, "conv3x3_chain": 10, "gather_rows": 1,
      "fused_bottleneck": 6, "conv_epilogue": 34}),
    ("yolov3_int8", "yolov3", 416, (BATCH,), 0.25, True,
     {"nms_keep": 1, "conv_epilogue": 5}),
)
EXPORT_TIMED = 30           # batches timed a path, live and exported in turn
EXPORT_CHILD_TIMEOUT = 600  # seconds for the fresh process of phase 18
# the serving daemon: phase 15's first JPEGs from client threads, the
# live backend's batch buckets, how long a request waits for batch-mates
SERVE_REQUESTS, SERVE_CLIENTS = 64, 8
SERVE_BUCKETS = (1, 8, BATCH)
SERVE_SIZES = {"yolov3": 416, "rapid": 1024}
SERVE_WAIT_MS = 10.0
# float32 responses, TF32 off, against the backend run at the batch
# shape the server gave each request (the request's canvas in a batch of
# its bucket): the same cuDNN algorithm, so the JSON's 4-decimal
# rounding is the whole difference; within 1e-3 px and 1e-4
SERVE_SCORE_GATE, SERVE_BOX_GATE = 1e-4, 1e-3
# and against `detect_one` (a batch of 1), whose convs may take another
# algorithm and sum in another order: on an H100 80GB HBM3 yolov3's
# rows read up to 1.4e-3 px apart at batch 32 against 1, so 3e-3 px,
# plus 1e-6 of a number's magnitude (a float32 ulp is 0.06 at rapid's
# seeded widths of up to 1e6 px)
SERVE_ONE_BOX_GATE, SERVE_ONE_BOX_RTOL = 3e-3, 1e-6
SERVE_RAPID_F32_CONF = 0.3
DARKNET_YOLOV3_416_GFLOPS = 65.86   # darknet's yolov3.cfg at 416: 65.86 BFLOPs
DEMO_IMAGES = 8


# ---------------------------------------------------------------------------
# inputs (numpy; the CPU tests use the same generators)
# ---------------------------------------------------------------------------

def golden_image() -> np.ndarray:
    """Deterministic 300x400 structured RGB image (no RNG, no PIL)."""
    h, w = 300, 400
    y = np.arange(h)[:, None]
    x = np.arange(w)[None, :]
    r = (x * 255 // w).astype(np.uint8)
    g = (y * 255 // h).astype(np.uint8)
    b = ((x + y) % 256).astype(np.uint8)
    img = np.stack([r + 0 * y, 0 * x + g, b], -1).astype(np.uint8)
    img[60:180, 50:150] = (220, 40, 40)     # solid rectangle
    img[100:250, 220:360] = (40, 200, 80)   # second rectangle
    return img


def padded_canvas(img: np.ndarray, size: int, x0: int, y0: int):
    """Place `img` on a gray size² canvas at (x0, y0), ratio 1: a
    letterbox without a resize. Returns (canvas, LetterboxInfo)."""
    from mydetection_tpu_torch.utils.image_ops import PAD_VALUE, LetterboxInfo

    h, w = img.shape[:2]
    canvas = np.full((size, size, 3), PAD_VALUE, np.uint8)
    canvas[y0:y0 + h, x0:x0 + w] = img
    return canvas, LetterboxInfo(ori_w=w, ori_h=h, ratio=1.0,
                                 pad_x=float(x0), pad_y=float(y0),
                                 input_size=size)


def write_coco_set(root: str, n: int = DATA_IMAGES, seed: int = 0
                   ) -> tuple[str, str]:
    """A synthetic COCO set in `root`, from `np.random.RandomState(seed)`:
    n JPEGs (quality 90) of 320-800 x 240-640 noise with 1-6 filled
    rectangles each, their boxes the annotations in DATA_CATEGORIES;
    and a rotated copy of the annotations, [cx, cy, w, h, DATA_ANGLE].
    Returns the two annotation files' paths."""
    from PIL import Image

    rng = np.random.RandomState(seed)
    images, anns = [], []
    for i in range(n):
        w, h = int(rng.randint(320, 801)), int(rng.randint(240, 641))
        img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        for _ in range(int(rng.randint(1, 7))):
            bw, bh = int(rng.randint(16, w // 2)), int(rng.randint(16, h // 2))
            x, y = int(rng.randint(0, w - bw)), int(rng.randint(0, h - bh))
            img[y:y + bh, x:x + bw] = rng.randint(0, 256, 3)
            anns.append({"id": len(anns), "image_id": i,
                         "category_id": int(rng.choice(DATA_CATEGORIES)),
                         "bbox": [float(x), float(y), float(bw), float(bh)],
                         "area": float(bw * bh), "iscrowd": 0})
        name = f"img{i:03d}.jpg"
        Image.fromarray(img).save(os.path.join(root, name), quality=90)
        images.append({"id": i, "file_name": name, "width": w, "height": h})
    gt = {"images": images, "annotations": anns,
          "categories": [{"id": c, "name": f"c{c}"} for c in DATA_CATEGORIES]}
    rot = json.loads(json.dumps(gt))
    for a in rot["annotations"]:
        x, y, bw, bh = a["bbox"]
        a["bbox"] = [x + bw / 2, y + bh / 2, bw, bh, DATA_ANGLE]
    paths = (os.path.join(root, "ann.json"), os.path.join(root, "rot_ann.json"))
    for path, tree in zip(paths, (gt, rot)):
        with open(path, "w") as fh:
            json.dump(tree, fh)
    return paths


def _iou32(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Float32 IoU of matched xyxy rows, in the kernel's order."""
    iw = np.maximum(np.minimum(a[:, 2], b[:, 2]) - np.maximum(a[:, 0], b[:, 0]),
                    np.float32(0))
    ih = np.maximum(np.minimum(a[:, 3], b[:, 3]) - np.maximum(a[:, 1], b[:, 1]),
                    np.float32(0))
    inter = iw * ih
    area_a = (np.maximum(a[:, 2] - a[:, 0], np.float32(0))
              * np.maximum(a[:, 3] - a[:, 1], np.float32(0)))
    area_b = (np.maximum(b[:, 2] - b[:, 0], np.float32(0))
              * np.maximum(b[:, 3] - b[:, 1], np.float32(0)))
    return inter / np.maximum((area_a + area_b) - inter, np.float32(1e-9))


def near_threshold_pairs(rng, n: int, thr: float, cls: np.ndarray
                         ) -> np.ndarray:
    """(n, 2, 4) float32 xyxy box pairs, already shifted by their class
    offset `cls * 8192`, whose float32 IoU is thr or one ulp from it."""
    thr32 = np.float32(thr)
    lo = np.nextafter(thr32, np.float32(-1))
    hi = np.nextafter(thr32, np.float32(2))
    found: list[np.ndarray] = []
    offsets = (cls.astype(np.float32) * np.float32(8192.0))
    while sum(len(f) for f in found) < n:
        m = 200_000
        off = offsets[rng.randint(0, len(offsets), m)][:, None]
        wh = rng.uniform(20, 120, (m, 2))
        xy = rng.uniform(0, 300, (m, 2))
        d = wh[:, 0] * (1 - thr) / (1 + thr) * (1 + rng.uniform(-1e-6, 1e-6, m))
        a = (np.concatenate([xy, xy + wh], 1).astype(np.float32) + off)
        b = a.copy()
        shift = d.astype(np.float32)
        b[:, 0] += shift
        b[:, 2] += shift
        iou = _iou32(a, b)
        hit = (iou >= lo) & (iou <= hi)
        found.append(np.stack([a[hit], b[hit]], 1))
    return np.concatenate(found)[:n]


def nms_cases(rng, b: int, k: int, thr: float = IOU_THRES):
    """Hard keep-mask inputs: boxes (b, k, 4) float32 in score order and
    already class-offset, valid (b, k) bool. Image i is of kind i % 6:
    random boxes with holes in `valid`; exact duplicates; tied-score runs
    (duplicates of one box in a row); pairs within 1 ulp of `thr`; all
    padding; mixed classes through the float32 offset."""
    boxes = np.zeros((b, k, 4), np.float32)
    valid = np.zeros((b, k), bool)

    def rand_boxes(n, spread=416.0):
        c = rng.uniform(0, spread, (n, 2))
        wh = rng.uniform(4, 120, (n, 2))
        return np.concatenate([c - wh / 2, c + wh / 2], 1).astype(np.float32)

    for i in range(b):
        kind = i % 6
        if kind == 0:
            boxes[i] = rand_boxes(k)
            valid[i] = rng.uniform(size=k) < 0.9
        elif kind == 1:
            base = rand_boxes(k)
            src = rng.randint(0, k, k)
            dup = rng.uniform(size=k) < 0.4
            boxes[i] = np.where(dup[:, None], base[np.minimum(src, np.arange(k))],
                                base)
            valid[i, :rng.randint(k // 2, k + 1)] = True
        elif kind == 2:
            base = rand_boxes(-(-k // 8))
            boxes[i] = np.repeat(base, 8, axis=0)[:k]
            valid[i] = True
        elif kind == 3:
            pairs = near_threshold_pairs(rng, -(-k // 2), thr,
                                         rng.randint(0, 80, 64))
            boxes[i] = pairs.reshape(-1, 4)[:k]
            valid[i] = True
        elif kind == 4:
            boxes[i] = rand_boxes(k)
        else:
            cls = rng.randint(0, 80, k).astype(np.float32)
            boxes[i] = rand_boxes(k) + (cls * np.float32(8192.0))[:, None]
            valid[i, :rng.randint(1, k + 1)] = True
    return boxes, valid


def person_boxes(rng, n: int, canvas: float = 1024.0) -> np.ndarray:
    """(n, 5) float32 rotated person-sized boxes (cx, cy, w, h, θ) in a
    canvas² image, about a third of them jittered duplicates of others."""
    c = rng.uniform(0, canvas, (n, 2))
    wh = np.stack([rng.uniform(20, 80, n), rng.uniform(40, 200, n)], 1)
    th = rng.uniform(-np.pi / 2, np.pi / 2, n)
    boxes = np.concatenate([c, wh, th[:, None]], 1)
    dup = rng.uniform(size=n) < 0.35
    src = rng.randint(0, n, n)
    jitter = rng.normal(0, 1, (n, 5)) * [3, 3, 4, 4, 0.05]
    boxes = np.where(dup[:, None], boxes[np.minimum(src, np.arange(n))] + jitter,
                     boxes)
    return boxes.astype(np.float32)


def rotated_cases(rng, b: int, k: int, thr: float = IOU_THRES,
                  device: str = "cpu"):
    """Hard suppress-kernel inputs: iou (b, k, k) float32 on `device`
    from the port's `pairwise_rotated_iou`, rows in score order, and
    valid (b, k) bool. Image i is of kind i % 6: person boxes with
    jittered duplicates; the same with a padding tail; a fifth of the
    upper-triangle entries set to thr or one ulp from it; a deliberately
    asymmetric matrix (the lower triangle replaced by noise, so a kernel
    that reads iou[later, earlier] disagrees); all padding; fewer valid
    rows than 64."""
    from mydetection_tpu_torch.ops.rotated import pairwise_rotated_iou

    boxes = torch.from_numpy(np.stack([person_boxes(rng, k)
                                       for _ in range(b)])).to(device)
    # an image at a time: the eager IoU holds ~830 bytes a pair at its peak
    iou = torch.cat([pairwise_rotated_iou(x[None], x[None])
                     for x in boxes]).contiguous()
    valid = np.ones((b, k), bool)
    thr32 = np.float32(thr)
    near = np.array([np.nextafter(thr32, np.float32(-1)), thr32,
                     np.nextafter(thr32, np.float32(2))], np.float32)
    upper = np.triu(np.ones((k, k), bool), 1)
    for i in range(b):
        kind = i % 6
        if kind == 1:
            valid[i, rng.randint(k // 4, k):] = False
        elif kind == 2:
            hit = upper & (rng.uniform(size=(k, k)) < 0.2)
            m = iou[i].cpu().numpy()
            m[hit] = near[rng.randint(0, 3, int(hit.sum()))]
            iou[i] = torch.from_numpy(m).to(device)
        elif kind == 3:
            m = iou[i].cpu().numpy()
            noise = rng.uniform(0, 1, (k, k)).astype(np.float32)
            m = np.where(upper, m, noise)
            iou[i] = torch.from_numpy(m).to(device)
        elif kind == 4:
            valid[i] = False
        elif kind == 5:
            valid[i] = False
            valid[i, :rng.randint(1, 64)] = True
    return iou, torch.from_numpy(valid).to(device)


def train_batch(seed: int, b: int, size: int, num_classes: int,
                max_gt: int = 100, max_boxes: int = 20,
                rotated: bool = False):
    """A synthetic training batch: uint8 (b, size, size, 3) noise
    canvases and 1 to max_boxes GT boxes an image, (cx, cy, w, h) in net
    pixels (sides size/32 to size/2, centres anywhere on the canvas),
    with `rotated` a fifth column θ in radians, uniform in (−π/2, π/2);
    classes in [0, num_classes), padded to max_gt with zeros and
    gt_valid False, as the JAX package's TrainLoader pads them."""
    rng = np.random.RandomState(seed)
    images = rng.randint(0, 256, (b, size, size, 3)).astype(np.uint8)
    boxes = np.zeros((b, max_gt, 5 if rotated else 4), np.float32)
    classes = np.zeros((b, max_gt), np.int32)
    valid = np.zeros((b, max_gt), bool)
    for i in range(b):
        k = rng.randint(1, max_boxes + 1)
        c = rng.uniform(0, size, (k, 2))
        wh = rng.uniform(size / 32, size / 2, (k, 2))
        boxes[i, :k, :4] = np.concatenate([c, wh], 1)
        classes[i, :k] = rng.randint(0, num_classes, k)
        valid[i, :k] = True
        if rotated:
            boxes[i, :k, 4] = rng.uniform(-np.pi / 2, np.pi / 2, k)
    return images, boxes, classes, valid


# ---------------------------------------------------------------------------
# measurement helpers
# ---------------------------------------------------------------------------

def cuda_ms(fn, iters: int = 20) -> float:
    """Mean device time of `fn()` over `iters` runs, by CUDA events. A
    sleep kernel ahead of the start event keeps the card busy while the
    host enqueues the runs, so short kernels are timed back to back and
    not at the pace of the host's launches."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def greedy_pairs(iou: torch.Tensor, valid: torch.Tensor,
                 keep: torch.Tensor) -> int:
    """The (kept i, later j) entries greedy must consult on these
    inputs: each valid box against the kept boxes before it, up to its
    first suppressor."""
    k = iou.shape[-1]
    kept = keep.long()
    rank = torch.cumsum(kept, dim=1)                       # kept at <= i
    sup = ((iou > np.float32(IOU_THRES)) & keep[:, :, None]
           & torch.ones(k, k, dtype=torch.bool, device=iou.device).triu(1))
    has_sup = sup.any(dim=1)                               # (B, K) over j
    first = sup.to(torch.uint8).argmax(dim=1)              # first suppressor
    tested = torch.where(has_sup, torch.gather(rank, 1, first), rank - kept)
    return int((tested * valid.long()).sum())


def nms_bound_ms(boxes: torch.Tensor, valid: torch.Tensor,
                 keep: torch.Tensor) -> tuple[float, str]:
    """Least time for the keep-mask of these inputs: bytes (boxes and
    valid read once, keep written once) over HBM rate, against the IoUs
    greedy needs here (`greedy_pairs`) over the fp32 rate."""
    from mydetection_tpu_torch.ops.boxes import pairwise_iou

    b, k, _ = boxes.shape
    nbytes = boxes.numel() * 4 + valid.numel() + keep.numel()
    pairs = greedy_pairs(pairwise_iou(boxes, boxes), valid, keep)
    ops = pairs * OPS_PER_IOU + 3 * b * k                  # + the areas
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def nms_dense_ms(valid: torch.Tensor) -> float:
    """Every upper-triangle IoU of the valid rows (and their areas) over
    the fp32 rate, in ms: what a kernel that does not skip pairs greedy
    never consults would compute."""
    n = valid.long().sum(dim=1)
    ops = int((n * (n - 1) // 2).sum()) * OPS_PER_IOU + 3 * int(n.sum())
    return ops / FP32_OPS_PER_S * 1e3


def rotated_nms_bound_ms(iou: torch.Tensor, valid: torch.Tensor,
                         keep: torch.Tensor) -> tuple[float, str, float]:
    """Least time for the suppress of these inputs: the IoU entries
    greedy needs here (`greedy_pairs`, 4 bytes and one compare each),
    valid read and keep written once, over HBM rate, against the
    compares over the fp32 rate. Also returns the dense figure, every
    entry of the (B, K, K) matrix read once, in ms."""
    pairs = greedy_pairs(iou, valid, keep)
    nbytes = pairs * 4 + valid.numel() + keep.numel()
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = pairs / FP32_OPS_PER_S * 1e3
    dense = (iou.numel() * 4 + valid.numel() + keep.numel()) / HBM_BYTES_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            dense)


def rotated_iou_bound_ms(boxes: torch.Tensor) -> tuple[float, str]:
    """Least time for the (B, K, K) rotated-IoU matrix of boxes (B, K,
    5): the boxes read once and the matrix written once over HBM rate,
    against OPS_PER_ROTATED_IOU float32 operations a pair over the fp32
    rate."""
    b, k, _ = boxes.shape
    t_bytes = (boxes.numel() * 4 + b * k * k * 4) / HBM_BYTES_PER_S * 1e3
    t_ops = b * k * k * OPS_PER_ROTATED_IOU / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def gn_bound_ms(calls, *, stats: bool = False,
                backward: bool = False) -> tuple[float, str]:
    """Least time for these GN calls: bytes over HBM rate against
    float32 operations over the fp32 rate. Forward (args x, bias, scale,
    shift): x read once, the output written once, the three (C,)
    parameters read once, with `stats` the (B, G) mean and inv written
    once; OPS_PER_GN_ELEMENT an element. Backward (args x, y, dy, bias,
    scale, mean, inv): x, y, dy read once, dx written once, bias, scale,
    mean, inv read and the three (C,) gradients written once;
    OPS_PER_GN_BWD_ELEMENT an element."""
    nbytes = ops = 0
    for args in calls:
        x, c = args[0], args[0].shape[1]
        group_stats = 2 * x.shape[0] * GN_GROUPS * 4
        if backward:
            nbytes += 4 * x.numel() * x.element_size() + 5 * c * 4 + group_stats
            ops += OPS_PER_GN_BWD_ELEMENT * x.numel()
        else:
            nbytes += (2 * x.numel() * x.element_size() + 3 * c * 4
                       + (group_stats if stats else 0))
            ops += OPS_PER_GN_ELEMENT * x.numel()
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def within_bf16_ulp(got: torch.Tensor, ref: torch.Tensor, floor: float
                    ) -> bool:
    """Every |got - ref| within one bf16 ulp of the larger of the two
    values plus `floor`."""
    g, r = got.float(), ref.float()
    big = torch.maximum(g.abs(), r.abs())
    ulp = (big.view(torch.int32) & 0x7F800000).view(torch.float32) * 2.0 ** -7
    return bool(((g - r).abs() <= ulp + floor).all())


def gn_error(got: torch.Tensor, ref: torch.Tensor) -> tuple[float, bool]:
    """(max |got - ref|, within the gate). float32: GN_F32_GATE — the
    two sum in other orders, so the statistics differ by a few float32
    ulps. bf16: one bf16 ulp of the larger of the two values plus
    GN_NEAR_ZERO, since float32 results a few ulps apart round to
    neighbouring bf16 values, and to 0 and a tiny positive value where
    the ReLU cuts."""
    d = float((got.float() - ref.float()).abs().max())
    if got.dtype == torch.float32:
        return d, d <= GN_F32_GATE
    return d, within_bf16_ulp(got, ref, GN_NEAR_ZERO)


def smi_line(fields: str = "name,power.limit") -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_kernel(rng) -> None:
    from mydetection_tpu_torch.kernels.nms import nms_keep, nms_keep_plain, plan_for

    for b, k in ((BATCH, PRE_NMS), (BATCH, 2048), (6, OLD_LARGEST_NMS_K)):
        boxes_np, valid_np = nms_cases(rng, b, k)
        boxes = torch.from_numpy(boxes_np).cuda()
        valid = torch.from_numpy(valid_np).cuda()
        keep = nms_keep(boxes, valid, IOU_THRES)
        plain = nms_keep_plain(boxes, valid, IOU_THRES)
        torch.cuda.synchronize()
        diff = int((keep != plain).sum())
        if diff:
            bad = sorted({int(i) for i in (keep != plain).nonzero()[:, 0]})
            raise AssertionError(f"kernel keep-mask differs from the plain "
                                 f"version in {diff} entries at B={b} K={k} "
                                 f"(images {bad})")
        if keep[4].any() or not keep.any():
            raise AssertionError("all-padding image kept a box, or none kept")
        print(f"kernel: nms_keep bit-equal to plain on B={b} K={k} hard "
              f"cases ({int(keep.sum())} kept of {int(valid.sum())} valid; "
              f"{plan_text(plan_for(valid))}); kernel "
              f"{cuda_ms(lambda: nms_keep(boxes, valid, IOU_THRES)):.4f} ms, "
              f"plain {cuda_ms(lambda: nms_keep_plain(boxes, valid, IOU_THRES), 1):.3f} ms",
              flush=True)


def plan_text(plan) -> str:
    """A greedy-NMS launch plan (`kernels.nms.NMSPlan`) in words."""
    where = ("on chip" if plan.on_chip
             else f"banded, {plan.stages} ring stages")
    return f"cluster {plan.cluster}, {plan.rows} rows a block, {where}"


def plan_dict(plan) -> dict:
    return {"cluster": plan.cluster, "rows_a_block": plan.rows,
            "on_chip": plan.on_chip, "stages": plan.stages}


def gn_case(gen, b: int, h: int, w: int, dtype, c: int = 256):
    """A bias_gn_relu call's inputs on the card: x (b, c, h, w) in
    channels_last with mean 2 and unit spread, bias N(0, 0.5), scale
    1 + N(0, 0.2), shift N(0, 0.5)."""
    kw = dict(device="cuda", generator=gen)
    x = (torch.randn(b, c, h, w, **kw) + 2.0).to(dtype).contiguous(
        memory_format=torch.channels_last)
    return (x, torch.randn(c, **kw) * 0.5, 1.0 + torch.randn(c, **kw) * 0.2,
            torch.randn(c, **kw) * 0.5)


def phase_gn() -> None:
    from mydetection_tpu_torch.kernels.gn import bias_gn_relu, bias_gn_relu_plain
    from mydetection_tpu_torch.models.fcos import level_shapes

    gen = torch.Generator(device="cuda").manual_seed(0)
    shapes = ([(BATCH, h, w) for h, w in level_shapes(608)] + [(3, 5, 7)]
              + GN_EDGE_SHAPES)
    report = []
    for dtype in (torch.float32, torch.bfloat16):
        worst = 0.0
        for b, h, w in shapes:
            args = gn_case(gen, b, h, w, dtype)
            got = bias_gn_relu(*args, groups=GN_GROUPS)
            again = bias_gn_relu(*args, groups=GN_GROUPS)
            ref = bias_gn_relu_plain(*args, groups=GN_GROUPS)
            torch.cuda.synchronize()
            err, ok = gn_error(got, ref)
            if not ok or not got.is_contiguous(
                    memory_format=torch.channels_last) \
                    or not torch.equal(got, again):
                raise AssertionError(f"bias_gn_relu {dtype} at {(b, h, w)}: "
                                     f"max |d| {err:.3g} outside its gate, "
                                     f"the output left channels_last, or two "
                                     f"runs differ")
            worst = max(worst, err)
        report.append(f"{str(dtype)[6:]} max |d| {worst:.3g}")
    print(f"gn: bias_gn_relu within its gates of plain and bit-reproducible "
          f"at {[s for s in shapes]} x 256 ch, {GN_GROUPS} groups "
          f"(f32 gate {GN_F32_GATE}, bf16 gate 1 ulp + {GN_NEAR_ZERO}): "
          f"{', '.join(report)}", flush=True)


def max_scaled(got, ref) -> float:
    """max |got - ref| over max |ref|, for tensors or numpy arrays."""
    g, r = torch.as_tensor(got).double(), torch.as_tensor(ref).double()
    return float((g - r).abs().max() / (r.abs().max() + 1e-30))


def gn_train_error(got: torch.Tensor, ref: torch.Tensor) -> tuple[float, bool]:
    """(max-scaled |got - ref|, within the gate) for the trainable GN's
    outputs. float32: GN_F32_GATE of the reference's max |value| — the
    kernel and the plain version sum in other orders. bf16 (dx): one
    bf16 ulp of the larger value plus GN_F32_GATE of the max |value|,
    where float32 results a few ulps apart round to neighbouring bf16
    values."""
    err = max_scaled(got, ref)
    if got.dtype == torch.float32:
        return err, err <= GN_F32_GATE
    return err, within_bf16_ulp(got, ref,
                                GN_F32_GATE * float(ref.float().abs().max()))


def gn_train_case(gen, b: int, h: int, w: int, dtype, channels_last_dy=True):
    """A backward call's inputs on the card: gn_case's x, bias, scale and
    shift, the forward-with-statistics kernel's y, mean and inv (a live
    ReLU mask), and dy N(0, 1) in channels_last, or contiguous NCHW."""
    from mydetection_tpu_torch.kernels.gn import bias_gn_relu_fwd_stats

    x, bias, scale, shift = gn_case(gen, b, h, w, dtype)
    y, mean, inv = bias_gn_relu_fwd_stats(x, bias, scale, shift,
                                          groups=GN_GROUPS)
    dy = torch.randn(x.shape, device="cuda", generator=gen).to(dtype)
    if channels_last_dy:
        dy = dy.contiguous(memory_format=torch.channels_last)
    return (x, bias, scale, shift), (x, y, dy, bias, scale, mean, inv)


def check_gn_train_case(fwd_args, bwd_args) -> tuple[float, float]:
    """#4 and #5 against their plain versions on one case, and each
    twice bit for bit; returns the worst (forward, backward) error."""
    from mydetection_tpu_torch.kernels.gn import (
        bias_gn_relu_bwd,
        bias_gn_relu_bwd_plain,
        bias_gn_relu_fwd_stats,
        bias_gn_relu_fwd_stats_plain,
    )

    shape = tuple(fwd_args[0].shape)
    got = bias_gn_relu_fwd_stats(*fwd_args, groups=GN_GROUPS)
    again = bias_gn_relu_fwd_stats(*fwd_args, groups=GN_GROUPS)
    ref = bias_gn_relu_fwd_stats_plain(*fwd_args, groups=GN_GROUPS)
    torch.cuda.synchronize()
    y_err, y_ok = gn_error(got[0], ref[0])
    errs = [max_scaled(a, b) for a, b in zip(got[1:], ref[1:])]
    if not y_ok or max(errs) > GN_F32_GATE or not got[0].is_contiguous(
            memory_format=torch.channels_last) \
            or not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"bias_gn_relu_fwd_stats {got[0].dtype} at "
                             f"{shape}: y max |d| {y_err:.3g}, mean/inv "
                             f"max-scaled {errs} outside their gates, y "
                             f"left channels_last, or two runs differ")
    fwd = max([y_err] + errs)
    got = bias_gn_relu_bwd(*bwd_args, groups=GN_GROUPS)
    again = bias_gn_relu_bwd(*bwd_args, groups=GN_GROUPS)
    ref = bias_gn_relu_bwd_plain(*bwd_args, groups=GN_GROUPS)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"bias_gn_relu_bwd at {shape} is not "
                             f"bit-reproducible across two runs")
    bwd = 0.0
    for name, a, b in zip(("dx", "dbias", "dscale", "dshift"), got, ref):
        err, ok = gn_train_error(a, b)
        if not ok or a.dtype != b.dtype:
            raise AssertionError(f"bias_gn_relu_bwd {a.dtype} at {shape}: "
                                 f"{name} max-scaled |d| {err:.3g} outside "
                                 f"its gate")
        bwd = max(bwd, err)
    if not got[0].is_contiguous(memory_format=torch.channels_last):
        raise AssertionError("bias_gn_relu_bwd's dx left channels_last")
    return fwd, bwd


def phase_gn_train() -> None:
    from mydetection_tpu_torch.models.fcos import level_shapes

    gen = torch.Generator(device="cuda").manual_seed(1)
    shapes = ([(TRAIN_BATCH, h, w) for h, w in level_shapes(608)]
              + [(3, 5, 7)] + GN_EDGE_SHAPES)
    report = []
    for dtype in (torch.float32, torch.bfloat16):
        worst = [0.0, 0.0]
        for b, h, w in shapes:
            errs = check_gn_train_case(*gn_train_case(gen, b, h, w, dtype))
            worst = [max(a, e) for a, e in zip(worst, errs)]
        errs = check_gn_train_case(*gn_train_case(gen, *shapes[1], dtype,
                                                  channels_last_dy=False))
        worst = [max(a, e) for a, e in zip(worst, errs)]
        report.append(f"{str(dtype)[6:]} fwd {worst[0]:.3g}, bwd {worst[1]:.3g}")
    print(f"gn_train: bias_gn_relu_fwd_stats (y, mean, inv) and "
          f"bias_gn_relu_bwd (dx, dbias, dscale, dshift) within their gates "
          f"of plain at {shapes} x 256 ch, {GN_GROUPS} groups, live ReLU "
          f"masks, one NCHW dy per dtype; both bit-reproducible over two "
          f"runs: {', '.join(report)}", flush=True)


def cosine(a, b) -> float:
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-300))


def rel_l2(got: dict, ref: dict) -> float:
    """Relative L2 distance over every entry of two name → array dicts."""
    num = sum(float(((np.asarray(got[k], np.float64) - ref[k]) ** 2).sum())
              for k in ref)
    den = sum(float((np.asarray(ref[k], np.float64) ** 2).sum()) for k in ref)
    return (num / den) ** 0.5


def compare_train_step(got: dict, ref: dict, family: str) -> str:
    """One train step against a reference run from the same weights and
    batch, each a dict of "terms" (floats), "grads", "delta" (the
    parameters' update) and "bufs" (BN running statistics), name → numpy.
    The gates are the TRAIN_* constants, the max-scaled one on the
    family's output convs (TRAIN_HEAD_OUT). Returns the report, raises
    outside a gate."""
    bad = []
    terms = {k: abs(got["terms"][k] - v) / abs(v) for k, v in ref["terms"].items()}
    if max(terms.values()) > TRAIN_LOSS_RTOL:
        bad.append(f"loss terms relative {terms}")
    near = max(max_scaled(got["grads"][k], v) for k, v in ref["grads"].items()
               if k.startswith(TRAIN_HEAD_OUT[family]))
    if near > TRAIN_HEAD_OUT_GATE:
        bad.append(f"head output gradients max-scaled {near:.3g}")
    cos, l2 = (1.0, ""), 0.0
    for w in ("grads", "delta"):    # one float64 pass over each pair
        num = den = 0.0
        for k, r in ref[w].items():
            a = np.asarray(got[w][k], np.float64).ravel()
            b = np.asarray(r, np.float64).ravel()
            aa, ab, bb = float(a @ a), float(a @ b), float(b @ b)
            cos = min(cos, (ab / (aa ** 0.5 * bb ** 0.5 + 1e-300), f"{w} {k}"))
            num += aa - 2 * ab + bb
            den += bb
        l2 = max(l2, (max(num, 0.0) / den) ** 0.5)
    if cos[0] < TRAIN_COSINE_GATE:
        bad.append(f"cosine {cos}")
    if l2 > TRAIN_L2_GATE:
        bad.append(f"relative L2 {l2:.3g}")
    bn = max(max_scaled(got["bufs"][k], v) for k, v in ref["bufs"].items())
    if bn > TRAIN_BN_GATE:
        bad.append(f"BN running statistics max-scaled {bn:.3g}")
    if bad:
        raise AssertionError("train step outside its gates: " + "; ".join(bad))
    return (f"loss terms within {max(terms.values()):.3g} relative, head "
            f"output gradients {near:.3g} max-scaled, every gradient and "
            f"update cosine >= {cos[0]:.6f}, relative L2 {l2:.3g}, BN "
            f"statistics {bn:.3g}")


def first_step(step, data) -> dict:
    """One step of `step` (a `TrainStep` or `DataParallelTrainStep`) on
    `data` at PARITY_LR, phase by phase, with every launch count reset
    just before: what `compare_train_step` reads ("terms" as floats,
    "grads", "delta" (the update), "bufs" (BN running statistics), as
    float32 numpy on the host) and the "launches"."""
    from mydetection_tpu_torch import kernels

    kernels.reset_launches()
    terms = step.forward(*step.batch(*data))
    grads = step.backward(terms)
    p0 = {k: p.detach().clone() for k, p in step.params.items()}
    step.update(grads, PARITY_LR)
    host = lambda t: t.detach().cpu().numpy()  # noqa: E731
    return {"terms": {k: float(v.detach()) for k, v in terms.items()},
            "grads": {k: host(g) for k, g in grads.items()},
            "delta": {k: host(p - p0[k]) for k, p in step.params.items()},
            "bufs": {k: host(b).copy() for k, b in step.model.named_buffers()},
            "launches": read_launches()}


def parity_train_run(family: str, device: str, steps: int = 4) -> dict:
    """The small train step of `family` on `device` from `init_weights(seed
    0)` and `train_batch(0, ...)` (rapid: one class, cxcywhθ GT): the
    first step phase by phase (terms, gradients, update, BN statistics,
    the kernels' launches), then `steps - 1` more on the same batch;
    "totals" has every step's loss."""
    from mydetection_tpu_torch.models.layers import init_weights
    from mydetection_tpu_torch.registry import get_model
    from mydetection_tpu_torch.training import make_train_step

    classes = 1 if family == "rapid" else PARITY_CLASSES
    model = get_model(family, num_classes=classes,
                      compute_dtype=torch.float32, input_size=PARITY_SIZE)
    init_weights(model, 0)
    step = make_train_step(model, input_size=PARITY_SIZE, device=device)
    data = train_batch(0, PARITY_BATCH, PARITY_SIZE, classes,
                       rotated=family == "rapid")
    out = first_step(step, data)
    out["totals"] = [out["terms"]["total"]] + [
        float(step(*data, PARITY_LR)["total"]) for _ in range(steps - 1)]
    return out


def phase_train_parity() -> None:
    """Each family's small f32 train step on the card against the CPU,
    under the TRAIN_* gates. fcos's step launches the two trainable GN
    kernels 40 times each; the others launch no kernel (the RetinaNet
    towers take `conv3x3_chain_plain` under autograd, the fused
    bottleneck stays out of train mode, Darknet has no kernel)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    for family in TRAIN_FAMILIES:
        cpu = parity_train_run(family, "cpu")
        gpu = parity_train_run(family, "cuda")
        want = ({"bias_gn_relu_fwd_stats": 40, "bias_gn_relu_bwd": 40}
                if family == "fcos" else {})
        want = {k: want.get(k, 0) for k in gpu["launches"]}
        if gpu["launches"] != want:
            raise AssertionError(f"the CUDA {family} train step launched "
                                 f"{gpu['launches']}, expected {want}")
        report = compare_train_step(gpu, cpu, family)
        for name, run in (("cuda", gpu), ("cpu", cpu)):
            t = run["totals"]
            if not (np.isfinite(t).all() and t[-1] < t[0]):
                raise AssertionError(f"{name} {family} train loss did not "
                                     f"fall: {t}")
        print(f"train parity: {family}-{PARITY_SIZE} batch {PARITY_BATCH}, "
              f"f32 (TF32 off), make_train_step cuda against cpu from the "
              f"same seeded weights and batch, first step: {report}; "
              f"launches {gpu['launches']}; total loss over "
              f"{len(gpu['totals'])} steps at lr {PARITY_LR}: cuda "
              f"{[round(v, 4) for v in gpu['totals']]}, cpu "
              f"{[round(v, 4) for v in cpu['totals']]}", flush=True)


def phase_rotated(rng) -> None:
    from mydetection_tpu_torch.kernels.nms import plan_for
    from mydetection_tpu_torch.kernels.rotated_nms import (
        nms_from_iou_keep,
        nms_from_iou_keep_plain,
    )

    for b, k in ((BATCH, ROT_PRE_NMS), (12, 2048), (12, OLD_LARGEST_ROTATED_K)):
        iou, valid = rotated_cases(rng, b, k, device="cuda")
        keep = nms_from_iou_keep(iou, valid, IOU_THRES)
        plain = nms_from_iou_keep_plain(iou, valid, IOU_THRES)
        torch.cuda.synchronize()
        diff = int((keep != plain).sum())
        if diff:
            bad = sorted({int(i) for i in (keep != plain).nonzero()[:, 0]})
            raise AssertionError(f"suppress kernel keep-mask differs from the "
                                 f"plain version in {diff} entries at B={b} "
                                 f"K={k} (images {bad})")
        if keep[4].any() or (keep & ~valid).any() or not keep.any():
            raise AssertionError("a padding row was kept, or none kept")
        print(f"rotated: nms_from_iou_keep bit-equal to plain on B={b} "
              f"K={k} hard cases ({int(keep.sum())} kept of "
              f"{int(valid.sum())} valid; "
              f"{plan_text(plan_for(valid, box_floats=0))}); kernel "
              f"{cuda_ms(lambda: nms_from_iou_keep(iou, valid, IOU_THRES)):.4f} ms, "
              f"plain {cuda_ms(lambda: nms_from_iou_keep_plain(iou, valid, IOU_THRES), 1):.3f} ms",
              flush=True)
        del iou


def tower_case(gen, b: int, h: int, w: int, dtype, c: int = 256,
               layers: int = TOWER_LAYERS, device: str = "cuda"):
    """A conv3x3_chain call's inputs: x (b, c, h, w) in channels_last
    with mean 0.5 and unit spread, the L layers' weights 0.1 N(0, 1)
    packed in `dtype`, biases N(0, 1) (L, c) float32."""
    from mydetection_tpu_torch.kernels.tower import pack_weights

    kw = dict(device=device, generator=gen)
    x = (torch.randn(b, c, h, w, **kw) + 0.5).to(dtype).contiguous(
        memory_format=torch.channels_last)
    weights = 0.1 * torch.randn(layers, c, c, 3, 3, **kw)
    return x, pack_weights(weights, dtype), torch.randn(layers, c, **kw)


def tower_error(got: torch.Tensor, ref: torch.Tensor) -> tuple[float, bool]:
    """(max-scaled |got - ref|, within TOWER_F32_GATE or
    TOWER_BF16_GATE by got's dtype)."""
    err = max_scaled(got, ref)
    gate = TOWER_F32_GATE if got.dtype == torch.float32 else TOWER_BF16_GATE
    return err, err <= gate


def tower_ref_error(got: torch.Tensor, ref: torch.Tensor, layers: int
                    ) -> tuple[float, bool]:
    """(max-scaled |got - ref|, within the gate) for the bf16 kernel
    against conv3x3_chain_reference: at one layer every element within
    one bf16 ulp of the larger value plus TOWER_REF_FLOOR of the max
    |value|, at more TOWER_REF_L4_GATE max-scaled."""
    err = max_scaled(got, ref)
    if layers > 1:
        return err, err <= TOWER_REF_L4_GATE
    return err, within_bf16_ulp(got, ref,
                                TOWER_REF_FLOOR * float(ref.float().abs().max()))


def phase_tower() -> None:
    from mydetection_tpu_torch.kernels.tower import (
        conv3x3_chain,
        conv3x3_chain_plain,
        conv3x3_chain_reference,
    )
    from mydetection_tpu_torch.models.retinanet import level_shapes

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(3)
    shapes = [(BATCH, h, w, 256) for h, w in level_shapes(608)] + [(2, 9, 13, 64)]
    report = []
    ref_worst = {1: 0.0, TOWER_LAYERS: 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        worst = 0.0
        for b, h, w, c in shapes:
            args = tower_case(gen, b, h, w, dtype, c)
            got = conv3x3_chain(*args)
            again = conv3x3_chain(*args)
            ref = conv3x3_chain_plain(*args)
            torch.cuda.synchronize()
            err, ok = tower_error(got, ref)
            if not ok or not torch.equal(got, again) or not got.is_contiguous(
                    memory_format=torch.channels_last):
                raise AssertionError(f"conv3x3_chain {dtype} at {(b, c, h, w)}: "
                                     f"max-scaled |d| {err:.3g} outside its "
                                     f"gate, two runs differ, or the output "
                                     f"left channels_last")
            worst = max(worst, err)
            if dtype == torch.float32:
                continue
            one = tower_case(gen, b, h, w, dtype, c, layers=1)
            for layers, case, out in ((TOWER_LAYERS, args, got),
                                      (1, one, conv3x3_chain(*one))):
                err, ok = tower_ref_error(out, conv3x3_chain_reference(*case),
                                          layers)
                if not ok:
                    raise AssertionError(
                        f"conv3x3_chain bf16 at {(b, c, h, w)}, L = {layers}: "
                        f"outside its gate of the kernel-order reference "
                        f"(max-scaled |d| {err:.3g})")
                ref_worst[layers] = max(ref_worst[layers], err)
        report.append(f"{str(dtype)[6:]} max-scaled |d| {worst:.3g}")
    print(f"tower: conv3x3_chain ({TOWER_LAYERS} layers) within its gates of "
          f"plain at (B, H, W, C) {shapes} (f32 gate {TOWER_F32_GATE}, TF32 "
          f"off; bf16 gate {TOWER_BF16_GATE}), bit-equal over two runs: "
          f"{', '.join(report)}; bf16 against the kernel-order reference: "
          f"L = 1 within one ulp + {TOWER_REF_FLOOR:g} of max everywhere "
          f"(max-scaled |d| {ref_worst[1]:.3g}), L = {TOWER_LAYERS} "
          f"max-scaled |d| {ref_worst[TOWER_LAYERS]:.3g} (gate "
          f"{TOWER_REF_L4_GATE:g})", flush=True)


def bottleneck_case(gen, b: int, h: int, w: int, c_in: int, c_out: int,
                    dtype, device: str = "cuda", bn_bias: float = 0.0,
                    with_block: bool = False):
    """A fused_bottleneck call's inputs: x (b, c_in, h, w) in
    channels_last with mean 0.5 and unit spread, and a port `Bottleneck`
    (a projection when c_in != c_out) with He-normal conv weights, BN
    statistics drawn as the TPU script draws them (mean 0.1 N(0, 1), var
    U(0.5, 2)) and BN biases `bn_bias`, folded in `dtype`. Returns
    (x, Folded), and the block in eval mode and `dtype` as a third item
    with `with_block`."""
    from mydetection_tpu_torch.kernels.bottleneck import fold_bottleneck
    from mydetection_tpu_torch.models.layers import BatchNorm
    from mydetection_tpu_torch.models.resnet import Bottleneck

    kw = dict(device=device, generator=gen)
    block = Bottleneck(c_in, c_out, 1, downsample=c_in != c_out).to(device)
    with torch.no_grad():
        for m in block.modules():
            if isinstance(m, torch.nn.Conv2d):
                std = (2.0 / m.weight[0].numel()) ** 0.5
                m.weight.copy_(std * torch.randn(m.weight.shape, **kw))
            elif isinstance(m, BatchNorm):
                m.mean.copy_(0.1 * torch.randn(m.mean.shape, **kw))
                m.var.copy_(0.5 + 1.5 * torch.rand(m.var.shape, **kw))
                m.bias.fill_(bn_bias)
    x = (torch.randn(b, c_in, h, w, **kw) + 0.5).to(dtype).contiguous(
        memory_format=torch.channels_last)
    folded = fold_bottleneck(block.eval(), dtype)
    if with_block:
        return x, folded, block.to(dtype)
    return x, folded


def bottleneck_error(got: torch.Tensor, ref: torch.Tensor) -> tuple[float, bool]:
    """(max-scaled |got - ref|, within BOTTLENECK_F32_GATE or
    BOTTLENECK_BF16_GATE by got's dtype)."""
    err = max_scaled(got, ref)
    gate = (BOTTLENECK_F32_GATE if got.dtype == torch.float32
            else BOTTLENECK_BF16_GATE)
    return err, err <= gate


def phase_bottleneck() -> None:
    from mydetection_tpu_torch.kernels import bottleneck as bk

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(4)
    report = []
    for dtype in (torch.float32, torch.bfloat16):
        worst = 0.0
        for b, h, w, c_in, c_out in BOTTLENECK_SHAPES:
            x, f = bottleneck_case(gen, b, h, w, c_in, c_out, dtype)
            got = bk.fused_bottleneck(x, *f)
            again = bk.fused_bottleneck(x, *f)
            ref = bk.fused_bottleneck_plain(x, *f)
            torch.cuda.synchronize()
            err, ok = bottleneck_error(got, ref)
            if not ok or not torch.equal(got, again) or got.shape != ref.shape \
                    or not got.is_contiguous(memory_format=torch.channels_last):
                raise AssertionError(f"fused_bottleneck {dtype} at {(b, h, w, c_in, c_out)}: "
                                     f"max-scaled |d| {err:.3g} outside its "
                                     f"gate, two runs differ, or the output "
                                     f"has the wrong shape or layout")
            worst = max(worst, err)
            del x, f, got, again, ref
        report.append(f"{str(dtype)[6:]} max-scaled |d| {worst:.3g}")
    smem = {f"{str(dt)[6:]} c_mid {cm}": bk.smem_bytes(cm, dt)
            for dt in (torch.float32, torch.bfloat16) for cm in bk.C_MIDS}
    print(f"bottleneck: fused_bottleneck within its gates of plain at (B, H, "
          f"W, c_in, c_out) {BOTTLENECK_SHAPES} (f32 gate "
          f"{BOTTLENECK_F32_GATE}, TF32 off; bf16 gate "
          f"{BOTTLENECK_BF16_GATE}), bit-equal over two runs: "
          f"{', '.join(report)}; dynamic shared memory a block {smem} bytes",
          flush=True)


def gather_cases(rng, b: int, n: int, k: int) -> dict:
    """(b, k) int64 index sets over n rows: sorted with duplicates (the
    TPU kernel's contract, first and last rows included), a random
    top-k order, and all equal."""
    srt = np.sort(rng.randint(0, n, (b, k)), axis=1)
    srt[:, :2] = 0
    srt[:, -2:] = n - 1
    topk = np.stack([rng.permutation(n)[:k] for _ in range(b)])
    return {"sorted": srt, "top-k order": topk,
            "all equal": np.full((b, k), rng.randint(0, n))}


def phase_gather(rng) -> None:
    from mydetection_tpu_torch.kernels.gather import gather_rows, gather_rows_plain

    checked = []
    for dtype in (torch.bfloat16, torch.float32):
        src = torch.randn(BATCH, GATHER_N, GATHER_C, device="cuda").to(dtype)
        small = torch.randn(BATCH, 1000, 7, device="cuda").to(dtype)
        for s, k in ((src, PRE_NMS), (small, 300)):
            for kind, sel in gather_cases(rng, BATCH, s.shape[1], k).items():
                for idx in (torch.from_numpy(sel).cuda(),
                            torch.from_numpy(sel).cuda().int()):
                    got = gather_rows(s, idx)
                    if not torch.equal(got, gather_rows_plain(s, idx)):
                        raise AssertionError(f"gather_rows differs from plain "
                                             f"on {tuple(s.shape)} {dtype}, "
                                             f"{kind} {idx.dtype} indices")
            checked.append(f"{tuple(s.shape)} {str(dtype)[6:]}")
        del src, small
    torch.cuda.synchronize()
    print(f"gather: gather_rows bit-equal to plain on {checked}, K = "
          f"{PRE_NMS} (300 on the C=7 rows), indices sorted with duplicates, "
          f"in top-k order and all equal, int64 and int32", flush=True)


def compare_rotated(gpu, cpu) -> str:
    """boxes_rot gates of the rapid parity: cx, cy within 1e-2 px; w, h
    within 1e-2 px + 1e-5 relative (seeded widths reach 1e6 px); θ
    within 1e-5 rad. Returns the report, raises outside a gate."""
    g, c = gpu.boxes_rot, cpu.boxes_rot
    d = np.abs(g - c)
    dxy = float(d[:, :2].max())
    dwh = float((d[:, 2:4] / (1e-2 + 1e-5 * np.abs(c[:, 2:4]))).max())
    dth = float(d[:, 4].max())
    if dxy > 1e-2 or dwh > 1 or dth > 1e-5:
        raise AssertionError(f"rapid cuda/cpu boxes_rot: max |d cxcy| {dxy:.3g}"
                             f" px (gate 1e-2), w/h at {dwh:.3g} of their "
                             f"gate, max |d theta| {dth:.3g} (gate 1e-5)")
    return (f"max |d cxcy| {dxy:.3g} px, w/h at {dwh:.3g} of the gate, "
            f"max |d theta| {dth:.3g}")


def match_detections(gpu, cpu, box_gate) -> bool:
    """One-to-one greedy matching of the CUDA detections to the CPU ones
    under the parity gates: class equal, score within
    PARITY_SCORE_GATE, each box coordinate within `box_gate` px (a
    number, or one per CPU coordinate). Neighbours whose scores are
    closer than the two devices' score error may come out swapped; a
    wrong box, score, class or count cannot match."""
    used = np.zeros(len(cpu), bool)
    for box, score, cls in zip(gpu.boxes_xyxy, gpu.scores, gpu.classes):
        db = np.abs(cpu.boxes_xyxy - box[None])
        cand = (~used & (cpu.classes == cls) & (db <= box_gate).all(axis=1)
                & (np.abs(cpu.scores - score) <= PARITY_SCORE_GATE))
        if not cand.any():
            return False
        used[int(np.argmin(np.where(cand, db.max(axis=1), np.inf)))] = True
    return True


def float64_boxes(name: str, canvas, info, conf: float, cpu) -> np.ndarray:
    """The boxes of a float64 CPU run of the same seeded model on the
    same canvas (the postprocess in float32, as in every run), which
    must keep the float32 CPU run's detections in its order."""
    from mydetection_tpu_torch import Detector

    det = Detector(name, device="cpu", input_size=canvas.shape[0],
                   compute_dtype=torch.float64, rng_seed=0)
    ref = det.detect_prepared(canvas[None], [info], conf_thres=conf,
                              nms_iou=IOU_THRES)[0]
    if len(ref) != len(cpu) or not np.array_equal(ref.classes, cpu.classes):
        raise AssertionError(f"{name} float64 and float32 CPU runs keep "
                             f"different detections; no float32 floor")
    return ref.boxes_xyxy.astype(np.float64)


def check_parity(name: str, canvas, info, conf: float, expect: dict,
                 box_floor: bool = False) -> None:
    """The CUDA Detector against the CPU one on the same seeded weights,
    float32, TF32 off: counts and classes equal, scores within
    PARITY_SCORE_GATE, boxes within PARITY_BOX_GATE px (rotated:
    `compare_rotated`), row by row or, where tied neighbours swap, by
    `match_detections`; the CUDA run launches each kernel in `expect`
    that many times. With `box_floor`, the box gate is PARITY_BOX_GATE
    plus twice the CPU's own float32 error F, the largest distance of
    its box coordinates from a float64 run's (`float64_boxes`): two
    float32 runs may each be F from the float64 one."""
    from mydetection_tpu_torch import Detector

    size = canvas.shape[0]
    kw = dict(input_size=size, compute_dtype=torch.float32, rng_seed=0)
    runs = {}
    for device in ("cpu", "cuda"):
        det = Detector(name, device=device, **kw)
        before = {fn: fn.launches for fn in expect}
        runs[device] = det.detect_prepared(canvas[None], [info],
                                           conf_thres=conf,
                                           nms_iou=IOU_THRES)[0]
        launched = {fn.__name__: fn.launches - before[fn] for fn in expect}
    cpu, gpu = runs["cpu"], runs["cuda"]
    box_gate, floor_note = PARITY_BOX_GATE, ""
    if box_floor:
        ref = float64_boxes(name, canvas, info, conf, cpu)
        floor = float(np.abs(cpu.boxes_xyxy - ref).max())
        box_gate = PARITY_BOX_GATE + 2.0 * floor
        own = (f"{float(np.abs(gpu.boxes_xyxy - ref).max()):.3g} px"
               if np.array_equal(gpu.classes, cpu.classes) else "not aligned")
        floor_note = (f" (gate {PARITY_BOX_GATE} px + 2 x {floor:.3g} px, the "
                      f"largest distance of the cpu's float32 boxes from a "
                      f"float64 run's; the card's from it: {own})")
    want = {fn.__name__: n for fn, n in expect.items()}
    if launched != want:
        raise AssertionError(f"CUDA {name} detect launched {launched}, "
                             f"expected {want}")
    if len(gpu) != len(cpu):
        raise AssertionError(f"{name} cuda/cpu detections differ: {len(gpu)} "
                             f"vs {len(cpu)} boxes")
    if len(cpu) == 0:
        raise AssertionError(f"{name} parity canvas produced no detections")
    gaps = np.diff(np.sort(cpu.scores))
    gap = (f"{float(gaps[gaps > 0].min()):.3g}" if (gaps > 0).any()
           else "none: every score is equal")
    if cpu.boxes_rot is not None:
        if not np.array_equal(gpu.classes, cpu.classes):
            raise AssertionError(f"{name} cuda/cpu classes differ")
        ds = float(np.abs(gpu.scores - cpu.scores).max())
        if ds > PARITY_SCORE_GATE:
            raise AssertionError(f"{name} cuda/cpu max |d score| {ds:.3g} "
                                 f"(gate {PARITY_SCORE_GATE})")
        branch, boxes = "row by row", compare_rotated(gpu, cpu)
    else:
        ds = float(np.abs(gpu.scores - cpu.scores).max())
        dbox = np.abs(gpu.boxes_xyxy - cpu.boxes_xyxy)
        db = float(dbox.max())
        if (np.array_equal(gpu.classes, cpu.classes)
                and ds <= PARITY_SCORE_GATE and (dbox <= box_gate).all()):
            branch = "row by row"
        elif match_detections(gpu, cpu, box_gate):
            branch = "one-to-one match (tied neighbours swapped)"
        else:
            raise AssertionError(f"{name} cuda/cpu detections differ: classes "
                                 f"{gpu.classes[:10]} vs {cpu.classes[:10]}, "
                                 f"max |d score| {ds:.3g} (gate "
                                 f"{PARITY_SCORE_GATE}), max |d box| {db:.3g} "
                                 f"px{floor_note or f' (gate {box_gate})'}, "
                                 f"and no one-to-one match")
        boxes = f"max |d box| {db:.3g} px{floor_note}"
    print(f"parity: {name}-{size} f32 (TF32 off) cuda == cpu on {len(cpu)} "
          f"detections at conf {conf}, {branch}, row-wise max |d score| "
          f"{ds:.3g}, {boxes}; smallest gap between distinct cpu scores "
          f"{gap}; launches {launched}", flush=True)


def noise_canvas(size: int, seed: int = 5):
    """A size² canvas of uniform uint8 noise that fills it (no letterbox
    border, so no region of identical pixels), with its LetterboxInfo."""
    from mydetection_tpu_torch.utils.image_ops import LetterboxInfo

    canvas = np.random.RandomState(seed).randint(0, 256, (size, size, 3))
    return canvas.astype(np.uint8), LetterboxInfo(
        ori_w=size, ori_h=size, ratio=1.0, pad_x=0.0, pad_y=0.0,
        input_size=size)


def parity_cases() -> dict:
    """name → (canvas, info, conf) of the detect parity runs: yolov3 on
    the golden image padded to 416, yolov3_608 on it letterboxed to 608
    (as `detect_one` sends it), fcos and rapid on its middle at 320, the
    RetinaNets on a 320² noise canvas (a uniform letterbox border would
    give exactly tied candidates). At init FCOS scores sit near
    0.01 x 0.5: conf 0.005 keeps fcos from being vacuous."""
    from mydetection_tpu_torch.utils.image_ops import letterbox_np

    middle = padded_canvas(golden_image()[:, 50:350], 320, 10, 10)
    return {"yolov3": (*padded_canvas(golden_image(), 416, 8, 58), 0.25),
            "yolov3_608": (*letterbox_np(golden_image(), 608), 0.25),
            "fcos": (*middle, 0.005), "rapid": (*middle, 0.3),
            "retinanet": (*noise_canvas(320), 0.005),
            "retinanet_r101": (*noise_canvas(320), 0.005)}


def phase_parity() -> None:
    from mydetection_tpu_torch.kernels.bottleneck import fused_bottleneck
    from mydetection_tpu_torch.kernels.gather import gather_rows
    from mydetection_tpu_torch.kernels.gn import bias_gn_relu
    from mydetection_tpu_torch.kernels.nms import nms_keep
    from mydetection_tpu_torch.kernels.rotated_nms import nms_from_iou_keep
    from mydetection_tpu_torch.kernels.tower import conv3x3_chain

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cases = parity_cases()
    check_parity("yolov3", *cases["yolov3"], {nms_keep: 1, fused_bottleneck: 0})
    t0 = time.perf_counter()
    check_parity("yolov3_608", *cases["yolov3_608"],
                 {nms_keep: 1, fused_bottleneck: 0})
    print(f"parity: yolov3_608-608 in {time.perf_counter() - t0:.1f} s "
          f"(both runs, the cpu's included)", flush=True)
    check_parity("fcos", *cases["fcos"], {nms_keep: 1, bias_gn_relu: 40,
                                          gather_rows: 1, fused_bottleneck: 6})
    check_parity("rapid", *cases["rapid"], {nms_from_iou_keep: 1,
                                            fused_bottleneck: 0})
    # the seeded deltas reach |d| ~ 50, so a corner is the difference of
    # two coordinates near 1e4 px and float32 alone moves it by ~1e-2 px
    # (the CPU's float32 boxes are 0.0139 px from its float64 ones here)
    for name in ("retinanet", "retinanet_r101"):
        check_parity(name, *cases[name],
                     {nms_keep: 1, conv3x3_chain: 10, gather_rows: 1,
                      fused_bottleneck: 6}, box_floor=True)


def match_bf16(gpu, cpu) -> dict:
    """Tie-aware one-to-one matching of bf16 card detections to bf16 CPU
    ones: each card detection, in score order, takes the unused CPU
    detection of its class within BF16_SCORE_TOL and BF16_BOX_TOL px
    (largest coordinate difference) that lies nearest, so neighbours
    tied in score may pair in any order. Returns the matched count, the
    unmatched counts of both sides and the largest score and box deltas
    of the matched pairs."""
    used = np.zeros(len(cpu), bool)
    ds = db = 0.0
    for box, score, cls in zip(gpu.boxes_xyxy, gpu.scores, gpu.classes):
        dist = np.abs(cpu.boxes_xyxy - box[None]).max(axis=1) \
            if len(cpu) else np.zeros(0)
        dscore = np.abs(cpu.scores - score)
        cand = (~used & (cpu.classes == cls) & (dist <= BF16_BOX_TOL)
                & (dscore <= BF16_SCORE_TOL))
        if cand.any():
            j = int(np.argmin(np.where(cand, dist, np.inf)))
            used[j] = True
            ds, db = max(ds, float(dscore[j])), max(db, float(dist[j]))
    matched = int(used.sum())
    return {"matched": matched, "unmatched_card": len(gpu) - matched,
            "unmatched_cpu": len(cpu) - matched, "max_d_score": ds,
            "max_d_box_px": db}


# the kernels on each bf16 parity path, by wrapper name, with the
# launches of one detect at 320 (besides the NMS's one, the gather's and
# the conv epilogue's, BF16_EPILOGUES: that kernel equals its plain
# version bit for bit, `epilogue_row`, so it moves no detection)
BF16_KERNELS = {"fcos": {"bias_gn_relu": 40, "fused_bottleneck": 6},
                "retinanet": {"conv3x3_chain": 10, "fused_bottleneck": 6},
                "retinanet_r101": {"conv3x3_chain": 10,
                                   "fused_bottleneck": 6}}
BF16_EPILOGUES = {"fcos": 34, "retinanet": 34, "retinanet_r101": 85}


def _kernel_sites() -> dict:
    """wrapper name → (the module whose global the model's call site
    reads for the kernel, the routing name that call site reads, what
    that name becomes to route the site to the plain version)."""
    from mydetection_tpu_torch.models import fcos as fcos_mod
    from mydetection_tpu_torch.models import resnet as resnet_mod
    from mydetection_tpu_torch.models import retinanet as retina_mod

    return {"bias_gn_relu": (fcos_mod, "pick", lambda kernel, plain: plain),
            "fused_bottleneck": (resnet_mod, "takes_kernel",
                                 lambda module, x: False),
            "conv3x3_chain": (retina_mod, "kernels_enabled", lambda: False)}


def plain_launches(base: dict, name: str) -> dict:
    """`base`'s launches with kernel `name` routed plain: the fused
    bottleneck's six blocks then run unfused, and their 19 convs launch
    the conv epilogue."""
    want = {**base, name: 0}
    if name == "fused_bottleneck":
        want["conv_epilogue"] += 19
    return want


@contextlib.contextmanager
def plain_kernel(name: str):
    """Route one kernel's call site to its plain version for the
    duration by rebinding the routing name it reads: fcos's towers'
    `pick` (#3), the RetinaNet subnet's `kernels_enabled` (#6), the
    bottleneck's `takes_kernel` (#7). A switch of this script only:
    `kernels.route.plain_versions` routes every kernel at once."""
    module, attr, plain = _kernel_sites()[name]
    saved = getattr(module, attr)
    setattr(module, attr, plain)
    try:
        yield
    finally:
        setattr(module, attr, saved)


@contextlib.contextmanager
def kernel_calls(names):
    """Record every call of the named kernels at their call sites:
    yields name → [(args, kwargs, output)], filled as the model runs."""
    sites = _kernel_sites()
    calls = {name: [] for name in names}
    saved = {name: getattr(sites[name][0], name) for name in names}
    for name, fn in saved.items():
        def record(*args, _fn=fn, _calls=calls[name], **kw):
            out = _fn(*args, **kw)
            _calls.append((args, kw, out))
            return out
        setattr(sites[name][0], name, record)
    try:
        yield calls
    finally:
        for name, fn in saved.items():
            setattr(sites[name][0], name, fn)


@contextlib.contextmanager
def op_calls(op):
    """Record every call of the custom op `op` (a `torch.ops` packet) as
    it dispatches, whichever Python name reached it: yields a list
    filled with (args, output) in call order."""
    from torch.utils._python_dispatch import TorchDispatchMode

    calls = []

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func.overloadpacket is op:
                calls.append((args, out))
            return out

    with Record():
        yield calls


def f32_distance(outs, refs) -> tuple[float, float]:
    """(max-scaled, relative-L2) distance of outputs from their float32
    references over all calls: the largest |out − ref| over the largest
    |ref| of its call, and sqrt(Σ|out − ref|² / Σ|ref|²)."""
    scaled, err2, ref2 = 0.0, 0.0, 0.0
    for out, ref in zip(outs, refs):
        d = out.float() - ref
        scaled = max(scaled, float(d.abs().max() / ref.abs().max().clamp_min(
            1e-30)))
        err2 += float((d.double() ** 2).sum())
        ref2 += float((ref.double() ** 2).sum())
    return scaled, (err2 / max(ref2, 1e-300)) ** 0.5


def kernel_f32_distances(name: str, calls, blocks) -> dict:
    """For one kernel's calls captured in a bf16 run: how far its bf16
    outputs, its plain version's bf16 outputs on the same inputs and,
    for the bottleneck, the unfused block's (the route the call site
    takes when the kernel is forced plain, the CPU's arithmetic) lie
    from the plain version run in float32 on the inputs upcast (TF32
    off). Each value is `f32_distance`'s pair."""
    from mydetection_tpu_torch.kernels.bottleneck import fused_bottleneck_plain
    from mydetection_tpu_torch.kernels.gn import bias_gn_relu_plain
    from mydetection_tpu_torch.kernels.tower import conv3x3_chain_plain

    plain = {"bias_gn_relu": bias_gn_relu_plain,
             "fused_bottleneck": fused_bottleneck_plain,
             "conv3x3_chain": conv3x3_chain_plain}[name]
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    outs = {"kernel": [], "plain": [], "unfused": []}
    refs = []
    try:
        with torch.inference_mode():
            for i, (args, kw, out) in enumerate(calls):
                up = [a.float() if torch.is_tensor(a) else a for a in args]
                refs.append(plain(*up, **kw).float())
                outs["kernel"].append(out)
                outs["plain"].append(plain(*args, **kw))
                if name == "fused_bottleneck":
                    outs["unfused"].append(blocks[i].unfused(args[0]))
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32
    return {who: f32_distance(o, refs) for who, o in outs.items() if o}


def phase_parity_bf16() -> None:
    """fcos, retinanet and retinanet_r101 at 320 in bf16 on the card
    against the same seeded weights in bf16 on the CPU, on the parity
    canvases. The card runs the kernels' numerics (float32 through each
    bias, one rounding per conv), the CPU the JAX bf16 graph's (the conv
    rounded first), so detections near a cut (the confidence gate, the
    top-k, NMS) may differ: `match_bf16` pairs them, and at least
    BF16_MIN_MATCHED of the larger count must pair.

    Then the attribution of the unmatched share, kernel by kernel: the
    card's matched share with each kernel of the path routed to its
    plain version in turn (`plain_kernel`) and with all of them
    (`plain_versions`), each run's launches checked; and, on each
    kernel's inputs captured in the all-kernels run, its bf16 output's
    distance from float32 beside its plain version's. A kernel further
    from float32 than its plain version by more than the plain version's
    own distance (by either measure) is at fault: the phase fails."""
    from mydetection_tpu_torch import Detector, kernels
    from mydetection_tpu_torch.kernels.route import plain_versions
    from mydetection_tpu_torch.models import resnet as resnet_mod

    cases = parity_cases()
    faults = []
    for name in ("fcos", "retinanet", "retinanet_r101"):
        t0 = time.perf_counter()
        canvas, info, conf = cases[name]
        size = canvas.shape[0]
        dets = {device: Detector(name, device=device, input_size=size,
                                 compute_dtype=torch.bfloat16, rng_seed=0)
                for device in ("cuda", "cpu")}

        def detect(device):
            return dets[device].detect_prepared(
                canvas[None], [info], conf_thres=conf, nms_iou=IOU_THRES)[0]

        cpu = detect("cpu")
        base = {"nms_keep": 1, "gather_rows": 1, **BF16_KERNELS[name],
                "conv_epilogue": BF16_EPILOGUES[name]}
        # the all-kernels run records each kernel's calls
        runs = [("all kernels", kernel_calls(BF16_KERNELS[name]), base)]
        runs += [(f"{k} plain", plain_kernel(k), plain_launches(base, k))
                 for k in BF16_KERNELS[name]]
        runs.append(("all plain", plain_versions(), {}))
        shares = []
        for label, ctx, want in runs:
            with ctx as recorded:
                kernels.reset_launches()
                gpu = detect("cuda")
                check_launches(f"{name} bf16 detect, {label},",
                               read_launches(), want)
            if recorded is not None:
                calls = recorded
            m = match_bf16(gpu, cpu)
            frac = m["matched"] / max(len(gpu), len(cpu), 1)
            shares.append(f"{label} {frac:.3f} ({m['matched']} of {len(gpu)} "
                          f"and {len(cpu)})")
            if label != "all kernels":
                continue
            print(f"parity bf16: {name}-{size} cuda vs cpu, {len(gpu)} and "
                  f"{len(cpu)} detections at conf {conf}: {m['matched']} "
                  f"matched ({frac:.3f} of the larger count; gate >= "
                  f"{BF16_MIN_MATCHED[name]}) within {BF16_SCORE_TOL} score "
                  f"and {BF16_BOX_TOL} px, {m['unmatched_card']} card and "
                  f"{m['unmatched_cpu']} cpu unmatched; matched pairs max "
                  f"|d score| {m['max_d_score']:.3g}, max |d box| "
                  f"{m['max_d_box_px']:.3g} px", flush=True)
            if frac < BF16_MIN_MATCHED[name]:
                raise AssertionError(f"{name} bf16 cuda/cpu: {frac:.3f} of "
                                     f"the detections matched, gate "
                                     f"{BF16_MIN_MATCHED[name]}")
        print(f"parity bf16 attribution: {name}-{size} matched share of the "
              f"card's detect against the cpu's bf16: {'; '.join(shares)}",
              flush=True)
        blocks = [m for m in dets["cuda"].model.modules()
                  if isinstance(m, resnet_mod.Bottleneck) and m.fused]
        for k, n in BF16_KERNELS[name].items():
            if len(calls[k]) != n:
                raise AssertionError(f"{name} bf16 detect: {len(calls[k])} "
                                     f"calls of {k} captured, expected {n}")
            dist = kernel_f32_distances(k, calls[k], blocks)
            (ks, kl), (ps, pl) = dist["kernel"], dist["plain"]
            fault = ks - ps > ps or kl - pl > pl
            if fault:
                faults.append(f"{name} {k}")
            unfused = (f"; the unfused block (the route forced plain) "
                       f"{dist['unfused'][0]:.3g}, {dist['unfused'][1]:.3g}"
                       if "unfused" in dist else "")
            print(f"parity bf16 attribution: {name}-{size} {k}, "
                  f"{len(calls[k])} calls of the all-kernels run, distance "
                  f"from float32 "
                  f"(max-scaled, relative L2): kernel {ks:.3g}, {kl:.3g}; "
                  f"plain {ps:.3g}, {pl:.3g}{unfused}: "
                  f"{'AT FAULT' if fault else 'no further than plain allows'}",
                  flush=True)
        del dets, calls
        print(f"parity bf16: {name} in {time.perf_counter() - t0:.1f} s",
              flush=True)
    if faults:
        raise AssertionError(f"bf16 kernels further from float32 than their "
                             f"plain versions allow: {faults}")


def main_canvases(size: int):
    """BATCH procedural canvases: the golden image with noise, padded
    at random offsets."""
    rng = np.random.RandomState(1)
    img = golden_image()
    canvases, infos = [], []
    for _ in range(BATCH):
        noisy = np.clip(img.astype(np.int16) + rng.randint(-20, 21, img.shape),
                        0, 255).astype(np.uint8)
        c, i = padded_canvas(noisy, size, rng.randint(0, size - 399),
                             rng.randint(0, size - 299))
        canvases.append(c)
        infos.append(i)
    return np.stack(canvases), infos


def check_detections(dets, infos, name: str, rotated: bool) -> None:
    """Per image: finite, descending scores; fcos and rapid at least one
    detection; axis-aligned boxes inside their image; rotated boxes with
    w, h > 0 and θ in [-π/2, π/2] (their envelope is not clipped, as in
    the JAX package)."""
    for d, info in zip(dets, infos):
        s = d.scores
        if len(s) == 0 and name != "yolov3":
            raise AssertionError(f"a {name} image yielded no detection")
        if not (np.isfinite(s).all() and np.isfinite(d.boxes_xyxy).all()):
            raise AssertionError("non-finite detections")
        if len(s) > 1 and (np.diff(s) > 0).any():
            raise AssertionError("scores are not descending")
        if rotated:
            r = d.boxes_rot
            if not (np.isfinite(r).all() and (r[:, 2:4] > 0).all()
                    and (np.abs(r[:, 4]) <= np.float32(np.pi / 2)).all()):
                raise AssertionError("a rotated box is non-finite, has no "
                                     "area, or its angle leaves [-pi/2, pi/2]")
            continue
        bx = d.boxes_xyxy
        if len(bx) and ((bx < 0).any() or (bx[:, 0::2] > info.ori_w).any()
                        or (bx[:, 1::2] > info.ori_h).any()):
            raise AssertionError("a box lies outside its image")


def drive_main(name: str, size: int, conf: float, smi: str, expect: dict,
               capture_gn: bool = False) -> dict:
    """One main path: bf16 `detect_prepared` on BATCH canvases with every
    launch count reset just before and read just after (each kernel in
    `expect` must show exactly that count, every other kernel none),
    the detections checked, then the batch's timing. Returns the NMS
    inputs (rotated: the suppress kernel's, and the boxes behind its IoU
    matrix; with capture_gn, every bias_gn_relu call's inputs too), the
    gather's (src, sel), every conv3x3_chain call's (x, packed,
    biases), every fused_bottleneck call's (x, folded) and every
    mydet::conv_epilogue call's (arguments, output) of the counted run,
    and the routed blocks in call order."""
    from mydetection_tpu_torch import Detector, kernels
    from mydetection_tpu_torch.kernels.bottleneck import fused_bottleneck
    from mydetection_tpu_torch.kernels.gather import gather_rows
    from mydetection_tpu_torch.kernels.gn import bias_gn_relu
    from mydetection_tpu_torch.kernels.nms import nms_keep
    from mydetection_tpu_torch.kernels.rotated_nms import nms_from_iou_keep
    from mydetection_tpu_torch.kernels.tower import conv3x3_chain
    from mydetection_tpu_torch.models import fcos as fcos_mod
    from mydetection_tpu_torch.models import resnet as resnet_mod
    from mydetection_tpu_torch.models import retinanet as retina_mod
    from mydetection_tpu_torch.ops import nms as ops_nms
    from mydetection_tpu_torch.ops import rotated as ops_rot
    from mydetection_tpu_torch.registry import forward_dense

    det = Detector(name, input_size=size, rng_seed=0)  # cuda, bf16
    rotated = det.cfg.rotated
    canvases, infos = main_canvases(size)
    det.warmup(batch_size=BATCH)
    captured = {"gn": [], "chain": [], "bottleneck": [],
                "blocks": [m for m in det.model.modules()
                           if isinstance(m, resnet_mod.Bottleneck) and m.fused]}
    pairwise = ops_rot.pairwise_rotated_iou

    def capture_nms(boxes, valid, thr):
        captured.update(boxes=boxes, valid=valid)
        return nms_keep(boxes, valid, thr)

    def capture_suppress(iou, valid, thr, **kw):
        captured.update(iou=iou, valid=valid)
        return nms_from_iou_keep(iou, valid, thr, **kw)

    def capture_pairwise(a, b):
        captured.update(rot_boxes=a)
        return pairwise(a, b)

    def capture_gn_call(x, bias, scale, shift, **kw):
        captured["gn"].append((x, bias, scale, shift))
        return bias_gn_relu(x, bias, scale, shift, **kw)

    def capture_chain(x, packed, biases):
        captured["chain"].append((x, packed, biases))
        return conv3x3_chain(x, packed, biases)

    def capture_gather(src, sel):
        captured["gather"] = (src, sel)
        return gather_rows(src, sel)

    def capture_bottleneck(x, *folded):
        captured["bottleneck"].append((x, folded))
        return fused_bottleneck(x, *folded)

    # the epilogue's call sites read it through `layers.epilogue_kernel`
    # at each call, so its calls are recorded where they dispatch
    recorder = op_calls(torch.ops.mydet.conv_epilogue)
    ops_nms.nms_keep = capture_nms
    ops_nms.gather_rows = capture_gather
    ops_rot.nms_from_iou_keep = capture_suppress
    ops_rot.pairwise_rotated_iou = capture_pairwise
    retina_mod.conv3x3_chain = capture_chain
    resnet_mod.fused_bottleneck = capture_bottleneck
    if capture_gn:
        fcos_mod.bias_gn_relu = capture_gn_call
    try:
        kernels.reset_launches()
        with recorder as captured["epilogue"]:
            dets = det.detect_prepared(canvases, infos, conf_thres=conf,
                                       nms_iou=IOU_THRES)
        launches = {fn.__name__: fn.launches for fn in kernels.KERNELS}
    finally:
        ops_nms.nms_keep = nms_keep
        ops_nms.gather_rows = gather_rows
        ops_rot.nms_from_iou_keep = nms_from_iou_keep
        ops_rot.pairwise_rotated_iou = pairwise
        retina_mod.conv3x3_chain = conv3x3_chain
        resnet_mod.fused_bottleneck = fused_bottleneck
        fcos_mod.bias_gn_relu = bias_gn_relu
    want = {fn.__name__: expect.get(fn.__name__, 0) for fn in kernels.KERNELS}
    if launches != want:
        raise AssertionError(f"{name} main path launches {launches}, "
                             f"expected {want}")
    check_detections(dets, infos, name, rotated)

    times = []
    for _ in range(10):
        t0 = time.perf_counter()
        det.detect_prepared(canvases, infos, conf_thres=conf,
                            nms_iou=IOU_THRES)
        times.append(time.perf_counter() - t0)
    clocks = smi_line("clocks.sm,power.draw,temperature.gpu")
    lat = float(np.median(times))
    # device time of the two halves of the batch, by CUDA events
    images = torch.from_numpy(canvases).cuda()
    conf_t = torch.full((BATCH,), conf, device="cuda")
    with torch.inference_mode():
        dense = forward_dense(det.model, images)
        fwd_ms = cuda_ms(lambda: forward_dense(det.model, images), 5)
        post_ms = cuda_ms(lambda: det._post(dense, conf_t, IOU_THRES), 5)
    split = ""
    if rotated:
        rb, iou, valid = captured["rot_boxes"], captured["iou"], captured["valid"]
        with torch.inference_mode():
            iou_ms = cuda_ms(lambda: pairwise(rb, rb), 5)
        kernel_ms = cuda_ms(lambda: nms_from_iou_keep(iou, valid, IOU_THRES))
        iou_bound, iou_by = rotated_iou_bound_ms(rb)
        split = (f" (IoU matrix {iou_ms:.3f} ms, bound {iou_bound:.4f} ms by "
                 f"{iou_by}; suppress kernel {kernel_ms:.4f} ms); detections "
                 f"per image {[len(d) for d in dets]}")
    print(f"main: {name}-{size} bf16 detect_prepared batch {BATCH} at conf "
          f"{conf}: {len(dets)} images, {sum(len(d) for d in dets)} "
          f"detections, launches {launches}; median batch latency "
          f"{lat * 1e3:.2f} ms (min {min(times) * 1e3:.2f}, max "
          f"{max(times) * 1e3:.2f}), {BATCH / lat:.1f} img/s; device: "
          f"forward_dense {fwd_ms:.2f} ms, postprocess {post_ms:.2f} ms"
          f"{split}; on {smi} (sm clock, power, temp after: {clocks})",
          flush=True)
    captured["launches"] = launches
    return captured


def timed_int8_convs(fn) -> tuple[float, float, int, int, int]:
    """One call of `fn` (an int8 forward) with every `_conv_i8` call
    bracketed by CUDA events: (the forward's device ms, the convs' ms —
    im2col and `torch._int_mm` — the convs' count, the largest im2col
    matrix and the largest int32 result in bytes)."""
    from mydetection_tpu_torch import quant, quant_resnet

    calls, conv = [], quant._conv_i8

    def timed(x, w, **kw):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        out = conv(x, w, **kw)
        stop.record()
        cout, kh, kw_, cin = w.shape
        rows = out.numel() // cout
        calls.append((start, stop, rows * kh * kw_ * cin, rows * cout * 4))
        return out

    quant._conv_i8 = quant_resnet._conv_i8 = timed
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    try:
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
    finally:
        quant._conv_i8 = quant_resnet._conv_i8 = conv
    return (start.elapsed_time(stop),
            sum(a.elapsed_time(b) for a, b, _, _ in calls), len(calls),
            max(c[2] for c in calls), max(c[3] for c in calls))


def top_device_ops(fn, n: int = 6) -> list:
    """One call of `fn` under `torch.profiler`: the n operators with the
    most device time of their own, [(name, ms)]."""
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=activities) as prof:
        fn()
        torch.cuda.synchronize()
    own = [(e.self_device_time_total / 1e3, e.key)
           for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CPU]
    return [(k, round(ms, 3)) for ms, k in sorted(own, reverse=True)[:n]]


def peak_gib(fn) -> float:
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() / 2 ** 30


def quant_main(name: str, size: int, conf: float, smi: str,
               expect: dict) -> None:
    """One int8 main path: `Detector(name, quantized=True, calib_images=
    the first QUANT_CALIB_IMAGES canvases)` (calibrate → quantize), then
    bf16 `detect_prepared` on BATCH canvases with every launch count
    reset just before and read just after (each kernel in `expect`
    exactly so often, every other none); the detections checked; then
    the batch's img/s beside the float bf16 Detector's on the same
    canvases, both forwards' device ms, the int8 convs' share of the
    int8 forward (im2col and `torch._int_mm`, by CUDA events), the
    largest im2col and int32 buffers, both forwards' peak memory; on
    fcos, the 40 float32 GN launches replayed against their plain
    versions."""
    from mydetection_tpu_torch import Detector, kernels, quant, quant_resnet
    from mydetection_tpu_torch.kernels.gn import bias_gn_relu, bias_gn_relu_plain
    from mydetection_tpu_torch.registry import forward_dense

    canvases, infos = main_canvases(size)
    fdet = Detector(name, input_size=size, rng_seed=0)       # cuda, bf16
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    qdet = Detector(name, input_size=size, rng_seed=0, quantized=True,
                    calib_images=list(canvases[:QUANT_CALIB_IMAGES]))
    torch.cuda.synchronize()
    calib_s = time.perf_counter() - t0
    qdet.warmup(batch_size=BATCH)
    gn_calls = []

    def capture_gn(x, bias, scale, shift, **kw):
        gn_calls.append((x, bias, scale, shift))
        return bias_gn_relu(x, bias, scale, shift, **kw)

    quant_resnet.bias_gn_relu = capture_gn
    try:
        kernels.reset_launches()
        dets = qdet.detect_prepared(canvases, infos, conf_thres=conf,
                                    nms_iou=IOU_THRES)
        launches = read_launches()
    finally:
        quant_resnet.bias_gn_relu = bias_gn_relu
    check_launches(f"{name} int8 main path", launches, expect)
    check_detections(dets, infos, name, qdet.cfg.rotated)
    if any(x.dtype != torch.float32 for x, *_ in gn_calls):
        raise AssertionError("the int8 towers' GN ran below float32")

    def rate(det) -> float:
        det.warmup(batch_size=BATCH)
        times = []
        for _ in range(5):
            t = time.perf_counter()
            det.detect_prepared(canvases, infos, conf_thres=conf,
                                nms_iou=IOU_THRES)
            times.append(time.perf_counter() - t)
        return BATCH / float(np.median(times))

    int8_rate, bf16_rate = rate(qdet), rate(fdet)
    images = torch.from_numpy(canvases).cuda()
    qp, cfg = qdet._q, qdet.cfg
    with torch.inference_mode():
        def int8_fwd():
            return quant.forward_dense_quantized(qp, images, cfg)

        def bf16_fwd():
            return forward_dense(fdet.model, images)

        int8_ms, bf16_ms = cuda_ms(int8_fwd, 5), cuda_ms(bf16_fwd, 5)
        fwd_ms, conv_ms, convs, cols, acc = timed_int8_convs(int8_fwd)
        int8_gib, bf16_gib = peak_gib(int8_fwd), peak_gib(bf16_fwd)
        top = top_device_ops(int8_fwd)
    calib = [np.stack(canvases[:QUANT_CALIB_IMAGES])]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    quant.quantize_model(fdet.model, calib)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    gn = ""
    if gn_calls:
        kernel_ms = sum(cuda_ms(lambda c=c: bias_gn_relu(*c)) for c in gn_calls)
        plain_ms = sum(cuda_ms(lambda c=c: bias_gn_relu_plain(*c), 3)
                       for c in gn_calls)
        worst = max(gn_error(bias_gn_relu(*c), bias_gn_relu_plain(*c))[0]
                    for c in gn_calls)
        gn = (f"; its {len(gn_calls)} float32 GN launches {kernel_ms:.3f} ms "
              f"(plain {plain_ms:.3f} ms), max error against plain "
              f"{worst:.3g}")
    ran = {k: v for k, v in launches.items() if v}
    print(f"quant main: {name}-{size} int8 detect_prepared batch {BATCH} at "
          f"conf {conf}: {sum(len(d) for d in dets)} detections, launches "
          f"{ran}; Detector(quantized=True) {calib_s:.2f} s (calibration on "
          f"{QUANT_CALIB_IMAGES} canvases, float init included), "
          f"calibrate + quantize again {warm_s:.3f} s; int8 "
          f"{int8_rate:.1f} img/s, bf16 float {bf16_rate:.1f} img/s "
          f"(x{int8_rate / bf16_rate:.3f}); device forward_dense int8 "
          f"{int8_ms:.2f} ms, bf16 {bf16_ms:.2f} ms; int8 convs {convs} "
          f"calls, {conv_ms:.2f} of {fwd_ms:.2f} ms "
          f"({100 * conv_ms / fwd_ms:.1f}%), largest im2col {cols / 2**30:.3f}"
          f" GiB, int32 result {acc / 2**30:.3f} GiB; peak memory int8 "
          f"{int8_gib:.2f} GiB, bf16 {bf16_gib:.2f} GiB{gn}; the int8 "
          f"forward's operators with the most device time of their own "
          f"(ms): {top}; on {smi}", flush=True)


def phase_quant(smi: str) -> None:
    for name, size, conf, expect in QUANT_MAINS:
        quant_main(name, size, conf, smi, expect)
        torch.cuda.empty_cache()


def nms_row(captured: dict, path: str) -> dict:
    """The NMS kernel at the main path's own inputs: batch 32, and the
    first image alone (B = 1, as `detect_one` sends)."""
    from mydetection_tpu_torch.kernels.nms import nms_keep, nms_keep_plain, plan_for

    boxes, valid = captured["boxes"], captured["valid"]
    keep = nms_keep(boxes, valid, IOU_THRES)
    plain = nms_keep_plain(boxes, valid, IOU_THRES)
    err = float((keep.float() - plain.float()).abs().max())
    if err:
        raise AssertionError("kernel and plain keep-masks differ on the "
                             "main path's NMS inputs")
    b1, v1 = boxes[:1].contiguous(), valid[:1].contiguous()
    if not torch.equal(nms_keep(b1, v1, IOU_THRES), plain[:1]):
        raise AssertionError("kernel keep-mask at B=1 differs from plain")
    bound, bound_by = nms_bound_ms(boxes, valid, keep)
    row = {
        "name": "nms_keep", "route": "cuda",
        "source": "mydetection_tpu_torch/kernels/csrc/nms.cu",
        "replaces": "mydetection_tpu/ops/pallas/nms_kernel.py:38",
        "launches": captured["launches"]["nms_keep"], "max_abs_err": err,
        "ms": cuda_ms(lambda: nms_keep(boxes, valid, IOU_THRES)),
        "plain_ms": cuda_ms(lambda: nms_keep_plain(boxes, valid, IOU_THRES), 3),
        "bound_ms": bound, "bound_by": bound_by, "library_ms": None,
        "ms_b1": cuda_ms(lambda: nms_keep(b1, v1, IOU_THRES)),
        "bound_ms_b1": nms_bound_ms(b1, v1, keep[:1])[0],
        "dense_ms": nms_dense_ms(valid),
        "valid": int(valid.sum()), "kept": int(keep.sum()),
        "plan": plan_dict(plan_for(valid)), "plan_b1": plan_dict(plan_for(v1)),
        "note": "no single PyTorch call computes greedy NMS; bound_ms "
                "counts the IoUs greedy consults on these inputs, "
                "dense_ms every upper-triangle IoU of the valid rows; "
                "ms_b1 is the first image alone",
    }
    print(f"nms on the {path} main path: {row['kept']} kept of "
          f"{row['valid']} valid, bit-equal; kernel {row['ms']:.4f} ms "
          f"(bound {bound:.6f} ms by {bound_by}, every valid pair "
          f"{row['dense_ms']:.6f} ms; {plan_text(plan_for(valid))}), B=1 "
          f"{row['ms_b1']:.4f} ms ({plan_text(plan_for(v1))}), plain "
          f"{row['plain_ms']:.3f} ms", flush=True)
    return row


def gn_levels(calls, kind: str, run, bound, library) -> list[dict]:
    """For each distinct input shape of `calls`, in order (an FCOS
    level): how many calls, one call's kernel ms (`run(args)`), bound ms
    (`bound(args)`) and library ms (`library(i)` for the shape's first
    call i), and the plan's cluster, whether the range stays on chip,
    and how many clusters the card holds at once."""
    from mydetection_tpu_torch.kernels.gn import max_active_clusters, plan_for

    first = {}
    for i, args in enumerate(calls):
        first.setdefault(tuple(args[0].shape), []).append(i)
    levels = []
    for shape, idx in first.items():
        args = calls[idx[0]]
        plan = plan_for(kind, args[0], GN_GROUPS)
        levels.append({
            "shape": list(shape), "calls": len(idx),
            "ms": cuda_ms(lambda: run(args), 20), "bound_ms": bound(args),
            "library_ms": cuda_ms(lambda: library(idx[0]), 20),
            "cluster": plan.cluster, "resident": plan.resident,
            "clusters_resident": max_active_clusters(kind, args[0],
                                                     GN_GROUPS)})
    return levels


def level_text(levels: list[dict]) -> str:
    return ", ".join(f"{lv['shape'][2]}x{lv['shape'][3]} x{lv['calls']}: "
                     f"{lv['ms']:.4f} / {lv['bound_ms']:.4f} / "
                     f"{lv['library_ms']:.4f} (cluster {lv['cluster']}, "
                     f"{lv['clusters_resident']} at once"
                     f"{'' if lv['resident'] else ', streaming'})"
                     for lv in levels)


def gn_row(captured: dict) -> dict:
    """The GN kernel at the main path's own inputs: the 40 calls of one
    FCOS forward, summed, the first P3 call alone, and one call a level
    (`levels`)."""
    import torch.nn.functional as F

    from mydetection_tpu_torch.kernels.gn import bias_gn_relu, bias_gn_relu_plain

    calls = captured["gn"]
    err = 0.0
    for args in calls:
        e, ok = gn_error(bias_gn_relu(*args, groups=GN_GROUPS),
                         bias_gn_relu_plain(*args, groups=GN_GROUPS))
        if not ok:
            raise AssertionError(f"bias_gn_relu outside its gate of plain on "
                                 f"the main path's {tuple(args[0].shape)} "
                                 f"input: max |d| {e:.3g}")
        err = max(err, e)
    lib_in = [(x + b.to(x.dtype)[:, None, None], s.to(x.dtype), t.to(x.dtype))
              for x, b, s, t in calls]
    ms = cuda_ms(lambda: [bias_gn_relu(*a, groups=GN_GROUPS) for a in calls], 5)
    plain_ms = cuda_ms(lambda: [bias_gn_relu_plain(*a, groups=GN_GROUPS)
                                for a in calls], 3)
    lib_ms = cuda_ms(lambda: [F.group_norm(x, GN_GROUPS, s, t, 1e-5)
                              for x, s, t in lib_in], 5)
    p3 = calls[0]
    p3_ms = cuda_ms(lambda: bias_gn_relu(*p3, groups=GN_GROUPS))
    p3_bound, _ = gn_bound_ms([p3])
    bound, bound_by = gn_bound_ms(calls)
    levels = gn_levels(
        calls, "fwd", lambda a: bias_gn_relu(*a, groups=GN_GROUPS),
        lambda a: gn_bound_ms([a])[0],
        lambda i: F.group_norm(lib_in[i][0], GN_GROUPS, *lib_in[i][1:], 1e-5))
    print(f"gn on the fcos main path: {len(calls)} calls, kernel {ms:.4f} ms "
          f"summed (bound {bound:.4f} ms by {bound_by}), plain {plain_ms:.3f} "
          f"ms, F.group_norm {lib_ms:.4f} ms; the P3 call "
          f"{tuple(p3[0].shape)} alone {p3_ms:.4f} ms (bound "
          f"{p3_bound:.4f} ms); one call a level (kernel / bound / "
          f"F.group_norm ms): {level_text(levels)}", flush=True)
    return {
        "name": "bias_gn_relu", "route": "cuda",
        "source": "mydetection_tpu_torch/kernels/csrc/gn.cu",
        "replaces": "mydetection_tpu/ops/pallas/gn_kernel.py:59",
        "launches": captured["launches"]["bias_gn_relu"], "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
        "bound_by": bound_by, "library_ms": lib_ms,
        "p3_ms": p3_ms, "p3_bound_ms": p3_bound, "levels": levels,
        "note": "times sum the 40 calls of one forward; levels time one "
                "call of each level; library_ms is F.group_norm on "
                "x + bias, which leaves out the bias add and the ReLU",
    }


def rotated_row(captured: dict) -> dict:
    """The suppress kernel at the rapid main path's own inputs: batch 32,
    and the first image alone (B = 1)."""
    from mydetection_tpu_torch.kernels.nms import plan_for
    from mydetection_tpu_torch.kernels.rotated_nms import (
        nms_from_iou_keep,
        nms_from_iou_keep_plain,
    )

    iou, valid = captured["iou"], captured["valid"]
    keep = nms_from_iou_keep(iou, valid, IOU_THRES)
    plain = nms_from_iou_keep_plain(iou, valid, IOU_THRES)
    err = float((keep.float() - plain.float()).abs().max())
    if err:
        raise AssertionError("suppress kernel and plain keep-masks differ on "
                             "the rapid main path's inputs")
    i1, v1 = iou[:1].contiguous(), valid[:1].contiguous()
    if not torch.equal(nms_from_iou_keep(i1, v1, IOU_THRES), plain[:1]):
        raise AssertionError("suppress kernel at B=1 differs from plain")
    bound, bound_by, dense = rotated_nms_bound_ms(iou, valid, keep)
    row = {
        "name": "nms_from_iou_keep", "route": "cuda",
        "source": "mydetection_tpu_torch/kernels/csrc/rotated_nms.cu",
        "replaces": "mydetection_tpu/ops/pallas/rotated_nms_kernel.py:36",
        "launches": captured["launches"]["nms_from_iou_keep"],
        "max_abs_err": err,
        "ms": cuda_ms(lambda: nms_from_iou_keep(iou, valid, IOU_THRES)),
        "plain_ms": cuda_ms(lambda: nms_from_iou_keep_plain(iou, valid,
                                                            IOU_THRES), 3),
        "bound_ms": bound, "bound_by": bound_by, "library_ms": None,
        "dense_read_ms": dense,
        "ms_b1": cuda_ms(lambda: nms_from_iou_keep(i1, v1, IOU_THRES)),
        "bound_ms_b1": rotated_nms_bound_ms(i1, v1, keep[:1])[0],
        "valid": int(valid.sum()), "kept": int(keep.sum()),
        "plan": plan_dict(plan_for(valid, box_floats=0)),
        "plan_b1": plan_dict(plan_for(v1, box_floats=0)),
        "note": "no single PyTorch call computes greedy NMS from an IoU "
                "matrix; bound_ms counts the entries greedy consults on "
                "these inputs, dense_read_ms every entry of the matrix; "
                "ms_b1 is the first image alone",
    }
    print(f"rotated on the rapid main path: {row['kept']} kept of "
          f"{row['valid']} valid (per image {keep.sum(1).tolist()}), "
          f"bit-equal; kernel {row['ms']:.4f} ms "
          f"(bound {bound:.6f} ms by {bound_by}, the whole matrix read once "
          f"{dense:.4f} ms; {plan_text(plan_for(valid, box_floats=0))}), B=1 "
          f"{row['ms_b1']:.4f} ms "
          f"({plan_text(plan_for(v1, box_floats=0))}), plain "
          f"{row['plain_ms']:.3f} ms", flush=True)
    return row


def tower_bound_ms(calls) -> tuple[float, str]:
    """Least time for these conv3x3_chain calls (args x, packed,
    biases): 2·B·H·W·9·C·C multiply-adds a layer over the bf16 tensor
    rate, against x read, the output written, the packed weights and
    the biases read once over HBM rate."""
    ops = nbytes = 0
    for x, packed, biases in calls:
        b, c, h, w = x.shape
        ops += 2 * b * h * w * packed.shape[1] * c * packed.shape[0]
        nbytes += (2 * x.numel() * x.element_size()
                   + packed.numel() * packed.element_size() + biases.numel() * 4)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / BF16_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


@torch.no_grad()
def tower_row(captured: dict) -> dict:
    """The conv chain at the retinanet main path's own inputs: the 10
    calls of one forward (2 subnets x 5 levels), summed, the first P3
    call alone, and one subnet's five levels (P3 to P7) each against
    its bound and cuDNN."""
    import torch.nn.functional as F

    from mydetection_tpu_torch.kernels.tower import (
        conv3x3_chain,
        conv3x3_chain_plain,
        unpack_weights,
    )

    calls = captured["chain"]
    err = 0.0
    for args in calls:
        got, again = conv3x3_chain(*args), conv3x3_chain(*args)
        e, ok = tower_error(got, conv3x3_chain_plain(*args))
        if not ok or not torch.equal(got, again):
            raise AssertionError(f"conv3x3_chain outside its gate of plain, or "
                                 f"not bit-reproducible, on the main path's "
                                 f"{tuple(args[0].shape)} input: {e:.3g}")
        err = max(err, e)
    # the library yardstick: per layer one cuDNN conv with its bias, then
    # an in-place ReLU, bf16 channels_last
    lib_in = [(x, [(wt.contiguous(), b.to(x.dtype))
                   for wt, b in zip(unpack_weights(p), bs)])
              for x, p, bs in calls]

    def library(inputs):
        for x, layers in inputs:
            for wt, b in layers:
                x = F.conv2d(x, wt, b, padding=1).relu_()

    ms = cuda_ms(lambda: [conv3x3_chain(*a) for a in calls], 5)
    plain_ms = cuda_ms(lambda: [conv3x3_chain_plain(*a) for a in calls], 5)
    lib_ms = cuda_ms(lambda: library(lib_in), 5)
    p3 = calls[0]
    p3_ms = cuda_ms(lambda: conv3x3_chain(*p3), 10)
    p3_bound, _ = tower_bound_ms([p3])
    bound, bound_by = tower_bound_ms(calls)
    # the head runs cls then box at each level: calls[0::2] is one subnet
    levels = [{"shape": list(a[0].shape),
               "ms": cuda_ms(lambda: conv3x3_chain(*a), 10),
               "bound_ms": tower_bound_ms([a])[0],
               "library_ms": cuda_ms(lambda: library([li]), 10)}
              for a, li in zip(calls[0::2], lib_in[0::2])]
    print(f"tower on the retinanet main path: {len(calls)} calls, kernel "
          f"{ms:.4f} ms summed (bound {bound:.4f} ms by {bound_by}), plain "
          f"{plain_ms:.4f} ms, cuDNN conv+bias+relu_ {lib_ms:.4f} ms; the P3 "
          f"call {tuple(p3[0].shape)} alone {p3_ms:.4f} ms (bound "
          f"{p3_bound:.4f} ms); max-scaled |d| {err:.3g}, bit-reproducible; "
          f"one subnet by level (kernel / bound / cuDNN ms): "
          + ", ".join(f"{lv['shape'][2]}x{lv['shape'][3]} {lv['ms']:.4f} / "
                      f"{lv['bound_ms']:.4f} / {lv['library_ms']:.4f}"
                      for lv in levels), flush=True)
    return {
        "name": "conv3x3_chain", "route": "cuda",
        "source": "mydetection_tpu_torch/kernels/csrc/tower.cu",
        "replaces": "mydetection_tpu/ops/pallas/tower_kernel.py:46",
        "launches": captured["launches"]["conv3x3_chain"], "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
        "bound_by": bound_by, "library_ms": lib_ms,
        "p3_ms": p3_ms, "p3_bound_ms": p3_bound, "levels": levels,
        "note": "times sum the 10 calls of one retinanet-608 batch-32 bf16 "
                "forward (4 layers each); levels are one subnet's five "
                "calls, P3 to P7; max_abs_err is max-scaled against the "
                "plain version; library_ms is per layer F.conv2d with its "
                "bias on cuDNN then relu_",
    }


def gather_bound_ms(src: torch.Tensor, sel: torch.Tensor) -> tuple[float, str]:
    """Least time for the gather: each selected row read once and written
    once, the indices read once, over HBM rate (no arithmetic)."""
    b, k = sel.shape
    nbytes = 2 * b * k * src.shape[-1] * src.element_size() \
        + sel.numel() * sel.element_size()
    return nbytes / HBM_BYTES_PER_S * 1e3, "bytes"


def gather_row(captured: dict) -> dict:
    """The row gather at the retinanet main path's own inputs."""
    from mydetection_tpu_torch.kernels.gather import gather_rows, gather_rows_plain
    from mydetection_tpu_torch.ops.nms import _rows

    src, sel = captured["gather"]
    got = gather_rows(src, sel)
    if not torch.equal(got, gather_rows_plain(src, sel)):
        raise AssertionError("gather_rows differs from plain on the main "
                             "path's inputs")
    bound, bound_by = gather_bound_ms(src, sel)
    row = {
        "name": "gather_rows", "route": "cuda",
        "source": "mydetection_tpu_torch/kernels/csrc/gather.cu",
        "replaces": "benchmarks/gather_experiments.py:69",
        "launches": captured["launches"]["gather_rows"], "max_abs_err": 0.0,
        "ms": cuda_ms(lambda: gather_rows(src, sel), 50),
        "plain_ms": cuda_ms(lambda: gather_rows_plain(src, sel), 50),
        "bound_ms": bound, "bound_by": bound_by,
        "library_ms": cuda_ms(lambda: _rows(src, sel), 50),
        "note": "the class-logit rows of the stage-1 boxes of one "
                "retinanet-608 batch-32 bf16 postprocess; library_ms is "
                "torch.gather through ops/nms.py::_rows",
    }
    print(f"gather on the retinanet main path: {tuple(src.shape)} "
          f"{src.dtype} by {tuple(sel.shape)} {sel.dtype}, bit-equal; kernel "
          f"{row['ms']:.4f} ms (bound {bound:.5f} ms by {bound_by}), plain "
          f"{row['plain_ms']:.4f} ms, torch.gather {row['library_ms']:.4f} ms",
          flush=True)
    return row


def bottleneck_bound_ms(calls) -> tuple[float, str]:
    """Least time for these fused_bottleneck calls (args x, folded):
    2·B·H·W·(c_in·c_mid + 9·c_mid² + c_mid·c_out [+ c_in·c_out]) a block
    over the tensor rate of x's dtype (bf16, else fp32), against x read
    and the output written once, the folded weights and biases read
    once, over HBM rate."""
    ops = nbytes = 0
    for x, f in calls:
        b, c_in, h, w = x.shape
        c_mid, c_out = f[0].shape[1], f[4].shape[1]
        k = c_in * c_mid + 9 * c_mid * c_mid + c_mid * c_out
        if f[6] is not None:
            k += c_in * c_out
        ops += 2 * b * h * w * k
        nbytes += (x.numel() + b * h * w * c_out) * x.element_size() + sum(
            t.numel() * t.element_size() for t in f if t is not None)
    rate = BF16_OPS_PER_S if calls[0][0].dtype == torch.bfloat16 \
        else FP32_OPS_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / rate * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


@torch.no_grad()
def bottleneck_row(captured: dict) -> dict:
    """The fused bottleneck at a main path's own inputs: the 6 calls of
    one forward, summed, and the largest call alone; the library
    yardstick is the same blocks unfused on cuDNN (conv, BN, ReLU, the
    shortcut, the add, in bf16)."""
    from mydetection_tpu_torch.kernels.bottleneck import (
        fused_bottleneck,
        fused_bottleneck_plain,
    )

    calls, blocks = captured["bottleneck"], captured["blocks"]
    err = 0.0
    for x, f in calls:
        got, again = fused_bottleneck(x, *f), fused_bottleneck(x, *f)
        e, ok = bottleneck_error(got, fused_bottleneck_plain(x, *f))
        if not ok or not torch.equal(got, again):
            raise AssertionError(f"fused_bottleneck outside its gate of "
                                 f"plain, or not bit-reproducible, on the "
                                 f"main path's {tuple(x.shape)} input: "
                                 f"{e:.3g}")
        err = max(err, e)
    ms = cuda_ms(lambda: [fused_bottleneck(x, *f) for x, f in calls], 5)
    each = [cuda_ms(lambda: fused_bottleneck(x, *f), 10) for x, f in calls]
    plain_ms = cuda_ms(lambda: [fused_bottleneck_plain(x, *f)
                                for x, f in calls], 3)
    lib_ms = cuda_ms(lambda: [blk.unfused(x) for blk, (x, _)
                              in zip(blocks, calls)], 5)
    big = int(np.argmax(each))
    big_bound, _ = bottleneck_bound_ms([calls[big]])
    bound, bound_by = bottleneck_bound_ms(calls)
    per_call = [{"shape": list(x.shape) + [f[4].shape[1], f[0].shape[1]],
                 "ms": t, "bound_ms": bottleneck_bound_ms([(x, f)])[0],
                 "library_ms": cuda_ms(lambda: blk.unfused(x), 10)}
                for (x, f), t, blk in zip(calls, each, blocks)]
    print(f"bottleneck on the retinanet main path: {len(calls)} calls, "
          f"kernel {ms:.4f} ms summed (bound {bound:.4f} ms by {bound_by}), "
          f"the largest {each[big]:.4f} ms (bound {big_bound:.4f}), plain "
          f"{plain_ms:.4f} ms, cuDNN unfused blocks {lib_ms:.4f} ms; "
          f"max-scaled |d| {err:.3g}, bit-reproducible; by call ((B, c_in, "
          f"H, W) -> c_out, c_mid: kernel / bound / cuDNN ms): "
          + ", ".join(f"{tuple(c['shape'][:4])} -> {c['shape'][4]}, "
                      f"{c['shape'][5]}: {c['ms']:.4f} / {c['bound_ms']:.4f} "
                      f"/ {c['library_ms']:.4f}" for c in per_call),
          flush=True)
    return {
        "name": "fused_bottleneck", "route": "cuda",
        "source": "mydetection_tpu_torch/kernels/csrc/bottleneck.cu",
        "replaces": "benchmarks/resnet_stage_experiments.py:76",
        "launches": captured["launches"]["fused_bottleneck"],
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound, "bound_by": bound_by, "library_ms": lib_ms,
        "largest_ms": each[big], "largest_bound_ms": big_bound,
        "calls": per_call,
        "note": "times sum the 6 calls of one retinanet-608 batch-32 bf16 "
                "forward (stage 0 and stage 1's blocks 1-3); calls are the "
                "six alone, shape (B, c_in, H, W, c_out, c_mid); "
                "max_abs_err is max-scaled against the plain version; "
                "library_ms is the same blocks unfused on cuDNN (conv, BN, "
                "ReLU, shortcut, add)",
    }


def kernel_device_ns(fn, reps: int) -> list[int]:
    """`fn()` once, then `reps` times under the profiler: the device ns
    of each kernel it launched, in launch order."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return [d for _, d in sorted(
        (e.start_ns(), e.duration_ns())
        for e in prof.profiler.kineto_results.events()
        if e.device_type() == torch.autograd.DeviceType.CUDA)]


def epilogue_bytes(args) -> int:
    """A conv_epilogue call's least traffic: x read and the output
    written once, the residual read (the per-channel vectors, a few KB,
    left out)."""
    x, residual = args[0], args[5]
    return x.numel() * x.element_size() * (2 if residual is None else 3)


def epilogue_row(captured: dict, path: str) -> dict:
    """The conv epilogue at a main path's own inputs: every call of one
    batch-32 forward, each bit-equal to its plain version (the eager
    ops) and to what the forward got; device time summed a forward by
    the profiler (CUDA events would time the host's pace: a small call's
    launch takes longer than its kernel), beside the bound and the plain
    version's, and each map's share of the HBM rate."""
    from mydetection_tpu_torch.kernels.epilogue import (
        conv_epilogue,
        conv_epilogue_plain,
    )

    calls = captured["epilogue"]
    reps = 5
    with torch.inference_mode():
        for args, out in calls:
            want = conv_epilogue_plain(*args)
            if not (torch.equal(out, want)
                    and torch.equal(conv_epilogue(*args), want)):
                raise AssertionError(f"conv_epilogue differs from its plain "
                                     f"version on {path}'s "
                                     f"{tuple(args[0].shape)} call")
        kernel = kernel_device_ns(
            lambda: [conv_epilogue(*a) for a, _ in calls], reps)
        plain = kernel_device_ns(
            lambda: [conv_epilogue_plain(*a) for a, _ in calls], reps)
    if len(kernel) != reps * len(calls):
        raise AssertionError(f"{path}: {len(kernel)} device kernels for "
                             f"{reps} x {len(calls)} conv_epilogue calls")
    shares: dict[str, list[float]] = {}
    for i, (args, _) in enumerate(calls):
        x = args[0]
        key = (f"{x.shape[1]}x{x.shape[2]}x{x.shape[3]}"
               f"{'+res' if args[5] is not None else ''}")
        ms = np.mean(kernel[i::len(calls)]) / 1e6
        shares.setdefault(key, []).append(
            epilogue_bytes(args) / HBM_BYTES_PER_S * 1e3 / ms)
    bound = sum(epilogue_bytes(a) for a, _ in calls) / HBM_BYTES_PER_S * 1e3
    row = {
        "name": "conv_epilogue", "route": "cuda", "path": path,
        "source": "mydetection_tpu_torch/kernels/csrc/epilogue.cu",
        "replaces": None, "launches": captured["launches"]["conv_epilogue"],
        "max_abs_err": 0.0, "ms": sum(kernel) / 1e6 / reps,
        "plain_ms": sum(plain) / 1e6 / reps, "bound_ms": bound,
        "bound_by": "bytes", "library_ms": None,
        "hbm_share_by_map": {k: round(100 * float(np.mean(v)), 1)
                             for k, v in shares.items()},
        "note": f"profiler device time of the {len(calls)} calls of one "
                f"{path} batch-32 bf16 forward, summed, each bit-equal to "
                "the plain version (the eager ops); replaces no TPU kernel "
                "(XLA fuses a conv's epilogue into the conv); library_ms "
                "none: no single PyTorch call computes BN, the activation "
                "and the residual; hbm_share_by_map is each map's (C x H x "
                "W) bound over its mean device time",
    }
    print(f"conv epilogue on the {path} main path: {len(calls)} calls, "
          f"bit-equal to plain; kernel {row['ms']:.4f} ms summed (bound "
          f"{bound:.4f} ms by bytes, {100 * bound / row['ms']:.1f}%), plain "
          f"{row['plain_ms']:.4f} ms; share of HBM by map (%): "
          f"{row['hbm_share_by_map']}", flush=True)
    return row


def train_step_gn_inputs(step, data, lr: float) -> dict:
    """Run one train step with the FCOS towers' `BiasGNReLU` swapped for
    a subclass that records what reaches the two trainable GN kernels:
    {"fwd": [(x, bias, scale, shift)] * 40, "bwd": [(x, y, dy, bias,
    scale, mean, inv)] * 40}, dy as autograd handed it over."""
    from mydetection_tpu_torch.kernels.gn import BiasGNReLU
    from mydetection_tpu_torch.models import fcos as fcos_mod

    captured = {"fwd": [], "bwd": []}

    class Recording(BiasGNReLU):
        @staticmethod
        def forward(ctx, x, bias, scale, shift, groups):
            captured["fwd"].append((x, bias, scale, shift))
            return BiasGNReLU.forward(ctx, x, bias, scale, shift, groups)

        @staticmethod
        def backward(ctx, dy):
            x, y, *rest = ctx.saved_tensors
            captured["bwd"].append((x, y, dy, *rest))
            return BiasGNReLU.backward(ctx, dy)

    fcos_mod.BiasGNReLU = Recording
    try:
        step(*data, lr)
    finally:
        fcos_mod.BiasGNReLU = BiasGNReLU
    return captured


def train_main(name: str, size: int, batch: int, smi: str,
               kernel_launches: dict) -> tuple:
    """One train main path: `name` at full width and depth, bf16, `size`²
    at `batch`, `make_train_step` with `burn_in_lr`, on a synthetic
    batch. Every step's launch counts are reset just before it and read
    just after, and must be `kernel_launches` (every other kernel none);
    TRAIN_WARMUP steps, then TRAIN_TIMED timed ones, each split by CUDA
    events into host (the batch to the card), forward, backward and
    optimizer; peak memory over the timed steps. Prints the line and
    returns (step, data, launches of the last step)."""
    from mydetection_tpu_torch import kernels
    from mydetection_tpu_torch.models.layers import init_weights
    from mydetection_tpu_torch.registry import get_model
    from mydetection_tpu_torch.training import burn_in_lr, make_train_step

    model = get_model(name, input_size=size)            # bf16, all classes
    init_weights(model, 0)
    step = make_train_step(model, input_size=size)
    data = train_batch(2, batch, size, model.config.num_classes,
                       rotated=model.config.rotated)
    want = {fn.__name__: 0 for fn in kernels.KERNELS}
    want.update(kernel_launches)
    lat, dev, totals = [], [], []
    for i in range(TRAIN_WARMUP + TRAIN_TIMED):
        if i == TRAIN_WARMUP:
            torch.cuda.reset_peak_memory_stats()
        lr = burn_in_lr(i + 1, base_lr=0.01)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        ev[0].record()
        args = step.batch(*data)
        ev[1].record()
        terms = step.forward(*args)
        ev[2].record()
        grads = step.backward(terms)
        ev[3].record()
        step.update(grads, lr)
        ev[4].record()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        launches = {fn.__name__: fn.launches for fn in kernels.KERNELS}
        if launches != want:
            raise AssertionError(f"{name} train step {i} launched "
                                 f"{launches}, expected {want}")
        vals = {k: float(v.detach()) for k, v in terms.items()}
        if not all(np.isfinite(v) for v in vals.values()):
            raise AssertionError(f"{name} train step {i} loss terms {vals}")
        totals.append(vals["total"])
        if i >= TRAIN_WARMUP:
            lat.append(t1 - t0)
            dev.append([ev[j].elapsed_time(ev[j + 1]) for j in range(4)])
        del args, terms, grads
    peak = torch.cuda.max_memory_allocated()
    clocks = smi_line("clocks.sm,power.draw,temperature.gpu")
    med = float(np.median(lat))
    split = np.median(np.array(dev), axis=0)
    ran = {k: v for k, v in launches.items() if v}
    print(f"train main: {name}-{size} bf16 batch {batch}, make_train_step "
          f"with burn_in_lr, {TRAIN_WARMUP} warm-up + {TRAIN_TIMED} timed "
          f"steps, kernel launches per step {ran or 'none'}, losses finite "
          f"(total {[round(v, 4) for v in totals]}); step latency median "
          f"{med * 1e3:.2f} ms (min {min(lat) * 1e3:.2f}, max "
          f"{max(lat) * 1e3:.2f}), {batch / med:.1f} img/s; device "
          f"(medians) host {split[0]:.2f} ms, forward {split[1]:.2f} ms, "
          f"backward {split[2]:.2f} ms, optimizer {split[3]:.2f} ms; peak "
          f"memory allocated {peak / 2**30:.2f} GiB; on {smi} (sm clock, "
          f"power, temp after: {clocks})", flush=True)
    return step, data, launches, batch / med


def phase_train_main(smi: str) -> dict:
    """The fcos-608 train main path at batch TRAIN_BATCH (the GN
    forward-with-statistics and backward kernels 40 each a step), then
    one more step that captures both kernels' inputs. Returns the
    capture, {"fwd": [...], "bwd": [...], "launches", "img_per_s"}."""
    from mydetection_tpu_torch.training import burn_in_lr

    step, data, launches, rate = train_main(
        "fcos", 608, TRAIN_BATCH, smi,
        {"bias_gn_relu_fwd_stats": 40, "bias_gn_relu_bwd": 40})
    captured = train_step_gn_inputs(
        step, data, burn_in_lr(TRAIN_WARMUP + TRAIN_TIMED + 1, base_lr=0.01))
    captured.update(launches=launches, img_per_s=rate)
    return captured


# ---------------------------------------------------------------------------
# the host data layer and the CLIs, from files
# ---------------------------------------------------------------------------

def read_launches() -> dict:
    from mydetection_tpu_torch import kernels

    return {fn.__name__: fn.launches for fn in kernels.KERNELS}


def check_launches(what: str, launches: dict, want: dict) -> None:
    """Every kernel's count equals `want`'s (absent: 0)."""
    full = {k: want.get(k, 0) for k in launches}
    if launches != full:
        raise AssertionError(f"{what} launched {launches}, expected {full}")


def run_cli(main, args: list[str]) -> tuple[object, str, float]:
    """A CLI's main(args) in process with every launch count reset just
    before: (its result, its stdout, wall seconds). The output is
    printed after the run, indented."""
    from mydetection_tpu_torch import kernels

    buf = io.StringIO()
    kernels.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        result = main(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out = buf.getvalue()
    print("  | " + "\n  | ".join(out.strip().splitlines()[-4:]), flush=True)
    return result, out, wall


def phase_data(root: str, smi: str) -> dict:
    """Write the synthetic set; report the decoder StreamingPipeline
    picks (the port's native library, or its build error and PIL); hold
    the native first batch against the PIL path's; then the pipeline's
    img/s alone (416, batch 32, 4 threads, with the copy to the card)
    and TrainLoader's (batch 16, sizes 320/416/512 drawn every batch,
    augmentation on, epoch 0 twice, bit for bit)."""
    from mydetection_tpu_torch import native
    from mydetection_tpu_torch.data.coco import CocoDataset
    from mydetection_tpu_torch.data.loader import StreamingPipeline, TrainLoader

    t0 = time.perf_counter()
    ann, rot_ann = write_coco_set(root)
    t_write = time.perf_counter() - t0
    with open(ann) as fh:
        paths = [os.path.join(root, im["file_name"])
                 for im in json.load(fh)["images"]]
    pipe = StreamingPipeline(paths, input_size=416, batch_size=BATCH,
                             num_threads=4)
    if pipe.decoder == "native":
        nat = next(iter(pipe))[0]
        pil = next(iter(StreamingPipeline(paths, input_size=416,
                                          batch_size=BATCH, num_threads=4,
                                          native=False)))[0]
        diff = (nat.int() - pil.int()).abs()
        worst, mean = int(diff.max()), float(diff.float().mean())
        if worst > NATIVE_MAX_LSB or mean >= NATIVE_MEAN_LSB:
            raise AssertionError(f"native decode vs PIL: max {worst} LSB, "
                                 f"mean {mean:.4f} (gates {NATIVE_MAX_LSB}, "
                                 f"< {NATIVE_MEAN_LSB})")
        decoder = (f"native ({native.library_path().name}); first batch vs "
                   f"PIL: max {worst} LSB, mean {mean:.4f}")
    else:
        decoder = ("PIL; the native library did not build: "
                   + " ".join((native.build_error() or "").split())[-300:])

    def pipe_pass() -> int:
        n = sum(len(infos) for _, infos, _ in pipe)
        torch.cuda.synchronize()
        return n

    pipe_pass()                                    # warm: page cache, pinned pool
    t0 = time.perf_counter()
    n = pipe_pass()
    pipe_rate = n / (time.perf_counter() - t0)

    loader = TrainLoader(CocoDataset(ann, root), batch_size=TRAIN_BATCH,
                         sizes=(320, 416, 512), num_threads=4, rescale_every=1)
    passes = []
    for _ in range(2):
        t0 = time.perf_counter()
        batches = list(loader.epoch(0))
        torch.cuda.synchronize()
        passes.append((time.perf_counter() - t0, batches))
    (dt0, a), (dt1, b) = passes
    same = len(a) == len(b) and all(
        torch.equal(x[0], y[0]) and x[4] == y[4]
        and all(np.array_equal(u, v) for u, v in zip(x[1:4], y[1:4]))
        for x, y in zip(a, b))
    if not same or a[0][0].device.type != loader.device.type:
        raise AssertionError("TrainLoader: two passes over epoch 0 differ, or "
                             "the images are not on the card")
    n_img = len(a) * TRAIN_BATCH
    loader_rate = n_img / min(dt0, dt1)
    print(f"data: {DATA_IMAGES} JPEGs written in {t_write:.2f} s; decoder "
          f"{decoder}; StreamingPipeline alone 416 batch {BATCH} 4 threads "
          f"(to the card, pinned): {pipe_rate:.1f} img/s; TrainLoader alone "
          f"batch {TRAIN_BATCH} sizes {sorted({x[4] for x in a})} "
          f"augmented, epoch 0 ({n_img} images) twice bit for bit: "
          f"{n_img / dt0:.1f} and {n_img / dt1:.1f} img/s; on {smi}",
          flush=True)
    return {"root": root, "ann": ann, "rot_ann": rot_ann,
            "pipe_img_per_s": pipe_rate, "loader_img_per_s": loader_rate}


def _seconds(out: str, what: str) -> float:
    m = re.search(rf"{what}: .*?([0-9.]+)s", out)
    return float(m.group(1)) if m else float("nan")


def rows_to_detections(rows: list[dict], ids) -> list:
    """COCO result rows → one `Detections` per image id (xyxy boxes,
    category ids as classes)."""
    from mydetection_tpu_torch.api import Detections

    out = []
    for img_id in ids:
        mine = [r for r in rows if r["image_id"] == img_id]
        xywh = np.asarray([r["bbox"] for r in mine], np.float64).reshape(-1, 4)
        out.append(Detections(
            boxes_xyxy=np.concatenate([xywh[:, :2], xywh[:, :2] + xywh[:, 2:]],
                                      axis=1),
            scores=np.asarray([r["score"] for r in mine], np.float32),
            classes=np.asarray([r["category_id"] for r in mine], np.int32)))
    return out


def nearest_text(gpu, cpu) -> str:
    """For a failed match: the counts, and the largest distance from a
    card detection to its nearest CPU one of its class (box px, score)."""
    worst_box = worst_score = 0.0
    for box, score, cls in zip(gpu.boxes_xyxy, gpu.scores, gpu.classes):
        same = cpu.classes == cls
        if not same.any():
            return f"{len(gpu)} card, {len(cpu)} CPU rows; class {cls} only on the card"
        db = np.abs(cpu.boxes_xyxy[same] - box[None]).max(axis=1)
        j = int(np.argmin(db))
        worst_box = max(worst_box, float(db[j]))
        worst_score = max(worst_score, abs(float(cpu.scores[same][j] - score)))
    return (f"{len(gpu)} card, {len(cpu)} CPU rows; nearest of its class at "
            f"most {worst_box:.4g} px, score {worst_score:.3g}")


def phase_evaluate(data: dict, smi: str) -> None:
    """The evaluate CLI in process, bf16, on the synthetic set: each of
    EVAL_MAINS with its kernels' launch counts (per batch, times the
    batches), stats all finite; then yolov3-416 float32 (TF32 off) on
    EVAL_F32_IMAGES images on the card against `--device cpu` from one
    seeded .npz: rows matched one to one and tie-aware under the parity
    gates (`match_detections`), every stat within EVAL_AP_GATE; the
    conv kernels scaled by EVAL_F32_SCALE, so the scores spread out
    (0.48-0.67 on these images, not all 1.0), at EVAL_F32_CONF."""
    from mydetection_tpu_torch import Detector, evaluate
    from mydetection_tpu_torch.checkpoint import save_checkpoint
    from mydetection_tpu_torch.convert import model_tree

    root = data["root"]
    for name, size, batch, rotated, per_batch in EVAL_MAINS:
        args = ["--model", name, "--img-dir", root, "--input-size", str(size),
                "--batch-size", str(batch),
                "--ann", data["rot_ann"] if rotated else data["ann"]]
        runs = []
        for _ in range(2):      # the first pays the path's first launches
            stats, out, wall = run_cli(evaluate.main, args + (
                ["--rotated"] if rotated else []))
            launches = read_launches()
            batches = -(-DATA_IMAGES // batch)
            check_launches(f"evaluate {name}", launches,
                           {k: v * batches for k, v in per_batch.items()})
            if not all(np.isfinite(v) for v in stats.values()):
                raise AssertionError(f"evaluate {name}: stats {stats}")
            runs.append((_seconds(out, "inference"), _seconds(out, "scoring"),
                         wall))
        (cold, _, _), (warm, score, wall) = runs
        ran = {k: v for k, v in launches.items() if v}
        print(f"evaluate: {name}-{size} bf16 batch {batch} "
              f"({batches} batches, {DATA_IMAGES} images), twice: inference "
              f"{cold:.3f} s ({DATA_IMAGES / cold:.1f} img/s) the first time, "
              f"{warm:.3f} s ({DATA_IMAGES / warm:.1f} img/s) the second; "
              f"the evaluator's scoring {score:.3f} s, main() {wall:.2f} s; "
              f"launches each {ran}; AP {stats['AP']:.4f}, AP50 "
              f"{stats['AP50']:.4f}; on {smi}", flush=True)

    # conv kernels scaled by EVAL_F32_SCALE: at the seeded init every
    # score is 1.0, so which of the tied rows make the top 100 turns on
    # float32 rounding
    npz = os.path.join(root, "yolov3_seeded.npz")
    seeded = Detector("yolov3", num_classes=len(DATA_CATEGORIES), device="cpu",
                      rng_seed=0)
    with torch.no_grad():
        for p in seeded.model.parameters():
            if p.dim() == 4:
                p.mul_(EVAL_F32_SCALE)
    save_checkpoint(npz, model_tree(seeded.model))
    args = ["--model", "yolov3", "--weights", npz, "--ann", data["ann"],
            "--img-dir", root, "--input-size", "416", "--batch-size",
            str(EVAL_F32_IMAGES), "--max-images", str(EVAL_F32_IMAGES),
            "--conf-thres", str(EVAL_F32_CONF), "--float32"]
    runs = {}
    for device in ("cuda", "cpu"):
        out_json = os.path.join(root, f"f32_{device}.json")
        stats, _, wall = run_cli(evaluate.main, args + [
            "--device", device, "--out", out_json])
        with open(out_json) as fh:
            runs[device] = (stats, json.load(fh), wall)
    (g_stats, g_rows, g_wall), (c_stats, c_rows, c_wall) = \
        runs["cuda"], runs["cpu"]
    if not c_rows:
        raise AssertionError("evaluate float32: no detection to compare")
    ids = range(EVAL_F32_IMAGES)
    for i, g, c in zip(ids, rows_to_detections(g_rows, ids),
                       rows_to_detections(c_rows, ids)):
        if len(g) != len(c) or not match_detections(g, c, PARITY_BOX_GATE):
            raise AssertionError(f"evaluate float32: image {i}: card rows do "
                                 f"not match the CPU's one to one: "
                                 f"{nearest_text(g, c)}")
    worst = max(abs(g_stats[k] - c_stats[k]) for k in c_stats)
    if worst > EVAL_AP_GATE:
        raise AssertionError(f"evaluate float32: card stats {g_stats}, CPU "
                             f"{c_stats}")
    print(f"evaluate f32: yolov3-416 float32, TF32 off, {EVAL_F32_IMAGES} "
          f"images at conf {EVAL_F32_CONF}, card against --device cpu from "
          f"one seeded .npz (conv kernels x {EVAL_F32_SCALE}): "
          f"{len(g_rows)} rows matched one to one (scores within "
          f"{PARITY_SCORE_GATE}, boxes {PARITY_BOX_GATE} px), stats within "
          f"{worst:.3g} (gate {EVAL_AP_GATE}); main() {g_wall:.2f} s on the "
          f"card, {c_wall:.2f} s on the CPU", flush=True)


def phase_evaluate_quant(data: dict, smi: str) -> None:
    """The evaluate CLI's int8 path on the synthetic set, bf16: each of
    EVAL_QUANT_MAINS once with `--quantized --calib-images
    EVAL_CALIB_IMAGES`, its kernels' launch counts (per batch, times the
    batches; fcos also the calibration walk's 40 GN launches), every
    stat finite."""
    from mydetection_tpu_torch import evaluate

    root = data["root"]
    for name, size, batch, rotated, per_batch in EVAL_QUANT_MAINS:
        args = ["--model", name, "--img-dir", root, "--input-size", str(size),
                "--batch-size", str(batch), "--quantized", "--calib-images",
                str(EVAL_CALIB_IMAGES),
                "--ann", data["rot_ann"] if rotated else data["ann"]]
        stats, out, wall = run_cli(evaluate.main, args + (
            ["--rotated"] if rotated else []))
        batches = -(-DATA_IMAGES // batch)
        want = {k: v * batches for k, v in per_batch.items()}
        if name == "fcos":      # the calibration walk's towers
            want["bias_gn_relu"] += 40
        want["conv_epilogue"] += per_batch["conv_epilogue"]   # its prologue
        launches = read_launches()
        check_launches(f"evaluate --quantized {name}", launches, want)
        if not all(np.isfinite(v) for v in stats.values()):
            raise AssertionError(f"evaluate --quantized {name}: {stats}")
        infer = _seconds(out, "inference")
        print(f"evaluate int8: {name}-{size} --quantized --calib-images "
              f"{EVAL_CALIB_IMAGES} batch {batch}: inference {infer:.3f} s "
              f"({DATA_IMAGES / infer:.1f} img/s), main() {wall:.2f} s "
              f"(calibration included); launches "
              f"{ {k: v for k, v in launches.items() if v} }; AP "
              f"{stats['AP']:.4f}, AP50 {stats['AP50']:.4f}; on {smi}",
              flush=True)


def _metrics(ckpt_dir: str, name: str) -> list[dict]:
    with open(os.path.join(ckpt_dir, f"{name}_metrics.jsonl")) as fh:
        return [json.loads(line) for line in fh]


def phase_train_cli(data: dict, smi: str, synthetic: dict) -> None:
    """The train CLI in process on the synthetic set: yolov3 at the
    default buckets (320, 416, 512), batch 16, TRAIN_CLI_ITERS
    iterations with checkpoints every 20 and validation at the end
    (its NMS launch the only kernel launch: the yolov3 step launches
    none); falling loss, finite rows, the TensorBoard file, the
    checkpoints loaded into a Detector; a resume to TRAIN_CLI_RESUMED;
    then fcos at 608, whose steps launch the trainable GN kernels 40
    times each. Each run's img/s beside the synthetic-batch train main
    line of its model (`synthetic`)."""
    from mydetection_tpu_torch import Detector, train
    from mydetection_tpu_torch.utils.tb_writer import read_scalars

    root = data["root"]
    ck, tb = os.path.join(root, "weights"), os.path.join(root, "tb")
    common = ["--ann", data["ann"], "--img-dir", root, "--batch-size",
              str(TRAIN_BATCH), "--lr", str(TRAIN_CLI_LR), "--burn-in",
              str(TRAIN_CLI_BURN_IN)]
    yolo = ["--model", "yolov3", "--ckpt-dir", ck, "--rescale-every", "10",
            "--log-every", "10",
            "--ckpt-every", "20", "--val-every", str(TRAIN_CLI_ITERS),
            "--val-max-images", "32", "--val-ann", data["ann"]]
    last, out, wall = run_cli(train.main, common + yolo + [
        "--iterations", str(TRAIN_CLI_ITERS), "--tensorboard-dir", tb])
    # 32 validation images are one batch: one NMS launch, 75 epilogues
    check_launches("train cli yolov3", read_launches(),
                   {"nms_keep": 1, "conv_epilogue": 75})
    rows = _metrics(ck, "yolov3")
    steps = [r for r in rows if "total" in r]
    vals = [r for r in rows if "val_AP" in r]
    if (last != TRAIN_CLI_ITERS or len(steps) != TRAIN_CLI_ITERS // 10
            or not all(np.isfinite(v) for r in steps for v in r.values())
            or not steps[-1]["total"] < steps[0]["total"]):
        raise AssertionError(f"train cli yolov3: rows {steps}")
    if len(vals) != 1 or not all(np.isfinite(vals[0][k])
                                 for k in ("val_AP", "val_AP50")):
        raise AssertionError(f"train cli yolov3: validation rows {vals}")
    [events] = [f for f in os.listdir(tb) if f.startswith("events.out")]
    if not any(t == "loss/total" for _, t, _ in
               read_scalars(os.path.join(tb, events))):
        raise AssertionError("train cli yolov3: no loss/total in TensorBoard")
    for it in (20, TRAIN_CLI_ITERS):
        Detector("yolov3", weights_path=os.path.join(ck, f"yolov3_{it}.npz"),
                 num_classes=len(DATA_CATEGORIES))
    _, out2, wall2 = run_cli(train.main, common + yolo + [
        "--iterations", str(TRAIN_CLI_RESUMED), "--resume",
        os.path.join(ck, f"yolov3_{TRAIN_CLI_ITERS}.npz")])
    if (f"at iteration {TRAIN_CLI_ITERS}" not in out2 or not os.path.exists(
            os.path.join(ck, f"yolov3_{TRAIN_CLI_RESUMED}.npz"))):
        raise AssertionError("train cli yolov3: the resume did not run")
    rates = [r["img_per_sec"] for r in steps]
    print(f"train cli: yolov3 bf16 batch {TRAIN_BATCH} from files, sizes "
          f"{[r['size'] for r in steps]} (each row's last), lr "
          f"{TRAIN_CLI_LR} burn-in {TRAIN_CLI_BURN_IN}: total "
          f"{[round(r['total'], 3) for r in steps]}, img/s every 10 "
          f"iterations {rates} (synthetic-batch train main at 416: "
          f"{synthetic['yolov3']:.1f}); val AP {vals[0]['val_AP']:.4f} AP50 "
          f"{vals[0]['val_AP50']:.4f}, NMS launched in validation; "
          f"{TRAIN_CLI_ITERS} iterations in {wall:.1f} s; checkpoints 20, "
          f"{TRAIN_CLI_ITERS} loaded into a Detector; resumed at "
          f"{TRAIN_CLI_ITERS} to {TRAIN_CLI_RESUMED} in {wall2:.1f} s; on "
          f"{smi}", flush=True)

    fcos_ck = os.path.join(root, "weights_fcos")
    fcos = ["--model", "fcos", "--ckpt-dir", fcos_ck, "--sizes", "608",
            "--log-every", "3", "--iterations", str(TRAIN_CLI_FCOS_ITERS)]
    _, _, wall = run_cli(train.main, common + fcos)
    per_step = {"bias_gn_relu_fwd_stats": 40, "bias_gn_relu_bwd": 40}
    check_launches("train cli fcos", read_launches(),
                   {k: v * TRAIN_CLI_FCOS_ITERS for k, v in per_step.items()})
    frows = _metrics(fcos_ck, "fcos")
    if not all(np.isfinite(v) for r in frows for v in r.values()):
        raise AssertionError(f"train cli fcos: rows {frows}")
    print(f"train cli: fcos-608 bf16 batch {TRAIN_BATCH} from files, "
          f"{TRAIN_CLI_FCOS_ITERS} iterations in {wall:.1f} s, the GN "
          f"kernels {per_step} a step; total "
          f"{[round(r['total'], 3) for r in frows]}, img/s every 3 "
          f"iterations {[r['img_per_sec'] for r in frows]} (synthetic-batch "
          f"train main: {synthetic['fcos']:.1f}); on {smi}", flush=True)


def dp_devices() -> list:
    """The data-parallel phase's replicas: two on the one card, or one a
    card."""
    n = torch.cuda.device_count()
    return ([torch.device("cuda", i) for i in range(n)] if n > 1
            else [torch.device("cuda", 0)] * 2)


@contextlib.contextmanager
def local_devices_as(devices: list):
    """`parallel.mesh.local_devices` returns `devices` for the duration."""
    from mydetection_tpu_torch.parallel import mesh

    saved = mesh.local_devices
    mesh.local_devices = lambda: list(devices)
    try:
        yield
    finally:
        mesh.local_devices = saved


def timed_steps(step, data, lr: float) -> list[float]:
    """Host-clock seconds of TRAIN_DP_TIMED whole steps after one
    warm-up, each synchronised."""
    out = []
    for i in range(TRAIN_DP_TIMED + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(*data, lr)
        torch.cuda.synchronize()
        if i:
            out.append(time.perf_counter() - t0)
    return out


def dp_pair(size: int, dtype) -> tuple:
    """The one-device fcos train step and the data-parallel one over
    `dp_devices()`, each on its own model from `init_weights(seed 0)`."""
    from mydetection_tpu_torch.models.layers import init_weights
    from mydetection_tpu_torch.parallel.mesh import make_mesh
    from mydetection_tpu_torch.registry import get_model
    from mydetection_tpu_torch.training import make_train_step

    def fcos():
        model = get_model("fcos", input_size=size, compute_dtype=dtype)
        init_weights(model, 0)
        return model

    one = make_train_step(fcos(), input_size=size)
    with local_devices_as(dp_devices()):
        dp = make_train_step(fcos(), input_size=size, mesh=make_mesh())
    return one, dp


def lockstep_us(devices: list, sums: int = 106) -> float:
    """Host µs a cross-replica sum costs under `mesh.lockstep` over
    `devices` (a (256,) float32 tensor a replica, as a BatchNorm's
    channel sums), median of 3 runs of `sums` sums: the fcos forward
    takes 106, two a BatchNorm of its ResNet-50."""
    from mydetection_tpu_torch.parallel import mesh

    def replica(x):
        group, rank = mesh.replica_group()
        for _ in range(sums):
            [x] = group.all_sum(rank, [x])
        return x

    runs = []
    for _ in range(3):
        xs = [torch.ones(256, device=d) for d in devices]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mesh.lockstep(devices, [lambda x=x: replica(x) for x in xs])
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0) / sums * 1e6)
    return float(np.median(runs))


def phase_train_dp(data: dict, smi: str) -> None:
    """The data-parallel fcos-608 train step at batch TRAIN_BATCH over
    `dp_devices()` against the one-device step from the same seeded
    weights and batch: first in float32 with TF32 off, under the
    TRAIN_* gates and TRAIN_DP_BN_GATE; then in bf16, its launches,
    and both steps timed in turn; then the train CLI with
    `--data-parallel` and a resume."""
    from mydetection_tpu_torch import train
    from mydetection_tpu_torch.evaluate import tf32_off
    from mydetection_tpu_torch.training import burn_in_lr

    devices = dp_devices()
    n = len(devices)
    per_step = {"bias_gn_relu_fwd_stats": 40, "bias_gn_relu_bwd": 40}
    size = TRAIN_DP_SIZE
    batch = train_batch(2, TRAIN_BATCH, size, 80)
    with tf32_off("cuda"):
        one, dp = dp_pair(size, torch.float32)
        ref = first_step(one, batch)
        del one
        got = first_step(dp, batch)
    check_launches("train dp step", got["launches"],
                   {k: v * n for k, v in per_step.items()})
    check_launches("train one-device step", ref["launches"], per_step)
    report = compare_train_step(got, ref, "fcos")
    bn = max(max_scaled(got["bufs"][k], v) for k, v in ref["bufs"].items())
    if bn > TRAIN_DP_BN_GATE:
        raise AssertionError(f"train dp: BN running statistics max-scaled "
                             f"{bn:.3g} from the one-device step's")
    states = [list(m.state_dict().values()) for m in dp.replicas]
    if not all(torch.equal(a, b) for other in states[1:]
               for a, b in zip(states[0], other)):
        raise AssertionError("train dp: the replicas differ after the step")
    print(f"train dp: fcos-{size} float32 (TF32 off) batch {TRAIN_BATCH} "
          f"over {n} replicas on {sorted({str(d) for d in devices})}, "
          f"{TRAIN_BATCH // n} images each, against the one-device step "
          f"from the same seeded weights and batch, first step at lr "
          f"{PARITY_LR}: {report}; BN statistics {bn:.3g} (gate "
          f"{TRAIN_DP_BN_GATE}); replicas bit-equal after it; launches "
          f"{got['launches']}", flush=True)
    del dp, ref, got
    torch.cuda.empty_cache()

    one, dp = dp_pair(size, torch.bfloat16)
    ref = first_step(one, batch)
    got = first_step(dp, batch)
    check_launches("train dp step bf16", got["launches"],
                   {k: v * n for k, v in per_step.items()})
    terms = max(abs(got["terms"][k] - v) / abs(v)
                for k, v in ref["terms"].items())
    cos = min(cosine(got["grads"][k], v) for k, v in ref["grads"].items())
    lr = burn_in_lr(TRAIN_WARMUP + TRAIN_TIMED + 1, base_lr=0.01)
    t_one, t_dp = [], []
    for _ in range(2):          # in turn, so both see the same card
        t_one += timed_steps(one, batch, lr)
        t_dp += timed_steps(dp, batch, lr)
    ms_one, ms_dp = np.median(t_one) * 1e3, np.median(t_dp) * 1e3
    print(f"train dp: bf16 batch {TRAIN_BATCH}, launches {got['launches']};"
          f" first step against the one-device step: loss terms within "
          f"{terms:.3g} relative, least gradient cosine {cos:.6f}, relative "
          f"L2 {rel_l2(got['grads'], ref['grads']):.3g}; step median "
          f"{ms_dp:.2f} ms ({TRAIN_BATCH / ms_dp * 1e3:.1f} img/s) "
          f"data-parallel, {ms_one:.2f} ms ({TRAIN_BATCH / ms_one * 1e3:.1f}"
          f" img/s) one device, {2 * TRAIN_DP_TIMED} steps each timed in "
          f"turn on the host clock (min {min(t_dp) * 1e3:.2f} / "
          f"{min(t_one) * 1e3:.2f}); a cross-replica sum "
          f"{lockstep_us(devices):.1f} µs of host time (106 a forward); "
          f"on {smi}", flush=True)
    del one, dp, ref, got
    torch.cuda.empty_cache()

    ck = os.path.join(data["root"], "weights_dp")
    args = ["--model", "fcos", "--ann", data["ann"], "--img-dir",
            data["root"], "--batch-size", str(TRAIN_BATCH), "--lr",
            str(TRAIN_CLI_LR), "--burn-in", str(TRAIN_CLI_BURN_IN),
            "--sizes", str(size), "--log-every", "1", "--ckpt-dir", ck,
            "--data-parallel"]
    first = os.path.join(ck, f"fcos_{TRAIN_DP_CLI_ITERS}.npz")
    with local_devices_as(devices):
        _, out, wall = run_cli(train.main, args + [
            "--iterations", str(TRAIN_DP_CLI_ITERS)])
        check_launches("train cli --data-parallel", read_launches(), {
            k: v * n * TRAIN_DP_CLI_ITERS for k, v in per_step.items()})
        _, out2, wall2 = run_cli(train.main, args + [
            "--iterations", str(TRAIN_DP_CLI_RESUMED), "--resume", first])
    said = f"data-parallel over {n} devices"
    rows = _metrics(ck, "fcos")
    if (said not in out or said not in out2 or not os.path.exists(first)
            or f"at iteration {TRAIN_DP_CLI_ITERS}" not in out2
            or not os.path.exists(os.path.join(
                ck, f"fcos_{TRAIN_DP_CLI_RESUMED}.npz"))
            or len(rows) != TRAIN_DP_CLI_RESUMED
            or not all(np.isfinite(v) for r in rows for v in r.values())):
        raise AssertionError(f"train cli --data-parallel: rows {rows}")
    print(f"train dp cli: fcos-{size} bf16 batch {TRAIN_BATCH} from files "
          f"--data-parallel over {n} replicas: {TRAIN_DP_CLI_ITERS} "
          f"iterations in {wall:.1f} s, checkpoint resumed to "
          f"{TRAIN_DP_CLI_RESUMED} in {wall2:.1f} s, the GN kernels "
          f"{per_step} a replica a step; total "
          f"{[round(r['total'], 3) for r in rows]}, img/s "
          f"{[r['img_per_sec'] for r in rows]}; on {smi}", flush=True)


@torch.no_grad()
def gn_fwd_stats_row(captured: dict) -> dict:
    """The forward-with-statistics kernel at the train main path's own
    inputs: the 40 calls of one step, summed."""
    import torch.nn.functional as F

    from mydetection_tpu_torch.kernels.gn import (
        bias_gn_relu_fwd_stats,
        bias_gn_relu_fwd_stats_plain,
    )

    calls = captured["fwd"]
    err = 0.0
    for args in calls:
        got = bias_gn_relu_fwd_stats(*args, groups=GN_GROUPS)
        ref = bias_gn_relu_fwd_stats_plain(*args, groups=GN_GROUPS)
        e, ok = gn_error(got[0], ref[0])
        stats = max(max_scaled(a, b) for a, b in zip(got[1:], ref[1:]))
        if not ok or stats > GN_F32_GATE:
            raise AssertionError(f"bias_gn_relu_fwd_stats outside its gates "
                                 f"on the train path's {tuple(args[0].shape)} "
                                 f"input: y {e:.3g}, mean/inv {stats:.3g}")
        err = max(err, e)
    lib_in = [(x + b.to(x.dtype)[:, None, None], s.to(x.dtype), t.to(x.dtype))
              for x, b, s, t in calls]
    ms = cuda_ms(lambda: [bias_gn_relu_fwd_stats(*a, groups=GN_GROUPS)
                          for a in calls], 5)
    plain_ms = cuda_ms(lambda: [bias_gn_relu_fwd_stats_plain(*a, groups=GN_GROUPS)
                                for a in calls], 3)
    lib_ms = cuda_ms(lambda: [F.group_norm(x, GN_GROUPS, s, t, 1e-5)
                              for x, s, t in lib_in], 5)
    bound, bound_by = gn_bound_ms(calls, stats=True)
    print(f"gn fwd_stats on the train main path: {len(calls)} calls, kernel "
          f"{ms:.4f} ms summed (bound {bound:.4f} ms by {bound_by}), plain "
          f"{plain_ms:.3f} ms, F.group_norm {lib_ms:.4f} ms", flush=True)
    return {
        "name": "bias_gn_relu_fwd_stats", "route": "cuda",
        "source": "mydetection_tpu_torch/kernels/csrc/gn.cu",
        "replaces": "mydetection_tpu/ops/pallas/gn_kernel.py:141",
        "launches": captured["launches"]["bias_gn_relu_fwd_stats"],
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound, "bound_by": bound_by, "library_ms": lib_ms,
        "note": "times sum the 40 calls of one fcos-608 batch-16 bf16 train "
                "step; library_ms is F.group_norm on x + bias, which leaves "
                "out the bias add, the ReLU and the saved statistics",
    }


@torch.no_grad()
def gn_bwd_row(captured: dict) -> dict:
    """The fused backward kernel at the train main path's own inputs:
    the 40 calls of one step, summed."""
    from mydetection_tpu_torch.kernels.gn import (
        bias_gn_relu_bwd,
        bias_gn_relu_bwd_plain,
    )

    calls = captured["bwd"]
    err = 0.0
    layouts = {"channels_last": 0, "nchw": 0, "other": 0}
    for args in calls:
        dy = args[2]
        layouts["channels_last" if dy.is_contiguous(
            memory_format=torch.channels_last) else
            "nchw" if dy.is_contiguous() else "other"] += 1
        got = bias_gn_relu_bwd(*args, groups=GN_GROUPS)
        again = bias_gn_relu_bwd(*args, groups=GN_GROUPS)
        ref = bias_gn_relu_bwd_plain(*args, groups=GN_GROUPS)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError("bias_gn_relu_bwd is not bit-reproducible on "
                                 "the train path's inputs")
        for a, b in zip(got, ref):
            e, ok = gn_train_error(a, b)
            if not ok:
                raise AssertionError(f"bias_gn_relu_bwd outside its gate on "
                                     f"the train path's {tuple(args[0].shape)} "
                                     f"input: {e:.3g}")
            err = max(err, e)
    # the library yardstick: aten's GroupNorm backward on contiguous NCHW
    # x + bias with its own statistics (no ReLU mask, no bias gradient)
    lib = []
    for x, _, dy, bias, scale, _, _ in calls:
        b, c, h, w = x.shape
        xb = (x + bias.to(x.dtype)[:, None, None]).contiguous()
        wt = scale.to(x.dtype)
        _, mean, rstd = torch.ops.aten.native_group_norm(
            xb, wt, None, b, c, h * w, GN_GROUPS, 1e-5)
        lib.append((dy.contiguous(), xb, mean, rstd, wt, b, c, h * w))
    ms = cuda_ms(lambda: [bias_gn_relu_bwd(*a, groups=GN_GROUPS)
                          for a in calls], 5)
    plain_ms = cuda_ms(lambda: [bias_gn_relu_bwd_plain(*a, groups=GN_GROUPS)
                                for a in calls], 3)
    lib_ms = cuda_ms(lambda: [torch.ops.aten.native_group_norm_backward(
        dy, xb, mean, rstd, wt, b, c, hw, GN_GROUPS, [True, True, True])
        for dy, xb, mean, rstd, wt, b, c, hw in lib], 5)
    bound, bound_by = gn_bound_ms(calls, backward=True)

    def aten(i):
        dy, xb, mean, rstd, wt, b, c, hw = lib[i]
        return torch.ops.aten.native_group_norm_backward(
            dy, xb, mean, rstd, wt, b, c, hw, GN_GROUPS, [True, True, True])

    levels = gn_levels(
        calls, "bwd", lambda a: bias_gn_relu_bwd(*a, groups=GN_GROUPS),
        lambda a: gn_bound_ms([a], backward=True)[0], aten)
    print(f"gn bwd on the train main path: {len(calls)} calls (dy layouts "
          f"{layouts}), kernel {ms:.4f} ms summed "
          f"(bound {bound:.4f} ms by {bound_by}), plain {plain_ms:.3f} ms, "
          f"aten native_group_norm_backward {lib_ms:.4f} ms; bit-reproducible, "
          f"max-scaled |d| {err:.3g}; one call a level (kernel / bound / "
          f"aten ms): {level_text(levels)}", flush=True)
    return {
        "name": "bias_gn_relu_bwd", "route": "cuda",
        "source": "mydetection_tpu_torch/kernels/csrc/gn.cu",
        "replaces": "mydetection_tpu/ops/pallas/gn_kernel.py:149",
        "launches": captured["launches"]["bias_gn_relu_bwd"],
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound, "bound_by": bound_by, "library_ms": lib_ms,
        "levels": levels, "dy_layouts": layouts,
        "note": "times sum the 40 calls of one fcos-608 batch-16 bf16 train "
                "step, each call's two launches (the kernel and the sum of "
                "its channel partials) and any copy of an NCHW dy; levels "
                "time one call of each level; max_abs_err is max-scaled "
                "over dx, dbias, dscale, dshift; the resident design reads "
                "x, y and dy once and x again, the bound each once; "
                "library_ms is aten.native_group_norm_backward on "
                "contiguous x + bias, which leaves out the ReLU mask and "
                "the bias gradient",
    }


# ---------------------------------------------------------------------------
# export, serve and the tools
# ---------------------------------------------------------------------------

def seconds_of(fn) -> float:
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def profiled(fn) -> dict:
    """One `fn()` under the profiler: the operators the host ran, and
    the card's own events (kernels, copies, sets) with their summed
    duration, each counted once (an operator's self device time repeats
    the kernels it launched)."""
    from torch.autograd import DeviceType

    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.events()
    device = [e for e in events if e.device_type != DeviceType.CPU]
    return {"host_ops": len(events) - len(device),
            "device_events": len(device),
            "device_ms": sum(e.device_time_total for e in device) / 1e3}


def interleaved_batch_s(a, b, runs: int = EXPORT_TIMED
                        ) -> tuple[float, float]:
    """Median host-clock seconds of `a()` and of `b()` (each returns
    host arrays, so it waits for the card), timed in turn in one process
    (a b, b a, a b, ...) so that both see the same host."""
    times = ([], [])
    for r in range(runs):
        for k in ((0, 1) if r % 2 == 0 else (1, 0)):
            times[k].append(seconds_of((a, b)[k]))
    return float(np.median(times[0])), float(np.median(times[1]))


def export_live(work: str, smi: str) -> dict:
    """Phase 18's first half: each of EXPORT_MAINS built and warmed up,
    exported (bf16, on the card) into `work`, its live padded outputs on
    the path's BATCH canvases saved beside the artifact; then the
    artifact loaded in this process too and the live and exported
    batches timed in turn (`interleaved_batch_s`), whole (`detect_prepared`
    from host canvases) and as the programs alone (the live dense
    forward and postprocess, the exported program, on a batch already
    on the card). Returns per path its export seconds, both img/s, the
    programs' ms, one profiled batch of each and the ops its programs
    call."""
    from mydetection_tpu_torch import Detector
    from mydetection_tpu_torch.export import export_detector, load_exported

    out = {}
    for label, name, size, buckets, conf, int8, want in EXPORT_MAINS:
        canvases, infos = main_canvases(size)
        kw = (dict(quantized=True,
                   calib_images=list(canvases[:QUANT_CALIB_IMAGES]))
              if int8 else {})
        det = Detector(name, input_size=size, rng_seed=0, **kw)
        det.warmup(batch_size=BATCH)
        t0 = time.perf_counter()
        meta = export_detector(det, os.path.join(work, f"{label}.npz"),
                               batch_size=buckets)
        export_s = time.perf_counter() - t0
        if meta["custom_ops"] != sorted(f"mydet::{k}" for k in want):
            raise AssertionError(f"export {label}: its programs call "
                                 f"{meta['custom_ops']}, the live path "
                                 f"launches {sorted(want)}")
        live = det._run_batch(canvases, conf, det.cfg.nms_iou, BATCH)
        np.savez(os.path.join(work, f"{label}_live.npz"), **live)
        served = load_exported(os.path.join(work, f"{label}.npz"))
        served.warmup()
        live_s, exported_s = interleaved_batch_s(
            lambda: det.detect_prepared(canvases, infos, conf_thres=conf),
            lambda: served.detect_prepared(canvases, infos,
                                           conf_thres=conf))
        # the programs alone on a batch already on the card: the live
        # dense forward and postprocess against the exported program
        images = torch.from_numpy(canvases).cuda()
        conf_t = torch.full((BATCH,), conf, device="cuda")
        call = served._calls[(size, BATCH)]

        def live_program():
            with torch.inference_mode():
                det._post(det._forward_dense(images), conf_t,
                          det.cfg.nms_iou)

        def exported_program():
            with torch.inference_mode():
                call(served.params, images, conf_t)

        programs_s = interleaved_batch_s(live_program, exported_program)
        out[label] = {"export_s": export_s, "live_img_per_s": BATCH / live_s,
                      "exported_img_per_s": BATCH / exported_s,
                      "programs_ms": [t * 1e3 for t in programs_s],
                      "live_profile": profiled(lambda: det.detect_prepared(
                          canvases, infos, conf_thres=conf)),
                      "exported_profile": profiled(
                          lambda: served.detect_prepared(
                              canvases, infos, conf_thres=conf)),
                      "custom_ops": meta["custom_ops"],
                      "detections": int(live["valid"].sum())}
        del det, served, images
        torch.cuda.empty_cache()
    return out


def export_child(work: str) -> int:
    """Phase 18's second half, in a fresh process whose
    `registry.get_model` raises: each artifact of EXPORT_MAINS loaded,
    warmed up, then one batch-32 detect on the path's canvases with
    every launch count reset just before and read just after, its
    padded outputs against the live ones saved in `work` (bit for bit).
    One JSON line a path."""
    from mydetection_tpu_torch import api, kernels, registry
    from mydetection_tpu_torch.export import load_exported

    def refuse(*args, **kwargs):
        raise AssertionError("registry.get_model was called while serving "
                             "an artifact")

    registry.get_model = api.get_model = refuse
    for label, name, size, buckets, conf, int8, want in EXPORT_MAINS:
        t0 = time.perf_counter()
        served = load_exported(os.path.join(work, f"{label}.npz"))
        load_s = time.perf_counter() - t0
        canvases, _ = main_canvases(size)
        served.warmup()
        kernels.reset_launches()
        got = served._run(canvases, conf)
        torch.cuda.synchronize()
        launches = read_launches()
        with np.load(os.path.join(work, f"{label}_live.npz")) as z:
            live = {k: z[k] for k in z.files}
        same = {k: bool(np.array_equal(got[k], live[k])) for k in live}
        valid = live["valid"] & got["valid"]
        print(json.dumps({
            "label": label, "load_s": load_s, "launches": launches,
            "bit_equal": same,
            "max_score_diff": float(np.abs(got["scores"] - live["scores"])
                                    [valid].max(initial=0.0)),
            "max_box_diff": float(np.abs(got["boxes"] - live["boxes"])
                                  [valid].max(initial=0.0))}), flush=True)
    return 0


def phase_export(work: str, smi: str) -> None:
    """Phase 18: EXPORT_MAINS exported on the card, then loaded and run
    in a fresh process that cannot build a model (`export_child`); each
    exported path bit-equal to the live one, launching exactly its
    kernels (the live path's counts, phases 13 and 13b); the exported
    and live img/s timed in turn in this process (`export_live`)."""
    live = export_live(work, smi)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c",
         f"import sys, chip_smoke; sys.exit(chip_smoke.export_child({work!r}))"],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
        text=True, timeout=EXPORT_CHILD_TIMEOUT)
    child_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"export child failed ({proc.returncode}):\n"
                             f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    rows = {r["label"]: r for r in map(json.loads, proc.stdout.splitlines())
            if r}
    for label, name, size, buckets, conf, int8, want in EXPORT_MAINS:
        r, lv = rows[label], live[label]
        check_launches(f"exported {label}", r["launches"], want)
        if not all(r["bit_equal"].values()):
            raise AssertionError(
                f"exported {label} differs from the live Detector: equal "
                f"{r['bit_equal']}, scores by {r['max_score_diff']:.3g}, "
                f"boxes by {r['max_box_diff']:.3g} px")
        print(f"export: {label}-{size} bf16 buckets {list(buckets)}: "
              f"exported in {lv['export_s']:.1f} s (ops "
              f"{lv['custom_ops']}), loaded in a fresh process without "
              f"model code in {r['load_s']:.1f} s; batch {BATCH} at conf "
              f"{conf}: {lv['detections']} detections, every output bit "
              f"for bit the live Detector's, launches "
              f"{ {k: v for k, v in r['launches'].items() if v} }; "
              f"{lv['exported_img_per_s']:.1f} img/s exported, "
              f"{lv['live_img_per_s']:.1f} img/s live, exported / live "
              f"{lv['exported_img_per_s'] / lv['live_img_per_s']:.3f} "
              f"(medians of {EXPORT_TIMED} batches each, timed in turn in "
              f"one process, host clock); the programs alone on a batch "
              f"already on the card, live / exported: "
              f"{lv['programs_ms'][0]:.2f} / {lv['programs_ms'][1]:.2f} ms "
              f"(medians, timed in turn); one batch under the profiler, "
              f"live / exported: {lv['live_profile']['host_ops']} / "
              f"{lv['exported_profile']['host_ops']} host operators, "
              f"{lv['live_profile']['device_events']} / "
              f"{lv['exported_profile']['device_events']} device events, "
              f"{lv['live_profile']['device_ms']:.2f} / "
              f"{lv['exported_profile']['device_ms']:.2f} ms of device "
              f"time; on {smi}", flush=True)
    print(f"export: the fresh process took {child_s:.1f} s in all; on {smi}",
          flush=True)


def post_json(url: str, body: bytes) -> dict:
    import urllib.request

    req = urllib.request.Request(url, data=body, method="POST")
    with urllib.request.urlopen(req, timeout=300) as r:
        return json.loads(r.read())


def get_json(url: str) -> dict:
    import urllib.request

    with urllib.request.urlopen(url, timeout=300) as r:
        return json.loads(r.read())


def serve_burst(srv, bodies: list[bytes], conf: float) -> tuple[list, float,
                                                                 dict]:
    """Start `srv` on a free port, send every body from SERVE_CLIENTS
    threads (client i sends bodies i, i + SERVE_CLIENTS, ...), stop it.
    Returns (the responses in body order, the burst's wall seconds, the
    server's /stats)."""
    import threading

    ready = threading.Event()
    server = threading.Thread(target=srv.serve, daemon=True,
                              kwargs={"port": 0, "ready_event": ready})
    server.start()
    try:
        if not ready.wait(600):
            raise AssertionError("the server did not warm up")
        base = f"http://127.0.0.1:{srv.port}"
        results, errors = [None] * len(bodies), []

        def client(i):
            try:
                for j in range(i, len(bodies), SERVE_CLIENTS):
                    results[j] = post_json(f"{base}/detect?conf_thres={conf}",
                                           bodies[j])
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(e)

        clients = [threading.Thread(target=client, args=(i,))
                   for i in range(SERVE_CLIENTS)]
        t0 = time.perf_counter()
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=600)
        wall = time.perf_counter() - t0
        stats = get_json(f"{base}/stats")
    finally:
        srv.shutdown()
        server.join(timeout=60)
    if errors or any(r is None for r in results) or server.is_alive():
        raise AssertionError(f"serve: {len(errors)} requests failed: "
                             f"{errors[:2]}")
    return results, wall, stats


def match_rows(got: np.ndarray, want: np.ndarray, rotated: bool,
               box_gate: float, box_rtol: float = 0.0
               ) -> tuple[bool, float, float]:
    """One-to-one match of response rows to reference rows: (x1, y1, x2,
    y2, score, cls) with the class equal, or rotated (cx, cy, w, h, deg,
    score); scores within SERVE_SCORE_GATE, every box number within
    `box_gate` plus `box_rtol` of its magnitude. Returns (matched, the
    largest box and score differences seen)."""
    got, want = got.reshape(-1, 6), want.reshape(-1, 6)
    nbox, col = (5, 5) if rotated else (4, 4)
    if len(got) != len(want):
        return False, float("inf"), float("inf")
    used = np.zeros(len(want), bool)
    worst_box = worst_score = 0.0
    for row in got:
        db = np.abs(want[:, :nbox] - row[None, :nbox])
        ds = np.abs(want[:, col] - row[col])
        ok = (~used & (db <= box_gate + box_rtol
                       * np.abs(want[:, :nbox])).all(axis=1)
              & (ds <= SERVE_SCORE_GATE))
        if not rotated:
            ok &= want[:, 5] == row[5]
        if not ok.any():
            return False, float(db.max(axis=1).min()), float(ds.min())
        j = int(np.argmin(np.where(ok, db.max(axis=1), np.inf)))
        used[j] = True
        worst_box = max(worst_box, float(db[j].max()))
        worst_score = max(worst_score, float(ds[j]))
    return True, worst_box, worst_score


def digest(canvas: np.ndarray) -> str:
    import hashlib

    return hashlib.sha1(np.ascontiguousarray(canvas).tobytes()).hexdigest()


def record_buckets(srv) -> dict:
    """Wrap `srv`'s backend so that each batch notes the bucket it ran
    at under the digest of each real canvas; returns that dict, which
    fills as the server runs."""
    bucket_of = {}
    inner = srv.backend.detect_prepared

    def detect_prepared(canvases, infos, **kw):
        for c in canvases[:len(infos)]:
            bucket_of[digest(c)] = int(canvases.shape[0])
        return inner(canvases, infos, **kw)

    srv.backend.detect_prepared = detect_prepared
    return bucket_of


def same_shape_references(backend, bodies: list[bytes], size: int,
                          bucket_of: dict, conf: float) -> list:
    """Each body's detections from `backend` at the batch shape the
    server ran it at: the body decoded and letterboxed as the server
    does (PIL), the canvases of one bucket run in batches of it, the
    last padded by repeating its last canvas, as the server pads."""
    from PIL import Image

    from mydetection_tpu_torch.utils.image_ops import letterbox_pil

    prepared = [letterbox_pil(Image.open(io.BytesIO(b)), size)
                for b in bodies]
    buckets = [bucket_of.get(digest(c)) for c, _ in prepared]
    if None in buckets:
        raise AssertionError(f"serve: request {buckets.index(None)}'s canvas "
                             f"is not one the server ran")
    refs = [None] * len(bodies)
    for bucket in sorted(set(buckets)):
        idx = [i for i, b in enumerate(buckets) if b == bucket]
        for at in range(0, len(idx), bucket):
            chunk = idx[at:at + bucket]
            canvases = np.stack([prepared[i][0] for i in chunk])
            if len(chunk) < bucket:
                canvases = np.concatenate([canvases, np.repeat(
                    canvases[-1:], bucket - len(chunk), axis=0)])
            dets = backend.detect_prepared(
                canvases, [prepared[i][1] for i in chunk], conf_thres=conf)
            for i, d in zip(chunk, dets):
                refs[i] = d.as_array()
    return refs


def scaled_detector(name: str, size: int, **kw):
    """A Detector of the seeded init with every conv kernel scaled by
    EVAL_F32_SCALE: unsaturated scores, so rows that tie at 1.0 do not
    change places between two batch shapes."""
    from mydetection_tpu_torch import Detector

    det = Detector(name, input_size=size, rng_seed=0, **kw)
    with torch.no_grad():
        for p in det.model.parameters():
            if p.dim() == 4:
                p.mul_(EVAL_F32_SCALE)
    return det


def phase_serve(work: str, data: dict, smi: str) -> None:
    """Phase 19: the serving daemon on SERVE_REQUESTS of phase 15's JPEGs
    from SERVE_CLIENTS client threads, two backends: the yolov3-416
    artifact (`from_artifact`, buckets 1 and 32) and a live rapid-1024
    Detector (`from_detector`, SERVE_BUCKETS). First float32 with TF32
    off, conv kernels scaled by EVAL_F32_SCALE: every response matched
    one to one (`match_rows`) to the backend run on the same canvas at
    the batch shape the server ran it at (`record_buckets`,
    `same_shape_references`), and to `detect_one` on the same bytes,
    whose batch of 1 may take another cuDNN algorithm than a coalesced
    batch of 8 or 32 (the looser SERVE_ONE_BOX_GATE); /stats showing
    fewer batches than requests; then
    the rates with bf16 backends (phase 18's artifact, the seeded rapid)
    on the same requests: requests/s, p50 and p99 latency, batches by
    size and occupancy."""
    from PIL import Image

    from mydetection_tpu_torch.evaluate import tf32_off
    from mydetection_tpu_torch.export import export_detector
    from mydetection_tpu_torch.serve import DetectionServer

    with open(data["ann"]) as fh:
        names = [im["file_name"] for im in json.load(fh)["images"]]
    bodies = []
    for name in names[:SERVE_REQUESTS]:
        with open(os.path.join(data["root"], name), "rb") as fh:
            bodies.append(fh.read())
    f32 = os.path.join(work, "yolov3_f32.npz")
    with tf32_off("cuda"):
        det = scaled_detector("yolov3", SERVE_SIZES["yolov3"],
                              compute_dtype=torch.float32)
        export_detector(det, f32, batch_size=(1, BATCH))
        del det
        checks = (("yolov3-416 artifact", False, EVAL_F32_CONF,
                   lambda: DetectionServer.from_artifact(
                       f32, max_wait_ms=SERVE_WAIT_MS, use_native=False)),
                  ("rapid-1024 live", True, SERVE_RAPID_F32_CONF,
                   lambda: DetectionServer.from_detector(
                       scaled_detector("rapid", SERVE_SIZES["rapid"],
                                       compute_dtype=torch.float32),
                       batch_buckets=list(SERVE_BUCKETS),
                       max_wait_ms=SERVE_WAIT_MS, use_native=False)))
        for what, rotated, conf, make in checks:
            srv = make()
            bucket_of = record_buckets(srv)
            responses, wall, stats = serve_burst(srv, bodies, conf)
            size = SERVE_SIZES["rapid" if rotated else "yolov3"]
            refs = same_shape_references(srv.backend, bodies, size,
                                         bucket_of, conf)
            worst = {"shape": [0.0, 0.0], "one": [0.0, 0.0]}
            rows = 0
            for i, (body, r, ref) in enumerate(zip(bodies, responses, refs)):
                got = np.asarray(r["detections"])
                one = srv.backend.detect_one(
                    pil_img=Image.open(io.BytesIO(body)),
                    conf_thres=conf).as_array()
                for key, want, gate, rtol in (
                        ("shape", ref, SERVE_BOX_GATE, 0.0),
                        ("one", one, SERVE_ONE_BOX_GATE,
                         SERVE_ONE_BOX_RTOL)):
                    ok, db, ds = match_rows(got, want, rotated, gate, rtol)
                    if not ok:
                        run = ("same batch shape" if key == "shape"
                               else "detect_one")
                        raise AssertionError(
                            f"serve f32 {what}: request {i}: {r['n']} rows "
                            f"against {len(want)} of the {run} run; "
                            f"nearest box {db:.4g}, score {ds:.3g}")
                    worst[key] = [max(worst[key][0], db),
                                  max(worst[key][1], ds)]
                rows += len(ref)
            if rows == 0:
                raise AssertionError(f"serve f32 {what}: no detection at "
                                     f"conf {conf} to compare")
            if not 0 < stats["batches"] < stats["requests"]:
                raise AssertionError(f"serve f32 {what}: {stats['batches']} "
                                     f"batches for {stats['requests']} "
                                     f"requests")
            print(f"serve f32: {what}, float32 TF32 off, conv kernels x "
                  f"{EVAL_F32_SCALE}, conf {conf}: {SERVE_REQUESTS} JPEG "
                  f"requests from {SERVE_CLIENTS} threads, {rows} rows each "
                  f"matched one to one to the backend run at the request's "
                  f"batch shape (largest box difference "
                  f"{worst['shape'][0]:.3g}, score {worst['shape'][1]:.3g}; "
                  f"gates {SERVE_BOX_GATE} px, {SERVE_SCORE_GATE}) and to "
                  f"detect_one on the same bytes (box {worst['one'][0]:.3g}, "
                  f"score {worst['one'][1]:.3g}; gates {SERVE_ONE_BOX_GATE} "
                  f"+ {SERVE_ONE_BOX_RTOL:g} x |value| px, "
                  f"{SERVE_SCORE_GATE}); {stats['batches']} batches by size "
                  f"{stats['batches_by_size']}; on {smi}", flush=True)
            del srv
            torch.cuda.empty_cache()

    from mydetection_tpu_torch import Detector

    rates = (("yolov3-416 artifact", 0.25,
              lambda: DetectionServer.from_artifact(
                  os.path.join(work, "yolov3.npz"),
                  max_wait_ms=SERVE_WAIT_MS)),
             ("rapid-1024 live", 0.3,
              lambda: DetectionServer.from_detector(
                  Detector("rapid", input_size=SERVE_SIZES["rapid"],
                           rng_seed=0),
                  batch_buckets=list(SERVE_BUCKETS),
                  max_wait_ms=SERVE_WAIT_MS)))
    for what, conf, make in rates:
        srv = make()
        decoder = "native" if srv.use_native else "PIL"
        _, wall, stats = serve_burst(srv, bodies, conf)
        lat = stats["latency_ms"]
        print(f"serve bf16: {what}, conf {conf}, {decoder} decode: "
              f"{SERVE_REQUESTS} JPEG requests from {SERVE_CLIENTS} threads "
              f"in {wall:.3f} s: {SERVE_REQUESTS / wall:.1f} requests/s, "
              f"latency p50 {lat['p50']} ms, p99 {lat['p99']} ms; "
              f"{stats['batches']} batches (by size "
              f"{stats['batches_by_size']}), {stats['mean_images_per_batch']} "
              f"images a batch, bucket occupancy {stats['bucket_occupancy']}; "
              f"on {smi}", flush=True)
        del srv
        torch.cuda.empty_cache()


def phase_tools(data: dict, smi: str) -> None:
    """Phase 20: `summary` of yolov3-416 on the card (GFLOPs an image
    within 0.1% of darknet's 65.86 and equal to the CPU's count, 62.00 M
    parameters); fcos-608's FLOP count with the kernels equal to
    use_pallas=False's; a `trace()` of one yolov3-416 bf16 batch and
    its `forward_dense`'s kernel time under the profiler beside the
    CUDA-event time; the demo CLI on DEMO_IMAGES of phase 15's JPEGs; a
    data-parallel
    Detector on the one card equal to the plain one."""
    import shutil

    from mydetection_tpu_torch import Detector, demo
    from mydetection_tpu_torch.registry import forward_dense
    from mydetection_tpu_torch.summary import summarize
    from mydetection_tpu_torch.utils.profiling import TRACE_FILE, trace
    from mydetection_tpu_torch.utils.visualization import has_cv2

    card = summarize("yolov3", input_size=416)
    cpu = summarize("yolov3", input_size=416, device="cpu")
    gf = card["gflops_per_image"]
    if abs(gf / DARKNET_YOLOV3_416_GFLOPS - 1) > 1e-3 \
            or gf != cpu["gflops_per_image"] \
            or card["params"] != cpu["params"]:
        raise AssertionError(f"summary yolov3-416: card {card}, CPU {cpu}")
    fk = summarize("fcos", input_size=608)["gflops_per_image"]
    fp = summarize("fcos", input_size=608,
                   use_pallas=False)["gflops_per_image"]
    if fk != fp:
        raise AssertionError(f"fcos-608 GFLOPs: {fk} with the kernels, {fp} "
                             f"with use_pallas=False")
    print(f"tools summary: yolov3-416 {gf:.4f} GFLOPs an image on the card "
          f"and on the CPU (darknet: {DARKNET_YOLOV3_416_GFLOPS}), "
          f"{card['params'] / 1e6:.2f} M parameters with BN statistics "
          f"{card['params_by_module']}; fcos-608 {fk:.4f} GFLOPs with the "
          f"kernels and with use_pallas=False; on {smi}", flush=True)

    canvases, infos = main_canvases(416)
    det = Detector("yolov3", input_size=416, rng_seed=0)
    det.warmup(batch_size=BATCH)
    from torch.autograd import DeviceType

    with tempfile.TemporaryDirectory() as logdir:
        with trace(logdir) as prof:
            det.detect_prepared(canvases, infos, conf_thres=0.25)
        size = os.path.getsize(os.path.join(logdir, TRACE_FILE))
    device_ms = sum(e.device_time_total for e in prof.events()
                    if e.device_type != DeviceType.CPU) / 1e3
    print(f"tools trace: one yolov3-416 bf16 batch of {BATCH}: "
          f"{len(prof.events())} events, {size / 1e6:.1f} MB of Chrome "
          f"trace, {device_ms:.2f} ms of device time (the card's own "
          f"events summed); on {smi}", flush=True)
    # the forward's own kernel time beside phase 13's CUDA-event reading,
    # which paces with the host when its launches outrun the sleep ahead
    images = torch.from_numpy(canvases).cuda()
    with torch.inference_mode():
        event_ms = cuda_ms(lambda: forward_dense(det.model, images), 5)
        fwd = profiled(lambda: forward_dense(det.model, images))
    print(f"tools forward: yolov3-416 bf16 forward_dense batch {BATCH}: "
          f"{fwd['device_ms']:.2f} ms of device time under the profiler "
          f"({fwd['device_events']} device events, {fwd['host_ops']} host "
          f"operators), {event_ms:.2f} ms by CUDA events (phase 13's "
          f"timing, mean of 5); on {smi}", flush=True)
    del images

    dp = Detector("yolov3", input_size=416, rng_seed=0, data_parallel=True)
    want = det._run_batch(canvases, 0.25, det.cfg.nms_iou, BATCH)
    got = dp._run_batch(canvases, 0.25, dp.cfg.nms_iou, BATCH)
    if dp._replicas is not None or not all(
            np.array_equal(got[k], want[k]) for k in want):
        raise AssertionError("data_parallel=True on one card differs from "
                             "the plain Detector")
    print(f"tools data_parallel: {torch.cuda.device_count()} card: the "
          f"single-device path, {int(got['valid'].sum())} detections bit "
          f"for bit the plain Detector's; on {smi}", flush=True)
    del det, dp
    torch.cuda.empty_cache()

    with open(data["ann"]) as fh:
        names = [im["file_name"] for im in json.load(fh)["images"]]
    with tempfile.TemporaryDirectory() as tmp:
        src, out = os.path.join(tmp, "in"), os.path.join(tmp, "out")
        os.makedirs(src)
        for name in names[:DEMO_IMAGES]:
            shutil.copy(os.path.join(data["root"], name), src)
        result, text, wall = run_cli(demo.main, [
            "--model", "yolov3", "--input", src, "--out-dir", out,
            "--input-size", "416"])
        saved = sorted(os.listdir(out))
    if len(result) != DEMO_IMAGES or len(saved) != DEMO_IMAGES:
        raise AssertionError(f"demo saved {saved}")
    print(f"tools demo: {DEMO_IMAGES} JPEGs in {wall:.2f} s, "
          f"{len(saved)} renders saved; cv2 "
          f"{'drew them' if has_cv2() else 'is not installed: unmarked copies'}"
          f"; on {smi}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 1
    from mydetection_tpu_torch.kernels import build

    smi = smi_line()
    print(f"device: {smi}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}", flush=True)
    t0 = time.perf_counter()
    logs = build.build_all()
    ptxas = [ln.strip() for log in logs.values() for ln in log.splitlines()
             if "registers" in ln or "smem" in ln]
    print(f"build: {sorted(logs) or 'cached'} in "
          f"{time.perf_counter() - t0:.1f} s; {' | '.join(ptxas)}", flush=True)
    phase_kernel(np.random.RandomState(0))
    phase_gn()
    phase_gn_train()
    phase_rotated(np.random.RandomState(0))
    phase_tower()
    phase_bottleneck()
    phase_gather(np.random.RandomState(0))
    phase_parity()
    phase_parity_bf16()
    phase_train_parity()
    yolo = drive_main("yolov3", 416, 0.25, smi,
                      {"nms_keep": 1, "conv_epilogue": 75})
    rows = [nms_row(yolo, "yolov3"), epilogue_row(yolo, "yolov3")]
    t0 = time.perf_counter()
    yolo = drive_main("yolov3_608", 608, 0.25, smi,
                      {"nms_keep": 1, "conv_epilogue": 75})
    nms_row(yolo, "yolov3_608")
    print(f"main: yolov3_608-608 in {time.perf_counter() - t0:.1f} s",
          flush=True)
    del yolo
    fcos = drive_main("fcos", 608, 0.005, smi,
                      {"nms_keep": 1, "bias_gn_relu": 40, "gather_rows": 1,
                       "fused_bottleneck": 6, "conv_epilogue": 34},
                      capture_gn=True)
    rows += [gn_row(fcos), epilogue_row(fcos, "fcos")]
    nms_row(fcos, "fcos")
    del fcos
    rapid = drive_main("rapid", 1024, 0.3, smi,
                       {"nms_from_iou_keep": 1, "conv_epilogue": 75})
    rows.append(rotated_row(rapid))
    del rapid
    retina_launches = {"nms_keep": 1, "conv3x3_chain": 10, "gather_rows": 1,
                       "fused_bottleneck": 6, "conv_epilogue": 34}
    retina = drive_main("retinanet", 608, 0.005, smi, retina_launches)
    rows += [tower_row(retina), gather_row(retina), bottleneck_row(retina)]
    nms_row(retina, "retinanet")
    del retina
    drive_main("retinanet_r101", 608, 0.005, smi,
               {**retina_launches, "conv_epilogue": 85})
    phase_quant(smi)
    train = phase_train_main(smi)
    rows += [gn_fwd_stats_row(train), gn_bwd_row(train)]
    synthetic = {"fcos": train["img_per_s"]}
    del train
    for name, size, batch in TRAIN_MAINS:   # no kernel runs on these
        synthetic[name] = train_main(name, size, batch, smi, {})[3]
        torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as root:
        data = phase_data(root, smi)
        phase_evaluate(data, smi)
        phase_evaluate_quant(data, smi)
        phase_train_cli(data, smi, synthetic)
        torch.cuda.empty_cache()
        phase_train_dp(data, smi)
        torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory() as work:
            phase_export(work, smi)
            phase_serve(work, data, smi)
        phase_tools(data, smi)
    torch.cuda.empty_cache()
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
