#!/usr/bin/env python3
"""Smoke run of the PyTorch port's serving and training paths on one CUDA
card.

    python3 chip_smoke.py

Phases, one line or more each; any failure exits non-zero:

1. environment: the card's name and power limit (``nvidia-smi``), the
   torch / CUDA / nvcc versions, and the time to build the CUDA kernels
   from this checkout (one ``nvcc`` per source, all at once);
2. the forward kernel against its plain PyTorch version on the card (TF32
   off), ties, NaN, one-row and one-column crops, an upsampled crop and
   C = 1 and 4 and the CLI's batches of 8 and 256 included, with its time, the plain version's, the library
   yardstick's (``F.grid_sample`` over ``F.affine_grid``) and the bound
   (CUDA events, median of 25 calls; profiler device time, L2-warm and
   L2-cold, one device operation per call);
2b. the two backward kernels (d theta, d images) against the plain
   backward on the card, the same way, with ``F.grid_sample``'s backward
   as the yardstick, ties, NaN, one-row and one-column crops, and for d
   images a zero scale, a flipped scale, an upsampled crop, an infinite
   theta and a huge finite theta included; each bit-identical between two
   runs, one device operation per call, and timed L2-warm and L2-cold;
3. serving: an R-50 224x224 -> 75x75 localizer with the assessor, seeded
   and saved as ``.pt`` snapshots in a temporary log dir, served through
   ``LocalizerInference(device="cuda")``: 2 single-frame requests and 3
   batches of 32 frames, with the forward kernel's launches checked and
   its device time per launch in a traced batch;
4. the same serving models and weights on the CPU against the card;
5. training: ``Trainer`` runs the pooled alternating step (8 steps per
   call, batch 64) on uint8 pools resident on the card, R-50 224->75 and
   the assessor, float32, Adam(amsgrad) lr 1e-3: 1 warm-up chunk and 3
   timed chunks, with each kernel's launches checked, a profiled chunk
   (with the crop kernels' device time per launch there, by name), and
   the last snapshot served through ``LocalizerInference``;
6. two training steps on the card against the CPU from the same weights
   (batch 4, full width);
7. the rotated crop's three kernels (K2: forward, d theta, d images)
   against their plain versions on the card (the forward bit for bit),
   ties, NaN, an upsampled crop, C = 4, a zero scale, a flipped scale, a
   rank-1 and a near-singular theta, an infinite and a huge finite theta
   included, with their times (one device operation per call, L2-warm and
   L2-cold), the plain versions', ``F.grid_sample``'s and the bounds;
8. rotation-dropout training: phase 5 at ``rotation_dropout_ratio=0.5`` on
   ``sampler="rotated_pallas"``, with K2's launches checked and K1's 0,
   the head's off-diagonal bias moved, and the snapshot served through
   K2's forward;
9. two rotated training steps (ratio 1.0) on the card (``rotated_pallas``)
   against the CPU (``rotated``) from the same weights (batch 4, full
   width);
10. the training CLI on the card, float32: first the CLI's own 512 ``stn``
   reference crops rendered by ``render_stn_crops`` (K1's forward, batches
   of 256) against the plain sampler on the same card tensors; then
   ``cli.train_localizer.main`` in this process on synthetic data (256
   scenes, 512 assessor crops rendered by K1's forward, 64 val scenes; one
   asset world), R-50 224->75, batch 64, 96 iterations in calls of 8, mAP
   on 2 val batches at every log entry, the assessor pool regenerated in a
   thread every 16 iterations; K1's launches accounted to the steps, the
   eval forwards and the crop renders, at least one pool swap, and the log
   dir served through ``LocalizerInference`` with boxes equal to the CLI's
   own eval step;
11. the same CLI for 8 ``--supervised`` iterations (no d theta launch) and
   16 ``--bf16`` iterations (every crop still K1's float32 kernel); then
   the bf16 step and the float32 step on phase 5's pools, 3 timed chunks
   each after a warm-up, alternating, and one traced bf16 chunk;
12. offline evaluation: ``cli.evaluate.main`` in this process sweeps phase
   10's three snapshots (iterations 32, 64, 96) on 64 labeled synthetic
   scenes of phase 10's world, batch 32, with the assessor, a BatchNorm
   warm-up of one batch, renders and deteval XML: per snapshot its metrics,
   seconds and eval images/s, K1's forward launched once per batch and pass
   (3 snapshots x 2 batches x 3 passes), nothing else; a second run
   evaluates nothing (resume); the last snapshot scored on the CPU against
   the card (boxes and mean IoU); phase 8's rotated log dir swept the same
   way on K2's forward; the XML and a render read back;
13. VisualBackprop serving: ``LocalizerInference(use_visual_backprop=True)``
   on phase 3's snapshot at batch 32, the heat map card against CPU, and
   serving images/s with and without it (median of 3 batches each, in
   turns);
14. the port's bench (``loans_tpu_torch.bench.measure`` at its operating
   point: R-50 bf16, batch 128, calls of 10 steps), its JSON line with the
   per-call spread and K1's launches;
15. K1's forward at the SSD augment's shapes, (8, 300^2, 4) -> 300^2 and
   (8, 512^2, 4) -> 512^2 (a scene and its coverage channel), against its
   plain version on the card: windows from the augment's draw function,
   the identity, a 4.0x window around the scene, a 0.3x window in a corner
   and one on an edge; its time per call, L2-warm and L2-cold device time,
   the plain version's and ``F.grid_sample``'s times and the bound;
16. the SSD training CLI (``cli.train_ssd.main`` in this process): SSD300,
   float32, batch 32, 64 iterations in calls of 8 on 256 synthetic scenes
   of one asset world, mAP on 2 val batches every 32 and snapshots at 32
   and 64, K1's forward launched once per iteration and neither backward;
   then SSD512 at batch 8 and SSD300 ``--bf16`` for 16 iterations each,
   and one traced call of the SSD300 step (the largest device items, the
   idle share, K1's share);
17. one SSD300 step at batch 2 on the card against the CPU from the same
   weights and draws: the augmented images, the encoded targets, the
   losses and the parameters after the update;
18. SSD serving and offline evaluation: ``load_inference`` on phase 16's
   log dir gives ``SSDInference``, which serves 2 single frames and 3
   batches of 32 (images/s), its detections held to the CPU's; then
   ``cli.evaluate.main`` sweeps both snapshots (mAP, seconds and images/s
   per snapshot), and a second run evaluates nothing; K1 launches 0.
   Each of phases 15-18 prints its seconds;
19. image files: phase 10's world written as PNGs by the port's writer (an
   image list of 256 scenes, a labeled csv of 512 IoU-labeled crops, 64
   labeled val scenes as a csv and a gt json) and read back by
   ``data/png.py``; its decode rate per row filter, the host resizes'
   rates and ``generate_dataset``; the training CLI on the files for 32
   iterations with the host loader (``--device-data off``, 8 threads,
   ``device_prefetch``) and with device pools (``on``), in turns, K1's
   launches checked (a forward and a d theta a step, a forward an eval
   batch); the loader alone; a traced stretch of steps on the loader (idle
   share); the off run's log dir served and swept against the labeled csv;
   the SSD CLI on the gt json with the host loader and ``--no-augment``
   (K1 launches 0), and the augmenting transform's refusal without cv2;
20. data-parallel training (``loans_tpu_torch.parallel``): ``torchrun
   --standalone --nproc_per_node=<cards>`` runs the training CLI (NCCL) at
   phase 10's configuration for 32 iterations without the pool refresh,
   against a plain process of the same argv, in turns: the logged losses
   alike, K1's launches of every rank counted (this script's ``--cli``
   mode), images/s of both; then two processes on the one card, joined
   over gloo through ``init_distributed(backend="gloo", ...)``, each on half
   of every global batch, against one process at the global batch: the
   pooled alternating step at R-50 (batch 64, 8 steps), the SSD300 step
   with the augmentation (batch 8, 4 steps) and R-18 on K2 at ratio 0.5
   (batch 64, 4 steps), per-step losses, the parameters against the
   update's size, the replicas bit for bit, and each kernel's launches per
   rank;
21. video, live serving and the training monitor on phase 10's log dir: (a)
   ``cli.video_inference.main`` on tools/bench_video.py's clip (240 frames
   of 640x480 of the synthetic world, mp4v, written here) in its six
   configurations (batch 1 serial and pipelined, 8, 32, gated, with
   VisualBackprop) and on phase 8's rotated log dir: sustained fps, 240
   frames written, K1's (K2's) forward once a batch, batch 8's boxes against
   batch 1's; (b) K1's forward at N = 1 and 8 against its plain version with
   its times; (c) ``localize``'s single-frame latency with and without the
   assessor, and an ``AsynchronousLocalizer`` fed the clip through
   ``Camera`` at 30 frames/s: frames submitted, dropped and answered, K1
   once an answered frame, the shutdown; (d) the training CLI for 32
   iterations with the BBoxPlotter every 8 streaming to an ``ImageServer``
   against the same argv without it, under deterministic cuDNN, and a run
   with ``--profile 8 4``: losses bit for bit, the canvases saved and received
   alike, K1 once more a plot, the trace naming K1's kernel, the last canvas
   against the CPU's; (e) the SSD CLI with its plot hook and the sweep's SSD
   renders. Without cv2 the video and live CLIs' refusals are checked
   instead;
22. the offline tools: (a) ``python -m loans_tpu_torch.cli.supervise`` over
   this script's ``--cli`` mode at phase 10's configuration for 48
   iterations (no refresh, a snapshot every 16); the first attempt's
   process group is killed with SIGKILL after its first snapshots, the
   supervisor relaunches it with both ``--resume-*`` flags at the ``_16.pt``
   files, and the resumed run logs from 24 and ends at 48 (rc 0): each
   attempt's K1 launches, the seconds from the kill to the resumed run's
   first log entry; (b) the dataset tools: ``average_snapshots
   --out-iteration 64`` in a copy of the resumed log dir, swept on the card
   with ``--bn-warmup`` (SWA's mAP beside the last snapshot's),
   ``convert_snapshot``'s model-only files served through
   ``LocalizerInference`` with boxes equal to the training snapshots' bit
   for bit, ``extract_frames --resize 224`` and ``blend_videos`` on phase
   21's clip (frames/s), or without cv2 their refusals;
23. backbone pretraining and the pretrained-weight importers: (a)
   ``cli.pretrain_backbone.main`` in this process, R-50 224^2 as a 64-class
   stamp classifier at batch 64 in calls of 50 steps (256 train and 64 val
   scenes), 150 iterations in float32 and 50 in bf16: loss, accuracy and
   images/s per log entry, the validation accuracy, the torchvision export's
   318 tensors, no crop kernel launched; (b) one classifier step at batch 4
   on the card against the CPU from the same weights and flip mask (logits,
   loss, BatchNorm statistics, parameters after the update); (c) (a)'s
   export through ``cli.import_resnet50 --verify``, and the same weights as
   a chainer npz (conv1 in BGR) through ``--source chainer``: the two files'
   tensors equal bit for bit; (d) phase 10's CLI from the imported backbone
   for 16 iterations, every backbone tensor restored and equal to the file's
   before the first step; (e) a VGG16 drawn here in torchvision's layout
   through ``cli.import_vgg16``, then the SSD CLI from it for 8 iterations
   at batch 32, every ``VGG16Extractor_0`` convolution restored;
24. the synthetic cache and data-parallel pretraining: (a) ``python -m
   loans_tpu_torch.cli.warm_cache`` (this script's ``--warm`` mode) at phase
   10's data flags with 2048 ``stn`` reference crops into a fresh
   directory: K1's forward once per render batch, the JAX package's file
   names, the seconds; (b) phase 10's CLI over that cache for one chunk:
   nothing generated or rendered, its pools (a)'s arrays, the ``data:``
   seconds cold against cached, crops/s and the recipe's 32768-crop pool
   worked out from it; (c) phase 10's cache warmed on the CPU against the
   card's: the same names, scenes and labels, the crops one step apart only
   where the two devices' float renders, a few position ulps apart,
   straddle a .5 boundary; (d) ``torchrun --nproc_per_node=<cards>`` of
   the pretraining CLI (this script's ``--pretrain`` mode, NCCL,
   deterministic cuDNN) against the same argv in this process (phase 23's
   for 50 iterations, pools of 64 scenes): the losses and the exports; (e)
   (run by phase 20's ranks, reported here) two gloo ranks sharing the
   card run ``classifier_step`` (R-50 224^2, global batch 64, 4 steps),
   each step against one process's, as phase 20's cases.

The line before the last is a JSON object of the six kernels: launches in
phase 10, the CLI (K1), and phase 8 (K2), with the launches of every path
driven (``launches_by_path``; phases 16 and 18 as ``train_ssd``,
``serve_ssd`` and ``evaluate_ssd``, phase 19 as ``train_cli_files``,
``evaluate_files`` and ``train_ssd_files``, phase 20 as ``train_ddp`` (the two
ranks over gloo, summed) and ``train_cli_torchrun``, phase 21 as
``serve_video`` (b8_pipelined; K2: ``serve_video_rotated``), ``serve_live``,
``train_cli_plot`` and ``train_ssd_plot``, phase 22 as ``train_cli_supervised``
(both attempts, summed) and ``evaluate_swa``, phase 23 as ``pretrain_backbone`` (K1 and K2:
0), ``train_cli_pretrained`` and ``train_ssd_pretrained``, phase 24 as ``warm_cache``,
``train_cli_cached``, ``pretrain_torchrun`` and ``pretrain_ddp`` (the last two 0)),
errors from phases 2, 2b, 7, 15 and 21,
K1's forward's times at phase 15's shapes (``ssd_shapes``) and phase 21's
(``serving_shapes``), times and
bounds at the training batch: ``ms`` per call (CUDA events, host launch
included), ``device_ms`` (profiler, calls back to back), ``device_cold_ms``
(L2 flushed before each call) and ``device_in_situ_ms`` (per launch in the
traced training chunk; null where the path launches none, as for d images).
The last line is ``{"ok": true, "device": {...}}``. Without a CUDA card it
exits with an error before printing either.
"""

from __future__ import annotations

import contextlib
import copy
import functools
import importlib.util
import io
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import xml.etree.ElementTree as ET

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from loans_tpu_torch import bench
from loans_tpu_torch.cli import evaluate, import_resnet50, import_vgg16, pretrain_backbone, train_localizer, train_ssd
from loans_tpu_torch.cli.bench_samplers import FLUSH_BYTES, device_events, device_time, fmt_us
from loans_tpu_torch.data import ssd_device, synthetic
from loans_tpu_torch.data.cv_resize import resize_linear
from loans_tpu_torch.data.datasets import LabeledImageDataset, resize_image
from loans_tpu_torch.data.device_data import device_chunk_batches
from loans_tpu_torch.data.loader import DataLoader, device_prefetch, padded_collate
from loans_tpu_torch.data.png import read_png
from loans_tpu_torch.data.ssd_augment import SSDTransform
from loans_tpu_torch.evaluation.evaluator import Evaluator
from loans_tpu_torch.inference import SSDInference, load_inference
from loans_tpu_torch.inference.localizer import LocalizerInference, set_precision
from loans_tpu_torch.insights.rendering import write_png
from loans_tpu_torch.models import SSD300
from loans_tpu_torch.models.resnet import ResNet
from loans_tpu_torch.ops import _cuda, stn
from loans_tpu_torch.ops.geometry import Size, box_to_theta, corners_to_aabb, theta_corners
from loans_tpu_torch.ops.stn import sample_rotated_kernel, sample_separable, sample_separable_kernel
from loans_tpu_torch.train import (
    AlternatingConfig,
    MetricsLog,
    Trainer,
    alternating_step,
    checkpoint,
    create_ssd_train_state,
    create_train_state,
    make_eval_step,
    pooled_step,
    ssd_train_step,
    to_float01,
)
from loans_tpu_torch.utils.registry import build_assessor, build_model

SEED = 0
DEVICE = "cuda"
INPUT, CROP, BATCH = 224, 75, 32
TRAIN_BATCH, STEPS_PER_CALL, TIMED_CHUNKS, LR = 64, 8, 3, 1e-3
POOL_SCENES, POOL_CROPS = 512, 1024
K1_TOL = 1e-5  # absolute, images in [0, 1]
# backward kernels against the plain backward on the card: d theta sums
# ~17k products per image in another order (a fixed tree in the kernel,
# matmuls in the plain version), so relative to its largest entry. d images
# sums a pixel's products in a fixed order in the kernel and in the plain
# version's matmuls or scatter in theirs; a float32 sum of n terms errs by
# up to about n * 2^-24 of their magnitude, in either order. So d images is
# held to the larger of 1e-5 absolute (a few products of cotangents of
# order 1: every crop of 224^2 -> 75^2 at scales of 0.3 and more) and n *
# 2^-24 of its largest entry, n the most products any pixel of this call
# sums (dimages_terms): 51 on the 16x800 crop of a 64^2 image, over 100
# on an upsampled 64^2 -> 200^2 crop. n * 2^-24 is capped at 1e-5 of the
# largest entry, as d theta, where a pixel sums hundreds or thousands (a
# zero scale sends all h_out * w_out = 5625 outputs to a pixel, a rank-1
# theta a line of them).
K1_BWD_TOL = {"dtheta_rel": 1e-5, "dimages_abs": 1e-5, "dimages_rel": 1e-5}
# K2 against its plain version on the card: the forward runs the plain
# version's float32 operations in its order, so it is held bit for bit
# (NaN where the plain version is NaN); d theta sums 5625 pixels' products
# per image in a fixed tree against torch's reductions; d images as K1's
K2_TOL = {"dtheta_rel": 1e-5, "dimages_abs": 1e-5, "dimages_rel": 1e-5}
# degenerate thetas for d images (phases 2b and 7): every output on one
# pixel, negative scales, an infinite theta00 at odd w_out (u = 0 exactly at
# j = 32 of 65, where inf * 0 is NaN: that image's d images all NaN) and
# theta00 = 1e30 (past 2^96, so K2 scans its positions for NaN; none is)
ZERO_SCALE = [[0, 0, -0.21], [0, 0, 0.13]]
FLIP = [[-0.7, 0.2, 0.1], [-0.15, -0.9, 0.05]]
INF_THETA = [[np.inf, 0.1, 0.1], [0.2, 0.5, 0]]
HUGE_THETA = [[1e30, 0.1, 0.1], [0.2, 0.5, 0]]
# card against CPU: float32 on both, sums in another order. The crop is
# held at the card's theta (the kernel against the CPU's plain crop, as in
# phase 2); end to end, a theta error d moves a sample by up to
# 2 * d * (INPUT - 1) / 2 px per axis (scale and shift), and these frames
# step by up to 1.0 between pixels at the rectangles' edges, so the crops
# may differ by 2 * d * (INPUT - 1) on top of rounding (rois_end_to_end).
# the stn renders' uint8 crops, K1 against the plain sampler: the two sum
# in another order, so a float within rounding of a .5 boundary may round to
# the other uint8 value; one step on at most 1e-3 of the pixels, as
# tests/test_torch_synthetic.py holds the port's renders to JAX's
RENDER_TOL = {"steps": 1, "share": 1e-3}
SLICE_TOL = {"theta": 1e-4, "boxes_px": 1e-2, "rois_at_card_theta": 1e-5, "scores": 1e-4}
# two training steps, card against CPU, float32, TF32 off: cuDNN's and the
# CPU's convolutions (and their backwards) sum in another order. Relative
# to each tensor's largest entry: losses 1e-3 (from step 2 on, the
# localizer's loss is mostly the out-of-image sum, linear in theta, which
# follows the R-50 features; serving's theta agrees card vs CPU to ~2e-5
# of its size in phase 4, and step 2 moves theta far off the image, where
# the sum is large); theta's gradient 1e-2: at
# step 1 it is only the assessor's, a sum of ~17k products per image with
# both signs, over a cotangent in which the few ReLUs whose input lies
# within float32 rounding of 0 switch differently on the two devices
# (phase 2b holds the kernel itself to 1e-5 on identical inputs); the
# head's gradient 1e-3; the stem conv's gradient loses digits in float32
# even on one device (0.7% of its largest entry against float64 in the CPU
# tests), so 5e-2; BatchNorm running statistics 1e-4. The crops' cotangent
# itself is printed, not held: a switched ReLU moves a whole receptive
# field's gradient, so its largest elementwise difference is of the order
# of the gradient (each convolution's dgrad alone agrees to 2e-6).
STEP_TOL = {"loss": 1e-3, "dtheta": 1e-2, "head_grad": 1e-3, "stem_grad": 5e-2, "bn_stats": 1e-4}
# phase 12: the evaluation CLI's scenes; card against CPU, the last
# snapshot's boxes after the same BatchNorm warm-up: phase 4's tolerance (the
# same float32 networks, TF32 off; a warm-up on 32 images moves the
# statistics by a float32 sum's error), and its mean IoU by what that moves
EVAL_SCENES = 64
EVAL_TOL = {"boxes_px": SLICE_TOL["boxes_px"]}
# phase 13: the heat map, card against CPU. It multiplies and renormalizes
# the channel means of the 50 recorded maps of R-50, each computed in float32 by cuDNN
# and the CPU in another order (phase 4: theta within ~2e-5 of its size);
# against JAX on the CPU the port's agrees within 1e-6. 1e-3 is a quarter
# of one step of the served uint8 image.
VBP_TOL = 1e-3
# H100 SXM peaks at 700 W (NVIDIA data sheet): HBM bytes/s and float32
# FLOP/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
FLUSH_MB = FLUSH_BYTES // 2**20
MANIFEST = {
    "localizer": {
        "model": "Localizer",
        "kwargs": {
            "out_size": [CROP, CROP],
            "n_layers": 50,
            "input_size": [INPUT, INPUT],
            "rotation_dropout_ratio": 0.0,
            "transform_rois_to_grayscale": False,
        },
    },
    "assessor": {"model": "ResnetAssessor", "kwargs": {}},
    "snapshot_names": ["Localizer", "ResnetAssessor"],
}
# rotation-dropout training and serving (phases 8 and 9): the same model
# at the JAX sampler bench's rotation ratio, on the rotated crop's kernels
ROTATED_KWARGS = {"rotation_dropout_ratio": 0.5, "sampler": "rotated_pallas"}
COUNTERS = {"fwd": "launches", "bwd_theta": "launches_bwd_theta", "bwd_images": "launches_bwd_images"}
KERNELS = {"K1": sample_separable_kernel, "K2": sample_rotated_kernel}
LIBRARIES = {"K1": "separable_sampler", "K2": "rotated_sampler"}
NO_LAUNCHES = {"fwd": 0, "bwd_theta": 0, "bwd_images": 0}
# phases 10 and 11: the training CLI at full width (R-50 224->75, batch 64)
# on synthetic data, as a user runs it on one card
# 96 iterations, so that the refresh submitted at chunk 2 (iteration 16) has
# 9 chunk boundaries to be swapped in at: twice the ~4.4 s its 512 crops take
# to generate alone, even at the step's full rate; a snapshot every 32, so
# that phase 12 has a sweep of three to evaluate
CLI_ITERATIONS, CLI_EVAL_BATCHES, CLI_SNAPSHOT_INTERVAL = 96, 2, 32
CLI_ARGV = [
    "synthetic:256", "synthetic:512", "synthetic:64", "--batch-size", str(TRAIN_BATCH),
    "--n-layers", "50", "--target-size", str(INPUT), str(INPUT), "--crop-size", str(CROP), str(CROP),
    "--iterations", str(CLI_ITERATIONS), "--steps-per-call", str(STEPS_PER_CALL),
    "--log-interval", str(STEPS_PER_CALL), "--snapshot-interval", str(CLI_SNAPSHOT_INTERVAL),
    "--eval-batches", str(CLI_EVAL_BATCHES), "--assessor-pipeline", "stn", "--assessor-refresh", "16",
    "--synthetic-assets", "16", "--device", DEVICE,
]
# phases 15-18: the SSD baseline. Phase 15 holds K1's forward at the SSD
# augment's shapes, (8, S, S, 4) -> S^2 (the scene and its coverage
# channel), to its plain version, at K1_TOL
SSD_CROP_BATCH = 8
# phase 16: the SSD training CLI as the README runs it (SSD300, batch 32) on
# synthetic data of one asset world; mAP on 2 val batches every 32
# iterations and a snapshot every 32, so that phase 18 sweeps two
SSD_ITERATIONS, SSD_BATCH, SSD_LOG_INTERVAL, SSD_EVAL_INTERVAL = 64, 32, 16, 32
SSD_ARGV = [
    "synthetic:256", "synthetic:32", "--model", "ssd300", "--batch-size", str(SSD_BATCH),
    "--iterations", str(SSD_ITERATIONS), "--steps-per-call", str(STEPS_PER_CALL),
    "--log-interval", str(SSD_LOG_INTERVAL), "--eval-interval", str(SSD_EVAL_INTERVAL), "--eval-batches", "2",
    "--snapshot-interval", str(SSD_EVAL_INTERVAL), "--synthetic-assets", "16", "--device", DEVICE,
]
SSD_SHORT = ["--iterations", "16", "--snapshot-interval", "16"]
# phase 17: one SSD300 step (batch 2) on the card against the CPU, the same
# weights and draws, TF32 off. The augmented images: the crop's positions
# come from float32 exp/log/sqrt of the draws, which the card and the CPU
# may round an ulp apart: a few ulps of a coordinate up to 4 x 300 px
# (1.2e-4 px each) where the scenes step by up to 1 between pixels, so
# 2e-4 (tests/test_torch_ssd_device.py holds the port to JAX the same way).
# The encoded classes exactly, but at anchors whose best IoU lies within
# 1e-5 of the 0.5 gate (counted, expected none); the offsets 1e-3 (order
# 1-10, a log of float32 box sides). The losses 1e-4 relative (float32
# cuDNN against the CPU's convolutions, activations in the hundreds; the
# CPU tests measure 2.3e-6 against JAX). The parameters after the update
# within 2 lr + 1e-7 everywhere (Adam moves a weight by about lr in its
# gradient's sign, which a gradient within float32 error of 0 may flip)
# and within 1e-6 on 99% of the entries
SSD_STEP_TOL = {"images": 2e-4, "loc": 1e-3, "iou_margin": 1e-5, "loss": 1e-4, "params_share": 0.99}
SSD_LR = 1e-4
# phase 23 (b): one classifier step (batch 4, full width, TF32 off), card against CPU,
# relative to each tensor's largest entry: the logits 1e-4 (R-50's float32
# features summed in another order by cuDNN and the CPU; phase 4 holds
# serving's theta, a dense layer on the same features, to ~2e-5); the loss
# 1e-4 (a cross-entropy of those logits); the BatchNorm statistics STEP_TOL's
# 1e-4; the parameters after the update as phase 17's (Adam moves a weight by
# about lr in its gradient's sign, which a gradient within float32 error of 0
# may flip): within 2 lr + 1e-7 everywhere and 1e-6 on 99% of the entries
PRETRAIN_STEP_TOL = {"logits": 1e-4, "loss": 1e-4, "bn_stats": STEP_TOL["bn_stats"],
                     "params_share": SSD_STEP_TOL["params_share"]}
# phase 18: the served detections, card against CPU, at a score gate of
# 0.1 (phase 16's young model passes the served 0.6 with few boxes), where
# a score is more than 0.05 from the gate (a box nearer may pass on one
# device only): every such anchor passes on both, its box to phase 4's
# 1e-2 px and its score to 1e-4; after NMS the same boxes kept, but at
# most 1% (a suppression whose IoU lies within rounding of 0.45 may go
# either way)
SSD_SERVE_TOL = {"gate": 0.1, "margin": 0.05, "boxes_px": SLICE_TOL["boxes_px"], "scores": 1e-4}
SSD_VAL_SEED, SSD_ASSET_SEED = SEED + 1, SEED + 9973  # the SSD CLI's val split and asset world


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke FAILED: {what}")


def reset_launches() -> None:
    for owner in KERNELS.values():
        for attr in COUNTERS.values():
            setattr(owner, attr, 0)


def read_launches() -> dict[str, dict[str, int]]:
    """Launches of each kernel since ``reset_launches``, by crop."""
    return {name: {k: getattr(owner, attr) for k, attr in COUNTERS.items()}
            for name, owner in KERNELS.items()}


def with_kwargs(**kwargs) -> dict:
    """``MANIFEST`` with these localizer kwargs changed."""
    loc = {"model": "Localizer", "kwargs": {**MANIFEST["localizer"]["kwargs"], **kwargs}}
    return {**MANIFEST, "localizer": loc}


def max_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest absolute difference; inf unless both are NaN at the same
    entries, which are left out."""
    nan = torch.isnan(want)
    if not torch.equal(torch.isnan(got), nan):
        return float("inf")
    diff = (got - want)[~nan].abs()
    return float(diff.max()) if diff.numel() else 0.0


def bit_identical(got: torch.Tensor, want: torch.Tensor) -> bool:
    """NaN exactly where ``want`` is NaN, and the same bits everywhere
    else."""
    nan = torch.isnan(want)
    return torch.equal(torch.isnan(got), nan) and torch.equal(
        got[~nan].view(torch.int32), want[~nan].view(torch.int32))


def dimages_terms(theta: torch.Tensor, out_size: Size, h: int, w: int, rotated: bool) -> int:
    """The most products one pixel of d images sums in this call: the
    outputs (i, j) with a non-zero hat on it along both axes."""
    if not rotated:  # (#i reaching row y) * (#j reaching column x)
        rows = (stn._hat(stn._offsets(theta[:, 1, 1], theta[:, 1, 2], out_size.height, h)) > 0).sum(1)
        cols = (stn._hat(stn._offsets(theta[:, 0, 0], theta[:, 0, 2], out_size.width, w)) > 0).sum(1)
        return int((rows.amax(1) * cols.amax(1)).max())
    n = theta.shape[0]
    px, py = stn._rotated_positions(theta, out_size, h, w)
    xs, ys = stn._axis_taps(px, w), stn._axis_taps(py, h)
    counts = torch.zeros(n * h * w, device=theta.device)
    base = torch.arange(n, device=theta.device)[:, None, None] * (h * w)
    for ty in ys:
        for tx in xs:
            live = (ty.hat > 0) & (tx.hat > 0)
            index = (base + ty.index * w + tx.index)[live]
            counts.index_add_(0, index, torch.ones_like(index, dtype=counts.dtype))
    return int(counts.max())


def dimages_tol(tol: dict, terms: int, largest: float) -> float:
    """The d images tolerance of a call whose pixels sum up to ``terms``
    products and whose largest entry is ``largest`` (see K1_BWD_TOL)."""
    return max(tol["dimages_abs"], min(terms * 2.0**-24, tol["dimages_rel"]) * largest)


def cuda_ms(fn, reps: int = 25) -> float:
    """Median CUDA-event time of ``fn`` in ms, after 3 warm-up runs."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_us(fn, match: str = "", cold: bool = False) -> float | None:
    """``device_time``'s µs per call alone."""
    return device_time(fn, match=match, cold=cold).per_call_us


def ms(us: float | None) -> float | None:
    return None if us is None else us / 1e3


def one_kernel_device_times(tag: str, name: str, kernel, n: int, card: str) -> dict:
    """The kernel ``name``'s device time per call, L2-warm and L2-cold, by
    its name; checks that a call is that one kernel and nothing else on the
    card (no fill, no finish, no table pre-pass)."""
    warm = device_time(kernel, match=name)
    cold = device_time(kernel, match=name, cold=True)
    for t in (warm, cold):
        check(len(t.names) == 1 and name in t.names[0] and t.ops_per_call <= 1,
              f"{tag} {name} N={n}: a call ran {t.names}, {t.ops_per_call:g} device operations per call")
    kind = name.split("_sampler_")[1]
    print(f"{tag} {kind} N={n}: device time (profiler, {name}) {fmt_us(warm.per_launch_us)} "
          f"L2-warm, {fmt_us(cold.per_launch_us)} L2-cold (a {FLUSH_MB} MiB copy before each call); "
          f"one device operation per call, {warm.names[0][:60]} ({card})")
    return {"device_ms": ms(warm.per_launch_us), "device_cold_ms": ms(cold.per_launch_us)}


def scenes(rng: np.random.Generator, n: int, size: int) -> np.ndarray:
    """Noise backgrounds, each with one bright rectangle pasted in."""
    frames = rng.uniform(0.0, 0.5, size=(n, size, size, 3)).astype(np.float32)
    for f in frames:
        y, x = rng.integers(0, size // 2, 2)
        h, w = rng.integers(size // 4, size // 2, 2)
        f[y : y + h, x : x + w] = rng.uniform(0.7, 1.0, 3)
    return frames


def on_card(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(DEVICE)


# -- phase 1 --------------------------------------------------------------
def environment() -> str:
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(card)
    nvcc = subprocess.run(
        [_cuda.nvcc_path(), "--version"], capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[-1]
    print(f"env: torch {torch.__version__}, CUDA {torch.version.cuda}, nvcc {nvcc}, "
          f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
          + ", ".join(f"{m} {'installed' if importlib.util.find_spec(m) else 'absent'}" for m in ("PIL", "cv2", "matplotlib")))
    start = time.perf_counter()
    _cuda.build_all()
    for name in _cuda.SIGNATURES:
        _cuda.load_library(name)
    build_s = time.perf_counter() - start
    print(f"build: {len(_cuda.SIGNATURES)} CUDA libraries in {build_s:.2f} s (one nvcc each, in parallel)")
    for name in _cuda.SIGNATURES:
        log = _cuda.library_path(name).with_suffix(".log").read_text()
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"build: {name}: {line.strip()}")
    return card


# -- bounds and the library yardstick ---------------------------------------
def bound(kernel: str, images: torch.Tensor, theta: torch.Tensor, out_size: Size) -> tuple[float, str]:
    """The least time (ms) the card could take for one call at these
    inputs, and whether bytes or operations set it: each input read once
    (of the images, the region that this run's taps touch), each output
    written once, over the HBM rate; the float32 operations that these
    taps need over the float32 rate."""
    n, h, w, c = images.shape
    ho, wo = out_size
    dy = stn._offsets(theta[:, 1, 1], theta[:, 1, 2], ho, h)
    dx = stn._offsets(theta[:, 0, 0], theta[:, 0, 2], wo, w)
    if kernel == "bwd_theta":  # taps where the hat or its derivative is non-zero
        ty = (stn._hat(dy) != 0) | (stn._hat_grad(dy) != 0)
        tx = (stn._hat(dx) != 0) | (stn._hat_grad(dx) != 0)
    else:
        ty, tx = stn._hat(dy) != 0, stn._hat(dx) != 0
    region = float((ty.any(1).sum(1) * tx.any(1).sum(1)).sum()) * c * 4
    ny, nx = ty.sum(-1).double(), tx.sum(-1).double()  # taps per output row / column
    crop_bytes, theta_bytes = n * ho * wo * c * 4, n * 24
    pairs = float((ny.sum(1) * nx.sum(1)).sum()) * c  # (row tap, column tap) pairs
    cols = float(nx.sum() * ho) * c
    if kernel == "fwd":  # read the region, write the crop
        nbytes, flops = region + crop_bytes + theta_bytes, 2 * pairs + 2 * cols
    elif kernel == "bwd_theta":  # read the region and g, write d theta
        nbytes, flops = region + crop_bytes + 2 * theta_bytes, 4 * pairs + 4 * cols + 10 * n * ho * wo * c
    else:  # read g, write all of d images
        nbytes, flops = crop_bytes + n * h * w * c * 4 + theta_bytes, 3 * pairs
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def library_crop(images_nchw: torch.Tensor, theta: torch.Tensor, out_size: Size) -> torch.Tensor:
    """The same crop as one PyTorch call: ``F.grid_sample`` over
    ``F.affine_grid`` (align corners, zero padding). A yardstick only."""
    grid = F.affine_grid(
        theta, (theta.shape[0], images_nchw.shape[1], out_size.height, out_size.width),
        align_corners=True,
    )
    return F.grid_sample(images_nchw, grid, mode="bilinear", padding_mode="zeros", align_corners=True)


def axis_aligned_theta(rng, n):
    theta = np.zeros((n, 2, 3), dtype=np.float32)
    theta[:, 0, 0] = rng.uniform(0.3, 1.1, n)
    theta[:, 1, 1] = rng.uniform(0.3, 1.1, n)
    theta[:, 0, 2] = rng.uniform(-0.4, 0.4, n)
    theta[:, 1, 2] = rng.uniform(-0.4, 0.4, n)
    return theta


BORDER_THETA = np.array(
    [[[0.6, 0, 0.7], [0, 0.5, 0.8]], [[0.8, 0, -0.9], [0, 0.9, -1.2]],
     [[1.2, 0, 0.0], [0, 1.3, 0.1]], [[0.3, 0, 0.95], [0, 0.3, -0.95]]],
    np.float32,
)


# -- phase 2 --------------------------------------------------------------
def kernel_against_plain(card: str) -> dict:
    rng = np.random.default_rng(SEED)

    def compare(name, images, theta, out_size, expect=None):
        images, theta = on_card(images), on_card(theta)
        got = sample_separable_kernel(images, theta, out_size)
        want = sample_separable(images, theta, out_size)
        torch.cuda.synchronize()
        err = max_err(got, want)
        if expect is not None:
            err = max(err, max_err(got, expect))
        check(err <= K1_TOL, f"K1 {name}: max abs err {err} > {K1_TOL}")
        print(f"K1 {name}: max_abs_err {err:.3e} (tol {K1_TOL})")
        return err, images, theta

    out = Size(CROP, CROP)
    errs, times = [], {}
    for n in (BATCH, TRAIN_BATCH, 128):
        imgs = rng.uniform(size=(n, INPUT, INPUT, 3)).astype(np.float32)
        err, images, theta = compare(f"N={n} {INPUT}^2->{CROP}^2", imgs, axis_aligned_theta(rng, n), out)
        errs.append(err)
        images_nchw = images.permute(0, 3, 1, 2).contiguous()
        kernel = lambda: sample_separable_kernel(images, theta, out)  # noqa: E731
        plain = lambda: sample_separable(images, theta, out)  # noqa: E731
        library = lambda: library_crop(images_nchw, theta, out)  # noqa: E731
        lib_err = float((library().permute(0, 2, 3, 1) - kernel()).abs().max())
        call_ms, plain_ms, lib_ms = cuda_ms(kernel), cuda_ms(plain), cuda_ms(library)
        bound_ms, bound_by = bound("fwd", images, theta, out)
        times[n] = {"ms": call_ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                    "bound_ms": bound_ms, "bound_by": bound_by}
        print(f"K1 N={n}: per call (CUDA events, host launch included) kernel "
              f"{call_ms * 1e3:.1f} us, plain bmm {plain_ms * 1e3:.1f} us, library grid_sample "
              f"{lib_ms * 1e3:.1f} us (max abs diff to the kernel {lib_err:.2e}); bound "
              f"{bound_ms * 1e3:.2f} us ({bound_by}) ({card})")
        times[n].update(one_kernel_device_times("K1", "separable_sampler_fwd", kernel, n, card))
        print(f"K1 N={n}: device time (profiler) kernel {fmt_us(times[n]['device_ms'] * 1e3)}, plain bmm "
              f"{fmt_us(device_us(plain))}, library {fmt_us(device_us(library))} ({card})")

    small = rng.uniform(size=(4, CROP, CROP, 3)).astype(np.float32)
    identity = np.tile(np.array([[1, 0, 0], [0, 1, 0]], np.float32), (4, 1, 1))
    errs.append(compare("identity", small, identity, out, expect=on_card(small))[0])
    ties = rng.uniform(size=(4, 129, 129, 3)).astype(np.float32)  # p_i = i: every position a tie
    errs.append(compare("identity 129^2->129^2 (all ties)", ties, identity, Size(129, 129), expect=on_card(ties))[0])
    imgs = rng.uniform(size=(4, INPUT, INPUT, 3)).astype(np.float32)
    off = np.tile(np.array([[0.5, 0, 5.0], [0, 0.5, 5.0]], np.float32), (4, 1, 1))
    errs.append(compare("off-image", imgs, off, out, expect=torch.zeros(4, CROP, CROP, 3, device=DEVICE))[0])
    errs.append(compare("border", imgs, BORDER_THETA, out)[0])
    errs.append(compare("h_out=1", imgs, axis_aligned_theta(rng, 4), Size(1, CROP))[0])
    errs.append(compare("w_out=1", imgs, axis_aligned_theta(rng, 4), Size(CROP, 1))[0])
    nan = axis_aligned_theta(rng, 4)
    nan[1, 1, 1] = np.nan  # NaN py everywhere in image 1: that image's crop NaN
    errs.append(compare("NaN theta", imgs, nan, out)[0])
    # consecutive output rows share input rows
    small = rng.uniform(size=(4, 64, 64, 3)).astype(np.float32)
    errs.append(compare("upsampled 64^2->200^2", small, axis_aligned_theta(rng, 4), Size(200, 200))[0])
    for c in (1, 4):  # not only the three channels of the main path
        imgs = rng.uniform(size=(4, INPUT, INPUT, c)).astype(np.float32)
        errs.append(compare(f"C={c}", imgs, axis_aligned_theta(rng, 4), out)[0])
    # the other batches of the CLI's path: served batches of 8 frames and
    # the stn pipeline's renders of RENDER_BATCH crops
    for n in (8, synthetic.RENDER_BATCH):
        imgs = rng.uniform(size=(n, INPUT, INPUT, 3)).astype(np.float32)
        errs.append(compare(f"N={n} {INPUT}^2->{CROP}^2", imgs, axis_aligned_theta(rng, n), out)[0])
    return {"max_abs_err": max(errs), "times": times}


# -- phase 2b -------------------------------------------------------------
def backward_against_plain(card: str) -> dict:
    rng = np.random.default_rng(SEED + 3)
    errs = {"bwd_theta": 0.0, "bwd_images": 0.0}

    def compare(name, images, theta, out_size, theta_defined=True):
        """``theta_defined`` false: an infinite or huge theta, whose d theta
        is not compared (only d images)."""
        images, theta = on_card(images), on_card(theta)
        shape = (images.shape[0], out_size.height, out_size.width, images.shape[3])
        g = on_card(rng.normal(size=shape).astype(np.float32))
        want_img, want_theta = stn.sample_separable_bwd(images, theta, g, out_size)
        got_theta = stn.separable_sampler_bwd_theta(images, theta, g)
        again = stn.separable_sampler_bwd_theta(images, theta, g)
        got_img = stn.separable_sampler_bwd_images(theta, g, tuple(images.shape))
        again_img = stn.separable_sampler_bwd_images(theta, g, tuple(images.shape))
        torch.cuda.synchronize()
        check(torch.equal(got_theta.view(torch.int32), again.view(torch.int32)),
              f"K1 bwd_theta {name}: two runs differ")
        check(torch.equal(got_img.view(torch.int32), again_img.view(torch.int32)),
              f"K1 bwd_images {name}: two runs differ")
        e_t = max_err(got_theta, want_theta) if theta_defined else 0.0
        e_i = max_err(got_img, want_img)
        s_t = float(want_theta.nan_to_num().abs().max())
        s_i = float(want_img.nan_to_num().abs().max())
        terms = dimages_terms(theta, out_size, images.shape[1], images.shape[2], rotated=False)
        tol_i = dimages_tol(K1_BWD_TOL, terms, s_i)
        print(f"K1 bwd {name}: " + (f"dtheta max_abs_err {e_t:.3e}, max_rel_err {e_t / max(s_t, 1e-30):.3e} "
                                    f"(tol {K1_BWD_TOL['dtheta_rel']:g} of max |dtheta| {s_t:.4g}); "
                                    if theta_defined else "dtheta not compared; ")
              + f"dimages max_abs_err {e_i:.3e}, max_rel_err {e_i / max(s_i, 1e-30):.3e} (tol {tol_i:.3g}, "
              f"up to {terms} products a pixel, max |dimages| {s_i:.4g}, NaN in {int(torch.isnan(got_img).flatten(1).all(1).sum())} images "
              f"throughout, as the plain version); both bit-identical between two runs")
        check(e_t <= K1_BWD_TOL["dtheta_rel"] * s_t, f"K1 bwd_theta {name}: {e_t} > tol")
        check(e_i <= tol_i, f"K1 bwd_images {name}: {e_i} > {tol_i}")
        errs["bwd_theta"] = max(errs["bwd_theta"], e_t)
        errs["bwd_images"] = max(errs["bwd_images"], e_i)
        return images, theta, g

    out = Size(CROP, CROP)
    times = {}
    for n in (TRAIN_BATCH, 128):
        imgs = rng.uniform(size=(n, INPUT, INPUT, 3)).astype(np.float32)
        images, theta, g = compare(f"N={n} {INPUT}^2->{CROP}^2", imgs, axis_aligned_theta(rng, n), out)
        images_nchw, g_nchw = (t.permute(0, 3, 1, 2).contiguous() for t in (images, g))
        theta_req = theta.clone().requires_grad_()
        lib_out_t = library_crop(images_nchw, theta_req, out)
        images_req = images_nchw.clone().requires_grad_()
        lib_out_i = library_crop(images_req, theta, out)
        calls = {
            "bwd_theta": (
                lambda: stn.separable_sampler_bwd_theta(images, theta, g),
                lambda: stn.sample_separable_bwd(images, theta, g, out, need_images=False),
                lambda: torch.autograd.grad(lib_out_t, theta_req, g_nchw, retain_graph=True),
            ),
            "bwd_images": (
                lambda: stn.separable_sampler_bwd_images(theta, g, tuple(images.shape)),
                lambda: stn.sample_separable_bwd(images, theta, g, out, need_theta=False),
                lambda: torch.autograd.grad(lib_out_i, images_req, g_nchw, retain_graph=True),
            ),
        }
        used = (slice(None), [0, 0, 1, 1], [0, 2, 1, 2])  # the entries the crop reads
        lib_dtheta = calls["bwd_theta"][2]()[0][used]
        plain_dtheta = calls["bwd_theta"][1]()[1][used]
        print(f"K1 bwd N={n}: library grid_sample dtheta (scales and shifts) against the plain "
              f"backward: max rel diff "
              f"{float((lib_dtheta - plain_dtheta).abs().max() / plain_dtheta.abs().max()):.2e}")
        for name, (kernel, plain, library) in calls.items():
            call_ms, plain_ms, lib_ms = cuda_ms(kernel), cuda_ms(plain), cuda_ms(library)
            bound_ms, bound_by = bound(name, images, theta, out)
            t = {"ms": call_ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                 "bound_ms": bound_ms, "bound_by": bound_by}
            print(f"K1 {name} N={n}: per call (CUDA events, host launch included) kernel "
                  f"{call_ms * 1e3:.1f} us, plain {plain_ms * 1e3:.1f} us, library grid_sample backward "
                  f"{lib_ms * 1e3:.1f} us; bound {bound_ms * 1e3:.2f} us ({bound_by}) ({card})")
            t.update(one_kernel_device_times("K1", f"separable_sampler_{name}", kernel, n, card))
            times.setdefault(name, {})[n] = t
            print(f"K1 {name} N={n}: device time (profiler) kernel {fmt_us(t['device_ms'] * 1e3)}, "
                  f"plain {fmt_us(device_us(plain))}, library {fmt_us(device_us(library))} ({card})")

    ties = rng.uniform(size=(4, 129, 129, 3)).astype(np.float32)  # p_i = i: every position a tie
    compare("identity 129^2->129^2 (all ties)", ties,
            np.tile(np.array([[1, 0, 0], [0, 1, 0]], np.float32), (4, 1, 1)), Size(129, 129))
    imgs = rng.uniform(size=(4, INPUT, INPUT, 3)).astype(np.float32)
    compare("off-image", imgs, np.tile(np.array([[0.5, 0, 5.0], [0, 0.5, 5.0]], np.float32), (4, 1, 1)), out)
    compare("border", imgs, BORDER_THETA, out)
    compare("h_out=1", imgs, axis_aligned_theta(rng, 4), Size(1, CROP))
    compare("w_out=1", imgs, axis_aligned_theta(rng, 4), Size(CROP, 1))
    nan = axis_aligned_theta(rng, 4)
    nan[1, 1, 1] = np.nan  # NaN py everywhere in image 1: its four used entries NaN
    compare("NaN theta", imgs, nan, out)
    compare("zero scale", imgs, np.tile(np.float32(ZERO_SCALE), (4, 1, 1)), out)
    compare("flipped scale", imgs, np.tile(np.float32(FLIP), (4, 1, 1)), out)
    small = rng.uniform(size=(4, 64, 64, 3)).astype(np.float32)  # several outputs per input row
    compare("upsampled 64^2->200^2", small, axis_aligned_theta(rng, 4), Size(200, 200))
    # 800 output columns over a 64-pixel row: the g window of an output row
    # that reaches it (2,400 floats) is wider than the kernel stages in
    # shared memory (kDimgGRow), so the column sums read g from global memory
    wide = np.tile(np.float32([[0.5, 0, 0.05], [0, 0.5, -0.05]]), (4, 1, 1))
    compare("upsampled 64^2->16x800 (g window past the stage)", small, wide, Size(16, 800))
    for what, rows, size in (("infinite theta00, w_out=65", INF_THETA, Size(CROP, 65)),
                             ("huge theta00 1e30", HUGE_THETA, out)):
        theta = axis_aligned_theta(rng, 4)
        theta[1] = rows
        compare(what, imgs, theta, size, theta_defined=False)
    return {"max_abs_err": errs, "times": times}


# -- phase 7 --------------------------------------------------------------
def rotated_bound(kernel: str, images: torch.Tensor, theta: torch.Tensor, out_size: Size) -> tuple[float, str]:
    """``bound`` for the rotated crop (K2): the region read is the union
    of this run's live 4-tap sets (a tap is live where its hat weight is
    non-zero; hat' is non-zero only there), not a rows x columns product.
    Operations per live tap and channel: a multiply and an add in its row,
    and the row's weight (forward); hat and hat' products and their sums,
    and g's (d theta); two products and the add (d images)."""
    n, h, w, c = images.shape
    px, py = stn._rotated_positions(theta, out_size, h, w)
    xs, ys = stn._axis_taps(px, w), stn._axis_taps(py, h)
    touched = torch.zeros(n * h * w, dtype=torch.bool, device=images.device)
    base = torch.arange(n, device=images.device)[:, None, None] * (h * w)
    taps = 0.0
    for ty in ys:
        for tx in xs:
            live = (ty.hat != 0) & (tx.hat != 0)
            touched[(base + ty.index * w + tx.index)[live]] = True
            taps += float(live.sum())
    region = float(touched.sum()) * c * 4
    pixels = n * out_size.height * out_size.width
    crop_bytes, theta_bytes = pixels * c * 4, n * 24
    if kernel == "fwd":  # read the region, write the crop
        nbytes, flops = region + crop_bytes + theta_bytes, 4 * taps * c
    elif kernel == "bwd_theta":  # read the region and g, write d theta
        nbytes, flops = region + crop_bytes + 2 * theta_bytes, 8 * taps * c + 4 * pixels * c + 12 * pixels
    else:  # read g, write all of d images
        nbytes, flops = crop_bytes + n * h * w * c * 4 + theta_bytes, 3 * taps * c
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def rotated_theta(rng, n):
    theta = axis_aligned_theta(rng, n)
    theta[:, 0, 1] = rng.uniform(-0.3, 0.3, n)
    theta[:, 1, 0] = rng.uniform(-0.3, 0.3, n)
    return theta


def rotated_against_plain(card: str) -> dict:
    """K2's forward, d theta and d images against ``sample_rotated`` and
    ``sample_rotated_bwd`` on the card."""
    rng = np.random.default_rng(SEED + 7)
    errs = {"fwd": 0.0, "bwd_theta": 0.0, "bwd_images": 0.0}

    def compare(name, images, theta, out_size, ties=False, theta_defined=True):
        """``theta_defined`` as in phase 2b."""
        images, theta = on_card(images), on_card(theta)
        shape = (images.shape[0], out_size.height, out_size.width, images.shape[3])
        g = on_card(rng.normal(size=shape).astype(np.float32))
        got = sample_rotated_kernel(images, theta, out_size)
        want = stn.sample_rotated(images, theta, out_size)
        want_img, want_theta = stn.sample_rotated_bwd(images, theta, g, out_size)
        got_theta = stn.rotated_sampler_bwd_theta(images, theta, g)
        again = stn.rotated_sampler_bwd_theta(images, theta, g)
        got_img = stn.rotated_sampler_bwd_images(theta, g, tuple(images.shape))
        again_img = stn.rotated_sampler_bwd_images(theta, g, tuple(images.shape))
        torch.cuda.synchronize()
        check(torch.equal(got_theta.view(torch.int32), again.view(torch.int32)),
              f"K2 bwd_theta {name}: two runs differ")
        check(torch.equal(got_img.view(torch.int32), again_img.view(torch.int32)),
              f"K2 bwd_images {name}: two runs differ")
        e_f, e_i = max_err(got, want), max_err(got_img, want_img)
        e_t = max_err(got_theta, want_theta) if theta_defined else 0.0
        s_t = float(want_theta.nan_to_num().abs().max())
        s_i = float(want_img.nan_to_num().abs().max())
        terms = dimages_terms(theta, out_size, images.shape[1], images.shape[2], rotated=True)
        tol_i = dimages_tol(K2_TOL, terms, s_i)
        print(f"K2 {name}: fwd max_abs_err {e_f:.3e} (bit-identical: {bit_identical(got, want)}); "
              + (f"dtheta max_abs_err {e_t:.3e}, max_rel_err {e_t / max(s_t, 1e-30):.3e} (tol "
                 f"{K2_TOL['dtheta_rel']:g} of max |dtheta| {s_t:.4g}); " if theta_defined else "dtheta not compared; ")
              + f"dimages max_abs_err {e_i:.3e} (tol {tol_i:.3g}, up to {terms} products a pixel, "
              f"max |dimages| {s_i:.4g}, NaN in "
              f"{int(torch.isnan(got_img).flatten(1).all(1).sum())} images throughout, as the plain version); "
              "d theta and d images bit-identical between two runs")
        check(bit_identical(got, want), f"K2 fwd {name}: not bit-identical to the plain version (max abs err {e_f})")
        check(e_t <= K2_TOL["dtheta_rel"] * s_t, f"K2 bwd_theta {name}: {e_t} > tol")
        check(e_i <= tol_i, f"K2 bwd_images {name}: {e_i} > {tol_i}")
        if ties:  # every position on a pixel: the dense VJP's rule moves nothing
            check(not got_theta.any() and not want_theta.any(), f"K2 {name}: d theta not exactly 0")
            print(f"K2 {name}: d theta exactly 0 in the kernel and the plain version")
        for k, e in (("fwd", e_f), ("bwd_theta", e_t), ("bwd_images", e_i)):
            errs[k] = max(errs[k], e)
        return images, theta, g

    out = Size(CROP, CROP)
    times = {}
    for n in (BATCH, TRAIN_BATCH, 128):
        imgs = rng.uniform(size=(n, INPUT, INPUT, 3)).astype(np.float32)
        images, theta, g = compare(f"N={n} {INPUT}^2->{CROP}^2", imgs, rotated_theta(rng, n), out)
        if n == BATCH:
            continue
        images_nchw, g_nchw = (t.permute(0, 3, 1, 2).contiguous() for t in (images, g))
        theta_req = theta.clone().requires_grad_()
        lib_out_t = library_crop(images_nchw, theta_req, out)
        images_req = images_nchw.clone().requires_grad_()
        lib_out_i = library_crop(images_req, theta, out)
        lib_err = float((library_crop(images_nchw, theta, out).permute(0, 2, 3, 1)
                         - sample_rotated_kernel(images, theta, out)).abs().max())
        lib_dtheta = torch.autograd.grad(lib_out_t, theta_req, g_nchw, retain_graph=True)[0]
        plain_dtheta = stn.sample_rotated_bwd(images, theta, g, out, need_images=False)[1]
        print(f"K2 N={n}: library grid_sample against the kernel: crop max abs diff {lib_err:.2e}, "
              f"dtheta max rel diff {float((lib_dtheta - plain_dtheta).abs().max() / plain_dtheta.abs().max()):.2e}")
        calls = {
            "fwd": (
                lambda: sample_rotated_kernel(images, theta, out),
                lambda: stn.sample_rotated(images, theta, out),
                lambda: library_crop(images_nchw, theta, out),
            ),
            "bwd_theta": (
                lambda: stn.rotated_sampler_bwd_theta(images, theta, g),
                lambda: stn.sample_rotated_bwd(images, theta, g, out, need_images=False),
                lambda: torch.autograd.grad(lib_out_t, theta_req, g_nchw, retain_graph=True),
            ),
            "bwd_images": (
                lambda: stn.rotated_sampler_bwd_images(theta, g, tuple(images.shape)),
                lambda: stn.sample_rotated_bwd(images, theta, g, out, need_theta=False),
                lambda: torch.autograd.grad(lib_out_i, images_req, g_nchw, retain_graph=True),
            ),
        }
        for name, (kernel, plain, library) in calls.items():
            call_ms, plain_ms, lib_ms = cuda_ms(kernel), cuda_ms(plain), cuda_ms(library)
            bound_ms, bound_by = rotated_bound(name, images, theta, out)
            t = {"ms": call_ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                 "bound_ms": bound_ms, "bound_by": bound_by}
            print(f"K2 {name} N={n}: per call (CUDA events, host launch included) kernel "
                  f"{call_ms * 1e3:.1f} us, plain {plain_ms * 1e3:.1f} us, library grid_sample "
                  f"{lib_ms * 1e3:.1f} us; bound {bound_ms * 1e3:.2f} us ({bound_by}) ({card})")
            t.update(one_kernel_device_times("K2", f"rotated_sampler_{name}", kernel, n, card))
            times.setdefault(name, {})[n] = t
            print(f"K2 {name} N={n}: device time (profiler) kernel {fmt_us(t['device_ms'] * 1e3)}, "
                  f"plain {fmt_us(device_us(plain))}, library {fmt_us(device_us(library))} ({card})")

    ties = rng.uniform(size=(4, 129, 129, 3)).astype(np.float32)  # p = pixel: every position a tie
    compare("identity 129^2->129^2 (all ties)", ties,
            np.tile(np.array([[1, 0, 0], [0, 1, 0]], np.float32), (4, 1, 1)), Size(129, 129), ties=True)
    imgs = rng.uniform(size=(4, INPUT, INPUT, 3)).astype(np.float32)
    border = BORDER_THETA.copy()
    border[:, 0, 1], border[:, 1, 0] = [0.2, -0.25, 0.3, 0.1], [0.15, 0.2, -0.3, -0.1]
    compare("border", imgs, border, out)
    compare("off-image", imgs, np.tile(np.array([[0.5, 0.1, 5.0], [0.1, 0.5, 5.0]], np.float32), (4, 1, 1)), out)
    compare("h_out=1", imgs, rotated_theta(rng, 4), Size(1, CROP))
    compare("w_out=1", imgs, rotated_theta(rng, 4), Size(CROP, 1))
    nan = rotated_theta(rng, 4)
    nan[1, 0, 1], nan[2, 1, 1] = np.nan, np.nan  # NaN px everywhere in image 1, NaN py in image 2
    compare("NaN theta", imgs, nan, out)
    small = rng.uniform(size=(4, 64, 64, 3)).astype(np.float32)  # neighbouring pixels share taps
    compare("upsampled 64^2->200^2", small, rotated_theta(rng, 4), Size(200, 200))
    imgs = rng.uniform(size=(4, INPUT, INPUT, 4)).astype(np.float32)  # the generic-C instance
    compare("C=4", imgs, rotated_theta(rng, 4), out)
    # singular and degenerate maps: d images takes every output as a
    # candidate of each tile there and scans those with a tap on it
    imgs = rng.uniform(size=(4, INPUT, INPUT, 3)).astype(np.float32)
    compare("zero scale", imgs, np.tile(np.float32(ZERO_SCALE), (4, 1, 1)), out)
    compare("flipped scale", imgs, np.tile(np.float32(FLIP), (4, 1, 1)), out)
    compare("rank-1 theta", imgs, np.tile(np.float32([[0.6, 0.3, 0.1], [0.4, 0.2, -0.1]]), (4, 1, 1)), out)
    compare("near-singular theta", imgs, np.tile(np.float32([[0.6, 0.3, 0.1], [0.4, 0.2001, -0.1]]), (4, 1, 1)),
            out)
    for what, rows, size in (("infinite theta00, w_out=65", INF_THETA, Size(CROP, 65)),
                             ("huge theta00 1e30", HUGE_THETA, out)):
        theta = rotated_theta(rng, 4)
        theta[1] = rows
        compare(what, imgs, theta, size, theta_defined=False)
    return {"max_abs_err": errs, "times": times}


# -- phase 3 --------------------------------------------------------------
def write_log_dir(log_dir: str, calib: np.ndarray) -> None:
    """Seeded port models as ``.pt`` snapshots. BatchNorm statistics are
    taken from one batch of scenes (random weights with unit statistics
    give activations far from unit scale), and the head is drawn so that
    theta is [0.8, 0, 0, 0, 0.8, 0] plus per-image offsets of about 0.15
    on that batch (the reference's zero head gives every frame the same
    crop)."""
    checkpoint.save_manifest(log_dir, MANIFEST)
    torch.manual_seed(SEED)
    loc = build_model("Localizer", **MANIFEST["localizer"]["kwargs"]).to(DEVICE)
    ass = build_assessor(MANIFEST["assessor"], loc)
    x = torch.from_numpy(calib).to(DEVICE)
    bns = [m for m in loc.modules() if isinstance(m, nn.BatchNorm2d)]
    with torch.no_grad():
        for bn in bns:
            bn.momentum = 1.0  # running statistics = this batch's
        loc.train().features(x)
        for bn in bns:
            bn.momentum = 0.1
        feats = loc.eval().features(x).mean(dim=(2, 3))
        mu, sd = feats.mean(0), feats.std(0).mean()
        gen = torch.Generator(device=DEVICE).manual_seed(SEED)
        w = torch.randn(6, feats.shape[1], generator=gen, device=DEVICE)
        w *= 0.15 / (feats.shape[1] ** 0.5 * sd)
        loc.param_predictor.weight.copy_(w)
        loc.param_predictor.bias.copy_(torch.tensor([0.8, 0, 0, 0, 0.8, 0], device=DEVICE) - w @ mu)
    checkpoint.save_params(f"{log_dir}/Localizer_1.pt", loc.state_dict())
    checkpoint.save_params(f"{log_dir}/ResnetAssessor_1.pt", ass.state_dict())


def serve(inf: LocalizerInference, frames: np.ndarray, card: str) -> dict:
    inf.localize_batch(frames[:BATCH])  # warm-up: cuDNN and allocator
    torch.cuda.synchronize()
    reset_launches()
    n_forward = 0
    for frame in frames[:2]:
        boxes, rois, scores, _ = inf.localize(frame)
        n_forward += 1
        check(boxes.shape == (1, 4) and rois.shape == (1, CROP, CROP, 3)
              and scores.shape == (1,), "localize shapes")
        check(np.isfinite(boxes).all() and np.isfinite(rois).all(), "localize finite")
    rates, kept_boxes = [], []
    for b in range(3):
        batch = frames[2 + b * BATCH : 2 + (b + 1) * BATCH]
        start = time.perf_counter()
        raw = inf.localize_batch(batch, sync=False)
        boxes, rois, scores, _ = inf.finish_batch(raw)
        rates.append(BATCH / (time.perf_counter() - start))
        n_forward += 1
        raw_scores = raw[2].cpu().numpy()
        check(boxes.shape == (BATCH, 1, 4) and rois.shape == (BATCH, CROP, CROP, 3)
              and scores.shape == (BATCH,), "localize_batch shapes")
        check(np.isfinite(boxes).all() and np.isfinite(rois).all(), "localize_batch finite")
        check(((raw_scores > 0) & (raw_scores < 1)).all(), "scores in (0, 1)")
        gated = raw_scores < inf.score_threshold
        check(np.array_equal(scores == 0, gated) and (boxes[gated] == 0).all(), "gating")
        kept_boxes.append(boxes[~gated, 0])
    launches = read_launches()
    check(launches == {"K1": {**NO_LAUNCHES, "fwd": n_forward}, "K2": NO_LAUNCHES},
          f"serving launched {launches} for {n_forward} forwards")
    launches = launches["K1"]
    profile_batch(inf, frames[2 : 2 + BATCH], card)
    spread = float(np.concatenate(kept_boxes)[:, 3].std())
    print(f"slice: {n_forward} forwards (2 x localize, 3 x localize_batch({BATCH})), "
          f"K1 launches {launches['fwd']}, x_max spread {spread:.1f} px")
    print(f"slice: localize_batch({BATCH}) images/s "
          f"{statistics.median(rates):.1f} (median; runs {', '.join(f'{r:.1f}' for r in rates)}) "
          f"({card})")
    return {"launches": launches["fwd"], "images_per_s": statistics.median(rates)}


def print_trace(prof, what: str, wall_ms: float, card: str, top: int = 8) -> None:
    events = device_events(prof)
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    print(f"trace: {what} wall {wall_ms:.2f} ms, device busy {busy_ms:.2f} ms, "
          f"idle share {max(0.0, 1 - busy_ms / wall_ms):.3f} ({card})")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"trace:   {e.self_device_time_total / 1e3:8.3f} ms x{e.count:<5d} {e.key[:90]}")


def profile_batch(inf: LocalizerInference, batch: np.ndarray, card: str) -> None:
    """One traced ``localize_batch``: wall time, device busy time, the
    device time of the largest kernels and copies, and K1's forward's
    device time per launch, by name."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        start = time.perf_counter()
        inf.localize_batch(batch)
        wall_ms = (time.perf_counter() - start) * 1e3
    print_trace(prof, f"localize_batch({len(batch)})", wall_ms, card)
    fwd = [e for e in device_events(prof) if "separable_sampler_fwd_kernel" in e.key]
    launches = sum(e.count for e in fwd)
    us = sum(e.self_device_time_total for e in fwd) / launches if launches else None
    print(f"trace: in the traced localize_batch({len(batch)}), separable_sampler_fwd {fmt_us(us)} "
          f"device time per launch ({launches} launches) ({card})")


# -- phase 4 --------------------------------------------------------------
def card_against_cpu(log_dir: str, inf: LocalizerInference, frames: np.ndarray) -> dict:
    cpu = LocalizerInference(log_dir, device="cpu", use_assessor=True, score_threshold=0.0)
    inf.score_threshold = 0.0
    two = frames[:2]
    with torch.inference_mode():
        rois_g, theta_g = inf.localizer(torch.from_numpy(two).to(DEVICE))
        rois_c, theta_c = cpu.localizer(torch.from_numpy(two))
        rois_at_card_theta = sample_separable(torch.from_numpy(two), theta_g.cpu(), Size(CROP, CROP))
    bg, _, sg, _ = inf.localize_batch(two)
    bc, _, sc, _ = cpu.localize_batch(two)
    errs = {
        "theta": float((theta_g.cpu() - theta_c).abs().max()),
        "boxes_px": float(np.abs(bg - bc).max()),
        "rois_at_card_theta": float((rois_g.cpu() - rois_at_card_theta).abs().max()),
        "scores": float(np.abs(sg - sc).max()),
    }
    tol = dict(SLICE_TOL, rois_end_to_end=1e-5 + 2 * errs["theta"] * (INPUT - 1))
    errs["rois_end_to_end"] = float((rois_g.cpu() - rois_c).abs().max())
    print("card vs CPU: " + ", ".join(
        f"{k} {v:.3e} (tol {tol[k]:.3g})" for k, v in errs.items()))
    for k, v in errs.items():
        check(v <= tol[k], f"card vs CPU {k}: {v} > {tol[k]}")
    return errs


# -- phases 5 and 8 ---------------------------------------------------------
def training_pools() -> dict:
    """The pools ``bench.py`` trains on: uint8 scenes and crops, uniform
    IoU labels (seed 0)."""
    gen = np.random.default_rng(SEED)
    return {
        "unlabeled": {"unlabeled": gen.integers(0, 256, (POOL_SCENES, INPUT, INPUT, 3), dtype=np.uint8)},
        "reference": {
            "real": gen.integers(0, 256, (POOL_CROPS, CROP, CROP, 3), dtype=np.uint8),
            "labels": gen.uniform(size=(POOL_CROPS, 1)).astype(np.float32),
        },
    }


def build_pair(device, manifest: dict = MANIFEST) -> tuple[nn.Module, nn.Module]:
    loc = build_model("Localizer", **manifest["localizer"]["kwargs"])
    return loc.to(device), build_assessor(manifest["assessor"], loc).to(device)


def train_slice(pools: dict, card: str, manifest: dict = MANIFEST, log_dir: str | None = None) -> dict:
    """``Trainer`` over ``pooled_step`` with ``manifest``'s models; checks
    that the crop's kernels (K2 at a non-zero rotation ratio, else K1)
    carried every step and the other crop's never ran, then serves the last
    snapshot on the card. The log dir is kept at ``log_dir`` when one is
    given."""
    rotated = manifest["localizer"]["kwargs"]["rotation_dropout_ratio"] > 0
    used, unused = ("K2", "K1") if rotated else ("K1", "K2")
    tag = "train rotated" if rotated else "train"
    torch.manual_seed(SEED)
    loc, ass = build_pair(DEVICE, manifest)
    loc_state, ass_state = create_train_state(loc, LR), create_train_state(ass, LR)
    head0 = loc.param_predictor.bias.detach().clone()
    ass0 = ass.Dense_0.weight.detach().clone()
    config = AlternatingConfig(image_size=Size(INPUT, INPUT))
    step_fn = functools.partial(pooled_step, steps_per_call=STEPS_PER_CALL, config=config)
    chunks = device_chunk_batches(pools, TRAIN_BATCH, STEPS_PER_CALL, seed=SEED, device=DEVICE)
    n_steps = STEPS_PER_CALL * (1 + TIMED_CHUNKS)
    nbytes = sum(t.numel() * t.element_size() for g in next(chunks)["pools"].values() for t in g.values())
    print(f"{tag}: pools on the card {nbytes / 2**20:.1f} MiB ({POOL_SCENES} scenes, {POOL_CROPS} crops, uint8); "
          f"localizer {manifest['localizer']['kwargs']}")
    generator = torch.Generator(device=DEVICE).manual_seed(SEED)
    with contextlib.nullcontext(log_dir) if log_dir else tempfile.TemporaryDirectory() as log_dir:
        checkpoint.save_manifest(log_dir, manifest)
        trainer = Trainer(
            step_fn, loc_state, ass_state, chunks, log_dir, max_iterations=n_steps, generator=generator,
            config={"batch_size": TRAIN_BATCH, "steps_per_call": STEPS_PER_CALL, "device": card},
            log_interval=STEPS_PER_CALL, steps_per_call=STEPS_PER_CALL, print_report=False,
        )
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        start = time.perf_counter()
        loc_state, ass_state = trainer.run()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - start
        launches = read_launches()
        check(launches == {used: {"fwd": n_steps, "bwd_theta": n_steps, "bwd_images": 0}, unused: NO_LAUNCHES},
              f"training launched {launches} for {n_steps} steps")
        log = MetricsLog.read(log_dir)
        check(len(log) == 1 + TIMED_CHUNKS, f"{len(log)} log entries")
        for e in log:
            check(np.isfinite(e["loss_localizer"]) and np.isfinite(e["loss_dis"]), f"losses finite: {e}")
        bias = loc.param_predictor.bias.detach()
        check(not torch.equal(bias, head0), "the head's bias moved")
        check(not torch.equal(ass.Dense_0.weight, ass0), "the assessor's head weight moved")
        # theta01 and theta10: only the rotated crop's d theta reaches them
        # (rotation dropout at ratio 0 zeroes them with a constant mask)
        off_diagonal = bias[[1, 3]]
        check(bool((off_diagonal != 0).all()) if rotated else not off_diagonal.any(),
              f"the head's off-diagonal bias {off_diagonal.tolist()} after training")
        rates = [e["images_per_sec"] for e in log[1:]]
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        for e in log:
            print(f"{tag}: iteration {e['iteration']} loss_localizer {e['loss_localizer']:.5f} "
                  f"loss_dis {e['loss_dis']:.5f} y_fake_mean {e['y_fake_mean']:.4f} "
                  f"y_real_mean {e['y_real_mean']:.4f} images/s {e['images_per_sec']:.1f}")
        print(f"{tag}: {n_steps} steps ({1 + TIMED_CHUNKS} chunks of {STEPS_PER_CALL}, batch {TRAIN_BATCH}) "
              f"in {wall_s:.2f} s; {used} launches {launches[used]}, {unused} launches {launches[unused]}; "
              f"peak memory {peak_gib:.2f} GiB; head off-diagonal bias {off_diagonal.tolist()}")
        print(f"{tag}: images/s at batch {TRAIN_BATCH}, timed chunks: "
              f"{', '.join(f'{r:.1f}' for r in rates)} (median {statistics.median(rates):.1f}) ({card})")
        in_situ = profile_chunk(loc_state, ass_state, next(chunks), step_fn, generator, card)
        for kernel in (f"{LIBRARIES[used]}_fwd", f"{LIBRARIES[used]}_bwd_theta"):
            us, count = in_situ.get(kernel, (None, 0))
            print(f"{tag}: in the traced chunk, {kernel} {fmt_us(us)} device time per launch "
                  f"({count} launches) ({card})")
        check(not {k for k in in_situ if not k.startswith(LIBRARIES[used])},
              f"{tag}: the traced chunk ran {sorted(in_situ)}")

        inf = LocalizerInference(log_dir, device=DEVICE, use_assessor=True)
        last = checkpoint.list_snapshots(log_dir, "Localizer_")[-1][0]
        check(last == n_steps, f"the last snapshot is Localizer_{last}.pt")
        frames = pools["unlabeled"]["unlabeled"][:8].astype(np.float32) / 255.0
        before = read_launches()[used]["fwd"]
        boxes, rois, scores, _ = inf.localize_batch(frames)
        served = read_launches()[used]["fwd"] - before
        check(served == 1, f"serving one batch launched the {used} forward {served} times")
        check(boxes.shape == (8, 1, 4) and rois.shape == (8, CROP, CROP, 3) and scores.shape == (8,),
              "trained snapshot: serving shapes")
        check(np.isfinite(boxes).all() and np.isfinite(rois).all() and np.isfinite(scores).all(),
              "trained snapshot: serving finite")
        print(f"{tag}: served Localizer_{n_steps}.pt through LocalizerInference on {DEVICE} "
              f"(sampler {inf.localizer.sampler_method(torch.from_numpy(frames).to(DEVICE))}, "
              f"{used} forward launches +{served}): 8 frames, mean score {float(np.mean(scores)):.4f}")
    return {"launches": launches[used], "images_per_s": statistics.median(rates),
            "device_in_situ_ms": {k: ms(us) for k, (us, _) in in_situ.items()}}


def profile_chunk(loc_state, ass_state, chunk, step_fn, generator, card: str) -> dict[str, tuple[float, int]]:
    """One traced chunk of ``STEPS_PER_CALL`` steps (after the counted run).
    Returns the crop kernels' device time per launch in µs and their
    launches there, by entry point (``<library>_fwd``, ...)."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        start = time.perf_counter()
        _, _, metrics = step_fn(loc_state, ass_state, chunk, generator)
        float(metrics["loss_localizer"])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3
    print_trace(prof, f"pooled_step({STEPS_PER_CALL} x batch {TRAIN_BATCH})", wall_ms, card, top=12)
    entries = [f"{library}_{kind}" for library in LIBRARIES.values() for kind in COUNTERS]
    return {entry: (e.self_device_time_total / e.count, e.count)
            for e in device_events(prof) for entry in entries if f"{entry}_kernel" in e.key}


# -- phases 6 and 9 ---------------------------------------------------------
def step_against_cpu(pools: dict, manifest: dict = MANIFEST, samplers: dict | None = None) -> dict:
    """Two alternating steps on the card and on the CPU from the same
    weights and batches (batch 4). Step 1's backbone gradient is exactly 0
    behind the zero-initialised head, so step 2 is compared too.
    ``samplers`` names each device's crop where the two differ; then d
    theta's off-diagonal entries are held on their own too."""
    tag = "train card vs CPU" if samplers is None else "train rotated card vs CPU"
    torch.manual_seed(SEED + 4)
    models = {"cpu": build_pair("cpu", manifest)}
    models[DEVICE] = tuple(copy.deepcopy(m).to(DEVICE) for m in models["cpu"])
    for device, sampler in (samplers or {}).items():
        models[device][0].sampler = sampler
    rng = np.random.default_rng(SEED + 5)
    batches = []
    for _ in range(2):
        si = rng.choice(POOL_SCENES, 4, replace=False)
        ci = rng.choice(POOL_CROPS, 4, replace=False)
        batches.append({"unlabeled": pools["unlabeled"]["unlabeled"][si],
                        "real": pools["reference"]["real"][ci],
                        "labels": pools["reference"]["labels"][ci]})
    config = AlternatingConfig(image_size=Size(INPUT, INPUT))
    out = {}
    for device, (loc, ass) in models.items():
        dthetas, rois_grads = [], []

        def capture(module, inputs, output, dthetas=dthetas, rois_grads=rois_grads):
            output[0].register_hook(lambda g: rois_grads.append(g.detach().cpu()))
            output[1].register_hook(lambda g: dthetas.append(g.detach().cpu()))

        hook = loc.register_forward_hook(capture)
        states = (create_train_state(loc, LR), create_train_state(ass, LR))
        metrics = []
        for batch in batches:
            *states, m = alternating_step(*states, {k: torch.from_numpy(v).to(device) for k, v in batch.items()},
                                          None, config)
            metrics.append({k: float(v) for k, v in m.items()})
        hook.remove()
        out[device] = {
            "metrics": metrics, "dtheta": dthetas, "rois_grad": rois_grads,
            "head_grad": loc.param_predictor.weight.grad.detach().cpu(),
            "stem_grad": loc.feature_extractor.Conv_0.weight.grad.detach().cpu(),
            "stats": {k: v.detach().cpu() for k, v in loc.state_dict().items() if "running" in k},
        }
    cpu, card = out["cpu"], out[DEVICE]

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))

    off_diagonal = (slice(None), [0, 1], [1, 0])
    diffs = {}
    for s in range(2):
        for k in ("loss_localizer", "loss_dis"):
            diffs[f"step{s + 1} {k}"] = ("loss", abs(card["metrics"][s][k] - cpu["metrics"][s][k])
                                         / max(abs(cpu["metrics"][s][k]), 1e-30))
        diffs[f"step{s + 1} dtheta"] = ("dtheta", rel(card["dtheta"][s], cpu["dtheta"][s]))
        if samplers is not None:
            diffs[f"step{s + 1} dtheta off-diagonals"] = (
                "dtheta", rel(card["dtheta"][s][off_diagonal], cpu["dtheta"][s][off_diagonal]))
    diffs["step2 head grad"] = ("head_grad", rel(card["head_grad"], cpu["head_grad"]))
    diffs["step2 stem conv grad"] = ("stem_grad", rel(card["stem_grad"], cpu["stem_grad"]))
    diffs["step2 BN running stats"] = ("bn_stats", max(rel(card["stats"][k], v) for k, v in cpu["stats"].items()))
    print(f"{tag} (relative): " + ", ".join(
        f"{name} {v:.3e} (tol {STEP_TOL[kind]:g})" for name, (kind, v) in diffs.items()))
    print(f"{tag}, crops' cotangent (not held, see STEP_TOL): " + ", ".join(
        f"step{s + 1} max {rel(card['rois_grad'][s], cpu['rois_grad'][s]):.3e}, L2 "
        f"{float((card['rois_grad'][s] - cpu['rois_grad'][s]).norm() / cpu['rois_grad'][s].norm()):.3e}"
        for s in range(2)))
    for name, (kind, v) in diffs.items():
        check(v <= STEP_TOL[kind], f"{tag} {name}: {v} > {STEP_TOL[kind]}")
    check(float(cpu["dtheta"][0].abs().max()) > 0, "theta gets a gradient")
    if samplers is not None:
        check(float(cpu["dtheta"][0][off_diagonal].abs().max()) > 0, "theta's off-diagonals get a gradient")
    return {name: v for name, (_, v) in diffs.items()}


# -- phases 10 and 11 ---------------------------------------------------------
def cli_run(tag: str, argv: list[str], card: str, log_root: str | None = None) -> dict:
    """``train_localizer.main(argv)`` in this process with every launch
    count at 0; checks the log, the launches of each kind, and serves the
    log dir. Returns the launches, the log, the accounting and the log dir,
    which is kept under ``log_root`` when one is given."""
    args = train_localizer.get_parser().parse_args(argv)
    iterations = args.iterations
    with contextlib.nullcontext(log_root) if log_root else tempfile.TemporaryDirectory() as tmp:
        torch.cuda.synchronize()
        reset_launches()
        synthetic.render_stn_crops.batches = 0
        device_chunk_batches.swaps = 0
        start = time.perf_counter()
        log_dir = train_localizer.main(argv + ["--log-dir", tmp])
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - start
        launches = read_launches()
        renders, swaps = synthetic.render_stn_crops.batches, device_chunk_batches.swaps
        log = MetricsLog.read(log_dir)
        check(len(log) == iterations // args.log_interval, f"{tag}: {len(log)} log entries")
        losses = ["loss_localizer"] + ([] if args.supervised else ["loss_dis"])
        for e in log:
            check(all(np.isfinite(e[k]) for k in losses + ["mean_iou", "map"]), f"{tag}: finite: {e}")
        n_val = (train_localizer._synthetic_n(args.val_file, 64) if train_localizer._is_synthetic(args.val_file)
                 else len(LabeledImageDataset(args.val_file)))
        n_val_batches = min(args.eval_batches, n_val // max(args.batch_size // 2, 1))
        evals = len(log) * n_val_batches
        steps = 0 if args.supervised else iterations  # supervised steps do not crop
        check(launches["K1"]["fwd"] == steps + evals + renders,
              f"{tag}: K1 forward launches {launches['K1']['fwd']} != {steps} steps + {evals} eval "
              f"forwards + {renders} render batches")
        check(launches["K1"]["bwd_theta"] == steps and launches["K1"]["bwd_images"] == 0,
              f"{tag}: K1 launches {launches['K1']} for {steps} alternating steps")
        check(launches["K2"] == NO_LAUNCHES, f"{tag}: K2 launches {launches['K2']}")
        snaps = sorted(os.listdir(log_dir))
        written = list(range(args.snapshot_interval, iterations + 1, args.snapshot_interval))
        want = {"manifest.json", "log"} | {f"Localizer_{i}.pt" for i in written}
        if not args.supervised:
            want |= {f"ResnetAssessor_{i}.pt" for i in written}
        check(want <= set(snaps), f"{tag}: the log dir holds {snaps}")
        # a snapshot is written after the log entry of its iteration, so the
        # next entry's interval holds the write (the last one follows the run)
        with_writes = [e["iteration"] for e in log if e["iteration"] - args.log_interval in written]
        for e in log:
            print(f"{tag}: iteration {int(e['iteration'])} images_per_sec {e['images_per_sec']:.1f} "
                  + " ".join(f"{k} {e[k]:.5f}" for k in losses + ["mean_iou", "map"]))
        print(f"{tag}: {iterations} iterations in {wall_s:.2f} s of wall time (data generation included); "
              f"K1 launches {launches['K1']}: forward = {steps} steps + {evals} eval forwards "
              f"+ {renders} render batches of {synthetic.RENDER_BATCH}; pool swaps {swaps}; log dir {snaps}")
        print(f"{tag}: snapshots at iterations {written}; the log entries at iterations "
              f"{[int(i) for i in with_writes]} include a snapshot write in their interval")
        served = serve_cli_log_dir(tag, log_dir, args)
    rates = [e["images_per_sec"] for e in log[1:] or log]
    return {"launches": launches["K1"], "swaps": swaps, "log": log, "served": served,
            "images_per_s": statistics.median(rates), "log_dir": log_dir}


def cli_triples(argv: list[str]) -> tuple[list, tuple, tuple]:
    """The (scene, box, IoU) triples of the CLI's ``stn`` reference pool
    under ``argv`` (its seed, sizes and asset world), the scene size and
    the crop size."""
    args = train_localizer.get_parser().parse_args(argv)
    img, crop = tuple(args.target_size), tuple(args.crop_size)
    triples = synthetic.assessor_triples(
        train_localizer._synthetic_n(args.reference_file, 1024), output_size=crop, image_size=img,
        seed=args.seed + 1, low_iou_fraction=args.assessor_low_iou, **train_localizer.build_asset_kw(args))
    return triples, img, crop


def render_against_plain(argv: list[str]) -> None:
    """The CLI's own reference pool of ``--assessor-pipeline stn`` (its
    scenes and boxes: the same seed, size and asset world) rendered by
    ``render_stn_crops`` on the card, K1's forward in batches of
    ``RENDER_BATCH``, against the plain sampler on the same card tensors:
    the float crops at K1_TOL, the uint8 crops within RENDER_TOL. Before
    the counted run, so these launches are not the path's."""
    triples, img, crop = cli_triples(argv)
    n = len(triples)
    got = np.stack(synthetic.render_stn_crops(triples, crop, device=DEVICE)).astype(np.int16)
    want, err = [], 0.0
    for start in range(0, n, synthetic.RENDER_BATCH):  # the renders' batches, unpadded
        part = triples[start : start + synthetic.RENDER_BATCH]
        scenes = torch.from_numpy(np.stack([t[0] for t in part])).to(DEVICE).float() / 255.0
        size = Size(*part[0][0].shape[:2])
        theta = box_to_theta(torch.from_numpy(np.stack([t[1] for t in part])).to(DEVICE), size)
        plain = sample_separable(scenes, theta, Size(*crop))
        err = max(err, max_err(sample_separable_kernel(scenes, theta, Size(*crop)), plain))
        want.append(torch.clip(torch.round(plain * 255.0), 0, 255).to(torch.uint8).cpu().numpy())
    diff = np.abs(got - np.concatenate(want).astype(np.int16))
    share = float((diff > 0).mean())
    check(err <= K1_TOL, f"cli renders: K1 against the plain sampler max abs err {err} > {K1_TOL}")
    check(int(diff.max()) <= RENDER_TOL["steps"] and share <= RENDER_TOL["share"],
          f"cli renders: uint8 crops differ by up to {int(diff.max())} on {share:.2e} of the pixels")
    print(f"cli renders: the CLI's {n} stn crops ({img[0]}^2->{crop[0]}^2, batches of "
          f"{synthetic.RENDER_BATCH}) through render_stn_crops (K1) against the plain sampler on the "
          f"same card tensors: floats max abs err {err:.3e} (tol {K1_TOL}), uint8 max diff "
          f"{int(diff.max())} on {share:.2e} of the pixels (tol {RENDER_TOL['steps']} step on "
          f"{RENDER_TOL['share']:g})")


def serve_cli_log_dir(tag: str, log_dir: str, args) -> float:
    """Serve the CLI's last snapshot through ``LocalizerInference`` on the
    card and hold its boxes against the CLI's own eval step
    (``make_eval_step``) on the same snapshot and val frames."""
    val = synthetic.SyntheticLocalizerDataset(
        8, image_size=tuple(args.target_size), seed=args.seed + 2, labeled=True, output_dtype="uint8",
        **train_localizer.build_asset_kw(args))
    frames = np.stack([val.items[i][0] for i in range(len(val))])
    inf = LocalizerInference(log_dir, device=DEVICE, use_assessor=True, score_threshold=0.0)
    boxes, rois, scores, _ = inf.localize_batch(frames.astype(np.float32) / 255.0)
    manifest = checkpoint.load_manifest(log_dir)
    loc = build_model("Localizer", **manifest["localizer"]["kwargs"])
    snap = checkpoint.list_snapshots(log_dir, "Localizer_")[-1][1]
    loc.load_state_dict(checkpoint.load_params(snap))
    state = create_train_state(loc.to(DEVICE))
    theta = make_eval_step()(state, torch.from_numpy(frames).to(DEVICE))
    want = corners_to_aabb(theta_corners(theta), Size(*args.target_size), clip=True).cpu().numpy()
    err = float(np.abs(boxes[:, 0] - want).max())
    check(np.isfinite(boxes).all() and np.isfinite(scores).all(), f"{tag}: served boxes finite")
    check(err <= SLICE_TOL["boxes_px"], f"{tag}: served boxes differ from the eval step's by {err} px")
    print(f"{tag}: served {os.path.basename(snap)} through LocalizerInference on {DEVICE}: 8 val frames, "
          f"boxes against the CLI's eval step max {err:.3e} px (tol {SLICE_TOL['boxes_px']:g}), "
          f"mean score {float(np.mean(scores)):.4f}")
    return err


def cli_phases(card: str, f32_step_rate: float, log_root: str) -> dict:
    """Phase 10 (float32, with the pool refresh; its log dir kept under
    ``log_root`` for phase 12) and phase 11 (``--supervised``, ``--bf16``,
    and the bf16 step timed beside the float32 one)."""
    render_against_plain(CLI_ARGV)
    f32 = cli_run("cli", CLI_ARGV, card, log_root)
    check(f32["swaps"] >= 1, f"cli: no assessor pool swap in {CLI_ITERATIONS} iterations")
    rates = ", ".join(f"{e['images_per_sec']:.1f}" for e in f32["log"][1:])
    print(f"cli: images/s at batch {TRAIN_BATCH}, float32, log entries after the first (each one interval "
          f"of {STEPS_PER_CALL} steps with the previous entry's eval; a smoke value): {rates} "
          f"(median {f32['images_per_s']:.1f}) ({card})")
    short = ["--iterations", "8", "--snapshot-interval", "8", "--supervised"]
    cli_run("cli supervised", CLI_ARGV + short, card)
    bf16 = cli_run("cli bf16", CLI_ARGV + ["--iterations", "16", "--snapshot-interval", "16", "--bf16"], card)
    print(f"cli bf16: images/s at batch {TRAIN_BATCH} {bf16['images_per_s']:.1f} (the one interval after the "
          f"first, a smoke value) ({card})")
    bf16_step(card, f32_step_rate)
    return f32


def bf16_step(card: str, f32_step_rate: float) -> None:
    """The ``--bf16`` step (convolutions and BatchNorm outputs in bfloat16)
    and the float32 step on phase 5's pools, each after a warm-up chunk:
    images/s of ``TIMED_CHUNKS`` chunks of ``STEPS_PER_CALL`` steps each,
    the two alternating, median; then one traced bf16 chunk: where its
    device time goes, and its idle share."""
    kwargs = MANIFEST["localizer"]["kwargs"]
    config = AlternatingConfig(image_size=Size(INPUT, INPUT))
    step_fn = functools.partial(pooled_step, steps_per_call=STEPS_PER_CALL, config=config)
    pools = training_pools()
    runs = {}
    for name, dtype in {"float32": torch.float32, "bf16": torch.bfloat16}.items():
        torch.manual_seed(SEED)
        loc = build_model("Localizer", **kwargs, dtype=dtype, norm_dtype=dtype).to(DEVICE)
        ass = build_model("ResnetAssessor", in_size=loc.out_size, dtype=dtype).to(DEVICE)
        runs[name] = {
            "states": (create_train_state(loc, LR), create_train_state(ass, LR)),
            "chunks": device_chunk_batches(pools, TRAIN_BATCH, STEPS_PER_CALL, seed=SEED, device=DEVICE),
            "generator": torch.Generator(device=DEVICE).manual_seed(SEED),
            "rates": [],
        }

    def chunk(run) -> float:
        torch.cuda.synchronize()
        start = time.perf_counter()
        _, _, metrics = step_fn(*run["states"], next(run["chunks"]), run["generator"])
        check(np.isfinite(float(metrics["loss_localizer"])), "bf16 step: loss finite")
        torch.cuda.synchronize()
        return STEPS_PER_CALL * TRAIN_BATCH / (time.perf_counter() - start)

    for run in runs.values():
        chunk(run)  # warm-up
    for _ in range(TIMED_CHUNKS):
        for run in runs.values():
            run["rates"].append(chunk(run))
    med = {name: statistics.median(run["rates"]) for name, run in runs.items()}
    for name, run in runs.items():
        print(f"cli bf16: {name} step images/s at batch {TRAIN_BATCH}, {TIMED_CHUNKS} chunks of "
              f"{STEPS_PER_CALL} after a warm-up (phase 5's pools, the two alternating): "
              f"{', '.join(f'{r:.1f}' for r in run['rates'])} (median {med[name]:.1f}) ({card})")
    print(f"cli bf16: bf16 step {med['bf16']:.1f} against float32 {med['float32']:.1f} images/s "
          f"({med['bf16'] / med['float32']:.2f}x; phase 5's float32 Trainer median {f32_step_rate:.1f}) ({card})")
    print("cli bf16: one traced chunk of the bf16 step (phase 5's pools, after the timed chunks):")
    run = runs["bf16"]
    in_situ = profile_chunk(*run["states"], next(run["chunks"]), step_fn, run["generator"], card)
    for kernel in ("separable_sampler_fwd", "separable_sampler_bwd_theta"):
        us, count = in_situ.get(kernel, (None, 0))
        print(f"cli bf16: in the traced chunk, {kernel} {fmt_us(us)} device time per launch ({count} launches)")


# -- phase 12 ---------------------------------------------------------------
def eval_argv(log_dir: str, out: str) -> list[str]:
    """The evaluation CLI on phase 10's world (the train CLI's val seed and
    asset seed: ``evaluate``'s defaults for a run at seed 0), batch 32."""
    return [f"synthetic:{EVAL_SCENES}", log_dir, "-b", str(BATCH), "-a", "--bn-warmup", "1",
            "--deteval", f"{out}/deteval", "--save-predictions", f"{out}/renders",
            "--synthetic-assets", "16", "--device", DEVICE]


def sweep_on_card(tag: str, log_dir: str, out: str, used: str, card: str) -> dict:
    """``cli.evaluate.main`` on the card with every count at 0: checks that
    each batch of each pass (scoring, renders, deteval) launched ``used``'s
    forward once and nothing else ran, the entries, the deteval XML and
    one render; then runs the CLI again, which must evaluate nothing."""
    snaps = checkpoint.list_snapshots(log_dir, "Localizer_")
    torch.cuda.synchronize()
    reset_launches()
    start = time.perf_counter()
    results = evaluate.main(eval_argv(log_dir, out))
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - start
    launches = read_launches()
    n_batches = EVAL_SCENES // BATCH
    passes = 3  # scoring, renders, deteval
    want = len(snaps) * n_batches * passes
    other = "K1" if used == "K2" else "K2"
    check(launches == {used: {**NO_LAUNCHES, "fwd": want}, other: NO_LAUNCHES},
          f"{tag}: launches {launches} for {len(snaps)} snapshots x {n_batches} batches x {passes} passes")
    names = [os.path.basename(p) for _, p in snaps]
    check([e["snapshot_name"] for e in results.entries] == names, f"{tag}: entries {results.entries}")
    for e in results.entries:
        t = results.timings[e["snapshot_name"]]
        check(all(np.isfinite(e[k]) for k in ("map", "mean_iou", "ap/object", "mean_assessor_score")),
              f"{tag}: {e}")
        check(0.0 <= e["mean_iou"] <= 1.0 and 0.0 <= e["mean_assessor_score"] <= 1.0, f"{tag}: {e}")
        print(f"{tag}: {e['snapshot_name']} map {e['map']:.4f} mean_iou {e['mean_iou']:.4f} "
              f"mean_assessor_score {e['mean_assessor_score']:.4f}; {t['seconds']:.3f} s for the snapshot "
              f"(restore, warm-up, 3 passes), scoring {t['images'] / t['score_seconds']:.1f} images/s "
              f"({t['images']} images, batch {BATCH}) ({card})")
    print(f"{tag}: {len(snaps)} snapshots in {wall_s:.2f} s of wall time (data generation included); "
          f"{used} forward launches {launches[used]['fwd']} = {len(snaps)} snapshots x {n_batches} batches "
          f"x {passes} passes, {other} {launches[other]}")
    for iteration, _ in snaps:  # the deteval XML and the renders read back
        root = ET.parse(f"{out}/deteval/deteval_{iteration}.xml").getroot()
        images = root.findall("image")
        check(len(images) == n_batches * BATCH and all(len(i.find("taggedRectangles")) == 1 for i in images),
              f"{tag}: deteval_{iteration}.xml holds {len(images)} images")
        renders = sorted(os.listdir(f"{out}/renders/{iteration}"))
        check(len(renders) == n_batches * BATCH, f"{tag}: {len(renders)} renders of iteration {iteration}")
    png = read_png(f"{out}/renders/{iteration}/0.png")
    check(png.shape == (INPUT, INPUT, 3), f"{tag}: a render of shape {png.shape}")
    check(bool((png == 255).all(-1).any()), f"{tag}: no white gt outline in the render")
    print(f"{tag}: deteval XML of {n_batches * BATCH} images per snapshot and {len(renders)} renders per "
          f"snapshot read back; render 0 of iteration {iteration} {png.shape} {png.dtype}")
    reset_launches()
    again = evaluate.main(eval_argv(log_dir, out))
    launches = read_launches()
    check(not again.timings and len(again.entries) == len(snaps), f"{tag}: the second run evaluated {again.timings}")
    check(launches == {"K1": NO_LAUNCHES, "K2": NO_LAUNCHES}, f"{tag}: the second run launched {launches}")
    print(f"{tag}: a second run evaluated nothing (resume): {len(again.entries)} entries, no launch")
    return {"results": results, "launches": want}


def evaluation_phase(card: str, cli_log_dir: str, rotated_log_dir: str, out: str) -> dict:
    """Phase 12: phase 10's sweep on the card, its last snapshot on the CPU
    against the card, and phase 8's rotated log dir on K2."""
    k1 = sweep_on_card("evaluate", cli_log_dir, f"{out}/cli", "K1", card)
    # the last snapshot again, on the card and on the CPU, with the same
    # warm-up: the scores, and the boxes of every eval image
    args = evaluate.get_parser().parse_args(eval_argv(cli_log_dir, out))
    ds = evaluate.build_dataset(args, Size(INPUT, INPUT))

    def batches():
        return iter(DataLoader(ds, BATCH, shuffle=False, drop_last=True, collate=padded_collate))

    last = checkpoint.list_snapshots(cli_log_dir, "Localizer_")[-1][1]
    prefix = os.path.basename(last)[: -len(".pt")]
    boxes, entries = {}, {}
    for device in (DEVICE, "cpu"):
        ev = Evaluator(cli_log_dir, snapshot_prefix=prefix, results_name=f"eval_last_{device}.json",
                       use_assessor=True, device=device)
        if device == DEVICE:  # traced: where a snapshot's warm-up and scoring pass spend their time
            acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
            with torch.profiler.profile(activities=acts) as prof:
                start = time.perf_counter()
                entries[device] = ev.sweep(batches, bn_warmup=1).entries[-1]
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - start) * 1e3
            print_trace(prof, f"Evaluator.sweep of {prefix}.pt (restore, warm-up, scoring; batch {BATCH})",
                        wall_ms, card, top=10)
        else:
            entries[device] = ev.sweep(batches, bn_warmup=1).entries[-1]
        boxes[device] = np.concatenate([ev.predict(torch.from_numpy(b[0]).to(device)) for b in batches()])
    gt = np.concatenate([b[1][:, 0] for b in batches()])
    sides = np.concatenate([boxes["cpu"][:, 2:] - boxes["cpu"][:, :2], gt[:, 2:] - gt[:, :2]]).ravel()
    min_side = float(sides[sides > 0].min())
    box_err = float(np.abs(boxes[DEVICE] - boxes["cpu"]).max())
    iou_err = abs(entries[DEVICE]["mean_iou"] - entries["cpu"]["mean_iou"])
    # a box corner moved by e px moves an IoU by at most 2 e / (the smaller
    # side it meets); four corners: 8 e over the smallest side of any box
    iou_tol = 8 * EVAL_TOL["boxes_px"] / min_side
    print(f"evaluate card vs CPU ({prefix}.pt, {len(gt)} images, BatchNorm warm-up on each device): boxes max "
          f"{box_err:.3e} px (tol {EVAL_TOL['boxes_px']:g}), mean_iou {iou_err:.3e} (tol {iou_tol:.3g}: "
          f"8 x the box tol over the smallest box side, {min_side:.1f} px), map card "
          f"{entries[DEVICE]['map']:.4f} CPU {entries['cpu']['map']:.4f}, mean_assessor_score diff "
          f"{abs(entries[DEVICE]['mean_assessor_score'] - entries['cpu']['mean_assessor_score']):.3e}")
    check(box_err <= EVAL_TOL["boxes_px"], f"evaluate card vs CPU: boxes {box_err} px")
    check(iou_err <= iou_tol, f"evaluate card vs CPU: mean_iou {iou_err} > {iou_tol}")
    k2 = sweep_on_card("evaluate rotated", rotated_log_dir, f"{out}/rotated", "K2", card)
    return {"K1": k1["launches"], "K2": k2["launches"]}


# -- phase 13 ---------------------------------------------------------------
def vbp_phase(card: str, serve_log_dir: str, frames: np.ndarray) -> int:
    """VisualBackprop served on the card at batch 32: the heat map against
    the CPU's, and images/s with and without it, in turns."""
    batch = frames[2 : 2 + BATCH]
    served = {vbp: LocalizerInference(serve_log_dir, device=DEVICE, use_assessor=True, use_visual_backprop=vbp)
              for vbp in (True, False)}
    cpu = LocalizerInference(serve_log_dir, device="cpu", use_assessor=True, use_visual_backprop=True)
    for inf in served.values():
        inf.localize_batch(batch)  # warm-up
    torch.cuda.synchronize()
    reset_launches()
    rates = {True: [], False: []}
    for _ in range(3):
        for vbp, inf in served.items():
            start = time.perf_counter()
            boxes, rois, scores, heat = inf.localize_batch(batch)
            rates[vbp].append(BATCH / (time.perf_counter() - start))
            check(np.isfinite(boxes).all() and (heat is None) != vbp, "vbp serving outputs")
            if vbp:
                check(len(heat) == BATCH and heat[0].shape == (INPUT, INPUT, 3) and heat[0].dtype == np.uint8,
                      "vbp heat maps")
                check(int(np.ptp(np.stack(heat))) > 100, "vbp heat maps are not constant")
    launches = read_launches()
    check(launches == {"K1": {**NO_LAUNCHES, "fwd": 6}, "K2": NO_LAUNCHES},
          f"vbp: 6 batches launched {launches}")
    card_heat = served[True]._predict(batch)[3].cpu()
    cpu_heat = cpu._predict(batch)[3]
    err = float((card_heat - cpu_heat).abs().max())
    print(f"vbp card vs CPU: heat map max abs err {err:.3e} (tol {VBP_TOL:g}) over {BATCH} frames "
          f"{INPUT}^2, {len(served[True].localizer.vbp_ladder())} ladder steps")
    check(err <= VBP_TOL, f"vbp card vs CPU: {err} > {VBP_TOL}")
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:  # after the timed batches
        start = time.perf_counter()
        served[True].localize_batch(batch)
        wall_ms = (time.perf_counter() - start) * 1e3
    print_trace(prof, f"localize_batch({BATCH}) with VisualBackprop", wall_ms, card, top=10)
    med = {vbp: statistics.median(r) for vbp, r in rates.items()}
    print(f"vbp: localize_batch({BATCH}) images/s with VisualBackprop "
          f"{', '.join(f'{r:.1f}' for r in rates[True])} (median {med[True]:.1f}), without "
          f"{', '.join(f'{r:.1f}' for r in rates[False])} (median {med[False]:.1f}), in turns; "
          f"{med[True] / med[False]:.3f}x; K1 forward launches {launches['K1']['fwd']} ({card})")
    return launches["K1"]["fwd"]


# -- phase 14 ---------------------------------------------------------------
def bench_phase(card: str) -> dict:
    """The port's bench at its operating point, with K1's launches."""
    torch.cuda.synchronize()
    reset_launches()
    run = bench.measure()
    launches = read_launches()
    steps = bench.STEPS_PER_CALL * (bench.WARMUP_CALLS + bench.CALLS)
    check(launches == {"K1": {**NO_LAUNCHES, "fwd": steps, "bwd_theta": steps}, "K2": NO_LAUNCHES},
          f"bench: {steps} steps launched {launches}")
    line = bench.result_line(run, bench.BATCH)
    print(json.dumps(line))
    calls = sorted(run["call_ms"])
    print(f"bench: {bench.CALLS} timed calls of {bench.STEPS_PER_CALL} steps at batch {bench.BATCH} "
          f"(bf16, after {bench.WARMUP_CALLS} warm-up calls): {run['images_per_sec']:.2f} images/s; per call "
          f"(CUDA events) min {calls[0]:.2f} ms, median {statistics.median(calls):.2f} ms, max {calls[-1]:.2f} ms; "
          f"loss_localizer {run['loss_localizer']:.5f}; K1 launches {launches['K1']} ({card})")
    return {"fwd": steps, "bwd_theta": steps}


# -- phase 15 ---------------------------------------------------------------
def ssd_windows(s: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(SSD_CROP_BATCH, 2, 3) thetas of SSD augment windows on an s^2 scene:
    four drawn by its draw function from a fixed generator (the first
    candidate that meets the drawn constraint, as the augment picks), then
    the identity window, a 4.0x window around the scene, a 0.3x window in
    a corner and a window that touches the right edge; and the windows
    (N, 4) yxyx in units of the scene's side."""
    n = SSD_CROP_BATCH
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    boxes = torch.tensor([[[0.3 * s, 0.25 * s, 0.65 * s, 0.7 * s]]], device=DEVICE).expand(n, 1, 4)
    valid = torch.ones(n, 1, dtype=torch.bool, device=DEVICE)
    draws = ssd_device.draw_ssd_augment(gen, torch.zeros(n, 1, 1, 3, device=DEVICE))
    win = ssd_device.augment_windows(draws, boxes, valid, s)
    win[4:] = torch.tensor([[0.0, 0.0, s, s], [-1.5 * s, -1.5 * s, 2.5 * s, 2.5 * s], [0.0, 0.0, 0.3 * s, 0.3 * s],
                            [0.2 * s, 0.5 * s, 0.7 * s, float(s)]], device=DEVICE)
    wy0, wx0, wy1, wx1 = win.unbind(-1)
    return box_to_theta(torch.stack([wx0, wy0, wx1, wy1], dim=-1), Size(s, s)).contiguous(), win / s


def ssd_crop_against_plain(card: str) -> dict:
    """Phase 15: K1's forward at the SSD augment's shapes against its plain
    version on the card, with its times, the library's and the bound."""
    rng = np.random.default_rng(SEED + 15)
    n, out = SSD_CROP_BATCH, {}
    for s in (300, 512):
        scenes = on_card(rng.uniform(size=(n, s, s, 3)).astype(np.float32))
        images = torch.cat([scenes, torch.ones(n, s, s, 1, device=DEVICE)], dim=-1).contiguous()
        theta, win = ssd_windows(s)
        size = Size(s, s)
        got = sample_separable_kernel(images, theta, size)
        want = sample_separable(images, theta, size)
        torch.cuda.synchronize()
        err = max_err(got, want)
        check(err <= K1_TOL, f"K1 ssd ({n}, {s}^2, 4) -> {s}^2: max abs err {err} > {K1_TOL}")
        sides = (win[:, 2:] - win[:, :2]).flatten()
        print(f"K1 ssd ({n}, {s}^2, 4) -> {s}^2: max_abs_err {err:.3e} (tol {K1_TOL}); window sides "
              f"{float(sides.min()):.3f}-{float(sides.max()):.3f} of the scene (drawn, identity, 4.0x around, "
              f"0.3x in a corner, on the right edge)")
        images_nchw = images.permute(0, 3, 1, 2).contiguous()
        kernel = lambda: sample_separable_kernel(images, theta, size)  # noqa: E731
        plain = lambda: sample_separable(images, theta, size)  # noqa: E731
        library = lambda: library_crop(images_nchw, theta, size)  # noqa: E731
        lib_err = float((library().permute(0, 2, 3, 1) - kernel()).abs().max())
        call_ms, plain_ms, lib_ms = cuda_ms(kernel), cuda_ms(plain), cuda_ms(library)
        bound_ms, bound_by = bound("fwd", images, theta, size)
        t = {"ms": call_ms, "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bound_ms, "bound_by": bound_by,
             "max_abs_err": err}
        t.update(one_kernel_device_times(f"K1 ssd {s}^2", "separable_sampler_fwd", kernel, n, card))
        t["plain_device_ms"], t["library_device_ms"] = ms(device_us(plain)), ms(device_us(library))
        print(f"K1 ssd ({n}, {s}^2, 4) -> {s}^2: per call (CUDA events, median of 25) kernel "
              f"{call_ms * 1e3:.2f} us, plain bmm {plain_ms * 1e3:.2f} us, library grid_sample "
              f"{lib_ms * 1e3:.2f} us (max abs diff to the kernel {lib_err:.2e}); device time "
              f"{t['device_ms'] * 1e3:.2f} us L2-warm, {t['device_cold_ms'] * 1e3:.2f} us L2-cold (plain "
              f"{fmt_us(None if t['plain_device_ms'] is None else t['plain_device_ms'] * 1e3)}, library "
              f"{fmt_us(None if t['library_device_ms'] is None else t['library_device_ms'] * 1e3)}); bound "
              f"{bound_ms * 1e3:.2f} us ({bound_by}: this run's read region and the crop over 3.35 TB/s), "
              f"roofline share L2-cold {bound_ms / t['device_cold_ms']:.2f} ({card})")
        out[s] = t
    return out


# -- phase 16 ---------------------------------------------------------------
def ssd_cli_run(tag: str, argv: list[str], card: str, log_root: str, k1_per_iteration: int = 1) -> dict:
    """``train_ssd.main(argv)`` in this process with every count at 0:
    K1's forward ``k1_per_iteration`` times per iteration (the device
    augment's window) and nothing else, finite losses, mAP at every eval
    interval, the snapshots; images/s per log entry."""
    args = train_ssd.get_parser().parse_args(argv)
    torch.cuda.synchronize()
    reset_launches()
    start = time.perf_counter()
    log_dir = train_ssd.main(argv + ["--log-dir", log_root])
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - start
    launches = read_launches()
    check(launches == {"K1": {**NO_LAUNCHES, "fwd": k1_per_iteration * args.iterations}, "K2": NO_LAUNCHES},
          f"{tag}: launches {launches} for {args.iterations} iterations")
    log = MetricsLog.read(log_dir)
    check(len(log) == args.iterations // args.log_interval, f"{tag}: {len(log)} log entries")
    for e in log:
        check(all(np.isfinite(e[k]) for k in ("loss", "loss/loc", "loss/conf")), f"{tag}: finite: {e}")
        print(f"{tag}: iteration {int(e['iteration'])} images_per_sec {e['images_per_sec']:.1f} loss "
              f"{e['loss']:.4f} loss/loc {e['loss/loc']:.4f} loss/conf {e['loss/conf']:.4f}"
              + (f" map {e['map']:.4f}" if "map" in e else "") + f" ({card})")
    evals = args.iterations // args.eval_interval
    check(sum("map" in e for e in log) == evals and all(0 <= e.get("map", 0) <= 1 for e in log),
          f"{tag}: {evals} evals expected in {log}")
    name = args.model.upper()
    written = list(range(args.snapshot_interval, args.iterations + 1, args.snapshot_interval))
    snaps = sorted(os.listdir(log_dir))
    check({f"{name}_{i}.pt" for i in written} | {"manifest.json", "log"} <= set(snaps), f"{tag}: {snaps}")
    print(f"{tag}: {args.iterations} iterations of {name} at batch {args.batch_size}{' bf16' if args.bf16 else ''} "
          f"in {wall_s:.2f} s of wall time (data generation and evals included); K1 launches {launches['K1']} "
          f"({k1_per_iteration} forward per iteration, no backward), K2 {launches['K2']}; log dir {snaps}")
    rates = [e["images_per_sec"] for e in log[1:] or log]
    return {"log_dir": log_dir, "launches": launches["K1"]["fwd"], "images_per_s": statistics.median(rates)}


def ssd_trace(card: str) -> None:
    """One traced pooled call of the SSD300 step (``STEPS_PER_CALL`` steps at
    batch 32, after a warm-up call): the largest device items, the idle
    share and K1's forward's share of the device time."""
    args = train_ssd.get_parser().parse_args(["synthetic:64"] + SSD_ARGV[1:])
    pool = train_ssd.build_pool(args, 300)
    torch.manual_seed(SEED)
    model = SSD300().to(DEVICE)
    state = create_ssd_train_state(model, SSD_LR)
    chunks = device_chunk_batches({"train": pool}, SSD_BATCH, STEPS_PER_CALL, seed=SEED, device=DEVICE)
    body = ssd_device.SSDPooledBody(model.coder(), 300)
    step = functools.partial(pooled_step, steps_per_call=STEPS_PER_CALL, body=body)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    float(step(state, None, next(chunks), gen)[2]["loss"])  # warm-up
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        start = time.perf_counter()
        float(step(state, None, next(chunks), gen)[2]["loss"])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3
    chunks.close()
    print_trace(prof, f"SSD300 pooled_step({STEPS_PER_CALL} x batch {SSD_BATCH}, float32)", wall_ms, card, top=12)
    events = device_events(prof)
    busy = sum(e.self_device_time_total for e in events)
    k1 = [e for e in events if "separable_sampler_fwd_kernel" in e.key]
    k1_us = sum(e.self_device_time_total for e in k1)
    count = sum(e.count for e in k1)
    share = f"{k1_us / busy:.4f}" if busy else "not measured"  # the profiler may lose a window
    print(f"trace: in the traced SSD300 call, separable_sampler_fwd {fmt_us(k1_us / count if count else None)} "
          f"device time per launch ({count} launches), {share} of the device time; "
          f"{SSD_BATCH * STEPS_PER_CALL / wall_ms * 1e3:.1f} images/s in the traced call ({card})")


def ssd_cli_phase(card: str, log_root: str) -> dict:
    """Phase 16: the SSD CLI, SSD300 float32 at batch 32 (kept for phase
    18), SSD512 at batch 8 and SSD300 bf16, then one traced call."""
    main = ssd_cli_run("ssd", SSD_ARGV, card, f"{log_root}/ssd300")
    ssd512 = list(SSD_ARGV)
    ssd512[ssd512.index("--model") + 1] = "ssd512"
    ssd512[ssd512.index("--batch-size") + 1] = "8"
    ssd512[0] = "synthetic:64"  # 512^2 scenes: a smaller pool
    big = ssd_cli_run("ssd512", ssd512 + SSD_SHORT, card, f"{log_root}/ssd512")
    bf16 = ssd_cli_run("ssd bf16", SSD_ARGV + SSD_SHORT + ["--bf16"], card, f"{log_root}/bf16")
    print(f"ssd: images/s, median log entry after the first: SSD300 float32 batch {SSD_BATCH} "
          f"{main['images_per_s']:.1f}, SSD512 float32 batch 8 {big['images_per_s']:.1f}, SSD300 bf16 batch "
          f"{SSD_BATCH} {bf16['images_per_s']:.1f} (the crop stays K1's float32 kernel) ({card})")
    ssd_trace(card)
    return {"log_dir": main["log_dir"], "launches": main["launches"] + big["launches"] + bf16["launches"]}


# -- phase 17 ---------------------------------------------------------------
def _draws_to(draws: ssd_device.SSDDraws, device) -> ssd_device.SSDDraws:
    return ssd_device.SSDDraws(*(
        type(d)(*(t.to(device) for t in d)) if isinstance(d, tuple) else d.to(device) for d in draws))


def ssd_step_against_cpu() -> None:
    """Phase 17: one SSD300 step at batch 2 on the card and on the CPU from
    the same weights and draws: the augmented images, the encoded targets,
    the losses and the parameters after the update (SSD_STEP_TOL)."""
    ds = synthetic.SyntheticLocalizerDataset(2, image_size=(300, 300), seed=SEED, labeled=True,
                                             output_dtype="uint8", asset_seed=SSD_ASSET_SEED, n_assets=16)
    scenes = np.stack([ds[i][0] for i in range(2)])
    boxes = np.stack([ds[i][1] for i in range(2)]).astype(np.float32)  # (2, 1, 4) pixel yxyx
    torch.manual_seed(SEED)
    cpu_model = SSD300()
    start_params = {k: v.clone() for k, v in cpu_model.state_dict().items()}
    coder = cpu_model.coder()
    draws = ssd_device.draw_ssd_augment(torch.Generator().manual_seed(SEED + 17), torch.zeros(2, 1, 1, 3))
    runs = {}
    for device, model in (("cpu", cpu_model), (DEVICE, copy.deepcopy(cpu_model).to(DEVICE))):
        x = to_float01(torch.from_numpy(scenes).to(device))
        b, v = torch.from_numpy(boxes).to(device), torch.ones(2, 1, dtype=torch.bool, device=device)
        images, b, v = ssd_device.ssd_augment_batch(x, b, v, 300, draws=_draws_to(draws, device))
        defaults = ssd_device.SSDPooledBody(coder, 300).defaults(torch.device(device))
        gt_loc, gt_conf = ssd_device.encode_batch(*defaults, b / 300, v)
        best_iou = ssd_device.pairwise_iou_yxyx(defaults[1], b / 300).amax(dim=2)
        state = create_ssd_train_state(model, SSD_LR)
        _, metrics = ssd_train_step(state, (images, gt_loc, gt_conf))
        runs[device] = {"images": images.cpu(), "loc": gt_loc.cpu(), "conf": gt_conf.cpu(), "iou": best_iou.cpu(),
                        "metrics": {k: float(m) for k, m in metrics.items()},
                        "params": {k: p.detach().cpu() for k, p in model.state_dict().items()}}
    cpu, card = runs["cpu"], runs[DEVICE]
    img_err = float((card["images"] - cpu["images"]).abs().max())
    near = (cpu["iou"] - 0.5).abs() < SSD_STEP_TOL["iou_margin"]
    conf_diff = (card["conf"] != cpu["conf"])
    loc_err = float((card["loc"] - cpu["loc"])[~conf_diff[..., None].expand_as(cpu["loc"])].abs().max())
    print(f"ssd step card vs CPU (SSD300, batch 2, lr {SSD_LR:g}): augmented images max abs err {img_err:.3e} "
          f"(tol {SSD_STEP_TOL['images']:g}); classes differ at {int(conf_diff.sum())} anchors "
          f"({int(near.sum())} within {SSD_STEP_TOL['iou_margin']:g} of the IoU gate; positives "
          f"{int((cpu['conf'] > 0).sum())}); offsets max abs err {loc_err:.3e} (tol {SSD_STEP_TOL['loc']:g})")
    check(img_err <= SSD_STEP_TOL["images"], f"ssd step: images {img_err}")
    check(not (conf_diff & ~near).any(), "ssd step: the encoded classes differ away from the IoU gate")
    check(loc_err <= SSD_STEP_TOL["loc"], f"ssd step: offsets {loc_err}")
    for k in ("loss", "loss/loc", "loss/conf"):
        a, b = card["metrics"][k], cpu["metrics"][k]
        rel = abs(a - b) / max(abs(b), 1e-12)
        print(f"ssd step card vs CPU: {k} card {a:.6f} CPU {b:.6f} rel err {rel:.3e} (tol {SSD_STEP_TOL['loss']:g})")
        check(rel <= SSD_STEP_TOL["loss"], f"ssd step: {k} {a} against {b}")
    worst, close, total = 0.0, 0, 0
    for key, p in cpu["params"].items():
        diff = (card["params"][key] - p).abs()
        worst = max(worst, float(diff.max()))
        close, total = close + int((diff <= 1e-6).sum()), total + diff.numel()
    moved = sum(not torch.equal(p, start_params[k]) for k, p in cpu["params"].items())
    print(f"ssd step card vs CPU: parameters after the update max abs diff {worst:.3e} (tol {2 * SSD_LR:g} + 1e-7), "
          f"{close / total:.5f} of the entries within 1e-6 (tol {SSD_STEP_TOL['params_share']}); "
          f"{moved} of {len(start_params)} tensors moved")
    check(worst <= 2 * SSD_LR + 1e-7 and close >= SSD_STEP_TOL["params_share"] * total, "ssd step: parameters")


# -- phase 18 ---------------------------------------------------------------
def ssd_frames(n: int) -> np.ndarray:
    """The SSD CLI's val scenes (seed 1, phase 16's asset world), float."""
    ds = synthetic.SyntheticLocalizerDataset(n, image_size=(300, 300), seed=SSD_VAL_SEED, labeled=True,
                                             asset_seed=SSD_ASSET_SEED, n_assets=16)
    return np.stack([ds[i][0] for i in range(n)])


def ssd_serve_and_evaluate(card: str, log_dir: str) -> dict:
    """Phase 18: ``load_inference`` on phase 16's log dir serves
    ``SSDInference``: 2 single frames and 3 batches of 32, images/s, the
    card's detections against the CPU's; then ``cli.evaluate.main`` sweeps
    both snapshots, and a second run evaluates nothing. K1 launches 0."""
    frames = ssd_frames(2 + 3 * SSD_BATCH)
    torch.cuda.synchronize()
    reset_launches()
    inf = load_inference(log_dir, device=DEVICE)
    check(isinstance(inf, SSDInference), f"load_inference gave {type(inf).__name__}")
    single = []
    for frame in frames[:2]:
        start = time.perf_counter()
        boxes, rois, scores, heat = inf.localize(frame)
        single.append((time.perf_counter() - start) * 1e3)
        check(boxes.shape[1:] == (4,) and len(scores) == len(boxes) and rois is None and heat is None,
              "ssd serve: localize's 4-tuple")
    rates, kept = [], []
    for b in range(3):
        batch = frames[2 + b * SSD_BATCH : 2 + (b + 1) * SSD_BATCH]
        start = time.perf_counter()
        out = inf.localize_batch(batch)
        rates.append(SSD_BATCH / (time.perf_counter() - start))
        kept += [len(s) for _, s in out]
        check(all(np.isfinite(bx).all() and np.isfinite(s).all() for bx, s in out), "ssd serve: finite")
    launches = read_launches()
    check(launches == {"K1": NO_LAUNCHES, "K2": NO_LAUNCHES}, f"ssd serve: launches {launches}")
    print(f"ssd serve: {os.path.basename(checkpoint.list_snapshots(log_dir, 'SSD300_')[-1][1])} through "
          f"load_inference -> SSDInference on {DEVICE}: single frames {', '.join(f'{t:.1f}' for t in single)} ms; "
          f"localize_batch({SSD_BATCH}) images/s {', '.join(f'{r:.1f}' for r in rates)} (median "
          f"{statistics.median(rates):.1f}; decode on the card, score gate and NMS on the host); detections kept "
          f"per frame {min(kept)}-{max(kept)}; K1 launches 0 ({card})")
    # held at a lower gate than the served 0.6, which a model this young
    # hardly passes: the comparison sees boxes
    cpu = SSDInference(log_dir, device="cpu", score_threshold=SSD_SERVE_TOL["gate"])
    inf.score_threshold = gate = SSD_SERVE_TOL["gate"]
    margin = SSD_SERVE_TOL["margin"]
    # every anchor's decoded box and score where the score is clear of the gate
    (card_b, card_p), (cpu_b, cpu_p) = (
        (t.cpu().numpy() for t in w._evaluator._predict(w._state, torch.from_numpy(frames[:4]).to(w.device)))
        for w in (inf, cpu))
    clear = np.abs(cpu_p[..., 1] - gate) > margin
    passed = clear & (cpu_p[..., 1] > gate)
    check(np.array_equal(clear & (card_p[..., 1] > gate), passed), "ssd serve card vs CPU: the gate differs")
    box_err = float(np.abs(card_b[passed] - cpu_b[passed]).max()) * inf.input_size if passed.any() else 0.0
    score_err = float(np.abs(card_p[clear] - cpu_p[clear]).max())
    # the kept boxes after NMS: the same, but where two boxes' IoU lies within
    # rounding of the 0.45 suppression threshold (a decision either device may
    # take; then the boxes it suppresses differ too): at most 1% apart
    kept, apart = 0, 0
    for (cb, cs), (pb, ps) in zip(inf.localize_batch(frames[:4]), cpu.localize_batch(frames[:4])):
        cb, pb = cb[cs > gate + margin], pb[ps > gate + margin]
        near = np.abs(cb[:, None, :] - pb[None, :, :]).max(-1) <= SSD_SERVE_TOL["boxes_px"]
        kept += max(len(cb), len(pb))
        apart += int((~near.any(1)).sum() + (~near.any(0)).sum())
    print(f"ssd serve card vs CPU (4 frames): {int(passed.sum())} anchors scoring over {gate + margin:g} on both, "
          f"none on one side only; their boxes max {box_err:.3e} px (tol {SSD_SERVE_TOL['boxes_px']:g}), scores "
          f"max {score_err:.3e} (tol {SSD_SERVE_TOL['scores']:g}); after NMS {kept} kept boxes, {apart} on one "
          f"device only (tol 1%)")
    check(box_err <= SSD_SERVE_TOL["boxes_px"] and score_err <= SSD_SERVE_TOL["scores"], "ssd serve card vs CPU")
    check(apart <= 0.01 * kept, f"ssd serve card vs CPU: {apart} of {kept} kept boxes on one device only")
    check(kept > 0 and passed.any(), "ssd serve card vs CPU: nothing compared")

    argv = ssd_eval_argv(log_dir)
    snaps = checkpoint.list_snapshots(log_dir, "SSD300_")
    reset_launches()
    start = time.perf_counter()
    results = evaluate.main(argv)
    wall_s = time.perf_counter() - start
    names = [os.path.basename(p) for _, p in snaps]
    check([e["snapshot_name"] for e in results.entries] == names, f"ssd evaluate: entries {results.entries}")
    for e in results.entries:
        t = results.timings[e["snapshot_name"]]
        check(0.0 <= e["map"] <= 1.0, f"ssd evaluate: {e}")
        print(f"ssd evaluate: {e['snapshot_name']} map {e['map']:.4f}; {t['seconds']:.3f} s for the snapshot, "
              f"scoring {t['images'] / t['score_seconds']:.1f} images/s ({t['images']} images, batch "
              f"{SSD_BATCH // 2}) ({card})")
    again = evaluate.main(argv)
    launches = read_launches()
    check(not again.timings and len(again.entries) == len(snaps), f"ssd evaluate: the second run {again.timings}")
    check(launches == {"K1": NO_LAUNCHES, "K2": NO_LAUNCHES}, f"ssd evaluate: launches {launches}")
    print(f"ssd evaluate: {len(snaps)} snapshots in {wall_s:.2f} s (data generation included); a second run "
          f"evaluated nothing (resume); K1 launches 0")
    return {"serve": 0, "evaluate": 0}


def ssd_phases(card: str, work: str) -> dict:
    """Phases 15-18, each with its seconds."""
    timed = {}

    def run(phase, fn, *args):
        start = time.perf_counter()
        out = fn(*args)
        timed[phase] = time.perf_counter() - start
        print(f"phase {phase}: {timed[phase]:.1f} s")
        return out

    crops = run(15, ssd_crop_against_plain, card)
    cli = run(16, ssd_cli_phase, card, f"{work}/ssd")
    run(17, ssd_step_against_cpu)
    served = run(18, ssd_serve_and_evaluate, card, cli["log_dir"])
    return {"crops": crops, "train": cli["launches"], "log_dir": cli["log_dir"], **served}


# -- phase 19 ---------------------------------------------------------------
# image files: phase 10's world written as PNGs with the port's own writer
# (256 train scenes as an image list, 512 IoU-labeled crops as a labeled csv,
# 64 labeled val scenes as a labeled csv and a gt json, and a gt json of the
# train scenes for the SSD), read back with data/png.py; then the training
# CLI on them for 32 iterations with the host loader (--device-data off, 8
# threads) and with the files materialized into device pools (on), in turns;
# the off run's log dir served and swept against the labeled csv; and the
# SSD CLI on the gt json with the host loader and --no-augment
FILES_ITERATIONS, FILES_LOG_INTERVAL, FILES_WORKERS = 32, 8, 8
FILES_ARGS = [
    "--batch-size", str(TRAIN_BATCH), "--n-layers", "50", "--target-size", str(INPUT), str(INPUT),
    "--crop-size", str(CROP), str(CROP), "--iterations", str(FILES_ITERATIONS),
    "--log-interval", str(FILES_LOG_INTERVAL), "--snapshot-interval", str(FILES_ITERATIONS),
    "--eval-batches", str(CLI_EVAL_BATCHES), "--synthetic-assets", "16",
    "--num-workers", str(FILES_WORKERS), "--device", DEVICE,
]
SSD_FILES_ITERATIONS = 16
SSD_FILES_ARGS = [
    "--model", "ssd300", "--batch-size", str(SSD_BATCH), "--iterations", str(SSD_FILES_ITERATIONS),
    "--log-interval", "8", "--eval-interval", str(SSD_FILES_ITERATIONS), "--eval-batches", "2",
    "--snapshot-interval", str(SSD_FILES_ITERATIONS), "--device-data", "off",
    "--num-workers", str(FILES_WORKERS), "--device", DEVICE,
]
# the row filters of the decode-rate files: the port's writer uses None; a
# Pillow-written PNG mixes Sub, Up, Average and Paeth rows
DECODE_FILTERS = {"None": 0, "Sub": 1, "Up": 2, "Average": 3, "Paeth": 4, "mixed 0-4": None}
DECODE_FILES = 32


def _rate(n: int, seconds: float) -> str:
    return f"{n / seconds:.1f} images/s ({seconds * 1e3 / n:.2f} ms an image)"


def write_image_files(root: str) -> dict:
    """Phase 10's datasets (the CLI's own dataset functions: the same seeds
    and asset world, the crops rendered by K1) written as PNGs, and read
    back."""
    args = train_localizer.get_parser().parse_args(CLI_ARGV)
    train, reference, val = train_localizer.build_datasets(args)
    os.makedirs(f"{root}/scenes")
    os.makedirs(f"{root}/crops")
    start = time.perf_counter()
    train_lines, train_gt = [], []
    for i, (img, box) in enumerate(train.items):
        write_png(f"{root}/scenes/t{i}.png", img)
        train_lines.append(f"scenes/t{i}.png")
        train_gt.append({"image": f"scenes/t{i}.png", "bounding_boxes": [box.tolist()]})
    crop_rows = []
    for i, (crop, iou) in enumerate(reference.items):
        write_png(f"{root}/crops/{i}.png", crop)
        crop_rows.append(f"crops/{i}.png\t{format(iou, '.4f')}")
    val_rows, val_gt = [], []
    for i, (img, box) in enumerate(val.items):
        write_png(f"{root}/scenes/v{i}.png", img)
        val_rows.append("\t".join([f"scenes/v{i}.png"] + [repr(float(v)) for v in box]))
        val_gt.append({"image": f"scenes/v{i}.png", "bounding_boxes": [box.tolist()]})
    files = {"train": f"{root}/train.txt", "crops": f"{root}/crops.csv", "val_csv": f"{root}/val.csv",
             "val_json": f"{root}/val.json", "train_json": f"{root}/train.json"}
    for key, lines in (("train", train_lines), ("crops", crop_rows), ("val_csv", val_rows)):
        with open(files[key], "w") as f:
            f.write("\n".join(lines) + "\n")
    for key, records in (("val_json", val_gt), ("train_json", train_gt)):
        with open(files[key], "w") as f:
            json.dump(records, f)
    write_s = time.perf_counter() - start
    n = len(train.items) + len(reference.items) + len(val.items)
    print(f"files: {len(train.items)} train scenes {INPUT}^2, {len(reference.items)} IoU-labeled crops {CROP}^2, "
          f"{len(val.items)} labeled val scenes (csv and gt json) written as PNG (no filter) in {write_s:.2f} s")
    for i in range(0, len(train.items), 16):
        check(np.array_equal(read_png(f"{root}/scenes/t{i}.png"), train.items[i][0]), f"files: scene {i} read back")
    for i in range(0, len(reference.items), 32):
        check(np.array_equal(read_png(f"{root}/crops/{i}.png"), reference.items[i][0]), f"files: crop {i} read back")
    start = time.perf_counter()
    for i in range(len(train.items)):
        read_png(f"{root}/scenes/t{i}.png")
    print(f"files: {n // 16 + len(reference.items) // 32} sampled files read back by data/png.py equal to the arrays "
          f"written; decode of the {len(train.items)} {INPUT}^2 train scenes on one thread: "
          f"{_rate(len(train.items), time.perf_counter() - start)}")
    decode_rates(root, [img for img, _ in train.items[:DECODE_FILES]])
    host_resize_rates([img for img, _ in train.items[:DECODE_FILES]])
    start = time.perf_counter()
    gen_csv = synthetic.generate_dataset(f"{root}/generated", 8, image_size=(INPUT, INPUT), output_size=(CROP, CROP))
    gen = LabeledImageDataset(gen_csv)
    examples = [gen[i] for i in range(len(gen))]
    check(all(e[0].shape == (CROP, CROP, 3) and 0.0 <= float(e[1][0]) <= 1.0 for e in examples),
          "files: generate_dataset's crops read back")
    print(f"files: generate_dataset wrote and LabeledImageDataset read back {len(gen)} IoU-labeled crops in "
          f"{time.perf_counter() - start:.2f} s (labels {[round(float(e[1][0]), 4) for e in examples]})")
    return files


def decode_rates(root: str, images: list[np.ndarray]) -> None:
    """data/png.py's decode rate on one thread for files whose rows all
    take one filter (or a mix), each read back equal to its image."""
    rates = []
    for name, f in DECODE_FILTERS.items():
        paths = []
        for i, img in enumerate(images):
            filters = f if f is not None else np.arange(img.shape[0]) % 5
            paths.append(write_png(f"{root}/decode_{f}_{i}.png", img, filters=filters))
        start = time.perf_counter()
        decoded = [read_png(p) for p in paths]
        seconds = time.perf_counter() - start
        check(all(np.array_equal(d, img) for d, img in zip(decoded, images)), f"files: {name} rows read back")
        rates.append(f"{name} {_rate(len(images), seconds)}")
    print(f"files: decode of {len(images)} {INPUT}^2 RGB PNGs, rows filtered by: " + "; ".join(rates))


def host_resize_rates(images: list[np.ndarray]) -> None:
    """The host resizes of the datasets on one thread: Pillow's LANCZOS in
    numpy (``datasets.resize_image``, a 300^2 file to 224^2) and OpenCV's
    linear (``cv_resize``, a 224^2 file to the SSD's 300^2)."""
    big = [resize_linear(img, (300, 300)) for img in images]
    start = time.perf_counter()
    for img in big:
        resize_image(img, (INPUT, INPUT))
    lanczos = time.perf_counter() - start
    start = time.perf_counter()
    for img in images:
        resize_linear(img, (300, 300))
    linear = time.perf_counter() - start
    print(f"files: host resize on one thread: LANCZOS 300^2->{INPUT}^2 {_rate(len(big), lanczos)}; "
          f"OpenCV linear {INPUT}^2->300^2 {_rate(len(images), linear)}")


def host_loader_rate(argv: list[str]) -> float:
    """The host loader alone (``--num-workers`` threads): the CLI's zipped
    train and reference streams for 32 batches, no step."""
    args = train_localizer.get_parser().parse_args(argv)
    train, reference, _ = train_localizer.build_datasets(args)
    batches = train_localizer._host_batches(args, train, reference)
    next(batches)  # the pool's first lookahead
    start = time.perf_counter()
    for _ in range(FILES_ITERATIONS):
        next(batches)
    seconds = time.perf_counter() - start
    batches.close()
    rate = FILES_ITERATIONS * args.batch_size / seconds
    print(f"files: the host loader alone ({args.num_workers} threads): {FILES_ITERATIONS} batches of "
          f"{args.batch_size} scenes + {args.batch_size} crops in {seconds:.2f} s = {rate:.1f} batches' "
          f"images/s (scenes counted)")
    return rate


def files_trace(argv: list[str], card: str) -> None:
    """One traced stretch of 4 alternating steps fed by the host loader and
    ``device_prefetch`` (after 3 warm-up steps): the idle share."""
    args = train_localizer.get_parser().parse_args(argv)
    train, reference, _ = train_localizer.build_datasets(args)
    loc_state, ass_state = train_localizer.build_states(args, torch.device(DEVICE))
    batches = device_prefetch(train_localizer._host_batches(args, train, reference), DEVICE)
    config = AlternatingConfig(image_size=Size(INPUT, INPUT))
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    for _ in range(3):
        float(alternating_step(loc_state, ass_state, next(batches), gen, config)[2]["loss_localizer"])
    steps = 4
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        start = time.perf_counter()
        for _ in range(steps):
            metrics = alternating_step(loc_state, ass_state, next(batches), gen, config)[2]
        float(metrics["loss_localizer"])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3
    batches.close()
    print_trace(prof, f"{steps} alternating steps at batch {TRAIN_BATCH} on the host loader "
                      f"({args.num_workers} threads, device_prefetch)", wall_ms, card, top=6)
    h2d = [e for e in device_events(prof) if "Memcpy HtoD" in e.key]
    print(f"trace: {sum(e.count for e in h2d)} H2D copies, {sum(e.self_device_time_total for e in h2d) / 1e3:.3f} ms "
          f"of device time; {steps * TRAIN_BATCH / wall_ms * 1e3:.1f} images/s in the traced stretch ({card})")


def files_evaluate(log_dir: str, val_csv: str, card: str) -> int:
    """``cli.evaluate.main`` on the labeled csv against the file run's log
    dir: K1's forward once per batch; a second run evaluates nothing."""
    argv = [val_csv, log_dir, "-b", str(BATCH), "-a", "--device", DEVICE]
    snaps = checkpoint.list_snapshots(log_dir, "Localizer_")
    n_batches = len(LabeledImageDataset(val_csv)) // BATCH
    torch.cuda.synchronize()
    reset_launches()
    results = evaluate.main(argv)
    torch.cuda.synchronize()
    launches = read_launches()
    want = len(snaps) * n_batches
    check(launches == {"K1": {**NO_LAUNCHES, "fwd": want}, "K2": NO_LAUNCHES},
          f"evaluate files: launches {launches} for {len(snaps)} snapshots x {n_batches} batches")
    for e in results.entries:
        t = results.timings[e["snapshot_name"]]
        check(all(np.isfinite(e[k]) for k in ("map", "mean_iou")), f"evaluate files: {e}")
        print(f"evaluate files: {e['snapshot_name']} against {os.path.basename(val_csv)}: map {e['map']:.4f} "
              f"mean_iou {e['mean_iou']:.4f} mean_assessor_score {e['mean_assessor_score']:.4f}; "
              f"{t['seconds']:.3f} s for the snapshot, scoring {t['images'] / t['score_seconds']:.1f} images/s "
              f"(decode on the host included) ({card})")
    reset_launches()
    again = evaluate.main(argv)
    check(not again.timings and read_launches() == {"K1": NO_LAUNCHES, "K2": NO_LAUNCHES},
          f"evaluate files: the second run evaluated {again.timings}")
    print(f"evaluate files: K1 forward launches {want} = {len(snaps)} snapshot x {n_batches} batches; "
          f"a second run evaluated nothing")
    return want


def files_ssd(files: dict, card: str, log_root: str) -> int:
    """The SSD CLI on the gt json with the host loader and ``--no-augment``
    (K1 launches 0); with cv2 also 8 augmented iterations, without it the
    augmenting transform's refusal by name."""
    argv = [files["train_json"], files["val_json"], *SSD_FILES_ARGS, "--no-augment"]
    run = ssd_cli_run("ssd files", argv, card, f"{log_root}/plain", k1_per_iteration=0)
    print(f"ssd files: SSD300 float32 batch {SSD_BATCH} on the gt json (host resize 224^2->300^2, encoder on the "
          f"host, device_prefetch): {run['images_per_s']:.1f} images/s, median log entry after the first ({card})")
    if importlib.util.find_spec("cv2"):
        short = [files["train_json"], files["val_json"], *SSD_FILES_ARGS, "--iterations", "8", "--log-interval", "8",
                 "--eval-interval", "8", "--snapshot-interval", "8"]
        aug = ssd_cli_run("ssd files augment", short, card, f"{log_root}/augment", k1_per_iteration=0)
        print(f"ssd files augment: {aug['images_per_s']:.1f} images/s with the host augmentation (cv2) ({card})")
    else:
        coder = SSD300().coder()
        try:
            SSDTransform(coder, 300, augment=True)(np.zeros((8, 8, 3), np.uint8), np.array([[1, 1, 5, 5]]))
        except RuntimeError as e:
            check("cv2" in str(e) and "--no-augment" in str(e), f"ssd files: the refusal {e}")
            print(f"ssd files: without cv2 the augmenting host transform refuses by name: {e}")
        else:
            check(False, "ssd files: the augmenting host transform ran without cv2")
    return run["launches"]


def files_phase(card: str, work: str) -> dict:
    """Phase 19."""
    files = write_image_files(f"{work}/files")
    inputs = [files["train"], files["crops"], files["val_csv"]]
    off = inputs + FILES_ARGS + ["--device-data", "off"]
    on = inputs + FILES_ARGS + ["--device-data", "on", "--steps-per-call", str(STEPS_PER_CALL)]
    loader = host_loader_rate(off)
    runs = {"off": [], "on": []}
    counted = cli_run("files off", off, card, f"{work}/files_off")
    runs["off"].append(counted["images_per_s"])
    for mode, argv in (("on", on), ("off", off), ("on", on)):
        runs[mode].append(cli_run(f"files {mode}", argv, card)["images_per_s"])
    check(counted["launches"] == {"fwd": FILES_ITERATIONS + (FILES_ITERATIONS // FILES_LOG_INTERVAL) * CLI_EVAL_BATCHES,
                                  "bwd_theta": FILES_ITERATIONS, "bwd_images": 0},
          f"files off: K1 launches {counted['launches']}")
    print(f"files: R-50 {INPUT}->{CROP} float32 at batch {TRAIN_BATCH}, {FILES_ITERATIONS} iterations, images/s "
          f"(median log entry after the first), in turns: host loader (--device-data off, {FILES_WORKERS} threads) "
          f"{', '.join(f'{r:.1f}' for r in runs['off'])}; device pools (on) "
          f"{', '.join(f'{r:.1f}' for r in runs['on'])}; the loader alone {loader:.1f} ({card})")
    files_trace(off, card)
    evaluated = files_evaluate(counted["log_dir"], files["val_csv"], card)
    ssd = files_ssd(files, card, f"{work}/files_ssd")
    return {"train": counted["launches"], "evaluate": evaluated, "train_ssd": ssd}


# -- phase 20 ---------------------------------------------------------------
# data-parallel training (loans_tpu_torch.parallel). First torchrun, one
# process per card (NCCL; this machine's cards), runs the training CLI at
# phase 10's configuration for 32 iterations, without the pool refresh (its
# swap chunk follows a thread's timing, so two runs would train on other
# crops), against a plain process of the same argv, in turns. Both run this
# script's --cli mode, which counts each process's kernel launches and, under
# torchrun, all-reduces one tensor over NCCL after the run. Early training
# is chaotic here: the localizer's loss is mostly the out-of-image sum of
# crops far outside the scene, and with cuDNN's default algorithms (whose
# backward sums with atomics in no fixed order) the torchrun run at world
# size 1 and the plain run differed by 3.7e-3 in the first log entry and by
# 63% in the second (an H100 80GB HBM3 at 700 W). So every comparison of
# phase 20 runs cuDNN's deterministic algorithms (deterministic_cudnn). At
# world size 1 the torchrun run is the plain run's program: its losses per
# log entry within DDP_TOL["cli_loss"] relative.
#
# Then two processes share the one card over gloo, each on half of every
# global batch: the pooled alternating step at R-50 224->75 (global batch
# 64, 8 steps), the SSD300 step with the on-device augmentation (global
# batch 8, 4 steps) and R-18 on K2 at ratio 0.5 (global batch 64, 4 steps).
# Every step is held against one process's step from the same state: before
# each step rank 0 copies the replicas' state (parameters, statistics, Adam's
# moments, the step's generator) into a second copy of the models and steps
# it on the whole global batch with the group's collectives suspended
# (parallel.suspended: what a process without a group runs). Two runs left
# to go apart would not do: the batch split in two changes float32 sums, a
# weight whose gradient is within rounding of 0 then steps by lr either way,
# and early training amplifies that (run apart from step 1, the localizer's
# loss drew apart by 11% at step 6 of R-50 and the SSD's difference grew
# tenfold a step, an H100 80GB HBM3 at 700 W). Each step, on rank 0:
# - the losses within DDP_TOL["loss"] relative (one function of the same
#   weights and batch; measured at most 4.4e-7 at the first step);
# - the gradients the step applied (averaged over the ranks) of the
#   localizer's head, the assessor and SSD300 (DDP_GRAD_HELD) within
#   DDP_TOL["grad"] of their tensor's largest entry (float32 sums of the
#   batch split in two, cuDNN's algorithms for half the batch; measured at
#   most 2.0e-3 at the first step, SSD300). The localizer's backbone
#   gradients are printed, not held: from step 2 on (the head starts at
#   zero) they leave BatchNorm's backward as small differences of large
#   terms, dominated by float32 rounding that depends on how the batch's
#   sums are split, on one process too. Their updates are held by the
#   share below, and tests/test_torch_parallel.py holds them, through
#   Adam's moments, against one process and JAX at R-18 64^2 on the CPU;
# - the BatchNorm running statistics within DDP_TOL["bn_stats"] of each
#   tensor's largest entry (STEP_TOL's bound, card against CPU);
# - the parameters within a tenth of lr of one process's on a share
#   DDP_TOL["params_share"] of their entries. Their largest difference is
#   printed in units of lr and not held: Adam moves a weight by about lr in
#   its gradient's sign, so no difference of one step can exceed about 2 lr.
# The replicas equal bit for bit after the last step. Last, the dry run
# (python -m loans_tpu_torch.parallel.dryrun) runs its two ranks on the card.
DDP_ITERATIONS = 32
DDP_CLI_ARGV = CLI_ARGV + ["--iterations", str(DDP_ITERATIONS), "--snapshot-interval", str(DDP_ITERATIONS),
                           "--assessor-refresh", "0"]
DDP_RANKS = 2
DDP_CASES = {  # case: (global batch, steps)
    "R-50 K1": (TRAIN_BATCH, 8),
    "SSD300": (SSD_CROP_BATCH, 4),
    "R-18 K2 ratio 0.5": (TRAIN_BATCH, 4),
}
DDP_GRAD_HELD = ("localizer head", "assessor", "SSD300", "classifier head")
DDP_TOL = {"cli_loss": 1e-5, "loss": 1e-4, "grad": 1e-2, "bn_stats": STEP_TOL["bn_stats"], "params_share": 0.9}


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN's deterministic algorithms for the block (restored after)."""
    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved


def ddp_ssd_pool(n: int = 32) -> dict[str, np.ndarray]:
    """Noise scenes of 300^2 with one or two gt boxes each (seed 0)."""
    gen = np.random.default_rng(SEED)
    yx = gen.uniform(0, 200, (n, 2, 2))
    hw = gen.uniform(40, 100, (n, 2, 2))
    return {"scenes": gen.integers(0, 256, (n, 300, 300, 3), dtype=np.uint8),
            "boxes": np.concatenate([yx, yx + hw], axis=-1).astype(np.float32),
            "valid": np.stack([np.ones(n, bool), gen.uniform(size=n) < 0.5], axis=1)}


def ddp_models(case: str) -> tuple[list[nn.Module], tuple, object]:
    """``case``'s models on the card (seed ``SEED``), their train states and
    the step's body."""
    torch.manual_seed(SEED)
    if case == "R-50 classifier":  # phase 24 (e)
        model = ResNet(50, class_labels=PRETRAIN_CLASSES).to(DEVICE)
        return [model], (create_train_state(model, LR), None), pretrain_backbone.classifier_body
    if case == "SSD300":
        model = SSD300().to(DEVICE)
        body = ssd_device.SSDPooledBody(model.coder(), 300, augment=True)
        return [model], (create_ssd_train_state(model, SSD_LR), None), body
    manifest = MANIFEST if case == "R-50 K1" else with_kwargs(n_layers=18, **ROTATED_KWARGS)
    models = list(build_pair(DEVICE, manifest))
    return models, tuple(create_train_state(m, LR) for m in models), alternating_step


def copy_states(dst: tuple, src: tuple) -> None:
    """``src``'s parameters, buffers, optimizer state (cloned) and step
    into ``dst``, whose models have the same layout."""
    for d, s in zip(dst, src):
        if s is None:
            continue
        with torch.no_grad():
            for a, b in zip(d.model.state_dict().values(), s.model.state_dict().values()):
                a.copy_(b)
        for gd, gs in zip(d.optimizer.param_groups, s.optimizer.param_groups):
            gd.update({k: v for k, v in gs.items() if k != "params"})
            for pd, ps in zip(gd["params"], gs["params"]):
                d.optimizer.state[pd] = {k: v.clone() for k, v in s.optimizer.state[ps].items()}
        d.step = s.step


def grad_group(case: str, i: int, name: str) -> str:
    """The group of parameter ``name`` of model ``i`` whose gradients are
    held together (see above)."""
    if case == "SSD300":
        return "SSD300"
    if case == "R-50 classifier":
        return "classifier head" if name.startswith("Dense_0.") else "classifier backbone"
    if i == 1:
        return "assessor"
    return "localizer head" if name.startswith("param_predictor.") else "localizer backbone"


def step_errors(case: str, got: list[nn.Module], want: list[nn.Module], lr: float) -> dict:
    """The ranks' models (``got``) against one process's (``want``) after a
    step from the same state: for each group of ``grad_group``, the largest
    gradient error relative to its tensor's largest entry, where, and the
    median over its tensors; the same for the floating buffers; the share
    of parameter entries within 0.1 lr and the largest parameter difference
    in units of lr."""
    grad, stats, close, total, largest = {}, 0.0, 0, 0, 0.0
    for i, (a, b) in enumerate(zip(got, want)):
        for (name, p), q in zip(a.named_parameters(), b.parameters()):
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            w = q.grad if q.grad is not None else torch.zeros_like(q)
            err = float((g - w).abs().max() / w.abs().max().clamp(min=1e-30))
            grad.setdefault(grad_group(case, i, name), {})[f"{i}.{name}"] = err
            d = (p.detach() - q.detach()).abs()
            close, total = close + int((d <= 0.1 * lr).sum()), total + d.numel()
            largest = max(largest, float(d.max()))
        for x, y in zip(a.buffers(), b.buffers()):
            if x.is_floating_point():
                stats = max(stats, float((x - y).abs().max() / y.abs().max().clamp(min=1e-30)))
    grads = {}
    for group, errs in grad.items():
        worst = max(errs, key=errs.get)
        grads[group] = {"largest": errs[worst], "at": worst, "median": statistics.median(errs.values())}
    return {"grads": grads, "stats": stats, "share": close / total, "largest_lr": largest / lr}


def ddp_case(case: str) -> dict:
    """``ALL_DDP_CASES[case]`` on this rank's share of each global batch, one
    pooled step a call, each step held against one process's step from the
    same state (made on rank 0, see above). Returns rank 0's record of each
    step (both sides' losses and seconds, ``step_errors``), this rank's
    launches in the ranks' steps alone, and the largest difference of any
    replica's parameter or statistic from rank 0's."""
    import torch.distributed as dist

    from loans_tpu_torch import parallel
    from loans_tpu_torch.parallel.dryrun import max_difference_from_rank0

    batch, steps = ALL_DDP_CASES[case]
    lr = SSD_LR if case == "SSD300" else LR
    main = parallel.rank() == 0
    models, states, body = ddp_models(case)
    for m in models:
        parallel.replicate(m)
    if case == "R-50 classifier":
        groups = {"cls": pretrain_backbone.make_scene_pool(PRETRAIN_DDP_POOL, PRETRAIN_CLASSES, SEED, SEED,
                                                           (INPUT, INPUT))}
    else:
        groups = {"train": ddp_ssd_pool()} if case == "SSD300" else training_pools()
    chunks = device_chunk_batches(groups, batch, 1, seed=SEED, device=DEVICE)
    generator = torch.Generator(device=DEVICE).manual_seed(SEED + 20)
    config = AlternatingConfig(image_size=Size(INPUT, INPUT))
    if main:  # one process's copy, stepped with the collectives suspended
        one_models, one_states, one_body = ddp_models(case)
        one_chunks = device_chunk_batches(groups, batch, 1, seed=SEED, device=DEVICE)
        one_generator = torch.Generator(device=DEVICE)
    records = []
    launches = {c: dict(NO_LAUNCHES) for c in KERNELS}
    with deterministic_cudnn():
        for _ in range(steps):
            if main:
                copy_states(one_states, states)
                one_generator.set_state(generator.get_state())
                torch.cuda.synchronize()
                start = time.perf_counter()
                with parallel.suspended():
                    *one_states, want = pooled_step(*one_states, next(one_chunks), one_generator, steps_per_call=1,
                                                    config=config, body=one_body)
                    want = parallel.reduce_metrics([want])[0]
                one_seconds = time.perf_counter() - start
            torch.cuda.synchronize()
            dist.barrier()
            before = read_launches()
            start = time.perf_counter()
            *states, got = pooled_step(*states, next(chunks), generator, steps_per_call=1, config=config, body=body)
            got = parallel.reduce_metrics([got])[0]
            seconds = time.perf_counter() - start
            after = read_launches()
            for c in KERNELS:
                for k in COUNTERS:
                    launches[c][k] += after[c][k] - before[c][k]
            if main:
                records.append({"got": got, "want": want, "seconds": seconds, "one_seconds": one_seconds,
                                **step_errors(case, models, one_models, lr)})
    chunks.close()
    if main:
        one_chunks.close()
    return {"records": records, "launches": launches, "spread": max_difference_from_rank0(models)}


def ddp_worker(rank: int, init_method: str, out_dir: str, cases: tuple[str, ...]) -> None:
    """One of the ranks that share the card: every case of ``cases``; each
    rank saves its launches, rank 0 its records and the spread."""
    from loans_tpu_torch import parallel

    set_precision()
    torch.cuda.set_device(0)
    # NCCL refuses two ranks on one GPU (each communicator needs a device of
    # its own), so the two ranks sharing this card join over gloo, which
    # stages CUDA tensors through the host
    parallel.init_distributed(backend="gloo", init_method=init_method, world_size=DDP_RANKS, rank=rank,
                              device_type="cuda", timeout=600)
    try:
        results = {case: ddp_case(case) for case in cases}
    finally:
        parallel.shutdown()
    with open(os.path.join(out_dir, f"launches.{rank}.json"), "w") as f:
        json.dump({case: r.pop("launches") for case, r in results.items()}, f)
    if rank == 0:
        with open(os.path.join(out_dir, "rank0.json"), "w") as f:
            json.dump(results, f)


def ddp_expected_launches(case: str, steps: int) -> dict:
    if case == "R-50 classifier":  # no crop
        return {"K1": NO_LAUNCHES, "K2": NO_LAUNCHES}
    if case == "SSD300":  # the augment's window: K1's forward only
        return {"K1": {"fwd": steps, "bwd_theta": 0, "bwd_images": 0}, "K2": NO_LAUNCHES}
    used, unused = ("K1", "K2") if case == "R-50 K1" else ("K2", "K1")
    return {used: {"fwd": steps, "bwd_theta": steps, "bwd_images": 0}, unused: NO_LAUNCHES}


def ddp_compare(case: str, result: dict, card: str) -> None:
    """The ranks' steps against one process's, each from the same state
    (see above); the replicas; both rates (two ranks on one card: a check
    of the collective path, not scaling)."""
    batch, steps = ALL_DDP_CASES[case]
    tag = f"ddp {case}"
    records = result["records"]
    check(len(records) == steps, f"{tag}: {len(records)} steps recorded, expected {steps}")
    for s, r in enumerate(records, 1):
        got, want = r["got"], r["want"]
        rel = {k: abs(got[k] - want[k]) / max(abs(want[k]), 1e-12) for k in want if k.startswith("loss")}
        print(f"{tag}: step {s}: " + ", ".join(
            f"{k} 2 ranks {got[k]:.6f} 1 process {want[k]:.6f} rel {rel[k]:.2e}" for k in rel)
            + f" (tol {DDP_TOL['loss']:g})")
        for group, e in r["grads"].items():
            held = group in DDP_GRAD_HELD
            print(f"{tag}: step {s}: {group} gradients applied, largest error {e['largest']:.3e} of its tensor's "
                  f"largest entry ({e['at']}), median {e['median']:.3e} "
                  + (f"(tol {DDP_TOL['grad']:g})" if held else "(not held: float32 rounding, see above)"))
            check(not held or e["largest"] <= DDP_TOL["grad"], f"{tag}: step {s} {group} gradient {e}")
        print(f"{tag}: step {s}: BatchNorm statistics {r['stats']:.3e} (tol {DDP_TOL['bn_stats']:g}); parameters "
              f"within 0.1 lr {r['share']:.5f} (tol {DDP_TOL['params_share']:g}), largest difference "
              f"{r['largest_lr']:.3f} lr (not held: about 2 lr at most)")
        check(all(np.isfinite(got[k]) for k in rel) and max(rel.values()) <= DDP_TOL["loss"],
              f"{tag}: step {s} losses {rel} (tol {DDP_TOL['loss']:g})")
        check(r["stats"] <= DDP_TOL["bn_stats"], f"{tag}: step {s} BatchNorm statistics {r['stats']:.3e}")
        check(r["share"] >= DDP_TOL["params_share"], f"{tag}: step {s} parameters within 0.1 lr {r['share']:.5f}")
    print(f"{tag}: the replicas' largest difference {result['spread']:g}")
    check(result["spread"] == 0.0, f"{tag}: the replicas differ by {result['spread']}")
    rate = [batch * (steps - 1) / sum(r[key] for r in records[1:]) for key in ("seconds", "one_seconds")]
    print(f"{tag}: images/s after the first step, global batch {batch}: 2 ranks sharing one card over gloo "
          f"{rate[0]:.1f}, 1 process {rate[1]:.1f} (the collective path's cost on one card, not scaling) ({card})")


def cli_process(tag: str, argv: list[str], nproc: int, work: str) -> dict:
    """``--cli`` mode of this script in a process of its own, under
    ``torchrun --standalone --nproc_per_node=nproc`` where ``nproc`` > 0:
    its log, launches summed over the ranks, backend and wall seconds."""
    run = tool_process("cli", tag, argv + ["--log-dir", os.path.join(work, tag.replace(" ", "_"))], nproc, work)
    return {**run, "log": MetricsLog.read(run["log_dir"])}


def ddp_cli_phase(card: str, work: str) -> dict:
    """torchrun at one process per card against a plain process, in turns."""
    n = torch.cuda.device_count()
    turns = []
    for turn in range(2):
        plain = cli_process(f"cli plain {turn}", DDP_CLI_ARGV, 0, work)
        ddp = cli_process(f"cli torchrun {turn}", DDP_CLI_ARGV, n, work)
        turns.append((plain, ddp))
        check(ddp["world"] == n and ddp["backend"] == ["nccl", float(n)],
              f"cli torchrun: world {ddp['world']}, backend and all-reduce {ddp['backend']}")
        check(len(ddp["log"]) == len(plain["log"]) == DDP_ITERATIONS // STEPS_PER_CALL, "cli torchrun: log entries")
        for a, b in zip(ddp["log"], plain["log"]):
            rel = {k: abs(a[k] - b[k]) / max(abs(b[k]), 1e-12)
                   for k in ("loss_localizer", "loss_dis", "y_fake_mean", "y_real_mean")}
            print(f"cli torchrun {turn}: iteration {int(a['iteration'])} " + ", ".join(
                f"{k} {a[k]:.5f} (plain {b[k]:.5f}, rel {rel[k]:.2e})" for k in rel)
                + f", mean_iou {a['mean_iou']:.4f} (plain {b['mean_iou']:.4f}), map {a['map']:.4f} "
                f"(plain {b['map']:.4f})")
            check(all(np.isfinite(a[k]) for k in rel) and max(rel.values()) <= DDP_TOL["cli_loss"],
                  f"cli torchrun: iteration {a['iteration']} {rel} (tol {DDP_TOL['cli_loss']:g})")
        evals = len(ddp["log"]) * CLI_EVAL_BATCHES  # rank 0 alone evaluates
        renders = -(-512 // synthetic.RENDER_BATCH)  # the stn crops, rendered on every rank
        for run in (plain, ddp):
            w = run["world"]
            want = {"fwd": w * (DDP_ITERATIONS + renders) + evals, "bwd_theta": w * DDP_ITERATIONS, "bwd_images": 0}
            check(run["launches"] == {"K1": want, "K2": NO_LAUNCHES}, f"cli torchrun: launches {run['launches']}")
    for name, i in (("plain", 0), ("torchrun", 1)):
        rates = [statistics.median(e["images_per_sec"] for e in t[i]["log"][1:]) for t in turns]
        walls = [t[i]["wall_s"] for t in turns]
        print(f"cli {name}: images/s at batch {TRAIN_BATCH}, median of the log entries after the first, turns "
              f"{', '.join(f'{r:.1f}' for r in rates)}; wall {', '.join(f'{w:.1f}' for w in walls)} s "
              f"(process start and data included) ({card})")
    print(f"cli torchrun: {n} process(es) on NCCL, K1 launches {turns[-1][1]['launches']['K1']} "
          f"= {DDP_ITERATIONS} steps + {renders} render batches a rank + {evals} eval forwards on rank 0")
    return {"launches": turns[-1][1]["launches"]}


def dryrun_on_card(card: str) -> None:
    """``python -m loans_tpu_torch.parallel.dryrun --processes 2`` on the
    card: two ranks (gloo, one card), one alternating step, the replicas
    equal afterwards."""
    start = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "loans_tpu_torch.parallel.dryrun", "--processes", "2"],
                          capture_output=True, text=True, timeout=300,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    check(proc.returncode == 0 and "agree across ranks: True" in proc.stdout,
          f"dryrun: exit {proc.returncode}:\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    for line in proc.stdout.splitlines():
        if line.startswith("dryrun:"):
            print(line)
    print(f"dryrun: {time.perf_counter() - start:.1f} s (process start included) ({card})")


def ddp_spawn(out_dir: str, cases: dict[str, tuple[int, int]]) -> dict:
    """``cases`` on ``DDP_RANKS`` ranks that share the card over gloo, each
    step against one process's: rank 0's results and each rank's launches,
    by case."""
    from loans_tpu_torch.parallel.dryrun import free_port

    os.makedirs(out_dir, exist_ok=True)
    start = time.perf_counter()
    torch.multiprocessing.spawn(ddp_worker, args=(f"tcp://127.0.0.1:{free_port()}", out_dir, tuple(cases)),
                                nprocs=DDP_RANKS, join=True)
    print(f"ddp: {DDP_RANKS} ranks on one card over gloo, {', '.join(cases)} with one process's steps on rank 0, "
          f"{time.perf_counter() - start:.1f} s (process start included)")
    with open(os.path.join(out_dir, "rank0.json")) as f:
        results = json.load(f)
    per_rank = []
    for r in range(DDP_RANKS):
        with open(os.path.join(out_dir, f"launches.{r}.json")) as f:
            per_rank.append(json.load(f))
    return {"results": results, "per_rank": per_rank}


def ddp_report(card: str, ranks: dict, cases: dict[str, tuple[int, int]]) -> dict:
    """``cases`` of a ``ddp_spawn`` checked and printed; the launches of the
    ranks' steps, each rank's checked and then summed."""
    total = {c: dict(NO_LAUNCHES) for c in KERNELS}
    for case, (_, steps) in cases.items():
        ddp_compare(case, ranks["results"][case], card)
        want = ddp_expected_launches(case, steps)
        for r, launches in enumerate(ranks["per_rank"]):
            check(launches[case] == want, f"ddp {case}: rank {r} launched {launches[case]}, expected {want}")
            for c in KERNELS:
                for k in COUNTERS:
                    total[c][k] += launches[case][c][k]
    print(f"ddp: launches of the {DDP_RANKS} ranks' steps in {', '.join(cases)}, summed: {total}")
    return total


def ddp_phase(card: str, work: str) -> dict:
    """Phase 20: the CLI under torchrun, then two ranks on the card over
    gloo, each step against one process's, then the dry run. The ranks also
    run phase 24 (e)'s case, whose start-up they share. Returns the launches
    of each path and the ranks' results."""
    cli = ddp_cli_phase(card, work)
    ranks = ddp_spawn(os.path.join(work, "ddp"), ALL_DDP_CASES)
    total = ddp_report(card, ranks, DDP_CASES)
    dryrun_on_card(card)
    return {"train_ddp": total, "train_cli_torchrun": cli["launches"], "ranks": ranks}


# -- phase 21 ---------------------------------------------------------------
# video, live serving and the training monitor at full width, on phase 10's
# log dir (R-50 224->75 and the ResnetAssessor at ch 128, float32). The clip
# is tools/bench_video.py's: 240 frames of 640x480 of the synthetic world
# (seed 3, 256 assets), mp4v, served in its six configurations. The video
# CLI launches K1's forward once a batch. b8_pipelined's boxes against
# b1_serial's at model scale: the same networks at batch 8 and 1 on the
# card, float32 sums in cuDNN's order for each batch: 1e-3 px, the bound of
# the CPU tests against JAX. Phase 8's rotated log dir goes through the
# video CLI too, on K2's forward.
CLIP = {"frames": 240, "size": (640, 480), "seed": 3, "assets": 256}
VIDEO_CONFIGS = {
    "b1_serial": ["-b", "1", "--no-pipeline"],
    "b1_pipelined": ["-b", "1"],
    "b8_pipelined": ["-b", "8"],
    "b32_pipelined": ["-b", "32"],
    "b8_gated": ["-b", "8", "-a"],
    "b8_vbp": ["-b", "8", "-a", "-v"],
}
VIDEO_TOL = {"boxes_px": 1e-3}
K1_SERVING_SHAPES = (1, 8)  # a live frame (and the plotter's), the video CLI's default batch
LATENCY = {"warmup": 10, "frames": 100}
LIVE = {"fps": 30, "seconds": 4.0, "shutdown_s": 2.0}
# the training monitor: phase 10's CLI for 32 iterations, without the pool
# refresh (whose swap chunk follows a thread's timing), with the plotter
# every 8 iterations streaming to a server on a thread, against the same
# argv without it, under deterministic cuDNN (phase 20): the losses equal
# bit for bit; then 16 iterations with a profiled window. The training's last canvas (on
# the card) against the port's on the CPU from that iteration's snapshot:
# the box tile equal where the boxes truncate alike (they agree within
# SLICE_TOL's 1e-2 px), every other pixel within one uint8 step (the crops
# agree within 1e-5, the heat maps within VBP_TOL), but the caption's rows
# where the two scores print apart
MONITOR_ITERATIONS, PLOT_INTERVAL = 32, 8
MONITOR_ARGV = CLI_ARGV + ["--iterations", str(MONITOR_ITERATIONS), "--snapshot-interval", str(MONITOR_ITERATIONS),
                           "--assessor-refresh", "0"]
MONITOR_PROFILE = ["--profile", "8", "4"]
CAPTION_ROWS = 16
# phase 16's SSD300 for 8 iterations in calls of 4 with the plot hook every 4
SSD_PLOT_ARGV = SSD_ARGV + ["--iterations", "8", "--steps-per-call", "4", "--log-interval", "4",
                            "--snapshot-interval", "8", "--plot-interval", "4"]


def write_clip(path: str) -> None:
    """tools/bench_video.py's clip, from the port's synthetic world."""
    import cv2

    ds = synthetic.SyntheticLocalizerDataset(CLIP["frames"], image_size=CLIP["size"], seed=CLIP["seed"],
                                             output_dtype="uint8", asset_seed=CLIP["seed"] + 9973,
                                             n_assets=CLIP["assets"])
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 24, CLIP["size"])
    for i in range(len(ds)):
        writer.write(np.ascontiguousarray(ds[i][..., ::-1]))  # RGB -> BGR
    writer.release()
    check(frames_in(path) == CLIP["frames"], f"clip: {frames_in(path)} frames in {path}")


def frames_in(path: str) -> int:
    import cv2

    cap = cv2.VideoCapture(path)
    n = 0
    while cap.read()[0]:
        n += 1
    cap.release()
    return n


def video_phase(card: str, log_dir: str, rotated_dir: str, work: str, clip: str) -> dict:
    """The video CLI on the clip in tools/bench_video.py's six
    configurations, then phase 8's rotated log dir at batch 8."""
    from loans_tpu_torch.cli import video_inference

    os.makedirs(work, exist_ok=True)
    runs = {}
    for name, extra in {**VIDEO_CONFIGS, "b8_rotated": ["-b", "8"]}.items():
        served = rotated_dir if name == "b8_rotated" else log_dir
        b = int(extra[extra.index("-b") + 1])
        torch.cuda.synchronize()
        reset_launches()
        start = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):  # the CLI's progress lines
            out = video_inference.main([served, "-i", clip, "-o", f"{work}/{name}.mp4", *extra, "--device", DEVICE])
        wall_s = time.perf_counter() - start
        launches = read_launches()
        batches = -(-CLIP["frames"] // b)
        used, other = ("K2", "K1") if name == "b8_rotated" else ("K1", "K2")
        check(launches == {used: {**NO_LAUNCHES, "fwd": batches}, other: NO_LAUNCHES},
              f"video {name}: launches {launches} for {batches} batches of {b}")
        written = [frames_in(out["output"])]
        if "-v" in extra:
            written.append(frames_in(video_inference.output_paths(
                video_inference.get_parser().parse_args([served, "-i", clip, "-o", out["output"]]))[1]))
        check(out["frames"] == CLIP["frames"] and written == [CLIP["frames"]] * len(written),
              f"video {name}: {out['frames']} frames served, {written} in the written videos")
        check(np.isfinite(out["boxes"]).all() and out["boxes"].shape == (CLIP["frames"], 4), f"video {name}: boxes")
        runs[name] = {**out, "launches": batches}
        print(f"video {name}: sustained fps {out['fps']:.1f} (after the first batch; {CLIP['frames']} frames of "
              f"{CLIP['size'][0]}x{CLIP['size'][1]} decoded, resized, served, drawn and encoded in {wall_s:.2f} s of "
              f"wall time{', VisualBackprop video too' if '-v' in extra else ''}); {used} forward launches {batches} "
              f"= one a batch of {b}{'; phase 8 rotated log dir' if used == 'K2' else ''} ({card})")
    err = float(np.abs(runs["b8_pipelined"]["boxes"] - runs["b1_serial"]["boxes"]).max())
    print(f"video: b8_pipelined boxes against b1_serial max {err:.3e} px at model scale (tol {VIDEO_TOL['boxes_px']:g})")
    check(err <= VIDEO_TOL["boxes_px"], f"video: b8_pipelined boxes {err} px from b1_serial's")
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof, contextlib.redirect_stdout(io.StringIO()):
        start = time.perf_counter()
        video_inference.main([log_dir, "-i", clip, "-o", f"{work}/traced.mp4", *VIDEO_CONFIGS["b8_pipelined"],
                              "--device", DEVICE])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3
    print_trace(prof, f"the video CLI at b8_pipelined, {CLIP['frames']} frames (start-up included)", wall_ms, card)
    serial, piped = runs["b1_serial"]["fps"], runs["b1_pipelined"]["fps"]
    print(f"video: the overlap at batch 1 (decode and drawing of one frame beside the card's work on the next): "
          f"b1_pipelined {piped:.1f} fps against b1_serial {serial:.1f} ({piped / serial:.3f}x); "
          + ", ".join(f"{k} {v['fps']:.1f}" for k, v in runs.items()) + f" fps ({card})")
    return {"K1": runs["b8_pipelined"]["launches"], "K2": runs["b8_rotated"]["launches"]}


def k1_serving_shapes(card: str) -> dict:
    """K1's forward at a live frame's and the video CLI's batch against its
    plain version (K1_TOL), with its times as phase 2 takes them."""
    rng = np.random.default_rng(SEED + 21)
    out, res = Size(CROP, CROP), {}
    for n in K1_SERVING_SHAPES:
        images = on_card(rng.uniform(size=(n, INPUT, INPUT, 3)).astype(np.float32))
        theta = on_card(axis_aligned_theta(rng, n))
        err = max_err(sample_separable_kernel(images, theta, out), sample_separable(images, theta, out))
        check(err <= K1_TOL, f"K1 N={n}: max abs err {err} > {K1_TOL}")
        images_nchw = images.permute(0, 3, 1, 2).contiguous()
        kernel = lambda: sample_separable_kernel(images, theta, out)  # noqa: E731
        plain = lambda: sample_separable(images, theta, out)  # noqa: E731
        library = lambda: library_crop(images_nchw, theta, out)  # noqa: E731
        bound_ms, bound_by = bound("fwd", images, theta, out)
        t = {"max_abs_err": err, "ms": cuda_ms(kernel), "plain_ms": cuda_ms(plain), "library_ms": cuda_ms(library),
             "bound_ms": bound_ms, "bound_by": bound_by}
        print(f"K1 N={n} {INPUT}^2->{CROP}^2: max_abs_err {err:.3e} (tol {K1_TOL}); per call (CUDA events, host "
              f"launch included) kernel {t['ms'] * 1e3:.1f} us, plain bmm {t['plain_ms'] * 1e3:.1f} us, library "
              f"grid_sample {t['library_ms'] * 1e3:.1f} us; bound {bound_ms * 1e3:.2f} us ({bound_by}) ({card})")
        t.update(one_kernel_device_times("K1", "separable_sampler_fwd", kernel, n, card))
        kernel_us = None if t["device_ms"] is None else t["device_ms"] * 1e3
        print(f"K1 N={n}: device time (profiler) kernel {fmt_us(kernel_us)}, plain bmm {fmt_us(device_us(plain))}, "
              f"library {fmt_us(device_us(library))} ({card})")
        res[f"({n}, {INPUT}^2, 3) -> {CROP}^2"] = t
    return res


def live_phase(card: str, log_dir: str, clip: str | None) -> int:
    """``localize``'s single-frame latency with and without the assessor,
    then an ``AsynchronousLocalizer`` fed the clip through ``Camera`` at
    LIVE["fps"]: its rate, the frames submitted, dropped and answered, the
    shutdown, and K1's forward once per answered frame."""
    from loans_tpu_torch.inference import AsynchronousLocalizer
    from loans_tpu_torch.inference.camera import Camera

    val = synthetic.SyntheticLocalizerDataset(8, image_size=(INPUT, INPUT), seed=SEED + 2, labeled=True,
                                              output_dtype="uint8", asset_seed=SEED + 9973, n_assets=16)
    frames = [val[i][0].astype(np.float32) / 255.0 for i in range(len(val))]
    for assessor in (False, True):
        inf = LocalizerInference(log_dir, device=DEVICE, use_assessor=assessor)
        for i in range(LATENCY["warmup"]):
            inf.localize(frames[i % len(frames)])
        times = []
        for i in range(LATENCY["frames"]):
            start = time.perf_counter()
            boxes, rois, scores, _ = inf.localize(frames[i % len(frames)])
            times.append((time.perf_counter() - start) * 1e3)
            check(boxes.shape == (1, 4) and np.isfinite(boxes).all(), "live: localize's boxes")
        print(f"live: localize single-frame latency{' with the assessor (-a)' if assessor else ''}: median "
              f"{statistics.median(times):.3f} ms, p90 {np.percentile(times, 90):.3f} ms, min {min(times):.3f} ms "
              f"over {LATENCY['frames']} frames of {INPUT}^2 after {LATENCY['warmup']} (host array to boxes on the "
              f"host) ({card})")
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            start = time.perf_counter()
            for frame in frames[:4]:
                inf.localize(frame)
            wall_ms = (time.perf_counter() - start) * 1e3
        print_trace(prof, f"4 x localize{' with the assessor' if assessor else ''}", wall_ms, card, top=5)
    if clip is None:
        print("live: cv2 is not installed: the camera and the worker's feed are not driven")
        return 0
    inf = LocalizerInference(log_dir, device=DEVICE, use_assessor=True)
    answered = []

    class Counted:
        def localize(self, image):
            out = inf.localize(image)
            answered.append(time.perf_counter())
            return out

    torch.cuda.synchronize()
    reset_launches()
    worker = AsynchronousLocalizer(Counted()).start_localization_worker()
    submitted = dropped = fetched = 0
    with Camera(clip) as cam:
        start = time.perf_counter()
        tick = 0
        while time.perf_counter() - start < LIVE["seconds"]:
            frame = np.ascontiguousarray(cam.get_frame()[:, ::-1])  # the live CLI's mirror
            resized, _ = inf.resize(frame)
            if worker.submit(inf.preprocess(resized, bgr_to_rgb=True)):
                submitted += 1
            else:
                dropped += 1
            result = worker.get_result()
            if result is not None:
                fetched += 1
                check(np.isfinite(result[0]).all(), "live: a result's boxes")
            tick += 1
            time.sleep(max(0.0, start + tick / LIVE["fps"] - time.perf_counter()))
    fps = worker.fps
    stop = time.perf_counter()
    worker.shutdown()
    shutdown_s = time.perf_counter() - stop
    check(not worker._worker.is_alive() and shutdown_s <= LIVE["shutdown_s"],
          f"live: shutdown took {shutdown_s:.2f} s")
    check(worker.localization_queue.empty() and worker.image_queue.empty(), "live: queues drained")
    launches = read_launches()
    check(launches == {"K1": {**NO_LAUNCHES, "fwd": len(answered)}, "K2": NO_LAUNCHES},
          f"live: launches {launches} for {len(answered)} answered frames")
    check(len(answered) >= 1 and submitted >= len(answered), f"live: {submitted} submitted, {len(answered)} answered")
    offered = submitted + dropped
    print(f"live: AsynchronousLocalizer fed the clip through Camera at {LIVE['fps']} frames/s for {LIVE['seconds']:g} s "
          f"(the assessor on): {offered} frames offered, {submitted} submitted, {dropped} dropped while the worker "
          f"was busy ({dropped / offered:.3f}), {len(answered)} answered ({len(answered) / LIVE['seconds']:.1f}/s), "
          f"{fetched} fetched; worker fps (its last localize) {fps:.1f}; shutdown in {shutdown_s:.3f} s; K1 forward "
          f"launches {launches['K1']['fwd']} = the answered frames ({card})")
    return len(answered)


def monitor_phase(card: str, work: str) -> dict:
    """The training CLI with the plotter streaming to a server against the
    same argv without it, then a run with a profiled window."""
    from loans_tpu_torch.insights.bbox_plotter import BBoxPlotter
    from loans_tpu_torch.insights.progress_server import ImageServer

    received = []
    server = ImageServer("127.0.0.1", 0, on_image=lambda img, title: received.append((title, img))).start()
    plot = ["--plot-interval", str(PLOT_INTERVAL), "--send-bboxes", f"127.0.0.1:{server.port}"]
    plots = list(range(0, MONITOR_ITERATIONS + 1, PLOT_INTERVAL))
    turns = []
    try:
        with deterministic_cudnn():
            for turn, tag in enumerate(("plot", "plain")):
                received.clear()
                torch.cuda.synchronize()
                reset_launches()
                start = time.perf_counter()
                log_dir = train_localizer.main(MONITOR_ARGV + (plot if tag == "plot" else [])
                                               + ["--log-dir", f"{work}/{tag}{turn}"])
                torch.cuda.synchronize()
                run = {"tag": tag, "log_dir": log_dir, "log": MetricsLog.read(log_dir), "launches": read_launches(),
                       "wall_s": time.perf_counter() - start}
                turns.append(run)
                if tag == "plot":
                    deadline = time.time() + 10
                    while len(received) < len(plots) and time.time() < deadline:
                        time.sleep(0.05)
                    run["received"] = list(received)
            profiled = train_localizer.main(MONITOR_ARGV + MONITOR_PROFILE + ["--iterations", "16",
                                                                             "--log-dir", f"{work}/profiled"])
    finally:
        server.stop()
    plain = turns[1]
    keys = ("loss_localizer", "loss_dis", "y_fake_mean", "y_real_mean", "mean_iou", "map")
    for run in turns:
        check(len(run["log"]) == MONITOR_ITERATIONS // STEPS_PER_CALL, f"monitor: {len(run['log'])} log entries")
        for a, b in zip(run["log"], plain["log"]):
            check(all(a[k] == b[k] for k in keys), f"monitor: iteration {a['iteration']}: {a} against {b}")
        got, want = run["launches"], plain["launches"]
        extra = len(plots) if run["tag"] == "plot" else 0
        check(got["K1"] == {**want["K1"], "fwd": want["K1"]["fwd"] + extra} and got["K2"] == NO_LAUNCHES,
              f"monitor: launches {got}, {want} without the plotter")
        if run["tag"] != "plot":
            continue
        plot_dir = run["log_dir"]
        pngs = sorted(int(f[:-4]) for f in os.listdir(f"{plot_dir}/bboxes"))
        check(pngs == plots, f"monitor: bboxes/ holds {pngs}")
        titles = sorted(int(t.split()[-1]) for t, _ in run["received"])
        check(titles == plots, f"monitor: the server got {titles}")
        for title, img in run["received"]:
            check(np.array_equal(img, read_png(f"{plot_dir}/bboxes/{title.split()[-1]}.png")),
                  f"monitor: the frame of {title} differs from its PNG")
    plot_dir = turns[0]["log_dir"]
    rates = {tag: [[e["images_per_sec"] for e in r["log"]] for r in turns if r["tag"] == tag] for tag in ("plot", "plain")}
    for i, e in enumerate(plain["log"]):
        with_, without = [r[i] for r in rates["plot"]], [r[i] for r in rates["plain"]]
        print(f"monitor: iteration {int(e['iteration'])} " + " ".join(f"{k} {e[k]:.5f}" for k in keys[:2])
              + f" (equal bit for bit in the {len(turns)} runs); images_per_sec with the plotter every {PLOT_INTERVAL} "
              f"{', '.join(f'{r:.1f}' for r in with_)}, without {', '.join(f'{r:.1f}' for r in without)} ({card})")
    # the plotter's cost per log entry: the entries after the first (which
    # holds the plot at iteration 0 and every run's warm-up)
    per_entry = [STEPS_PER_CALL * TRAIN_BATCH * (1 / statistics.median(w[i] for w in rates["plot"])
                                                  - 1 / statistics.median(w[i] for w in rates["plain"]))
                 for i in range(1, len(plain["log"]))]
    walls = ", ".join(f"{r['wall_s']:.1f}" for r in turns)
    print(f"monitor: the plotter costs {', '.join(f'{t * 1e3:.1f}' for t in per_entry)} ms a plot (each log entry "
          f"after the first: entry time with it less without), a log entry of {STEPS_PER_CALL} steps "
          f"{1e3 * STEPS_PER_CALL * TRAIN_BATCH / statistics.median(r for w in rates['plain'] for r in w[1:]):.1f} ms "
          f"without it; {len(plots)} canvases ({read_png(f'{plot_dir}/bboxes/0.png').shape}) a run, saved and "
          f"streamed, equal pixel for pixel; K1 launches {turns[0]['launches']['K1']} with the plotter = "
          f"{plain['launches']['K1']['fwd']} + {len(plots)} plots; wall "
          f"{walls} s (data generation included) ({card})")
    traces = os.listdir(f"{profiled}/profile")
    with open(f"{profiled}/profile/{traces[0]}") as f:
        text = f.read()
    check(len(traces) == 1 and "separable_sampler_fwd_kernel" in text,
          f"monitor: profile traces {traces}, separable_sampler_fwd_kernel named: "
          f"{'separable_sampler_fwd_kernel' in text}")
    print(f"monitor: --profile {' '.join(MONITOR_PROFILE[1:])} wrote {traces[0]} ({len(text) / 2**20:.1f} MiB, Chrome "
          f"JSON) naming separable_sampler_fwd_kernel {text.count('separable_sampler_fwd_kernel')} times ({card})")

    # the training's last canvas, drawn on the card, against the CPU's from
    # the snapshot of that iteration
    args = train_localizer.get_parser().parse_args(MONITOR_ARGV)
    val = synthetic.SyntheticLocalizerDataset(
        train_localizer._synthetic_n(args.val_file, 64), image_size=tuple(args.target_size), seed=args.seed + 2,
        labeled=True, output_dtype="uint8", **train_localizer.build_asset_kw(args))
    image, gt = val.get_example(0)[:2]
    manifest = checkpoint.load_manifest(plot_dir)
    boxes, scores = {}, {}
    for device in (DEVICE, "cpu"):
        loc = build_model("Localizer", **manifest["localizer"]["kwargs"])
        loc.load_state_dict(checkpoint.load_params(f"{plot_dir}/Localizer_{MONITOR_ITERATIONS}.pt"))
        ass = build_assessor(manifest["assessor"], loc)
        ass.load_state_dict(checkpoint.load_params(f"{plot_dir}/ResnetAssessor_{MONITOR_ITERATIONS}.pt"))
        plotter = BBoxPlotter(image, f"{work}/canvas_{device}", gt_bbox=np.asarray(gt).reshape(-1, 4))
        out = plotter.forward(loc.to(device), ass.to(device))
        boxes[device], scores[device] = out[1], float(np.ravel(out[2])[0])
        if device == "cpu":
            cpu_canvas = plotter.compose(*out)
    card_canvas = read_png(f"{plot_dir}/bboxes/{MONITOR_ITERATIONS}.png")
    check(card_canvas.shape == cpu_canvas.shape, f"monitor canvas: {card_canvas.shape} vs {cpu_canvas.shape}")
    diff = np.abs(card_canvas.astype(int) - cpu_canvas.astype(int)).max(axis=-1)
    box_err = float(np.abs(boxes[DEVICE] - boxes["cpu"]).max())
    same_caption = f"{scores[DEVICE]:.3f}" == f"{scores['cpu']:.3f}"
    body = diff if same_caption else diff[:-CAPTION_ROWS]
    same_boxes = np.array_equal(np.trunc(boxes[DEVICE]), np.trunc(boxes["cpu"]))
    print(f"monitor canvas card vs CPU (iteration {MONITOR_ITERATIONS}, {card_canvas.shape}): boxes max {box_err:.3e} px "
          f"(tol {SLICE_TOL['boxes_px']:g}), truncated alike {same_boxes}; box tile pixels apart "
          f"{int((body[:, :INPUT] > 0).sum())}; other pixels max {int(body[:, INPUT:].max())} levels apart (tol 1), "
          f"{int((diff > 0).sum())} in all; caption score card {scores[DEVICE]:.5f} CPU {scores['cpu']:.5f}")
    check(box_err <= SLICE_TOL["boxes_px"], f"monitor canvas: boxes {box_err} px apart")
    check(not same_boxes or not body[:, :INPUT].any(), "monitor canvas: the box tiles differ")
    check(int(body.max()) <= 1, f"monitor canvas: {int(body.max())} levels apart")
    return dict(turns[0]["launches"]["K1"])


def ssd_eval_argv(log_dir: str) -> list[str]:
    """The sweep of phase 16's log dir on the SSD CLI's val split."""
    return [f"synthetic:{SSD_BATCH}", log_dir, "-b", str(SSD_BATCH // 2), "--seed", str(SSD_VAL_SEED),
            "--asset-seed", str(SSD_ASSET_SEED), "--synthetic-assets", "16", "--device", DEVICE]


def ssd_plot_phase(card: str, work: str, ssd_log_dir: str) -> int:
    """The SSD CLI with its plot hook, and the sweep's SSD renders (or,
    without Pillow, their refusal)."""
    run = ssd_cli_run("ssd plot", SSD_PLOT_ARGV, card, f"{work}/ssd_plot")
    plots = sorted(os.listdir(f"{run['log_dir']}/bboxes"))
    check(plots == ["0.png", "4.png", "8.png"], f"ssd plot: bboxes/ holds {plots}")
    shapes = {read_png(f"{run['log_dir']}/bboxes/{p}").shape for p in plots}
    check(shapes == {(300, 300, 3)}, f"ssd plot: canvases of {shapes}")
    print(f"ssd plot: the plot hook drew iterations 0, 4 and 8 ({shapes.pop()}); K1 forward once an iteration, "
          f"none for a plot ({card})")
    argv = ssd_eval_argv(ssd_log_dir) + ["--force-reset", "--save-predictions", f"{work}/ssd_renders"]
    if not importlib.util.find_spec("PIL"):
        try:
            evaluate.main(argv)
        except SystemExit as e:
            check("Pillow is not installed" in str(e), f"ssd renders: the refusal {e}")
            print(f"ssd renders: without Pillow the SSD renders refuse by name: {e}")
        else:
            check(False, "ssd renders: ran without Pillow")
        return run["launches"]
    reset_launches()
    start = time.perf_counter()
    results = evaluate.main(argv)
    wall_s = time.perf_counter() - start
    launches = read_launches()
    check(launches == {"K1": NO_LAUNCHES, "K2": NO_LAUNCHES}, f"ssd renders: launches {launches}")
    for _, path in checkpoint.list_snapshots(ssd_log_dir, "SSD300_"):
        it = os.path.basename(path)[len("SSD300_"):-len(".pt")]
        renders = sorted(os.listdir(f"{work}/ssd_renders/{it}"))
        check(len(renders) == SSD_BATCH, f"ssd renders: {len(renders)} renders of iteration {it}")
        check(read_png(f"{work}/ssd_renders/{it}/0.png").shape == (300, 300, 3), "ssd renders: a render's shape")
    print(f"ssd renders: --save-predictions on phase 16's log dir: {len(results.entries)} snapshots x {SSD_BATCH} "
          f"renders with score text in {wall_s:.2f} s; K1 launches 0 ({card})")
    return run["launches"]


def phase21(card: str, work: str, cli_log_dir: str, rotated_dir: str, ssd_log_dir: str) -> dict:
    """Phase 21 (a)-(e), each part with its seconds; the launches of the
    paths it adds."""
    out, timed = {}, {}

    def part(name, fn, *args):
        start = time.perf_counter()
        result = fn(*args)
        timed[name] = time.perf_counter() - start
        return result

    clip = None
    if importlib.util.find_spec("cv2"):
        clip = f"{work}/clip.mp4"
        part("clip", write_clip, clip)
        out["serve_video"] = part("a", video_phase, card, cli_log_dir, rotated_dir, f"{work}/video", clip)
    else:
        from loans_tpu_torch.cli import live_inference, video_inference

        for cli, argv in ((video_inference, [cli_log_dir, "-i", "clip.mp4"]), (live_inference, [cli_log_dir])):
            try:
                cli.main(argv + ["--device", DEVICE])
            except SystemExit as e:
                check("OpenCV (cv2)" in str(e), f"{cli.__name__}: the refusal {e}")
                print(f"video: without cv2 {cli.__name__} refuses by name: {e}")
            else:
                check(False, f"{cli.__name__} ran without cv2")
        out["serve_video"] = {"K1": 0, "K2": 0}
    out["serving_shapes"] = part("b", k1_serving_shapes, card)
    out["serve_live"] = part("c", live_phase, card, cli_log_dir, clip)
    out["train_cli_plot"] = part("d", monitor_phase, card, f"{work}/monitor")
    out["train_ssd_plot"] = part("e", ssd_plot_phase, card, f"{work}/monitor", ssd_log_dir)
    print("phase 21: " + ", ".join(f"({k}) {v:.1f} s" for k, v in timed.items()))
    return out


# -- phase 22 ---------------------------------------------------------------
# the offline tools on phase 10's configuration (R-50 224->75, the assessor
# at ch 128, float32, batch 64), without the pool refresh. (a) The
# supervisor (python -m loans_tpu_torch.cli.supervise) runs this script's
# --cli mode for 48 iterations with a snapshot every 16; once the first
# attempt has written both _16 snapshots, its process group is killed with
# SIGKILL (an OOM kill or a lost card), and the supervisor must relaunch it
# with both --resume-* flags at those files; the resumed run logs from 24 on
# and ends at 48. Each attempt's launches are its own process's: the killed
# one's as its --cli mode recorded them at its _16 snapshot. The stall
# timeout stays above the CLI's start-up (its clock starts at launch); the
# stall path is held on the CPU (tests/test_torch_supervise.py). (b) The
# dataset tools on (a)'s resumed log dir: average_snapshots --out-iteration
# 64 (SWA of 32 and 48) in a copy, swept on the card with --bn-warmup
# (phase 12's sweep: 3 snapshots x 2 batches x 3 passes of K1's forward);
# convert_snapshot of the last training snapshots served through
# LocalizerInference with boxes, rois and scores equal bit for bit to the
# training snapshots'; extract_frames --resize 224 and blend_videos (the
# clip and phase 21's served b8 video) on phase 21's clip, or without cv2
# their refusals.
SUPERVISED_ITERATIONS, SUPERVISED_SNAPSHOT = 48, 16
SUPERVISED_ARGV = CLI_ARGV + ["--iterations", str(SUPERVISED_ITERATIONS), "--snapshot-interval",
                              str(SUPERVISED_SNAPSHOT), "--assessor-refresh", "0"]
SUPERVISE_FLAGS = ["--stall-timeout", "300", "--poll-interval", "0.5", "--max-restarts", "2"]
SUPERVISED_TIMEOUT_S = 600


def cli_launches(argv: list[str], start: int, end: int) -> dict:
    """K1's launches of the CLI's run from iteration ``start`` to ``end``
    (phase 20's accounting, without the refresh): a forward and a d theta a
    step, a forward an eval batch of each log entry, a forward per render
    batch of the reference crops at start-up."""
    args = train_localizer.get_parser().parse_args(argv)
    renders = -(-train_localizer._synthetic_n(args.reference_file, 1024) // synthetic.RENDER_BATCH)
    steps, evals = end - start, (end - start) // args.log_interval * args.eval_batches
    return {"K1": {"fwd": steps + evals + renders, "bwd_theta": steps, "bwd_images": 0}, "K2": NO_LAUNCHES}


def _wait_for(what: str, cond, proc: subprocess.Popen, timeout_s: float, poll_s: float = 0.05):
    deadline = time.perf_counter() + timeout_s
    while True:
        found = cond()
        if found:
            return found
        check(proc.poll() is None, f"{what}: the supervisor exited {proc.returncode} first")
        check(time.perf_counter() < deadline, f"{what}: not within {timeout_s} s")
        time.sleep(poll_s)


def supervised_phase(card: str, work: str) -> dict:
    """Phase 22 (a): the training CLI under the supervisor, killed after its
    first snapshot and resumed. Returns the resumed log dir and the
    launches of both attempts."""
    import glob
    import signal

    from loans_tpu_torch.cli import supervise

    out, base = f"{work}/supervised", f"{work}/supervised_logs"
    cmd = [sys.executable, "-m", "loans_tpu_torch.cli.supervise", *SUPERVISE_FLAGS, "--", sys.executable,
           os.path.abspath(__file__), "--cli", out, *SUPERVISED_ARGV, "--log-dir", base]
    snap = SUPERVISED_SNAPSHOT
    start = time.perf_counter()
    with open(f"{work}/supervise.log", "w") as log:
        sup = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT, cwd=os.path.dirname(os.path.abspath(__file__)))
        try:
            first = _wait_for(f"supervised: {snap} snapshots", lambda: [
                d for d in glob.glob(f"{base}/*") if os.path.exists(f"{d}/Localizer_{snap}.pt")
                and os.path.exists(f"{d}/ResnetAssessor_{snap}.pt") and os.path.exists(f"{out}.0.at{snap}.json")],
                sup, SUPERVISED_TIMEOUT_S)[0]
            at_snapshot_s = time.perf_counter() - start
            check(not glob.glob(f"{first}/*_{2 * snap}.pt"), f"supervised: attempt 0 passed {2 * snap} first")
            pgid = json.load(open(f"{out}.0.at{snap}.json"))["pgid"]
            check(pgid not in (os.getpgrp(), sup.pid), f"supervised: the child's process group {pgid}")
            os.killpg(pgid, signal.SIGKILL)  # the child leads a session (and process group) of its own
            killed = time.perf_counter()
            resumed = _wait_for("supervised: the resumed run's first log entry", lambda: [
                d for d in glob.glob(f"{base}/*") if d != first and os.path.exists(f"{d}/log")], sup,
                SUPERVISED_TIMEOUT_S)[0]
            to_first_entry_s = time.perf_counter() - killed
            rc = sup.wait(timeout=SUPERVISED_TIMEOUT_S)
        finally:
            if sup.poll() is None:
                sup.kill()
                sup.wait()
    wall_s = time.perf_counter() - start
    printed = [line for line in open(f"{work}/supervise.log").read().splitlines() if line.startswith("[supervise]")]
    for line in printed:
        print(f"supervised: {line}")
    check(rc == 0, f"supervised: the supervisor exited {rc}")
    attempts = [line for line in printed if " attempt " in line]
    flags = (f"--resume-localizer {first}/Localizer_{snap}.pt --resume-discriminator "
             f"{first}/ResnetAssessor_{snap}.pt --no-freeze")
    check(len(attempts) == 2 and attempts[1].endswith(flags), f"supervised: the attempts {attempts}")
    check("[supervise] child exited rc=-9" in printed, "supervised: the kill is not reported")
    record = json.load(open(f"{out}.0.json"))
    check(record["log_dir"] == resumed, f"supervised: the resumed run wrote {record['log_dir']}, not {resumed}")
    log = MetricsLog.read(resumed)
    its = [int(e["iteration"]) for e in log]
    check(its[0] > snap and its[-1] == SUPERVISED_ITERATIONS and rc == 0, f"supervised: resumed log at {its}")
    check(all(np.isfinite(e[k]) for e in log for k in ("loss_localizer", "loss_dis", "mean_iou", "map")),
          "supervised: finite losses")
    check(os.path.exists(f"{resumed}/Localizer_{SUPERVISED_ITERATIONS}.pt"), "supervised: the last snapshot")
    launches = [json.load(open(f"{out}.0.at{snap}.json"))["launches"], record["launches"]]
    want = [cli_launches(SUPERVISED_ARGV, 0, snap), cli_launches(SUPERVISED_ARGV, snap, SUPERVISED_ITERATIONS)]
    for i, (got, expected) in enumerate(zip(launches, want)):
        check(got == expected, f"supervised: attempt {i} launches {got} != {expected}")
    rates = [e["images_per_sec"] for e in log[1:]]
    print(f"supervised: attempt 0 killed (SIGKILL to its process group) {at_snapshot_s:.1f} s after the "
          f"supervisor's start, at its iteration-{snap} snapshots; attempt 1 resumed from them, logged iterations "
          f"{its}, rc 0; {to_first_entry_s:.1f} s from the kill to the resumed run's first log entry (the "
          f"supervisor's poll, its {supervise.RESTART_PAUSE_S:g} s pause, a process start, data, "
          f"{STEPS_PER_CALL} steps and an eval); "
          f"resumed images/s per log entry after the first {', '.join(f'{r:.1f}' for r in rates)}; "
          f"{wall_s:.1f} s in all ({card})")
    print(f"supervised: K1 launches, attempt 0 at its snapshot {launches[0]['K1']}, attempt 1 {launches[1]['K1']} "
          f"(a forward and a d theta a step, a forward an eval batch, a forward a render batch of the reference "
          f"crops at each start-up)")
    total = {k: launches[0]["K1"][k] + launches[1]["K1"][k] for k in COUNTERS}
    return {"log_dir": resumed, "launches": total}


def tools_phase(card: str, work: str, log_dir: str) -> int:
    """Phase 22 (b): the dataset tools on the supervised run's log dir and
    phase 21's clip. Returns the SWA sweep's K1 launches."""
    from loans_tpu_torch.cli import dataset_tools

    last = SUPERVISED_ITERATIONS
    swa_dir = f"{work}/swa"
    os.makedirs(swa_dir)
    for name in os.listdir(log_dir):  # a copy of the log dir: its files linked
        os.symlink(os.path.join(log_dir, name), os.path.join(swa_dir, name))
    start = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as said:
        dataset_tools.main(["average_snapshots", swa_dir, "--out-iteration", str(last + SUPERVISED_SNAPSHOT)])
    print(f"swa: {said.getvalue().strip()} in {time.perf_counter() - start:.2f} s")
    swa = f"Localizer_{last + SUPERVISED_SNAPSHOT}.pt"
    sweep = sweep_on_card("evaluate swa", swa_dir, f"{work}/swa_eval", "K1", card)
    scores = {e["snapshot_name"]: e for e in sweep["results"].entries}
    check(swa in scores, f"swa: {swa} not scored")
    print(f"swa: {swa} (SWA of iterations {SUPERVISED_SNAPSHOT * 2}..{last}) map {scores[swa]['map']:.4f} mean_iou "
          f"{scores[swa]['mean_iou']:.4f} beside the last real snapshot Localizer_{last}.pt map "
          f"{scores[f'Localizer_{last}.pt']['map']:.4f} mean_iou {scores[f'Localizer_{last}.pt']['mean_iou']:.4f} "
          f"(--bn-warmup 1 re-estimates the statistics; K1 forward launches {sweep['launches']}) ({card})")

    conv_dir = f"{work}/converted"
    os.makedirs(conv_dir)
    shutil.copy(f"{log_dir}/manifest.json", conv_dir)
    for name in ("Localizer", "ResnetAssessor"):
        with contextlib.redirect_stdout(io.StringIO()):
            dataset_tools.main(["convert_snapshot", f"{log_dir}/{name}_{last}.pt", f"{conv_dir}/{name}_{last}.pt"])
    sizes = [os.path.getsize(f"{d}/Localizer_{last}.pt") / 2**20 for d in (log_dir, conv_dir)]
    args = train_localizer.get_parser().parse_args(SUPERVISED_ARGV)
    val = synthetic.SyntheticLocalizerDataset(
        BATCH, image_size=tuple(args.target_size), seed=args.seed + 2, labeled=True, output_dtype="uint8",
        **train_localizer.build_asset_kw(args))
    frames = np.stack([val.items[i][0] for i in range(len(val))]).astype(np.float32) / 255.0
    served = []
    reset_launches()
    with deterministic_cudnn():
        for d in (log_dir, conv_dir):
            inf = LocalizerInference(d, snapshot=f"Localizer_{last}.pt", device=DEVICE, use_assessor=True,
                                     score_threshold=0.0)
            served.append(inf.localize_batch(frames)[:3])
    launches = read_launches()
    check(launches == {"K1": {**NO_LAUNCHES, "fwd": 2}, "K2": NO_LAUNCHES}, f"converted: launches {launches}")
    equal = [np.array_equal(a, b) for a, b in zip(*served)]
    check(all(equal) and np.isfinite(served[0][0]).all(), f"converted: boxes, rois, scores equal {equal}")
    print(f"converted: convert_snapshot of Localizer_{last}.pt ({sizes[0]:.1f} MiB with the optimizer -> "
          f"{sizes[1]:.1f} MiB) and ResnetAssessor_{last}.pt served through LocalizerInference on {DEVICE}: "
          f"{BATCH} val frames, boxes, rois and scores equal to the training snapshots' bit for bit; "
          f"K1 launches {launches['K1']['fwd']} (one a batch)")

    clip = f"{work}/clip.mp4"
    if not importlib.util.find_spec("cv2"):
        for argv in (["extract_frames", clip, f"{work}/frames"], ["blend_videos", clip, clip, f"{work}/blend.mp4"]):
            try:
                dataset_tools.main(argv)
            except SystemExit as e:
                check("OpenCV (cv2)" in str(e), f"{argv[0]}: the refusal {e}")
                print(f"tools: without cv2 {argv[0]} refuses by name: {e}")
            else:
                check(False, f"{argv[0]} ran without cv2")
        return sweep["launches"]
    start = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        dataset_tools.main(["extract_frames", clip, f"{work}/frames", "--resize", "224"])
    extract_s = time.perf_counter() - start
    names = sorted(n for n in os.listdir(f"{work}/frames") if n.endswith(".png"))
    rows = open(f"{work}/frames/gt.csv").read().split()
    size = (224, 224 * CLIP["size"][1] // CLIP["size"][0])
    frame0 = read_png(f"{work}/frames/{names[0]}")
    check(len(names) == len(rows) == CLIP["frames"] and frame0.shape == (size[1], size[0], 3),
          f"extract_frames: {len(names)} PNGs, {len(rows)} csv rows, frame {frame0.shape}")
    served_video = f"{work}/video/b8_pipelined.mp4"
    start = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        dataset_tools.main(["blend_videos", clip, served_video, f"{work}/blend.mp4"])
    blend_s = time.perf_counter() - start
    check(frames_in(f"{work}/blend.mp4") == CLIP["frames"], "blend_videos: frames written")
    print(f"tools: extract_frames --resize 224 of the clip ({CLIP['frames']} frames of {CLIP['size'][0]}x"
          f"{CLIP['size'][1]} -> {size[0]}x{size[1]} PNGs, LANCZOS in numpy): {CLIP['frames'] / extract_s:.1f} "
          f"frames/s ({extract_s:.2f} s); blend_videos of the clip and phase 21's b8 video: "
          f"{CLIP['frames'] / blend_s:.1f} frames/s ({blend_s:.2f} s, mp4v) (host, {card})")
    return sweep["launches"]


def phase22(card: str, work: str) -> dict:
    """Phase 22 (a) and (b), each with its seconds; the launches of the
    paths it adds."""
    start = time.perf_counter()
    supervised = supervised_phase(card, work)
    mid = time.perf_counter()
    swa = tools_phase(card, work, supervised["log_dir"])
    print(f"phase 22: (a) {mid - start:.1f} s, (b) {time.perf_counter() - mid:.1f} s")
    return {"train_cli_supervised": supervised["launches"], "evaluate_swa": swa}

# -- phase 23 -------------------------------------------------------------------
# (a) the pretraining CLI at full width, the JAX tool's defaults (R-50 224^2,
# 64 classes, batch 64, 50 steps a call), cut to 256 train and 64 val scenes
# and 150 iterations in float32, 50 in bf16
PRETRAIN_CLASSES = 64
PRETRAIN_ARGV = ["--classes", str(PRETRAIN_CLASSES), "--pool", "256", "--val-pool", "64",
                 "--batch-size", str(TRAIN_BATCH), "--steps-per-call", "50", "--log-interval", "50",
                 "--seed", str(SEED), "--device", DEVICE]
PRETRAIN_ITERATIONS = {"pretrain": 150, "pretrain bf16": 50}
TORCHVISION_R50_TENSORS = 318  # resnet50's state_dict without fc
# (d) phase 10's CLI from the imported backbone; (e) SSD300 from a VGG16
PRETRAINED_CLI_ARGV = CLI_ARGV + ["--iterations", "16", "--snapshot-interval", "16"]
PRETRAINED_SSD_ARGV = SSD_ARGV + ["--iterations", "8", "--log-interval", "8", "--eval-interval", "8",
                                  "--snapshot-interval", "8"]
# (out, in) channels of torchvision vgg16's 13 convolutions
VGG16_CONVS = [(64, 3), (64, 64), (128, 64), (128, 128), (256, 128), (256, 256), (256, 256), (512, 256),
               (512, 512), (512, 512), (512, 512), (512, 512), (512, 512)]


def pretrain_run(tag: str, argv: list[str], card: str) -> dict:
    """``pretrain_backbone.main(argv)`` in this process with every count at
    0: finite losses, accuracies in [0, 1], the exported file's tensors, no
    crop kernel launched; images/s per log entry, over each interval."""
    args = pretrain_backbone.get_parser().parse_args(argv)
    torch.cuda.synchronize()
    reset_launches()
    start = time.perf_counter()
    result = pretrain_backbone.main(argv)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - start
    launches = read_launches()
    check(launches == {"K1": NO_LAUNCHES, "K2": NO_LAUNCHES}, f"{tag}: launches {launches}")
    log = result["log"]
    check(len(log) == args.iterations // args.log_interval, f"{tag}: {len(log)} log entries")
    done, seconds, rates = 0, 0.0, []
    for e in log:
        check(np.isfinite(e["loss"]) and 0 <= e["acc"] <= 1, f"{tag}: {e}")
        at = e["iteration"] * args.batch_size / e["images_per_sec"]  # the CLI's cumulative rate -> seconds
        rates.append((e["iteration"] - done) * args.batch_size / (at - seconds))
        done, seconds = e["iteration"], at
        print(f"{tag}: iteration {e['iteration']} loss {e['loss']:.4f} acc {e['acc']:.4f} images_per_sec "
              f"{e['images_per_sec']:.1f} (the interval's {rates[-1]:.1f}) ({card})")
    exported = torch.load(result["out"], map_location="cpu", weights_only=True)
    check(result["tensors"] == len(exported) == TORCHVISION_R50_TENSORS, f"{tag}: {len(exported)} tensors written")
    check(all(torch.isfinite(v).all() for v in exported.values()), f"{tag}: the export is finite")
    check(0 <= result["val_acc"] <= 1, f"{tag}: val acc {result['val_acc']}")
    print(f"{tag}: {args.iterations} iterations of R-50 at batch {args.batch_size} in {wall_s:.2f} s of wall time "
          f"(pools included); val acc {result['val_acc']:.4f}; {len(exported)} tensors in torchvision's layout; "
          f"K1 and K2 launches 0 ({card})")
    return {**result, "launches": launches, "interval_images_per_s": rates}


def pretrain_step_against_cpu() -> dict:
    """One classifier step at batch 4 on the card and on the CPU from the
    same weights, scenes and flip mask: logits, loss, the BatchNorm
    statistics and the parameters after the update (PRETRAIN_STEP_TOL)."""
    pool = pretrain_backbone.make_scene_pool(4, 64, SEED, SEED + 23)
    torch.manual_seed(SEED + 23)
    cpu_model = ResNet(50, class_labels=64)
    flip = pretrain_backbone.draw_flips(torch.Generator().manual_seed(SEED + 24), 4)
    runs = {}
    for device, model in (("cpu", cpu_model), (DEVICE, copy.deepcopy(cpu_model).to(DEVICE))):
        logits = []
        hook = model.register_forward_hook(lambda m, i, out, logits=logits: logits.append(out.detach().cpu()))
        batch = {k: torch.from_numpy(v).to(device) for k, v in pool.items()}
        _, metrics = pretrain_backbone.classifier_step(create_train_state(model, LR), batch, flip.to(device))
        hook.remove()
        runs[device] = {"metrics": {k: float(v) for k, v in metrics.items()}, "logits": logits[0],
                        "state": {k: v.detach().cpu() for k, v in model.state_dict().items()}}
    cpu, card = runs["cpu"], runs[DEVICE]

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))

    diffs = {"logits": rel(card["logits"], cpu["logits"]),
             "loss": abs(card["metrics"]["loss"] - cpu["metrics"]["loss"]) / abs(cpu["metrics"]["loss"]),
             "bn_stats": max(rel(card["state"][k], v) for k, v in cpu["state"].items() if "running" in k)}
    worst, close, total = 0.0, 0, 0
    for key, p in cpu["state"].items():
        if "running" in key or key.endswith("num_batches_tracked"):
            continue
        diff = (card["state"][key] - p).abs()
        worst = max(worst, float(diff.max()))
        close, total = close + int((diff <= 1e-6).sum()), total + diff.numel()
    print("pretrain step card vs CPU (R-50 224^2, 64 classes, batch 4, float32, lr 1e-3; relative): "
          + ", ".join(f"{k} {v:.3e} (tol {PRETRAIN_STEP_TOL[k]:g})" for k, v in diffs.items())
          + f"; loss card {card['metrics']['loss']:.6f} CPU {cpu['metrics']['loss']:.6f}, acc card "
          f"{card['metrics']['acc']:.2f} CPU {cpu['metrics']['acc']:.2f}; parameters after the update max abs diff "
          f"{worst:.3e} (tol {2 * LR:g} + 1e-7), {close / total:.5f} of the entries within 1e-6 "
          f"(tol {PRETRAIN_STEP_TOL['params_share']})")
    for k, v in diffs.items():
        check(v <= PRETRAIN_STEP_TOL[k], f"pretrain step: {k} {v}")
    check(worst <= 2 * LR + 1e-7 and close >= PRETRAIN_STEP_TOL["params_share"] * total, "pretrain step: parameters")
    return {**diffs, "params_max_abs": worst}


def r50_imports(pth: str, root: str) -> str:
    """(a)'s export through ``import_resnet50 --verify``, and the same
    weights renamed to chainer's keys with conv1 in BGR, as an npz, through
    ``--source chainer --verify``: the two files equal bit for bit."""
    tv = torch.load(pth, map_location="cpu", weights_only=True)
    npz = {}
    for _, _, tv_conv, tv_bn, ch_conv, ch_bn in import_resnet50.r50_modules():
        w = tv[f"{tv_conv}.weight"].numpy()
        npz[f"{ch_conv}/W"] = w[:, ::-1] if tv_conv == "conv1" else w  # caffe's conv1 reads BGR
        for leaf, ch_leaf in import_resnet50.CHAINER_BN.items():
            npz[f"{ch_bn}/{ch_leaf}"] = tv[f"{tv_bn}.{leaf}"].numpy()
    np.savez(f"{root}/r50_chainer.npz", **npz)
    verify = ["--verify", "--device", DEVICE]
    outs = [import_resnet50.main([pth, f"{root}/r50_torchvision.pt"] + verify),
            import_resnet50.main([f"{root}/r50_chainer.npz", f"{root}/r50_chainer.pt", "--source", "chainer"]
                                 + verify)]
    a, b = (checkpoint.load_params(p) for p in outs)
    check(list(a) == list(b) and all(a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]) for k in a),
          "import: the torchvision and chainer files differ")
    print(f"import: torchvision .pth and chainer .npz (conv1 in BGR) -> {len(a)} backbone tensors each, verified in "
          f"a Localizer on {DEVICE}; the two files' tensors equal bit for bit")
    return outs[0]


@contextlib.contextmanager
def restores_recorded():
    """``checkpoint.restore_params`` recording each call: the keys it
    loaded, and those whose tensor differs from the file's right after the
    restore (before the first step)."""
    restore, records = checkpoint.restore_params, []

    def recorded(path, model, skip_prefixes=()):
        loaded = restore(path, model, skip_prefixes)
        file, state = checkpoint.load_params(path), model.state_dict()
        records.append({"loaded": loaded, "unequal": [k for k in loaded if not torch.equal(state[k].cpu(), file[k])]})
        return loaded

    checkpoint.restore_params = recorded
    try:
        yield records
    finally:
        checkpoint.restore_params = restore


def pretrained_cli(card: str, r50_pt: str, root: str) -> dict[str, int]:
    """Phase 10's CLI from the imported backbone: every backbone tensor
    restored and equal to the file's before the first step; K1's launches."""
    with restores_recorded() as records:
        run = cli_run("cli pretrained", PRETRAINED_CLI_ARGV + ["--pretrained-model", r50_pt], card, f"{root}/cli")
    backbone = [k for k in build_model("Localizer", **MANIFEST["localizer"]["kwargs"]).state_dict()
                if k.startswith("feature_extractor.") and not k.endswith("num_batches_tracked")]
    check(len(records) == 1 and sorted(records[0]["loaded"]) == sorted(backbone) and not records[0]["unequal"],
          f"cli pretrained: restored {[len(r['loaded']) for r in records]} keys of {len(backbone)}")
    print(f"cli pretrained: --pretrained-model restored {len(records[0]['loaded'])} of {len(backbone)} backbone "
          f"tensors (the head kept), each equal to the file's before the first step; K1 launches {run['launches']}")
    return run["launches"]


def vgg16_state(seed: int) -> dict[str, torch.Tensor]:
    """A torchvision ``vgg16`` ``state_dict`` drawn from ``seed`` in its
    published shapes (13 convolutions, fc6 (4096, 25088), fc7 (4096,
    4096)), He-scaled so that SSD300 trains from it with finite losses."""
    rng = np.random.default_rng(seed)
    shapes = {f"features.{idx}": (cout, cin, 3, 3)
              for idx, (cout, cin) in zip(import_vgg16.FEATURE_CONVS, VGG16_CONVS)}
    shapes.update({"classifier.0": (4096, 512 * 7 * 7), "classifier.3": (4096, 4096)})
    state = {}
    for name, shape in shapes.items():
        w = rng.standard_normal(shape, dtype=np.float32)
        w *= np.float32(np.sqrt(2.0 / np.prod(shape[1:])))
        state[f"{name}.weight"] = torch.from_numpy(w)
        state[f"{name}.bias"] = torch.from_numpy(rng.normal(0.0, 0.01, shape[0]).astype(np.float32))
    return state


def pretrained_ssd(card: str, root: str) -> int:
    """A VGG16 drawn here through ``import_vgg16``, then the SSD CLI from it:
    every ``VGG16Extractor_0`` convolution restored and equal to the file's
    before the first step (``L2Norm_0`` kept); K1's forward launches."""
    pth = f"{root}/vgg16.pth"
    torch.save(vgg16_state(SEED + 16), pth)
    size_mb = os.path.getsize(pth) / 2**20
    start = time.perf_counter()
    pt = import_vgg16.main([pth, f"{root}/vgg16.pt"])
    import_s = time.perf_counter() - start
    os.remove(pth)
    with restores_recorded() as records:
        run = ssd_cli_run("ssd pretrained", PRETRAINED_SSD_ARGV + ["--pretrained-model", pt], card, f"{root}/ssd")
    convs = [k for k in SSD300().state_dict() if k.startswith("VGG16Extractor_0.Conv_")]
    check(len(records) == 1 and sorted(records[0]["loaded"]) == sorted(convs) and len(convs) == 30
          and not records[0]["unequal"], f"ssd pretrained: restored {[r['loaded'] for r in records]}")
    print(f"ssd pretrained: a {size_mb:.0f} MiB torchvision VGG16 converted in {import_s:.2f} s; --pretrained-model "
          f"restored all {len(convs)} VGG16Extractor_0 convolution tensors (L2Norm_0 kept), each equal to the "
          f"file's before the first step; K1 forward launches {run['launches']}")
    return run["launches"]


def phase23(card: str, work: str) -> dict:
    """Phase 23 (a)-(e), each with its seconds; the launches of the paths it
    adds."""
    root = f"{work}/pretrain"
    os.makedirs(root, exist_ok=True)
    times = [time.perf_counter()]
    runs = {}
    for tag, n in PRETRAIN_ITERATIONS.items():
        out = f"{root}/{tag.replace(' ', '_')}.pth"
        runs[tag] = pretrain_run(tag, PRETRAIN_ARGV + ["--iterations", str(n), "--out", out]
                                 + (["--bf16"] if "bf16" in tag else []), card)
    times.append(time.perf_counter())
    pretrain_step_against_cpu()
    times.append(time.perf_counter())
    r50_pt = r50_imports(runs["pretrain"]["out"], root)
    times.append(time.perf_counter())
    cli = pretrained_cli(card, r50_pt, root)
    times.append(time.perf_counter())
    ssd = pretrained_ssd(card, root)
    times.append(time.perf_counter())
    print("phase 23: " + ", ".join(f"({part}) {b - a:.1f} s" for part, a, b in zip("abcde", times, times[1:])))
    pretrain = {name: {kind: sum(r["launches"][name][kind] for r in runs.values()) for kind in COUNTERS}
                for name in KERNELS}
    return {"pretrain_backbone": pretrain, "train_cli_pretrained": cli, "train_ssd_pretrained": ssd}


# -- phase 24 -------------------------------------------------------------------
# (a) cli.warm_cache on the card at phase 10's data flags with a reference
# pool 4 times phase 10's (2048 stn crops: 8 render batches of K1's forward)
# into a fresh directory, in this script's --warm mode (a process of its own,
# its launches counted); (b) phase 10's CLI over that cache for one chunk:
# it renders nothing, and its pools are (a)'s arrays; (c) the cache warmed on
# the CPU (K1's plain version) against the card's at phase 10's own size: the
# same names, the scenes and labels equal, the crops one step apart only at a
# .5 tie (CACHE_FLOAT_TOL below);
# (d) the pretraining CLI under torchrun (NCCL, one process per card; this
# script's --pretrain mode) against the same argv in this process (phase
# 23's, 50 iterations, float32, its pools cut to 64 and 64 scenes: the host
# makes them serially, ~40 ms a scene), both under deterministic cuDNN: the
# losses per log entry within DDP_TOL["cli_loss"] and the exports by phase
# 20's rule; (e) two gloo ranks sharing the card run classifier_step at R-50
# 224^2, global batch 64, for 4 steps, each against one process's step from
# the same state, as phase 20's cases (a pool of 64 scenes); phase 20's ranks
# run it beside its cases, and phase 24 reports it.
WARM_REFERENCE = 4 * train_localizer._synthetic_n(CLI_ARGV[1], 0)
WARM_ARGV = [CLI_ARGV[0], f"synthetic:{WARM_REFERENCE}"] + CLI_ARGV[2:] + ["--assessor-refresh", "0"]
CACHED_ARGV = WARM_ARGV + ["--iterations", str(STEPS_PER_CALL), "--snapshot-interval", str(STEPS_PER_CALL)]
RECIPE_CROPS = 32768  # the recipe's reference pool (ROADMAP: synthetic:2048/32768/512)
PRETRAIN_TORCHRUN_ARGV = PRETRAIN_ARGV + ["--iterations", "50", "--pool", "64", "--val-pool", "64"]
# (c): the card and the CPU compute theta and the sample positions in float32
# with roundings that may differ, so a sample may move by a few ulps of its
# position (2^-16 px between 128 and 256 px) and a crop value by that times
# the step between two neighbouring pixels (at most 1 in [0, 1]): the float
# crops of the two devices are held to 4 such ulps, and a pixel may round to
# the other uint8 value only where a .5 boundary lies between them, within
# that times 255 steps of either (a sample halfway between two pixels whose
# values differ by an odd number is such a tie)
CACHE_FLOAT_TOL = 4 * 2.0**-16
PRETRAIN_DDP_POOL = 64
PRETRAIN_DDP_CASES = {"R-50 classifier": (TRAIN_BATCH, 4)}
ALL_DDP_CASES = {**DDP_CASES, **PRETRAIN_DDP_CASES}


@contextlib.contextmanager
def data_seconds():
    """The ``data:`` seconds of each split the training CLI's
    ``build_datasets`` builds in the block, by its label."""
    timed, seconds = train_localizer._timed, {}

    def recorded(what, build):
        start = time.perf_counter()
        out = timed(what, build)
        seconds[what] = time.perf_counter() - start
        return out

    train_localizer._timed = recorded
    try:
        yield seconds
    finally:
        train_localizer._timed = timed


@contextlib.contextmanager
def cache_reads():
    """The datasets ``cached_synthetic`` returns in the block, and whether
    each was generated (a miss) or read (a hit)."""
    cached, records = synthetic.cached_synthetic, []

    def recorded(cache_dir, kind, build, **kw):
        generated = []

        def build_recorded(items):
            generated.append(items is None)
            return build(items=items)

        records.append({"ds": cached(cache_dir, kind, build_recorded, **kw), "generated": any(generated)})
        return records[-1]["ds"]

    synthetic.cached_synthetic = recorded
    try:
        yield records
    finally:
        synthetic.cached_synthetic = cached


def cache_names(argv: list[str]) -> list[str]:
    """The cache file names of the training CLI's three synthetic splits
    under ``argv``: the JAX package's keys (``cached_synthetic``), written
    out here from the flags."""
    args = train_localizer.get_parser().parse_args(argv)
    world = {"asset_seed": str(args.seed + 9973), "n_assets": str(args.synthetic_assets)}
    img = list(args.target_size)
    n = [train_localizer._synthetic_n(f, 0) for f in (args.train_file, args.reference_file, args.val_file)]
    return [synthetic._cache_key("scenes", n=n[0], image_size=img, seed=args.seed, labeled=False, **world),
            synthetic._cache_key("crops", n=n[1], crop=list(args.crop_size), image_size=img, seed=args.seed + 1,
                                 pipeline=args.assessor_pipeline, low_iou=args.assessor_low_iou, **world),
            synthetic._cache_key("scenes", n=n[2], image_size=img, seed=args.seed + 2, labeled=True, **world)]


def load_cache(cache_dir: str) -> dict[str, list[np.ndarray]]:
    out = {}
    for name in sorted(os.listdir(cache_dir)):
        with np.load(os.path.join(cache_dir, name), allow_pickle=False) as z:
            out[name] = [z[f"col{i}"] for i in range(int(z["ncols"]))]
    return out


def tool_process(mode: str, tag: str, argv: list[str], nproc: int, work: str) -> dict:
    """``--cli``, ``--warm`` or ``--pretrain`` mode of this script in a
    process of its own, under ``torchrun --standalone
    --nproc_per_node=nproc`` where ``nproc`` > 0: rank 0's record
    (launches summed over the ranks), its stdout and the wall seconds."""
    out = os.path.join(work, tag.replace(" ", "_"))
    cmd = [sys.executable, os.path.abspath(__file__), f"--{mode}", out] + argv
    if nproc:
        cmd[1:1] = ["-m", "torch.distributed.run", "--standalone", f"--nproc_per_node={nproc}"]
    start = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    wall_s = time.perf_counter() - start
    check(proc.returncode == 0, f"{tag}: exit {proc.returncode}:\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    records = [json.load(open(f"{out}.{r}.json")) for r in range(max(nproc, 1))]
    launches = {c: {k: sum(r["launches"][c][k] for r in records) for k in COUNTERS} for c in KERNELS}
    return {**records[0], "launches": launches, "stdout": proc.stdout, "wall_s": wall_s}


def warm_phase(card: str, work: str) -> dict:
    """Phase 24 (a) and (b): the cache warmed on the card, then the CLI
    over it. Returns the launches of both paths."""
    cache = f"{work}/cache"
    warm = tool_process("warm", "warm", WARM_ARGV + ["--synthetic-cache", cache], 0, work)
    renders = -(-WARM_REFERENCE // synthetic.RENDER_BATCH)
    check(warm["renders"] == renders and warm["launches"] == {"K1": {**NO_LAUNCHES, "fwd": renders}, "K2": NO_LAUNCHES},
          f"warm: {warm['renders']} render batches, launches {warm['launches']}")
    names = sorted(cache_names(WARM_ARGV))
    check(sorted(os.listdir(cache)) == names, f"warm: the cache holds {sorted(os.listdir(cache))}, expected {names}")
    said = [line for line in warm["stdout"].splitlines() if line.startswith("warmed cache in ")]
    check(len(said) == 1 and said[0].endswith(f"-> {cache}"), f"warm: printed {said}")
    print(f"warm: {said[0]} ({warm['wall_s']:.1f} s of wall time, process start included); K1 forward launches "
          f"{warm['launches']['K1']['fwd']} = {renders} render batches of {synthetic.RENDER_BATCH}; files {names} "
          f"(the JAX package's keys) ({card})")

    files = load_cache(cache)
    with data_seconds() as hit_s, cache_reads() as reads:
        run = cli_run("cli cached", CACHED_ARGV + ["--synthetic-cache", cache], card)
    want = cli_launches(CACHED_ARGV, 0, STEPS_PER_CALL)["K1"]
    check(not any(r["generated"] for r in reads) and len(reads) == 3, "cli cached: a split was generated")
    check(run["launches"] == {**want, "fwd": want["fwd"] - renders},
          f"cli cached: K1 launches {run['launches']}, expected {want} less {renders} renders")
    for name, r in zip(cache_names(CACHED_ARGV), reads):
        cols = [np.stack([np.asarray(v) for v in col]) for col in zip(*r["ds"].items)]
        check(len(cols) == len(files[name]) and all(a.dtype == b.dtype and np.array_equal(a, b)
                                                    for a, b in zip(cols, files[name])),
              f"cli cached: the pool read from {name} differs from the file (a)")
    cold_s = warm["data_seconds"]
    for what, seconds in cold_s.items():
        print(f"warm: data: {what} cold {seconds:.2f} s in (a), from the cache {hit_s[what]:.2f} s in (b) ({card})")
    ref = next(w for w in cold_s if "reference" in w)
    rate = WARM_REFERENCE / cold_s[ref]
    print(f"warm: {rate:.1f} stn crops/s rendered cold (triples on the host, K1 on the card); the recipe's "
          f"{RECIPE_CROPS}-crop pool would take {RECIPE_CROPS / rate:.0f} s at that rate (worked out, not measured) "
          f"({card})")
    print(f"cli cached: one chunk of {STEPS_PER_CALL} iterations over the warmed cache, nothing generated or "
          f"rendered, K1 launches {run['launches']}, its three pools equal to (a)'s files")
    return {"warm_cache": warm["launches"], "train_cli_cached": run["launches"]}


def render_floats(triples: list, img: tuple, crop: tuple, device: str) -> np.ndarray:
    """The ``stn`` crops of ``triples`` as ``render_stn_crops`` makes them
    on ``device`` (K1's forward on the card, its plain version on the CPU),
    before they are rounded to uint8: float32 in [0, 1]."""
    out = []
    for start in range(0, len(triples), synthetic.RENDER_BATCH):
        part = triples[start : start + synthetic.RENDER_BATCH]
        scenes = torch.from_numpy(np.stack([t[0] for t in part])).to(device).float() / 255.0
        theta = box_to_theta(torch.from_numpy(np.stack([t[1] for t in part])).to(device), Size(*img))
        sampler = sample_separable_kernel if torch.device(device).type == "cuda" else sample_separable
        out.append(sampler(scenes, theta, Size(*crop)).cpu().numpy())
    return np.concatenate(out)


def cpu_cache_against_card(work: str) -> None:
    """Phase 24 (c): phase 10's cache warmed on the CPU against the card's:
    the crops one step apart only where the two float renders, within
    CACHE_FLOAT_TOL of each other, lie on both sides of a .5 boundary."""
    from loans_tpu_torch.cli import warm_cache

    dirs = {"cpu": f"{work}/cache_cpu", DEVICE: f"{work}/cache_card"}
    for device, cache_dir in dirs.items():
        warm_cache.main(CLI_ARGV + ["--synthetic-cache", cache_dir, "--device", device])
    cpu, card = (load_cache(d) for d in (dirs["cpu"], dirs[DEVICE]))
    check(sorted(cpu) == sorted(card) == sorted(cache_names(CLI_ARGV)), f"cache cpu: names {sorted(cpu)}")
    crops = cache_names(CLI_ARGV)[1]
    for name in card:
        for i, (a, b) in enumerate(zip(cpu[name], card[name])):
            check(a.dtype == b.dtype and a.shape == b.shape, f"cache cpu: {name} col{i} {a.shape} {b.shape}")
            if name == crops and i == 0:
                diff = np.abs(a.astype(np.int16) - b.astype(np.int16))
                triples, img, crop = cli_triples(CLI_ARGV)
                floats = {d: render_floats(triples, img, crop, d) for d in ("cpu", DEVICE)}
                err = float(np.abs(floats["cpu"] - floats[DEVICE]).max())
                steps = floats["cpu"][diff > 0].astype(np.float64) * 255.0
                to_tie = float(np.abs(steps - np.floor(steps) - 0.5).max(initial=0.0))
                share = float((diff > 0).mean())
                check(int(diff.max()) <= RENDER_TOL["steps"] and err <= CACHE_FLOAT_TOL
                      and to_tie <= CACHE_FLOAT_TOL * 255.0,
                      f"cache cpu: crops differ by up to {int(diff.max())} on {share:.2e} of the pixels, floats "
                      f"{err:.3e} apart, a differing pixel {to_tie:.3e} steps from a .5 boundary")
            else:
                check(np.array_equal(a, b), f"cache cpu: {name} col{i} differs")
    print(f"cache cpu: phase 10's cache warmed with --device cpu (K1's plain version) against {DEVICE} (K1): the "
          f"same {len(card)} file names, scenes and labels equal; the {len(card[crops][0])} stn crops differ by up to "
          f"{int(diff.max())} step (tol {RENDER_TOL['steps']}) on {share:.2e} of the pixels; the two float renders "
          f"{err:.3e} apart (tol {CACHE_FLOAT_TOL:.3e}), and every differing pixel within {to_tie:.3e} steps of a .5 "
          f"boundary (tol {CACHE_FLOAT_TOL * 255:.3e}): rounded apart at a tie")


def export_rule(got_pth: str, want_pth: str, lr: float) -> tuple[float, float]:
    """Phase 20's rule for two exports: the share of entries within 0.1 lr
    and the largest difference in units of lr."""
    got, want = (torch.load(p, map_location="cpu", weights_only=True) for p in (got_pth, want_pth))
    check(list(got) == list(want), "pretrain torchrun: the exports' keys differ")
    close = total = 0
    largest = 0.0
    for k, w in want.items():
        if w.is_floating_point():
            d = (got[k] - w).abs()
            close, total, largest = close + int((d <= 0.1 * lr).sum()), total + d.numel(), max(largest, float(d.max()))
    return close / total, largest / lr


def pretrain_torchrun(card: str, work: str) -> dict[str, dict[str, int]]:
    """Phase 24 (d): the pretraining CLI under torchrun against the same
    argv in this process."""
    n = torch.cuda.device_count()
    start = time.perf_counter()
    plain = run_tool("pretrain", PRETRAIN_TORCHRUN_ARGV + ["--out", f"{work}/pretrain_plain.pth"])
    plain["wall_s"] = time.perf_counter() - start
    ddp = tool_process("pretrain", "pretrain torchrun", PRETRAIN_TORCHRUN_ARGV + ["--out", f"{work}/pretrain_ddp.pth"],
                       n, work)
    for tag, run in (("pretrain plain", plain), ("pretrain torchrun", ddp)):
        check(run["launches"] == {"K1": NO_LAUNCHES, "K2": NO_LAUNCHES}, f"{tag}: {run['launches']}")
    check(ddp["world"] == n and ddp["backend"] == ["nccl", float(n)],
          f"pretrain torchrun: world {ddp['world']}, backend and all-reduce {ddp['backend']}")
    log, want = ddp["result"]["log"], plain["result"]["log"]
    check(len(log) == len(want) == 1, f"pretrain torchrun: {len(log)} and {len(want)} log entries")
    for a, b in zip(log, want):
        rel = abs(a["loss"] - b["loss"]) / abs(b["loss"])
        print(f"pretrain torchrun: iteration {a['iteration']} loss {a['loss']:.6f} (plain {b['loss']:.6f}, rel "
              f"{rel:.2e}, tol {DDP_TOL['cli_loss']:g}), acc {a['acc']:.4f} (plain {b['acc']:.4f}), images/s "
              f"{a['images_per_sec']:.1f} (plain {b['images_per_sec']:.1f}) ({card})")
        check(np.isfinite(a["loss"]) and rel <= DDP_TOL["cli_loss"] and a["iteration"] == b["iteration"],
              f"pretrain torchrun: {a} against {b}")
    share, largest = export_rule(ddp["result"]["out"], plain["result"]["out"], LR)
    print(f"pretrain torchrun: {n} process(es) on NCCL; val acc {ddp['result']['val_acc']:.4f} (plain "
          f"{plain['result']['val_acc']:.4f}); the exports within 0.1 lr on {share:.5f} of the entries (tol "
          f"{DDP_TOL['params_share']:g}), largest difference {largest:.3f} lr; wall {ddp['wall_s']:.1f} s "
          f"(torchrun and process start included) against {plain['wall_s']:.1f} s in this process (pools "
          f"included); K1 and K2 launches 0")
    check(share >= DDP_TOL["params_share"], f"pretrain torchrun: exports within 0.1 lr on {share}")
    return ddp["launches"]


def phase24(card: str, work: str, ranks: dict | None = None) -> dict:
    """Phase 24 (a)-(e), each with its seconds; the launches of the paths it
    adds. (e) reads ``ranks``, phase 20's ``ddp_spawn`` (run here when
    none is given)."""
    times = [time.perf_counter()]
    warmed = warm_phase(card, work)
    times.append(time.perf_counter())
    cpu_cache_against_card(work)
    times.append(time.perf_counter())
    torchrun = pretrain_torchrun(card, work)
    times.append(time.perf_counter())
    ranks = ranks or ddp_spawn(os.path.join(work, "ddp_pretrain"), PRETRAIN_DDP_CASES)
    ddp = ddp_report(card, ranks, PRETRAIN_DDP_CASES)
    times.append(time.perf_counter())
    print("phase 24: " + ", ".join(f"({part}) {b - a:.1f} s" for part, a, b in zip(("a-b", "c", "d", "e"), times,
                                                                                     times[1:])))
    return {**warmed, "pretrain_torchrun": torchrun, "pretrain_ddp": ddp}


def tool_worker(mode: str, argv: list[str]) -> None:
    """``python3 chip_smoke.py --warm|--pretrain <out> <argv>``:
    ``cli.warm_cache`` or ``cli.pretrain_backbone`` in this process (under
    torchrun: this rank's) with the launches counted from 0, under
    deterministic cuDNN; under torchrun one tensor is all-reduced over the
    group after the run. Writes ``<out>.<rank>.json``: the launches, the
    render batches, the ``data:`` seconds by split, the pretraining result,
    the world and the backend."""
    out, argv = argv[0], argv[1:]
    record = run_tool(mode, argv)
    with open(f"{out}.{record['rank']}.json", "w") as f:
        json.dump(record, f)


def run_tool(mode: str, argv: list[str]) -> dict:
    """``tool_worker``'s run, in this process: its record."""
    import torch.distributed as dist

    from loans_tpu_torch import parallel
    from loans_tpu_torch.cli import warm_cache

    with parallel.process_group("cuda"), deterministic_cudnn(), data_seconds() as seconds:
        reset_launches()
        synthetic.render_stn_crops.batches = 0
        result = None
        if mode == "pretrain":
            result = pretrain_backbone.main(argv)
        else:
            warm_cache.main(argv)
        launches = read_launches()
        backend = None
        if dist.is_initialized():
            x = torch.ones(1, device=parallel.bind_device("cuda"))
            dist.all_reduce(x)
            backend = [dist.get_backend(), float(x)]
        return {"launches": launches, "renders": synthetic.render_stn_crops.batches, "data_seconds": seconds,
                "result": result, "backend": backend, "rank": parallel.rank(), "world": parallel.world_size()}


def cli_worker(argv: list[str]) -> None:
    """``python3 chip_smoke.py --cli <out> <train_localizer argv>``: the
    training CLI in this process (under torchrun: this rank's) with the
    launches counted from 0; under torchrun one tensor is all-reduced over
    the group after the run. Writes ``<out>.<rank>.json``, and at every
    snapshot the launches so far."""
    import torch.distributed as dist

    from loans_tpu_torch import parallel

    out, argv = argv[0], argv[1:]
    save_state = checkpoint.save_state

    def save_and_count(path, state):
        """A snapshot, and this process's launches so far and its process
        group beside it (``<out>.<rank>.at<step>.json``): a killed run
        leaves its counts."""
        save_state(path, state)
        at = f"{out}.{parallel.rank()}.at{int(state.step)}.json"
        with open(at + ".tmp", "w") as f:
            json.dump({"launches": read_launches(), "pgid": os.getpgrp()}, f)
        os.replace(at + ".tmp", at)

    checkpoint.save_state = save_and_count
    with parallel.process_group("cuda"), deterministic_cudnn():
        reset_launches()
        log_dir = train_localizer.main(argv)
        launches = read_launches()
        backend = None
        if dist.is_initialized():
            x = torch.ones(1, device=parallel.bind_device("cuda"))
            dist.all_reduce(x)
            backend = [dist.get_backend(), float(x)]
        record = {"launches": launches, "log_dir": log_dir, "backend": backend, "rank": parallel.rank(),
                  "world": parallel.world_size()}
    with open(f"{out}.{record['rank']}.json", "w") as f:
        json.dump(record, f)


def kernel_entry(name: str, source: str, replaces: str, launches: int, err: float, t: dict,
                 in_situ: dict, by_path: dict) -> dict:
    return {
        "name": name,
        "route": "cuda",
        "source": f"loans_tpu_torch/ops/csrc/{source}",
        "replaces": replaces,
        "launches": launches,
        "launches_by_path": by_path,
        "max_abs_err": err,
        "ms": t["ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"],
        "library_ms": t["library_ms"],
        "device_ms": t["device_ms"],
        "device_cold_ms": t.get("device_cold_ms"),
        "device_in_situ_ms": in_situ.get(name),
    }


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke FAILED: torch.cuda.is_available() is false")
    set_precision()
    card = environment()
    k1 = kernel_against_plain(card)
    k1_bwd = backward_against_plain(card)
    frames = scenes(np.random.default_rng(SEED + 1), 2 + 3 * BATCH, INPUT)
    calib = scenes(np.random.default_rng(SEED + 2), BATCH, INPUT)
    with tempfile.TemporaryDirectory() as work:  # log dirs that phases 12 and 13 read again
        serve_dir, rotated_dir = f"{work}/serve", f"{work}/rotated"
        write_log_dir(serve_dir, calib)
        inf = LocalizerInference(serve_dir, device=DEVICE, use_assessor=True)
        serving = serve(inf, frames, card)
        card_against_cpu(serve_dir, inf, frames)
        pools = training_pools()
        k1_train = train_slice(pools, card)
        step_against_cpu(pools)
        k2 = rotated_against_plain(card)
        k2_train = train_slice(pools, card, with_kwargs(**ROTATED_KWARGS), rotated_dir)
        step_against_cpu(pools, with_kwargs(rotation_dropout_ratio=1.0),
                         samplers={DEVICE: "rotated_pallas", "cpu": "rotated"})
        cli = cli_phases(card, k1_train["images_per_s"], f"{work}/cli")
        evaluated = evaluation_phase(card, cli["log_dir"], rotated_dir, f"{work}/evaluate")
        vbp_launches = vbp_phase(card, serve_dir, frames)
        bench_launches = bench_phase(card)
        ssd = ssd_phases(card, work)
        start = time.perf_counter()
        with_files = files_phase(card, work)
        print(f"phase 19: {time.perf_counter() - start:.1f} s")
        start = time.perf_counter()
        ddp = ddp_phase(card, work)
        print(f"phase 20: {time.perf_counter() - start:.1f} s")
        start = time.perf_counter()
        monitor = phase21(card, work, cli["log_dir"], rotated_dir, ssd["log_dir"])
        print(f"phase 21: {time.perf_counter() - start:.1f} s")
        start = time.perf_counter()
        tools = phase22(card, work)
        print(f"phase 22: {time.perf_counter() - start:.1f} s")
        start = time.perf_counter()
        pretrained = phase23(card, work)
        print(f"phase 23: {time.perf_counter() - start:.1f} s")
        start = time.perf_counter()
        cached = phase24(card, work, ddp["ranks"])
        print(f"phase 24: {time.perf_counter() - start:.1f} s")
    k1_src, k2_src = "separable_sampler.cu", "rotated_sampler.cu"
    launches1, launches2 = cli["launches"], k2_train["launches"]
    in_situ = {**k1_train["device_in_situ_ms"], **k2_train["device_in_situ_ms"]}
    ssd_paths = {"train_ssd": ssd["train"], "serve_ssd": ssd["serve"], "evaluate_ssd": ssd["evaluate"],
                 "train_ssd_files": with_files["train_ssd"]}
    no_ssd = dict.fromkeys(ssd_paths, 0)
    files_paths = {kind: {"train_cli_files": with_files["train"][kind],
                          "evaluate_files": with_files["evaluate"] if kind == "fwd" else 0,
                          "train_ddp": ddp["train_ddp"]["K1"][kind],
                          "train_cli_torchrun": ddp["train_cli_torchrun"]["K1"][kind]} for kind in COUNTERS}
    monitor_paths = {kind: {"serve_video": monitor["serve_video"]["K1"] if kind == "fwd" else 0,
                            "serve_live": monitor["serve_live"] if kind == "fwd" else 0,
                            "train_cli_plot": monitor["train_cli_plot"][kind],
                            "train_ssd_plot": monitor["train_ssd_plot"] if kind == "fwd" else 0} for kind in COUNTERS}
    tools_paths = {kind: {"train_cli_supervised": tools["train_cli_supervised"][kind],
                          "evaluate_swa": tools["evaluate_swa"] if kind == "fwd" else 0,
                          "pretrain_backbone": pretrained["pretrain_backbone"]["K1"][kind],
                          "train_cli_pretrained": pretrained["train_cli_pretrained"][kind],
                          "train_ssd_pretrained": pretrained["train_ssd_pretrained"] if kind == "fwd" else 0,
                          "warm_cache": cached["warm_cache"]["K1"][kind],
                          "train_cli_cached": cached["train_cli_cached"][kind],
                          "pretrain_torchrun": cached["pretrain_torchrun"]["K1"][kind],
                          "pretrain_ddp": cached["pretrain_ddp"]["K1"][kind]}
                   for kind in COUNTERS}
    k1_paths = {
        "fwd": {"serve": serving["launches"], "train": k1_train["launches"]["fwd"], "train_cli": launches1["fwd"],
                "evaluate": evaluated["K1"], "serve_vbp": vbp_launches, "bench": bench_launches["fwd"], **ssd_paths,
                **files_paths["fwd"], **monitor_paths["fwd"], **tools_paths["fwd"]},
        "bwd_theta": {"train": k1_train["launches"]["bwd_theta"], "train_cli": launches1["bwd_theta"],
                      "evaluate": 0, "bench": bench_launches["bwd_theta"], **no_ssd, **files_paths["bwd_theta"],
                      **monitor_paths["bwd_theta"], **tools_paths["bwd_theta"]},
        "bwd_images": {"train": 0, "train_cli": launches1["bwd_images"], "evaluate": 0, "bench": 0, **no_ssd,
                       **files_paths["bwd_images"], **monitor_paths["bwd_images"], **tools_paths["bwd_images"]},
    }
    k1_fwd = kernel_entry("separable_sampler_fwd", k1_src, "loans_tpu/ops/stn.py:421", launches1["fwd"],
                          max([k1["max_abs_err"]] + [t["max_abs_err"] for t in ssd["crops"].values()]
                              + [t["max_abs_err"] for t in monitor["serving_shapes"].values()]),
                          k1["times"][TRAIN_BATCH], in_situ, k1_paths["fwd"])
    k1_fwd["ssd_shapes"] = {f"({SSD_CROP_BATCH}, {s}^2, 4) -> {s}^2": t for s, t in ssd["crops"].items()}
    k1_fwd["serving_shapes"] = monitor["serving_shapes"]
    k2_paths = {
        "fwd": {"train_rotated": launches2["fwd"], "evaluate_rotated": evaluated["K2"]},
        "bwd_theta": {"train_rotated": launches2["bwd_theta"], "evaluate_rotated": 0},
        "bwd_images": {"train_rotated": launches2["bwd_images"], "evaluate_rotated": 0},
    }
    for kind in COUNTERS:
        k2_paths[kind]["train_ddp"] = ddp["train_ddp"]["K2"][kind]
        k2_paths[kind]["serve_video_rotated"] = monitor["serve_video"]["K2"] if kind == "fwd" else 0
        k2_paths[kind]["pretrain_backbone"] = pretrained["pretrain_backbone"]["K2"][kind]
        for path in ("warm_cache", "pretrain_torchrun", "pretrain_ddp"):
            k2_paths[kind][path] = cached[path]["K2"][kind]
        k2_paths[kind]["train_cli_cached"] = 0  # cli_run checks K2's launches at 0
    print(json.dumps({"kernels": [
        k1_fwd,
        kernel_entry("separable_sampler_bwd_theta", k1_src, "loans_tpu/ops/stn.py:641", launches1["bwd_theta"],
                     k1_bwd["max_abs_err"]["bwd_theta"], k1_bwd["times"]["bwd_theta"][TRAIN_BATCH], in_situ,
                     k1_paths["bwd_theta"]),
        kernel_entry("separable_sampler_bwd_images", k1_src, "loans_tpu/ops/stn.py:641", launches1["bwd_images"],
                     k1_bwd["max_abs_err"]["bwd_images"], k1_bwd["times"]["bwd_images"][TRAIN_BATCH], in_situ,
                     k1_paths["bwd_images"]),
        kernel_entry("rotated_sampler_fwd", k2_src, "loans_tpu/ops/stn.py:474", launches2["fwd"],
                     k2["max_abs_err"]["fwd"], k2["times"]["fwd"][TRAIN_BATCH], in_situ, k2_paths["fwd"]),
        kernel_entry("rotated_sampler_bwd_theta", k2_src, "loans_tpu/ops/stn.py:256", launches2["bwd_theta"],
                     k2["max_abs_err"]["bwd_theta"], k2["times"]["bwd_theta"][TRAIN_BATCH], in_situ,
                     k2_paths["bwd_theta"]),
        kernel_entry("rotated_sampler_bwd_images", k2_src, "loans_tpu/ops/stn.py:256", launches2["bwd_images"],
                     k2["max_abs_err"]["bwd_images"], k2["times"]["bwd_images"][TRAIN_BATCH], in_situ,
                     k2_paths["bwd_images"]),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--cli"]:
        cli_worker(sys.argv[2:])
    elif sys.argv[1:2] in (["--warm"], ["--pretrain"]):
        tool_worker(sys.argv[1][2:], sys.argv[2:])
    else:
        main()
