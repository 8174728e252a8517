"""Smoke run of the PyTorch port (repsurf_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Run from the root of a checkout.  Phases, each printing its lines:

  1. card    - requires CUDA; prints the card's name and power limit as
               nvidia-smi gives them, the torch / CUDA versions, TF32 off;
  2. build   - compiles repsurf_torch/csrc/*.cu with nvcc, prints the time
               and, from ptxas's report, the registers, stack and spills
               of the kNN, FPS, umbrella (tq at both list lengths, full,
               the slab's two passes), ball-feature, row-grouping,
               chunk-mean and batch-norm kernels;
  2b. batch norm - the batch-norm kernels (statistics, normalisation,
               eval, backward; ReLU fused) at the cells' shapes, PT's
               [8, 80000, 16, 32] masked and not, its C = 3 and C = 4
               companions, seg SA1 [8, 20000, 32, 64], the seg umbrella
               [8, 80000, 8, 10], cls SA1 [64, 512, 32, 64], FP
               [8, 80000, 128], and edge shapes, element for element equal
               to the module's torch composition and autograd of it on the
               card (the statistics to the plain mirrors), each twice,
               bit-equal; kernel
               table row 11 at PT's shape (forward and backward against
               their bytes bound and the bytes they move, the mirrors,
               the module's torch composition and F.batch_norm + ReLU
               as the library's yardstick); the batch_norm launches of
               one training step and one eval forward of the umbrella
               seg model, PointTransformer and the classifier, equal to
               the norms each called;
  3. kernels - each CUDA kernel against its plain PyTorch version on the
               card, at the shapes of the classification eval path, with
               kernel and plain times (CUDA events, median of 20 runs), the
               call's device time (torch.profiler), the bound and, where
               one PyTorch call computes the same function, that call's
               time; each FPS line also its time a round and the round
               floor of its launch shape (the same rounds with the sweep
               removed); each ball-feature line its device time split into
               the kernel and the channels' torch.cat; the ball-feature
               kernel at edge shapes (C, S, ragged M, valid counts, empty
               balls, a cloud past its shared stage), its feat and
               selection bit-equal to the plain version and ball_query;
  3b. umbrella kernels - tq, full and slab against the plain composition
               at the cls shape (C = 10, and C = 9 for tq) and at a small
               room's pass (the seg style), full and the slab's live rows
               bit-equal to tq there and at small shapes, each timed tq's
               device time beside its scan floor (the same launch without
               the fan geometry and the stores), full's block-size sweep
               (8, 16, 32 warps) beside tq's device time, the slab's
               listed queries equal to the plain guard replay's mask, its
               call split into slab_order, the window pass and the
               re-solve pass (CUDA events and torch.profiler), the re-solve
               pass alone on the window pass's list, the seg-style
               gradient; the kernel entry driven with impl full and slab
               for their launch counts;
  4. slice   - repsurf_ssg_umb at full width, seeded random weights, vote
               evaluation (batch 64, 2048 -> 1024 points, 10 votes) through
               the kernels; launch counts, finite log-probs, kernel path
               against plain path on one batch, times per batch;
  5. train kernels - at the shapes of both SA stages of the classifier:
               the ball-feature backward (the scatter kernel) twice, bit-equal,
               its runs equal to selection_csr's, bit-equal to a float32 sum
               in ascending slot order, and against a float64 scatter-add
               within 1e-6 of the sum of each element's |contributions|,
               with its and index_add_'s device times (torch.profiler); the row-grouping kernel's
               forward bit-equal to ball_query + index_points, its device
               time split into the selection (the launch without the
               output walk, its selection equal to ball_query's) and the
               walk, and its backward as above; the umbrella Function's gradient against
               the plain composition's; the runs and sums of a cloud too
               large for shared memory (the global-memory variant); then
               ops/neighbors.ball_group, the row kernel's entry point,
               driven forward and backward;
  5b. pointnext kernels - at the shapes of s3dis_pnx_train's step, on 8
               of its crops (24,000 points of 220,000-point rooms at 0.04
               voxels, valid counts), each against its plain version: FPS
               24,000 -> 6,000 -> 1,500 -> 375 -> 93 (indices equal); the
               ball grouping as PointNeXt calls it (no polar) at each
               stage's set abstraction (C = 67, 131, 259, 515) and one
               self-query of its blocks (C = 131, 259, 515, 1,027; radii
               0.1 to 1.6): dp, feat and the selection bit-equal to the
               plain version and ball_query, and its scatter backward held
               as in phase 5 (untimed); the decoder's 3-NN through
               ops/neighbors.knn (indices and distances equal to
               knn_plain);
  6. cls train slice - repsurf_ssg_umb at full width, seeded random
               weights, ClsConfig defaults, one epoch of 8 train steps
               (batch 64, 2048 -> 1024) through train_epoch and 8 more timed
               one by one; launch counts, finite losses, peak memory; one
               SGD step on the kernel path against the plain path, per
               parameter (with --profile also a torch.profiler table of one
               train step);
  6b. step graph - the three classifiers (repsurf_ssg_umb, _2x, _tri) at
               batch 64, GRAPH_STEPS Adam steps each eagerly and through
               train_step's CUDA graph (one eager step, a capture, replays)
               from the same weights and generator seed: losses, counts,
               parameters, buffers, Adam's moments and step counts and the
               generators' states bit for bit, and the kernel launch
               counters alike on both sides; for repsurf_ssg_umb timed
               steps of each side and a torch.profiler trace of each,
               whose kernels and counts a step must agree (but for the
               two fills of the generator's seed and offset a replay
               adds); a capture that fails (a blocking host copy put back
               in ieee_div) warning once and leaving its key eager with
               the same results and counters, then a fresh capture;
  7. cli     - python -m repsurf_torch.cli.train_cls --synthetic for 2
               epochs with vote evaluation, then again to 3 epochs, which
               must resume from the checkpoint's epoch;
  7b. seg cli - python -m repsurf_torch.cli.train_seg --synthetic at full
               width (repsurf_umb_ssg, SegConfig defaults, two rooms,
               batches of 2 x 80,000 points, validation every epoch) for 2
               epochs, then --epoch 3 --resume from the best checkpoint:
               finite losses, the checkpoint's epoch the last one that
               logged a new best, the resume starting after it, the seg
               kernels launched, each run's seconds and train-step median;
               then python -m repsurf_torch.cli.test_s3dis serving a room
               from that checkpoint;
  8. seg kernels - the polar-division check; FPS, window kNN and brute kNN
               against their plain versions at every shape of the
               repsurf_umb_ssg step at 2 x 80,000 points (synthetic rooms
               and their FPS subsets), with the window kernel's re-solved
               queries per sample (at most RESOLVE_LIMIT, else the run
               fails) and its call split into window_tables, the window
               pass and the re-solve pass (CUDA events and torch.profiler
               device time); brute kNN on every route (1, 8, 16 and 32
               lanes a query) at small M; FPS on the stream route at
               [1, 150,000] and [2, 400,000]; FPS edge cases (duplicates
               across the blocks of a cluster, valid ending inside a
               block's share, npoint > valid, every one-block
               instantiation, every cluster size 2..16, the stream route)
               equal to fps_plain; an adversarial window case held to
               brute force; kernel and plain times (CUDA events, median)
               and the kNN kernels' device times;
  9. seg slice - repsurf_umb_ssg at full width, seeded random weights,
               3 train steps and one eval step on bench.py's batch of two
               80,000-point rooms; launch counts, finite losses, kernel path
               against plain path on one eval forward, step times (with
               --profile also a torch.profiler table of one train step);
  10. scene    - whole-scene inference of repsurf_umb_ssg at full width,
               seeded random weights: predict_scene with device votes and
               the median filter on R1 (a 120,000-point 8 x 8 x 3 m room,
               80,000-point chunks) and R2 (a 12,000-point 3 x 3 x 2.6 m
               room, whose 12,288-point passes take the seg-style umbrella
               kernel); chunks, seconds, launch counts by kernel and by
               umbrella style; device-mode labels against host-mode labels
               away from vote ties; one R2 batch on the kernel path against
               the plain path; python -m repsurf_torch.cli.test_s3dis
               --synthetic with its mIoU/mAcc/OA line, then again with
               --voxel_max 0 on a 400,000-point room whose voxel passes
               exceed the FPS registers' 131,072 points (the stream
               route), its pass sizes, its predictions read back in range
               and its kernel launches;
  11. model families - window kNN at k = 16 at PointTransformer's four
               window shapes (80,000 -> 80,000 and -> 20,000, 20,000 ->
               20,000 and -> 5,000; re-solved queries per sample held to
               RESOLVE_LIMIT, the call split as in phase 8), brute kNN at
               k = 16 at its five smaller shapes on the route the policy
               picks, brute kNN at k = 3 over [64, 1024] (the triangular
               constructor), the ball-feature forward and its scatter
               backward at repsurf_ssg_tri's SA1 (C = 10) and SA2 (C = 138)
               widths, each against its plain version; then
               repsurf_ssg_tri (ClsConfig defaults), pointnet2_ssg and
               pointtransformer (SegConfig defaults, bench.py's two
               80,000-point rooms) at full width, each with FAMILY_STEPS
               timed train steps, its peak memory and the kernel path
               against the plain path, then through its CLIs, the three
               training CLIs at once and then the two test CLIs at once:
               train_cls --model for one epoch with vote evaluation;
               train_seg --model for one epoch (a step, validation, the
               best checkpoint), then test_s3dis --model serving a room
               from it; finite losses and each CLI's kernel launches by
               kernel and k;
  11b. scannet and data parallelism - four ScanNet-format scenes of
               300,000 points (synthetic_room at 0.02 m spacing, xyzrgbl,
               labels 1..13 with a few percent 0, train.txt and val.txt);
               FPS, window kNN and brute kNN at the shapes of a ScanNet
               training step of 2 x 120,000 points and its eval forward
               (FPS 120,000 -> 30,000, the sectorized [8, 30,000] -> 7,503,
               30,000 -> 7,500 -> 1,875 -> 468; window kNN 120,000 ->
               120,000 at k = 9, -> 30,000 and 30,000 -> 7,500 at k = 32,
               30,000 -> 120,000 at k = 3; brute kNN 7,500 -> 1,875 and
               1,875 -> 468 at k = 32 and the FP shapes at k = 3), each
               exact against its plain version, the window's re-solved
               queries per sample held to RESOLVE_LIMIT; the seg CLI with
               --dataset ScanNet at its defaults (voxel 0.02, voxel_max
               120,000), batch 2, --loop 1, 2 epochs with validation,
               --workers 2, --n_devices 1 --bn sync: finite losses, class
               0 never predicted, the kernels launched by shape, the step
               median, the loader's data seconds a step and peak memory;
               then at once: the same with --bn per_device for one epoch,
               train_cls --synthetic --dp_mode shard_map --n_devices 1 for
               one epoch with votes, and test_s3dis serving a room of R2's
               size from a reference-format .pth and from the port's
               checkpoint of the same weights (the labels must be equal);
  12. tools   - the op tables of profile_seg --steps 3 --top 25 --fwd
               --scene 220000 (train step, eval forward, predict_scene on
               a room of 220,000 raw points) and profile_cls --ops, each
               CLI in its own process, each table from a whole trace and
               naming the path's kernels with device time above 0;
               knn_window_stats, its re-solved queries per sample held to
               RESOLVE_LIMIT; a ModelNet40Dataset batch of [32, 1024] from
               a txt fixture through fps_sample and repsurf_ssg_umb with
               40 classes, finite;
  13. a JSON line of the kernels, then {"ok": true, "device": {...}}.
      A device time that torch.profiler did not record whole in
      PROFILE_TRIES traces is null there; the SA1 re-solve check then
      compares the passes by CUDA events.

Any failed check raises, so the script exits non-zero and prints no
result line.
"""

import contextlib
import copy
import dataclasses
import functools
import json
import math
import re
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

import numpy as np
import torch

from repsurf_torch.utils.profiling import (
    PAD_KERNELS,
    PROFILER,
    checked_trace,
    device_split,
    not_measured_as_null,
)

BATCH, RAW_POINTS, NUM_POINT = 64, 2048, 1024
REPS = 20
UMB_ATOL = 1e-5  # umbrella features: atan2/acos/sqrt/division chains
NEAR_TIE = 1e-6  # azimuth gap under which two fan neighbours may swap
NEAR_TIE_SHARE = 1e-3
POS_ATOL = 1e-6  # ball pos: xyz2sphere of the relative coordinates
LOGP_ATOL = 1e-4  # log-probs, kernel path against plain path
SEG_BATCH, SEG_POINTS = 2, 80000
SEG_PARAMS = 976957  # repsurf_umb_ssg, as the JAX model
SEG_LOGIT_ATOL = 1e-4  # seg logits, kernel path against plain path
RESOLVE_LIMIT = 64  # window re-solves a sample at the seg shapes (the JAX smoke run's limit)
LARGE_ROOM_RAW = 400000  # the --voxel_max 0 room's raw points
FPS_LARGE = ((1, 150000, 2048, (10.0, 10.0, 3.0)), (2, 400000, 1024, (16.0, 16.0, 3.0)))
# s3dis_pnx_train's step: 8 crops of 24,000 points at 0.04 voxels of
# 220,000-point rooms; PointNeXt-XL's width, first radius and ball size
PNX_BATCH, PNX_POINTS, PNX_RAW, PNX_VOXEL = 8, 24000, 220000, 0.04
PNX_WIDTH, PNX_RADIUS, PNX_NSAMPLE = 64, 0.1, 32
SLOW_MS = 2000.0  # a plain version this slow is timed fewer times
ONCE_MS = 1000.0  # in phase 11b, a plain version this slow is timed once
FPS_SRC, FPS_TPU = "repsurf_torch/csrc/fps.cu", "repsurf_tpu/ops/pallas/fps.py:36"
WINDOW_SRC = "repsurf_torch/csrc/knn_window.cu"
WINDOW_TPU = "repsurf_tpu/ops/pallas/knn_window.py:60"
KNN_SRC, KNN_TPU = "repsurf_torch/csrc/knn.cu", "repsurf_tpu/ops/pallas/knn.py:35"
BALL_SRC = "repsurf_torch/csrc/ball_group.cu"
BALL_ROWS_TPU = "repsurf_tpu/ops/pallas/ball_group.py:56"
BALL_FEAT_BWD_TPU = "repsurf_tpu/ops/pallas/ball_group.py:699"
BALL_ROWS_BWD_TPU = "repsurf_tpu/ops/pallas/ball_group.py:792"
SCATTER_RTOL = 1e-6  # of the sum of |contributions| of each gradient element
UMB_GRAD_RTOL = 1e-5  # of max |grad|: the same composition, atomics in its gathers
UPDATE_RTOL = 1e-3  # SGD update, kernel path against plain path, per parameter,
UPDATE_FLOOR = 1e-3  # relative to max(its largest update, this share of the global one)
CLS_PARAMS = 1476791
TRI, TRI_PARAMS = "repsurf.repsurf_ssg_tri", 1475087
PN2, PN2_PARAMS = "pointnet2.pointnet2_ssg", 968173
PT, PT_PARAMS = "pointtransformer.pointtransformer", 7767729
FAMILY_STEPS = 3  # timed train steps of each family, after one warm-up
GRAPH_STEPS = 5  # phase 6b: train steps a classifier, eager against graphed
GRAPH_TIMED = 20  # phase 6b: timed steps a side
GRAPH_TRACED = 3  # phase 6b: traced steps a side
GRAPH_MODELS = ("repsurf.repsurf_ssg_umb", "repsurf.repsurf_ssg_umb_2x",
                "repsurf.repsurf_ssg_tri")
GRAPH_TRACE_KERNELS = ("fps_kernel", "umbrella_tq_kernel", "ball_feature_kernel",
                       "ball_scatter", "bn_sum_kernel", "bn_backward_dx_kernel")
BALL_FEAT_TPU = "repsurf_tpu/ops/pallas/ball_group.py:208"
BALL_FEAT_T_TPU = "repsurf_tpu/ops/pallas/ball_group.py:374"
CLI_TIMEOUT = 300
UMB_SRC, UMB_TPU = "repsurf_torch/csrc/umbrella.cu", "repsurf_tpu/ops/pallas/umbrella.py"
UMB_REPLACES = {"tq": UMB_TPU + ":302", "full": UMB_TPU + ":88", "slab": UMB_TPU + ":606"}
SEG_ROOM_POINTS, SEG_ROOM_SIZE = 12288, (3.0, 3.0, 2.6)  # a small room's pass, R2's shape
R1_POINTS, R2_POINTS = 120000, 12000
SCANNET_SCENES, SCANNET_RAW = 4, 300000  # phase 11b: two train and two val scenes
SEG_PARAMS_SCANNET = 977989  # repsurf_umb_ssg with ScanNet's 21 classes
VOTE_TIE = 1e-6  # top-two vote-averaged probability gap, device against host mode
PROFILER_TIMEOUT = 900  # seconds of a profiling CLI's process
SEG_TABLE_KERNELS = ("fps_kernel", "knn_window_kernel", ("knn_split_kernel", "knn_kernel"))
SCENE_TABLE_RAW = 220000  # raw points of the whole-scene op table's room
CLS_TABLE_KERNELS = ("fps_kernel", "umbrella_tq_kernel", "ball_feature_kernel")
MODELNET_SHAPES = 32  # a [32, 1024] batch from the ModelNet40 fixture
# H100 SXM data sheet: float32 outside the tensor cores, HBM3
PEAK_F32_FLOPS, PEAK_BYTES_PER_S = 67e12, 3.35e12
FADD_CYCLES, SM_CLOCK_HZ = 4, 1.98e9  # a dependent float32 add; the H100 SXM's boost clock
KNN_FLOPS = 8  # one squared distance: 3 differences, 3 products, 2 sums
PTXAS_KERNELS = (  # (label, a substring or substrings of the mangled name) for the build's report
    ("knn_kernel<32>", "knn_kernelILi32EE"),
    ("knn_split_kernel<32,32>", "knn_split_kernelILi32ELi32EE"),
    ("knn_split_kernel<32,16>", "knn_split_kernelILi32ELi16EE"),
    ("knn_split_kernel<256,32>", "knn_split_kernelILi256ELi32EE"),
    ("knn_window_kernel<32>", "knn_window_kernelILi32EE"),
    ("knn_resolve_kernel<32>", "knn_resolve_kernelILi32EE"),
    ("fps_kernel<32,stream>", "fps_kernelILi32ELb1EE"),
    ("umbrella_tq_kernel<9>", "umbrella_tq_kernelILi9ELb0EE"),
    ("umbrella_tq_kernel<17>", "umbrella_tq_kernelILi17ELb0EE"),
    ("umbrella_full_kernel<9>", "umbrella_full_kernelILi9ELi8EE"),
    ("umbrella_slab_kernel<9>", "20umbrella_slab_kernelILi9EE"),
    ("umbrella_slab_resolve_kernel<9>", "umbrella_slab_resolve_kernelILi9EE"),
    ("ball_feature_kernel", "19ball_feature_kernelE"),
    ("ball_feature_kernel_wide", "24ball_feature_kernel_wideE"),
    ("ball_group_kernel", "17ball_group_kernelE"),
    ("ball_group_kernel_wide", "22ball_group_kernel_wideE"),
    ("chunk_mean_kernel<float>", "chunk_mean_kernelIfE"),
    ("chunk_mean_kernel<double>", "chunk_mean_kernelIdE"),
    ("bn_sum_kernel<float,4,MeanOp>", ("bn_sum_kernelIfLi4E", "6MeanOpIfE")),
    ("bn_sum_kernel<float,1,VarOp>", ("bn_sum_kernelIfLi1E", "5VarOpIfE")),
    ("bn_sum_kernel<float,4,GradOp>", ("bn_sum_kernelIfLi4E", "6GradOpIfE")),
    ("bn_normalize_kernel<float,4>", "bn_normalize_kernelIfLi4EE"),
    ("bn_backward_dx_kernel<float,4>", "bn_backward_dx_kernelIfLi4EE"),
)
FPS_FLOPS = 9  # a distance and the running minimum
BN_SRC = "repsurf_torch/csrc/batch_norm.cu"
BN_SHAPES = (  # (label, x, its mask or None, ReLU): the cells' batch norms, then edge shapes
    ("PT attention", (8, 80000, 16, 32), (8, 80000, 1), True),
    ("PT attention, unmasked", (8, 80000, 16, 32), None, True),
    ("PT linear_p", (8, 80000, 16, 3), (8, 80000, 1), True),
    ("PT linear_w.3 at stage 1", (8, 80000, 16, 4), (8, 80000, 1), True),
    ("seg SA1", (8, 20000, 32, 64), (8, 20000, 1), True),
    ("seg umbrella", (8, 80000, 8, 10), (8, 80000, 1), True),
    ("cls SA1", (64, 512, 32, 64), None, True),
    ("FP", (8, 80000, 128), (8, 80000, 1), False),
    ("PT stage 5", (8, 312, 16, 512), (8, 312, 1), True),
    ("PointNeXt stage-1 aggregation", (8, 6000, 32, 128), (8, 6000, 1), True),
    ("PointNeXt stage-4 expansion, two slices", (8, 93, 4096), (8, 93, 1), True),
    ("cls head", (64, 256), None, True),
    ("odd C", (2, 3000, 13), (2, 3000, 1), True),
    ("few rows", (2, 37, 6), (2, 37, 1), True),
)
BN_FLOPS = 6  # an element: the statistics' three and the normalisation's three


def phase_card():
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this smoke run needs one GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(
        f"card: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
        f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}"
    )
    return smi


def phase_build():
    import repsurf_torch
    from repsurf_torch.ops.kernels import build

    here = Path(__file__).resolve().parent
    if Path(repsurf_torch.__file__).resolve().parent.parent != here:
        raise RuntimeError(f"repsurf_torch imported from {repsurf_torch.__file__}, "
                           f"not from this checkout ({here})")
    path, seconds = build.build()
    build.library()
    print(f"build: {len(list(build.CSRC.glob('*.cu')))} sources -> {path.name} "
          f"in {seconds:.1f} s")
    report = build.report_path()
    if not report.exists():
        print("  ptxas: no report (the library was built before reports were kept)")
        return
    found = build.resources(report.read_text())
    parts = []
    for label, key in PTXAS_KERNELS:
        subs = key if isinstance(key, tuple) else (key,)
        hits = [v for name, v in found.items() if all(k in name for k in subs)]
        if len(hits) != 1:
            raise AssertionError(f"ptxas report: {len(hits)} kernels match {key}")
        regs, stack, st, ld = hits[0]
        parts.append(f"{label} {regs} registers, {stack} B stack, {st}/{ld} B spill st/ld")
    print("  ptxas: " + "; ".join(parts))


def median_ms(fn, reps=REPS, warm=3):
    """Median over ``reps`` runs of fn, timed with CUDA events after
    ``warm`` warm-up runs."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def device_ms(fn, reps=REPS):
    """Device time of one call of fn (device_split, every kernel)."""
    return device_split(fn, {}, reps)["other"]


def adaptive_ms(fn):
    """median_ms with one sizing run for warm-up: REPS runs, or as few as 3
    for a function slower than SLOW_MS / REPS."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    first = (time.perf_counter() - t0) * 1e3
    return median_ms(fn, reps=max(3, min(REPS, int(SLOW_MS / max(first, 1e-3)))), warm=1)


def once_if_slow_ms(fn):
    """adaptive_ms, but a function whose sizing run takes over ONCE_MS is
    timed by that run alone (host clock around a synchronised call)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    first = (time.perf_counter() - t0) * 1e3
    if first > ONCE_MS:
        return first
    return median_ms(fn, reps=max(3, min(REPS, int(SLOW_MS / max(first, 1e-3)))), warm=0)


def bound(flops, nbytes):
    """(ms, 'operations' | 'bytes'): the least time the card could take for
    work of ``flops`` float32 operations moving ``nbytes`` (each input read
    once, each output written once)."""
    t_ops, t_mem = flops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_mem else (t_mem, "bytes")


def _entry(name, source, replaces, err, kernel_fn, plain_fn, work, timer=median_ms,
           library_fn=None, plain_timer=None):
    """One kernels-JSON entry: the kernel's and its plain version's times
    (CUDA events around the call, host work included; the plain version by
    ``plain_timer`` when given, else ``timer``) and the call's device time
    (torch.profiler, every kernel it launches), ``work`` = (flops, bytes)
    of this call for the bound, and the time of ``library_fn``, one PyTorch
    call computing the same function, where one exists."""
    ms, plain_ms = timer(kernel_fn), (plain_timer or timer)(plain_fn)
    dev_ms = device_ms(kernel_fn)
    library_ms = None if library_fn is None else timer(library_fn)
    bound_ms, bound_by = bound(*work)
    lib = "" if library_ms is None else f", library {library_ms:.4f} ms"
    print(f"  {name}: max_abs_err {err:.3g}, kernel {ms:.4f} ms (device {dev_ms:.4f} ms), plain "
          f"{plain_ms:.4f} ms{lib}, bound {bound_ms:.4f} ms ({bound_by})")
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "max_abs_err": float(err), "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms}


def fps_round_floor_ms(xyz, npoint):
    """The time of repsurf_fps_round_floor: FPS's launch shape for this
    cloud (threads, cluster size) and npoint rounds with the sweep removed,
    so only the reduction and the exchange: the round-latency floor."""
    from repsurf_torch.ops.kernels import build
    from repsurf_torch.ops.kernels.common import check_launch, ptr, stream

    b, n = xyz.shape[0], xyz.shape[1]
    lib = build.library()
    idx = torch.empty((b, npoint), dtype=torch.int32, device=xyz.device)
    xyz = xyz.contiguous()

    def probe():
        check_launch(lib.repsurf_fps_round_floor(ptr(xyz), b, n, npoint, ptr(idx),
                                                 stream(xyz.device)), "repsurf_fps_round_floor")

    return median_ms(probe)


def fps_rounds(entry, xyz, npoint):
    """Add to an FPS entry its time a round, the round floor of its launch
    shape, and the cluster size; print them."""
    from repsurf_torch.ops.kernels import build

    floor_ms = fps_round_floor_ms(xyz, npoint)
    cs = build.library().repsurf_fps_cluster_size(xyz.shape[1])
    entry.update(round_us=entry["ms"] * 1e3 / npoint, round_floor_us=floor_ms * 1e3 / npoint,
                 cluster=cs)
    print(f"    {entry['name']}: {'one block' if cs == 1 else f'{cs}-block cluster'}, "
          f"{entry['round_us']:.3f} us a round; the round floor (no sweep) "
          f"{entry['round_floor_us']:.3f} us")
    return entry


def check_fps(xyz, npoint):
    from repsurf_torch.ops.gather import index_points
    from repsurf_torch.ops.kernels.fps import fps, fps_plain

    idx, sam = fps(xyz, npoint, return_xyz=True)
    pidx = fps_plain(xyz, npoint)
    torch.cuda.synchronize()
    if not torch.equal(idx, pidx):
        raise AssertionError(f"fps {tuple(xyz.shape)}->{npoint}: indices differ")
    if not torch.equal(sam, index_points(xyz, idx)):
        raise AssertionError("fps: sampled xyz differ from the gather")
    b, n = xyz.shape[0], xyz.shape[1]
    return idx, sam, fps_rounds(_entry(
        f"fps[{b}x{n}->{npoint}]",
        "repsurf_torch/csrc/fps.cu", "repsurf_tpu/ops/pallas/fps.py:36", 0.0,
        lambda: fps(xyz, npoint, return_xyz=True), lambda: fps_plain(xyz, npoint),
        (FPS_FLOPS * b * npoint * n, 4 * (3 * b * n + 4 * b * npoint)),
    ), xyz, npoint)


def check_fps_edges(dev):
    """FPS cases that stress the kernel's exchange, each held equal to
    fps_plain on the defined slots (the first min(npoint, valid)): every
    point duplicated in another block of its cluster, so every round's
    lowest-index tie crosses the exchange; valid ending inside a block's
    share and inside the last block; N not a multiple of a block's points;
    npoint > valid; every one-block instantiation (1..32 points a thread)
    and every cluster size the wrapper picks, 2..16, the largest cloud in
    registers included; the stream route, with duplicates across its
    register and streamed points and valid ending in its streamed
    points."""
    from repsurf_torch.ops.kernels import build
    from repsurf_torch.ops.kernels.fps import fps, fps_plain

    lib = build.library()
    rng = np.random.RandomState(11)

    def run(tag, n, npoint, valid=None, dup=False):
        half = n // 2 if dup else n
        base = rng.rand(2, half, 3).astype(np.float32)
        pts = np.concatenate([base, base, base[:, :n - 2 * half]], axis=1) if dup else base
        xyz = torch.from_numpy(pts).to(dev)
        v = None if valid is None else torch.tensor(valid, device=dev)
        idx = fps(xyz, npoint, valid=v)
        want = fps_plain(xyz, npoint, valid=v)
        torch.cuda.synchronize()
        for i in range(2):
            m = npoint if valid is None else min(npoint, valid[i])
            if not torch.equal(idx[i, :m], want[i, :m]):
                raise AssertionError(f"fps edge case {tag} [2x{n}->{npoint}, valid {valid}]: "
                                     f"indices differ")
        return lib.repsurf_fps_cluster_size(n)

    seen = {}
    for p in range(1, 33):  # one block, p points a thread
        n = 256 * p - 5
        seen[n] = run("one block", n, 96, valid=[n, n - 700], dup=True)
    seen[3000] = run("npoint > valid", 3000, 200, valid=[50, 3000])
    seen[20000] = run("valid mid share and in the last block", 20000, 256,
                      valid=[7777, 19000], dup=True)
    seen[20001] = run("npoint > valid, cluster", 20001, 300, valid=[150, 20001])
    for cs in range(2, 17):
        n = cs * 5120 - 77
        seen[n] = run(f"cluster of {cs}", n, 64, valid=[n, n - 3001], dup=True)
    n_max = lib.repsurf_fps_register_points()
    seen[n_max] = run("the largest cloud in registers", n_max, 48, dup=True)
    seen[n_max + 1] = run("stream", n_max + 1, 48, valid=[n_max + 1, n_max - 5000], dup=True)
    seen[150001] = run("stream, valid in the streamed points", 150001, 64,
                       valid=[150001, 149001], dup=True)
    sizes = sorted(set(seen.values()))
    print(f"  fps edge cases: {len(seen)} clouds, duplicates across blocks, valid inside a "
          f"block's share and the last block, npoint > valid, N up to 150001 (the stream route "
          f"above {n_max}): equal to fps_plain on the defined slots; cluster sizes {sizes}")
    if sizes != list(range(1, 17)):
        raise AssertionError(f"fps edge cases reached cluster sizes {sizes}, not 1..16")


def umbrella_near_ties(xyz, k, style, valid=None):
    """[B, N] azimuth near-tie points of the style's fans (NEAR_TIE gap)."""
    from repsurf_torch.geometry.umbrella import azimuth_near_ties

    return azimuth_near_ties(xyz, k, drop_self=style == "cls", rotate=style == "seg",
                             valid=valid, gap=NEAR_TIE)


def slab_listed(xyz, k, args):
    """The slab window pass's list of failing queries: ([B, N] bool, the
    counts per sample)."""
    from repsurf_torch.ops.kernels.common import counts_i32
    from repsurf_torch.ops.kernels.umbrella import slab_order, slab_pass

    flags = {a: args[a] for a in ("drop_self", "rotate", "return_dist", "style")}
    valid = counts_i32(args["valid"], xyz.shape[0], xyz.device)
    _, resolved, fails = slab_pass(xyz, valid, slab_order(xyz, valid), k, **flags)
    counts = resolved.tolist()
    listed = torch.zeros(xyz.shape[:2], dtype=torch.bool, device=xyz.device)
    for s, c in enumerate(counts):
        listed[s, fails[s, :c].long()] = True
    return listed, counts


def slab_split(name, xyz, k, args):
    """The slab call's three steps timed apart: slab_order (the x-sort),
    the window pass and the re-solve pass, each by CUDA events (median),
    and the call's device time by kernel.  Returns the dict it prints."""
    from repsurf_torch.ops.kernels.common import counts_i32
    from repsurf_torch.ops.kernels.umbrella import (
        slab_order,
        slab_pass,
        slab_resolve,
        umbrella_features_kernel,
    )

    flags = {a: args[a] for a in ("drop_self", "rotate", "return_dist", "style")}
    valid = counts_i32(args["valid"], xyz.shape[0], xyz.device)
    order = slab_order(xyz, valid)
    outs = slab_pass(xyz, valid, order, k, **flags)
    dev = device_split(lambda: umbrella_features_kernel(xyz, k, impl="slab", **args),
                       {"pass": "umbrella_slab_kernel", "resolve": "umbrella_slab_resolve"})
    split = {"order_ms": median_ms(lambda: slab_order(xyz, valid)),
             "pass_ms": median_ms(lambda: slab_pass(xyz, valid, order, k, **flags)),
             "resolve_ms": median_ms(lambda: slab_resolve(xyz, valid, *outs, k, **flags)),
             "order_device_ms": dev["other"], "pass_device_ms": dev["pass"],
             "resolve_device_ms": dev["resolve"]}
    print(f"    {name}: slab_order {split['order_ms']:.4f} ms, window pass "
          f"{split['pass_ms']:.4f} ms, re-solve pass {split['resolve_ms']:.4f} ms (CUDA events); "
          f"device time (profiler) window pass {dev['pass']:.4f} ms, re-solve pass "
          f"{dev['resolve']:.4f} ms, the rest (the sort) {dev['other']:.4f} ms")
    return split


def check_slab_resolve(name, xyz, k, args, near):
    """The slab's re-solve kernel alone on the window pass's list: its rows
    against the plain composition over the listed queries (within UMB_ATOL
    away from near-ties), with its kernels-JSON entry."""
    from repsurf_torch.geometry.umbrella import umbrella_for_queries
    from repsurf_torch.ops.kernels.common import counts_i32
    from repsurf_torch.ops.kernels.knn import knn_plain
    from repsurf_torch.ops.kernels.umbrella import fan_shape, slab_order, slab_pass, slab_resolve

    flags = {a: args[a] for a in ("drop_self", "rotate", "return_dist", "style")}
    b, n = xyz.shape[0], xyz.shape[1]
    valid = counts_i32(args["valid"], b, xyz.device)
    outs = slab_pass(xyz, valid, slab_order(xyz, valid), k, **flags)
    out, resolved, fails = outs
    slab_resolve(xyz, valid, *outs, k, **flags)
    counts = resolved.tolist()
    listed = [(s, fails[s, :c].long()) for s, c in enumerate(counts) if c]

    def plain():
        rows = []
        for s, r in listed:
            q = xyz[s:s + 1, r]
            idx, _ = knn_plain(k, xyz[s:s + 1], q, valid=None if valid is None else valid[s:s + 1])
            rows.append(umbrella_for_queries(xyz[s:s + 1], q, idx[..., int(flags["drop_self"]):],
                                             rotate=flags["rotate"],
                                             return_dist=flags["return_dist"],
                                             style=flags["style"]))
        return rows

    err = 0.0
    for (s, r), want in zip(listed, plain()):
        e = (out[s, r] - want[0]).abs().amax(dim=(1, 2))[~near[s, r]]
        err = max(err, float(e.max()) if e.numel() else 0.0)
    if err > UMB_ATOL:
        raise AssertionError(f"{name}: a re-solved row differs by {err} away from near-ties")
    g, c = fan_shape(k, flags["drop_self"], flags["return_dist"])
    nv = [n] * b if valid is None else valid.tolist()
    pairs = sum(cnt * nv[s] for s, cnt in enumerate(counts))
    entry = _entry(name, UMB_SRC, UMB_REPLACES["slab"], err,
                   lambda: slab_resolve(xyz, valid, *outs, k, **flags), plain,
                   # the listed queries against every point; the cloud in
                   # once, the listed rows out
                   (KNN_FLOPS * pairs, 4 * (3 * b * n + sum(counts) * g * c)))
    entry["resolved_per_sample"] = counts
    return entry


def full_sweep(name, xyz, k, args, want, tq_device_ms):
    """The full kernel at 8, 16 and 32 warps a block, each bit-equal to tq's
    features ``want``: device times beside tq's.  Returns {warps: ms}."""
    from repsurf_torch.ops.kernels.umbrella import umbrella_full_warps

    times = {}
    for warps in (8, 16, 32):
        if not torch.equal(umbrella_full_warps(xyz, k, warps, **args), want):
            raise AssertionError(f"{name}: {warps} warps a block differ from tq")
        times[warps] = device_ms(lambda: umbrella_full_warps(xyz, k, warps, **args))
    print(f"    {name}: block sweep, device time by warps a block "
          + ", ".join(f"{w} {t:.4f} ms" for w, t in times.items())
          + f" (each bit-equal to tq); tq {tq_device_ms:.4f} ms")
    return times


def check_umbrella(impl, xyz, style, return_dist=True, valid=None, near=None, k=9,
                   timed=True):
    """One umbrella kernel against the plain composition: within UMB_ATOL
    away from azimuth near-ties (at most 0.1 % of the points); the slab's
    listed queries equal to the plain guard replay's mask, their counts to
    the call's; a timed tq beside its scan floor's device time.
    Returns (features, its kernels-JSON entry when ``timed``, else None)."""
    from repsurf_torch.ops.kernels.umbrella import (
        SLAB,
        fan_shape,
        slab_guard_plain,
        umbrella_fan_features_plain,
        umbrella_features_kernel,
        umbrella_tq_scan_floor,
    )

    args = dict(drop_self=style == "cls", rotate=style == "seg", return_dist=return_dist,
                style=style, valid=valid)
    b, n = xyz.shape[0], xyz.shape[1]
    g, c = fan_shape(k, args["drop_self"], return_dist)
    tag = f"umbrella_{impl}[{b}x{n},k={k},{style},C={c}]"
    feat = umbrella_features_kernel(xyz, k, impl=impl, **args)
    pfeat = umbrella_fan_features_plain(xyz, k, **args)
    torch.cuda.synchronize()
    live = torch.ones((b, n), dtype=torch.bool, device=xyz.device)
    if valid is not None:
        live = torch.arange(n, device=xyz.device)[None] < valid[:, None]
    rows = live if impl == "slab" else torch.ones_like(live)  # slab: padded rows unspecified
    near = umbrella_near_ties(xyz, k, style, valid) if near is None else near
    err = (feat - pfeat).abs().amax(dim=(2, 3))
    off = (err > UMB_ATOL) & rows
    n_near, n_pts = int(near.sum()), near.numel()
    nv = n * b if valid is None else int(valid.sum())
    pairs = n * nv
    extra = ""
    if impl == "slab":
        resolved = umbrella_features_kernel.slab_resolved.tolist()
        listed, counts = slab_listed(xyz, k, args)
        replay = slab_guard_plain(xyz, k, valid)
        if counts != resolved or int(listed.sum()) != sum(counts) or \
                not torch.equal(listed, replay):
            raise AssertionError(f"{tag}: listed {counts} (the call {resolved}), the plain "
                                 f"guard replay {replay.sum(dim=1).tolist()}, "
                                 f"{int((listed != replay).sum())} queries differ")
        extra = (f"; re-solved queries per sample {resolved}, the listed set = the plain guard "
                 "replay's mask")
        # the window's candidates, then the whole cloud for each listed query
        pairs = 3 * SLAB * n * b + sum(resolved) * (nv // b)
    print(f"  {tag}: near-tie points {n_near} of {n_pts}; points off by > {UMB_ATOL}: "
          f"{int(off.sum())}{extra}")
    if (off & ~near).any():
        raise AssertionError(f"{tag}: {int((off & ~near).sum())} points differ "
                             f"beyond {UMB_ATOL} away from azimuth near-ties")
    if not torch.isfinite(feat[rows]).all():
        raise AssertionError(f"{tag}: features not finite")
    if n_near > NEAR_TIE_SHARE * n_pts:
        raise AssertionError(f"{tag}: {n_near} near-tie points exceed 0.1%")
    if not timed:
        return feat, None
    entry = _entry(
        tag, UMB_SRC, UMB_REPLACES[impl], float(err[rows & ~near].max()),
        lambda: umbrella_features_kernel(xyz, k, impl=impl, **args),
        lambda: umbrella_fan_features_plain(xyz, k, **args),
        (KNN_FLOPS * pairs, 4 * (3 * b * n + b * n * g * c)),
    )
    entry.update(impl=impl, style=style)
    if impl == "tq":
        floor = device_ms(lambda: umbrella_tq_scan_floor(xyz, k, **args))
        entry["floor_device_ms"] = floor
        print(f"    {tag}: scan floor {floor:.4f} ms of the kernel's {entry['device_ms']:.4f} ms "
              f"(device time)")
    return feat, entry


def check_ball(radius, nsample, xyz, new_xyz, tensors, valid=None, replaces=None):
    """The feature kernel at one shape: feat and the selection it writes
    bit-equal to the plain version's and to ball_query's, pos within
    POS_ATOL.  With ``replaces``, also through the autograd entry, timed:
    its kernels-JSON entry, the call's device time split into the kernel,
    the concatenation of the channel tensors and the rest."""
    from repsurf_torch.ops.kernels.ball_group import (
        ball_group_feature,
        ball_group_feature_plain,
        ball_group_feature_selection,
    )
    from repsurf_torch.ops.neighbors import ball_query

    args = (radius, nsample, xyz, new_xyz, tensors)
    b, n, m = xyz.shape[0], xyz.shape[1], new_xyz.shape[1]
    c = sum(t.shape[-1] for t in tensors)
    tag = (f"ball_feature[{b}x{n}->{m},S={nsample},C={c}"
           f"{'' if valid is None else ',valid ' + str(valid.tolist())}]")
    pos, feat, sel = ball_group_feature_selection(*args, valid=valid, return_polar=True)
    ppos, pfeat = ball_group_feature_plain(*args, valid=valid, return_polar=True)
    psel = ball_query(radius, nsample, xyz, new_xyz, valid=valid)
    torch.cuda.synchronize()
    if not torch.equal(sel, psel):
        raise AssertionError(f"{tag}: the selection differs from ball_query's")
    if not torch.equal(feat, pfeat):
        raise AssertionError(f"{tag}: feat not bit-equal")
    err = float((pos - ppos).abs().max())
    if err > POS_ATOL:
        raise AssertionError(f"{tag}: pos off by {err}")
    if replaces is None:
        return sel
    kernel_fn = functools.partial(ball_group_feature, *args, return_polar=True)
    gpos, gfeat = kernel_fn()
    if not (torch.equal(gfeat, feat) and torch.equal(gpos, pos)):
        raise AssertionError(f"{tag}: the autograd entry differs from the selection entry")
    entry = _entry(
        tag, BALL_SRC, replaces, err, kernel_fn,
        lambda: ball_group_feature_plain(*args, return_polar=True),
        # the ball query's distances; xyz, centers and channels in, pos (6)
        # and feat (C - 3) out
        (KNN_FLOPS * b * m * n, 4 * (3 * b * n + 3 * b * m + b * n * c
                                     + b * m * nsample * (6 + c - 3))),
    )
    split = device_split(kernel_fn, {"kernel": "ball_feature_kernel", "cat": "Cat"})
    entry.update(channels=c, kernel_device_ms=split["kernel"], cat_device_ms=split["cat"])
    print(f"    {tag}: device time (profiler) kernel {split['kernel']:.4f} ms, the channels' "
          f"torch.cat {split['cat']:.4f} ms, other {split['other']:.4f} ms")
    return entry


def check_ball_edges(dev):
    """The feature kernel at untimed edge shapes, each as check_ball, and
    the row-grouping kernel on the same inputs, bit-equal to its plain
    version: C in (4, 13, 141, 142); S in (1, 33, 64, 128) (the narrow and
    the wide instantiations of both); M = 37, not a multiple of a block's 8
    queries; valid counts; empty balls (queries far outside the cloud); a
    cloud of 20,000 points, larger than the kernels' shared stage of 2,048,
    so it is scanned stage by stage."""
    from repsurf_torch.ops.kernels.ball_group import (
        ball_group_channels,
        ball_group_channels_plain,
    )

    gen = torch.Generator(dev).manual_seed(12)

    def case(b, n, m, nsample, c, radius, valid, far):
        xyz = torch.rand((b, n, 3), generator=gen, device=dev) * 2 - 1
        q = xyz[:, torch.randperm(n, generator=torch.Generator().manual_seed(n))[:m].to(dev)]
        q[:, :far] += 50.0  # empty balls: point 0
        extra = torch.randn((b, n, c - 3), generator=gen, device=dev)
        valid = torch.tensor(valid, device=dev)
        sel = check_ball(radius, nsample, xyz, q, [xyz, extra], valid=valid)
        tcat = torch.cat([xyz, extra], dim=-1)
        if not torch.equal(ball_group_channels(radius, nsample, xyz, q, tcat, valid=valid),
                           ball_group_channels_plain(radius, nsample, xyz, q, tcat, valid=valid)):
            raise AssertionError(f"ball_group [{b}x{n}->{m},S={nsample},C={c}]: not bit-equal")
        return int((sel[:, far:] != sel[:, far:, :1]).any(-1).sum())

    shapes = ([(2, 300, 37, 32, c, 0.3, [300, 151], 3) for c in (4, 13, 141, 142)]
              + [(2, 700, 37, s, 13, 0.45, [700, 512], 2) for s in (1, 33, 64, 128)]
              + [(2, 20000, 512, 32, 13, 0.12, [20000, 9001], 4)])
    varied = [case(*shape) for shape in shapes][-1]
    print(f"  ball_feature edge shapes: {len(shapes)} calls (C in (4, 13, 141, 142), S in (1, "
          f"33, 64, 128), M = 37, valid counts, empty balls, [2x20000->512] past the 2,048-point "
          f"stage with {varied} balls of more than one point): feat and selection bit-equal to "
          f"the plain version and ball_query, pos within {POS_ATOL}; ball_group bit-equal to its "
          f"plain version on every one")


def phase_kernels(dev):
    from repsurf_torch.data.scanobjectnn import SyntheticClouds
    from repsurf_torch.models import get_model
    from repsurf_torch.ops.gather import index_points

    print("kernels: each against its plain version on the card")
    raw = torch.from_numpy(SyntheticClouds(n_samples=BATCH, seed=1).data).to(dev)
    entries = []
    with torch.inference_mode():
        _, xyz1, e = check_fps(raw, NUM_POINT)
        entries.append(e)
        idx2, xyz2, e = check_fps(xyz1, 512)
        entries.append(e)
        idx3, xyz3, e = check_fps(xyz2, 128)
        entries.append(e)
        # realistic SA inputs: umbrella constructor normals, random features
        gen = torch.Generator().manual_seed(0)
        model = get_model("repsurf.repsurf_ssg_umb", generator=gen).to(dev).eval()
        normal1 = model.surface_constructor(xyz1)
        entries.append(check_ball(0.2, 32, xyz1, xyz2, [xyz1, normal1],
                                  replaces=BALL_FEAT_T_TPU))
        normal2 = index_points(normal1, idx2)
        feat2 = torch.randn((BATCH, 512, 128), generator=torch.Generator(dev).manual_seed(1),
                            device=dev)
        entries.append(check_ball(0.4, 64, xyz2, xyz3, [xyz2, normal2, feat2],
                                  replaces=BALL_FEAT_TPU))
        check_ball_edges(dev)
    stages = dict(xyz1=xyz1, xyz2=xyz2, xyz3=xyz3, normal1=normal1, normal2=normal2,
                  feat2=feat2)
    return entries, stages


@contextlib.contextmanager
def plain_kernels():
    """Route the model's kernel calls to the plain versions, for the
    kernel-path / plain-path comparison of the slice; restored on exit."""
    import repsurf_torch.data.transforms as transforms
    import repsurf_torch.geometry.umbrella as geo_umbrella
    import repsurf_torch.nn.blocks as blocks
    import repsurf_torch.nn.pointtransformer as pointtransformer
    import repsurf_torch.nn.triangular as triangular
    import repsurf_torch.ops.interpolate as interpolate
    from repsurf_torch.nn.layers import MaskedBatchNorm
    import repsurf_torch.ops.neighbors as neighbors
    import repsurf_torch.ops.sampling as sampling
    from repsurf_torch.ops.kernels.ball_group import ball_group_feature_plain
    from repsurf_torch.ops.kernels.fps import fps_plain
    from repsurf_torch.ops.kernels.knn import knn_plain
    from repsurf_torch.ops.kernels.umbrella import umbrella_fan_features_plain
    from repsurf_torch.ops.gather import index_points

    def ball_group_plain(radius, nsample, xyz, new_xyz, tensors, valid=None):
        idx = neighbors.ball_query(radius, nsample, xyz, new_xyz, valid=valid)
        return [None if t is None else index_points(t, idx) for t in tensors]

    def umbrella_plain(xyz, k, impl="auto", **kw):
        return umbrella_fan_features_plain(xyz, k, **kw)

    def norm_composition(self, x, mask=None, relu=False):  # the module's CPU route
        y = self._composition(x, mask)
        return torch.relu(y) if relu else y

    swaps = [(sampling, "fps", fps_plain), (transforms, "fps", fps_plain),
             (geo_umbrella, "umbrella_features_kernel", umbrella_plain),
             (blocks, "ball_group_feature", ball_group_feature_plain),
             (neighbors, "ball_group", ball_group_plain),
             (geo_umbrella, "knn", knn_plain), (blocks, "knn", knn_plain),
             (interpolate, "knn", knn_plain), (triangular, "knn", knn_plain),
             (pointtransformer, "knn", knn_plain),
             (MaskedBatchNorm, "forward", norm_composition)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    try:
        for mod, name, fn in swaps:
            setattr(mod, name, fn)
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def reset_umbrella_counts():
    from repsurf_torch.ops.kernels.umbrella import umbrella_features_kernel as umb

    for counts in (umb.launches, umb.launches_by_style):
        for key in counts:
            counts[key] = 0
    umb.slab_resolve_launches = 0


def umbrella_counts():
    """{'umbrella_tq': n, 'umbrella_full': n, 'umbrella_slab': n,
    'umbrella_slab_resolve': n} and the launches by style, since the last
    reset."""
    from repsurf_torch.ops.kernels.umbrella import umbrella_features_kernel as umb

    by_impl = {f"umbrella_{k}": v for k, v in umb.launches.items()}
    by_impl["umbrella_slab_resolve"] = umb.slab_resolve_launches
    return by_impl, dict(umb.launches_by_style)


def phase_slice(dev):
    from repsurf_torch.data.scanobjectnn import SyntheticClouds
    from repsurf_torch.data.transforms import fps_sample
    from repsurf_torch.ops.kernels.ball_group import ball_group_feature
    from repsurf_torch.ops.kernels.fps import fps
    from repsurf_torch.train.train_cls import ClsConfig, build_model, eval_step, evaluate

    cfg = ClsConfig()
    model = build_model(cfg, generator=torch.Generator().manual_seed(cfg.seed)).to(dev).eval()
    n_params = sum(p.numel() for p in model.parameters())
    data = SyntheticClouds(n_samples=2 * BATCH, seed=1)
    counters = (fps, ball_group_feature)

    for k in counters:
        k.launches = 0
    reset_umbrella_counts()
    ball_group_feature.launches_by_channels.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    single_acc, vote_acc = evaluate(model, data, cfg, torch.Generator(dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in counters}
    launches["umbrella_tq"] = umbrella_counts()[0]["umbrella_tq"]
    by_c = dict(ball_group_feature.launches_by_channels)
    print(f"slice: repsurf_ssg_umb ({n_params} parameters), {len(data)} clouds, "
          f"batch {cfg.batch_size}, {RAW_POINTS}->{cfg.num_point}, {cfg.num_votes} votes: "
          f"{eval_s:.3f} s; launches {launches}, ball by C {by_c}")
    if min(launches.values()) == 0 or by_c.get(13, 0) == 0 or by_c.get(141, 0) == 0:
        raise AssertionError("a kernel of the path was not launched in the slice")
    print(f"  accuracy (random weights, a sanity print): single {single_acc:.4f}, "
          f"vote {vote_acc:.4f}")

    raw = torch.from_numpy(data.data[:BATCH]).to(dev)
    target = torch.from_numpy(data.label[:BATCH]).to(dev)
    with torch.inference_mode():
        _, _, vote_sum = eval_step(model, raw, target, cfg,
                                   generator=torch.Generator(dev).manual_seed(0))
        if vote_sum.shape != (BATCH, cfg.num_class) or not torch.isfinite(vote_sum).all():
            raise AssertionError("vote log-probs not finite or of the wrong shape")
        pts = fps_sample(raw, cfg.num_point)
        sign = torch.where(torch.arange(BATCH, device=dev) % 3 == 0, -1.0, 1.0)
        logp = model(pts, inv_sign=sign)
        with plain_kernels():
            plain_logp = model(pts, inv_sign=sign)
        err = float((logp - plain_logp).abs().max())
        print(f"  kernel path vs plain path, one batch: max |d log-prob| {err:.3g} "
              f"(limit {LOGP_ATOL})")
        if not torch.isfinite(logp).all() or err > LOGP_ATOL:
            raise AssertionError("kernel path and plain path disagree")
        fwd_ms = median_ms(lambda: model(fps_sample(raw, cfg.num_point), inv_sign=sign))
    vote_times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eval_step(model, raw, target, cfg, generator=torch.Generator(dev).manual_seed(0))
        torch.cuda.synchronize()
        vote_times.append((time.perf_counter() - t0) * 1e3)
    print(f"  single forward (FPS + model) per batch of {BATCH}: {fwd_ms:.3f} ms "
          f"(CUDA events, median of {REPS}); {cfg.num_votes}-vote eval_step per batch: "
          f"{statistics.median(vote_times):.3f} ms (host clock, median of 5)")
    return launches, by_c


def ordered_sum(sel, g, n, coff):
    """The plain oracle of the scatter kernel on the card: selection_csr's
    runs, then run position j = 0, 1, ... of every point added at once, a
    sequential float32 sum in ascending slot order."""
    from repsurf_torch.ops.kernels.ball_group import selection_csr

    order, starts = selection_csr(sel, n)
    order, starts = order.long(), starts.long()
    c = g.shape[-1]
    rows = g.reshape(-1, c)
    length = starts[1:] - starts[:-1]
    acc = torch.zeros((length.numel(), c), dtype=torch.float32, device=g.device)
    for j in range(int(length.max()) if length.numel() else 0):
        live = torch.nonzero(length > j)[:, 0]
        acc[live] = acc[live] + rows[order[starts[live] + j]]
    out = torch.cat([acc.new_zeros((acc.shape[0], coff)), acc], dim=-1)
    return out.reshape(sel.shape[0], n, coff + c)


def check_scatter_runs(name, sel, g, n, coff):
    """The kernel's runs equal selection_csr's, and its sums the ordered
    float32 oracle's, bit for bit."""
    from repsurf_torch.ops.kernels.ball_group import ball_scatter, selection_csr

    out, order, starts = ball_scatter(sel, g, n, coff, return_runs=True)
    corder, cstarts = selection_csr(sel, n)
    oracle = ordered_sum(sel, g, n, coff)
    torch.cuda.synchronize()
    if not (torch.equal(order, corder) and torch.equal(starts, cstarts)):
        raise AssertionError(f"{name}: the kernel's runs differ from selection_csr's")
    if not torch.equal(out, oracle):
        raise AssertionError(f"{name}: not bit-equal to the ordered float32 sum")
    return out


def check_scatter(name, replaces, sel, g, n, coff, backward_fn, timed=True):
    """The backward kernel at one shape: ``backward_fn`` (the gradient as
    the autograd Function returns it) twice, bit-equal, and equal to the
    scatter kernel called on sel; its runs equal to selection_csr's and
    its sums bit-equal to the ordered float32 oracle; within SCATTER_RTOL
    of the sum of the |contributions| of each element of a float64
    scatter-add.  Then, if ``timed``, its kernels-JSON entry."""
    from repsurf_torch.ops.kernels.ball_group import ball_scatter, ball_scatter_plain

    a, b = backward_fn(), backward_fn()
    direct = check_scatter_runs(name, sel, g, n, coff)
    torch.cuda.synchronize()
    if not (torch.equal(a, b) and torch.equal(a, direct)):
        raise AssertionError(f"{name}: two runs, or the Function and the kernel, differ")
    ref = ball_scatter_plain(sel, g.double(), n, coff)
    contrib = ball_scatter_plain(sel, g.abs().double(), n, coff)
    err = (a.double() - ref).abs()
    if (err > SCATTER_RTOL * contrib).any():
        raise AssertionError(f"{name}: off the float64 scatter-add by more than "
                             f"{SCATTER_RTOL} of the contributions")
    worst = float((err / contrib.clamp(min=1e-30)).max())
    print(f"  {name}: bit-equal twice; runs equal to selection_csr's; bit-equal to the "
          f"ordered float32 sum; worst |err| / sum|contributions| {worst:.3g} "
          f"(limit {SCATTER_RTOL})")
    if not timed:
        return None
    # the library call: index_add_ of the cotangent rows into a [B*N, C]
    # buffer (its flat point keys made once, outside the timing)
    bsz, c = sel.shape[0], g.shape[-1]
    key = (sel.long() + torch.arange(bsz, device=sel.device)[:, None, None] * n).reshape(-1)
    rows, acc = g.reshape(-1, c), torch.zeros((bsz * n, c), device=g.device)
    entry = _entry(name, BALL_SRC, replaces, float(err.max()),
                   lambda: ball_scatter(sel, g, n, coff),
                   lambda: ball_scatter_plain(sel, g, n, coff),
                   # one add per cotangent element; cotangent and selection
                   # in, [B, N, coff + C] out
                   (g.numel(), 4 * (g.numel() + sel.numel() + bsz * n * (coff + c))),
                   library_fn=lambda: acc.index_add_(0, key, rows))
    entry["library_device_ms"] = device_ms(lambda: acc.index_add_(0, key, rows))
    print(f"    {name}: device time (profiler) kernel {entry['device_ms']:.4f} ms, "
          f"index_add_ {entry['library_device_ms']:.4f} ms")
    return entry


def check_scatter_global(dev):
    """A cloud whose runs do not fit in shared memory (the kernel's
    global-scratch variant), and an N that is not a multiple of 32: short
    balls padded with their first hit and empty balls on point 0."""
    from repsurf_torch.ops.kernels import build

    lib = build.library()
    gen = torch.Generator(dev).manual_seed(5)
    for b, n, m, s, c, coff in ((2, 20000, 5000, 32, 13, 0), (3, 1000, 300, 24, 7, 3)):
        sel = torch.randint(0, n, (b, m, s), generator=gen, device=dev, dtype=torch.int32)
        sel[:, ::10] = 0  # empty balls gather point 0
        sel[:, 1::10, s // 3:] = sel[:, 1::10, :1]  # short balls, padded with the first hit
        g = torch.randn((b, m, s, c), generator=gen, device=dev)
        words = lib.repsurf_ball_scatter_scratch(b, n, m * s)
        check_scatter_runs(f"ball_scatter[{b}x{n},M={m},S={s},C={c}]", sel, g, n, coff)
        print(f"  ball_scatter [{b}x{n}, M={m}, S={s}, C={c}, coff={coff}]: runs equal to "
              f"selection_csr's, bit-equal to the ordered float32 sum; "
              f"{'global scratch of ' + str(words) + ' ints' if words else 'shared memory'}")
        if (words > 0) != (n == 20000):
            raise AssertionError("ball_scatter took the wrong workspace variant")


def check_ball_rows(radius, nsample, xyz, new_xyz, tcat):
    """The row-grouping kernel: forward bit-equal to ball_query +
    index_points, its device time (torch.profiler) split into the kernel's
    selection (the same launch without the output walk, whose selection
    must equal ball_query's) and the walk; backward through check_scatter."""
    from repsurf_torch.ops.kernels.ball_group import (
        ball_group_channels,
        ball_group_channels_plain,
        ball_group_select_floor,
    )
    from repsurf_torch.ops.neighbors import ball_query

    b, m, c = xyz.shape[0], new_xyz.shape[1], tcat.shape[-1]
    shape = f"{b}x{xyz.shape[1]}->{m},S={nsample},C={c}"
    with torch.no_grad():
        out = ball_group_channels(radius, nsample, xyz, new_xyz, tcat)
        ref = ball_group_channels_plain(radius, nsample, xyz, new_xyz, tcat)
        torch.cuda.synchronize()
        if not torch.equal(out, ref):
            raise AssertionError(f"ball_group[{shape}]: not bit-equal to the gather")
        n = xyz.shape[1]
        fwd = _entry(f"ball_group[{shape}]", BALL_SRC, BALL_ROWS_TPU, 0.0,
                     lambda: ball_group_channels(radius, nsample, xyz, new_xyz, tcat),
                     lambda: ball_group_channels_plain(radius, nsample, xyz, new_xyz, tcat),
                     (KNN_FLOPS * b * m * n,
                      4 * (3 * b * n + 3 * b * m + b * n * c + b * m * nsample * c)))
        floor_sel = ball_group_select_floor(radius, nsample, xyz, new_xyz, c)
        if not torch.equal(floor_sel, ball_query(radius, nsample, xyz, new_xyz).to(torch.int32)):
            raise AssertionError(f"ball_group[{shape}]: the selection floor's selection differs")
        kernel = device_split(lambda: ball_group_channels(radius, nsample, xyz, new_xyz, tcat),
                              {"kernel": "ball_group_kernel"})["kernel"]
        floor = device_ms(lambda: ball_group_select_floor(radius, nsample, xyz, new_xyz, c))
    fwd.update(channels=c, kernel_device_ms=kernel, select_floor_device_ms=floor)
    print(f"    ball_group[{shape}]: device time (profiler) kernel {kernel:.4f} ms = selection "
          f"floor {floor:.4f} ms + output walk {kernel - floor:.4f} ms")
    leaf = tcat.detach().requires_grad_(True)
    g = torch.randn((b, m, nsample, c), generator=torch.Generator(xyz.device).manual_seed(2),
                    device=xyz.device)

    def backward():
        out = ball_group_channels(radius, nsample, xyz, new_xyz, leaf)
        return torch.autograd.grad(out, leaf, g)[0]

    sel = ball_query(radius, nsample, xyz, new_xyz)
    bwd = check_scatter(f"ball_group_bwd[{shape}]", BALL_ROWS_BWD_TPU, sel, g, xyz.shape[1],
                        0, backward)
    bwd["channels"] = c
    return [fwd, bwd]


def check_feature_backward(radius, nsample, xyz, new_xyz, tcat):
    from repsurf_torch.ops.kernels.ball_group import ball_group_feature
    from repsurf_torch.ops.neighbors import ball_query

    b, m, c = xyz.shape[0], new_xyz.shape[1], tcat.shape[-1]
    leaf = tcat.detach().requires_grad_(True)
    g = torch.randn((b, m, nsample, c - 3), generator=torch.Generator(xyz.device).manual_seed(3),
                    device=xyz.device)

    def backward():
        _, feat = ball_group_feature(radius, nsample, xyz, new_xyz, [leaf], return_polar=True)
        return torch.autograd.grad(feat, leaf, g)[0]

    sel = ball_query(radius, nsample, xyz, new_xyz)
    entry = check_scatter(f"ball_feature_bwd[{b}x{xyz.shape[1]}->{m},S={nsample},C={c}]",
                          BALL_FEAT_BWD_TPU, sel, g, xyz.shape[1], 3, backward)
    entry["channels"] = c
    return entry


def check_umbrella_grad(xyz, style="cls"):
    """The umbrella Function's gradient (its backward re-runs the plain
    composition) against autograd through the plain composition."""
    from repsurf_torch.ops.kernels.umbrella import (
        umbrella_fan_features_plain,
        umbrella_features_kernel,
    )

    args = dict(drop_self=style == "cls", rotate=style == "seg", style=style)
    x = xyz.detach().requires_grad_(True)
    out = umbrella_features_kernel(x, 9, **args)
    g = torch.randn(out.shape, generator=torch.Generator(xyz.device).manual_seed(4),
                    device=xyz.device)
    got = torch.autograd.grad(out, x, g)[0]
    want = torch.autograd.grad(umbrella_fan_features_plain(x, 9, **args), x, g)[0]
    torch.cuda.synchronize()
    rel = float((got - want).abs().max() / want.abs().max())
    print(f"  umbrella Function gradient vs the plain composition's "
          f"[{xyz.shape[0]}x{xyz.shape[1]},k=9,{style}]: max |d| / max |grad| {rel:.3g} "
          f"(limit {UMB_GRAD_RTOL})")
    if not torch.isfinite(got).all() or rel > UMB_GRAD_RTOL:
        raise AssertionError("umbrella gradient differs from the plain composition's")


def phase_train_kernels(stages):
    """The backward kernels and the row-grouping kernel at both SA stages'
    shapes, then ops/neighbors.ball_group driven forward and backward (the
    row kernel's entry point; no model calls it).  Returns the entries and
    the entry point's launch counts by channel count."""
    from repsurf_torch.ops.kernels.ball_group import ball_group_channels
    from repsurf_torch.ops.neighbors import ball_group

    print("train kernels: the backward and row-grouping kernels against their plain versions")
    st = {k: v.clone() for k, v in stages.items()}  # out of inference mode
    sa = ((0.2, 32, st["xyz1"], st["xyz2"], [st["normal1"]]),
          (0.4, 64, st["xyz2"], st["xyz3"], [st["normal2"], st["feat2"]]))
    entries = []
    for radius, nsample, xyz, q, rest in sa:
        tcat = torch.cat([xyz, *rest], dim=-1)
        entries.append(check_feature_backward(radius, nsample, xyz, q, tcat))
        entries += check_ball_rows(radius, nsample, xyz, q, tcat)
    check_scatter_global(xyz.device)
    check_umbrella_grad(st["xyz1"])

    ball_group_channels.launches_by_channels.clear()
    ball_group_channels.backward_launches_by_channels.clear()
    for radius, nsample, xyz, q, rest in sa:
        leaves = [t.detach().requires_grad_(True) for t in rest]
        grouped = ball_group(radius, nsample, xyz, q, [xyz, None, *leaves])
        torch.cat([grouped[0], *grouped[2:]], dim=-1).square().sum().backward()
        if any(t.grad is None for t in leaves):
            raise AssertionError("ops/neighbors.ball_group: no gradient reached its inputs")
    torch.cuda.synchronize()
    fwd = dict(ball_group_channels.launches_by_channels)
    bwd = dict(ball_group_channels.backward_launches_by_channels)
    print(f"  ops/neighbors.ball_group forward and backward at both stages: launches by C "
          f"{fwd}, backward {bwd}")
    return entries, fwd, bwd


def pnx_crops(dev, seed=7):
    """The cell s3dis_pnx_train's inputs at its size: 8 crops of 24,000
    points of 220,000-point rooms at 0.04 voxels (``seg_crop_train.crop``),
    with their valid counts, on the card."""
    from benchmark.data.synthetic_scene import raw_room
    from benchmark.traffic.seg_crop_train import crop

    rng = np.random.RandomState(seed)
    coord = np.stack([crop(rng, *raw_room(rng, PNX_RAW), PNX_POINTS, PNX_VOXEL)[0]
                      for _ in range(PNX_BATCH)])
    return (torch.from_numpy(coord).to(dev),
            torch.full((PNX_BATCH,), PNX_POINTS, dtype=torch.int32, device=dev))


def check_pnx_ball(tag, radius, xyz, q, channels, valid, gen):
    """A local aggregation's grouping as PointNeXt calls it
    (``ball_group_feature`` on [xyz, feat], the cloud's valid counts, no
    polar): dp, feat and the selection the kernel writes equal to the plain
    version's and ball_query's, bit for bit; the scatter backward into the
    channels as check_scatter holds it.  Returns the median hits a ball."""
    from repsurf_torch.ops.kernels.ball_group import (
        ball_group_feature,
        ball_group_feature_plain,
        ball_group_feature_selection,
    )
    from repsurf_torch.ops.neighbors import ball_query

    b, n, m = xyz.shape[0], xyz.shape[1], q.shape[1]
    feat = torch.randn((b, n, channels - 3), generator=gen, device=xyz.device)
    args = (radius, PNX_NSAMPLE, xyz, q, [xyz, feat])
    name = f"{tag} [{b}x{n}->{m},r={radius},S={PNX_NSAMPLE},C={channels}]"
    with torch.no_grad():
        pos, got, sel = ball_group_feature_selection(*args, valid=valid)
        ppos, pfeat = ball_group_feature_plain(*args, valid=valid)
        psel = ball_query(radius, PNX_NSAMPLE, xyz, q, valid=valid)
        torch.cuda.synchronize()
        if not torch.equal(sel, psel):
            raise AssertionError(f"{name}: the selection differs from ball_query's at "
                                 f"{int((sel != psel).sum())} slots")
        if not (torch.equal(got, pfeat) and torch.equal(pos, ppos)):
            raise AssertionError(f"{name}: dp or feat not bit-equal to the plain version")
        hits = (sel != sel[..., :1]).sum(-1) + 1
        del pos, got, ppos, pfeat, psel
    tcat = torch.cat([xyz, feat], dim=-1)
    leaf = tcat.requires_grad_(True)
    g = torch.randn((b, m, PNX_NSAMPLE, channels - 3), generator=gen, device=xyz.device)

    def backward():
        _, out = ball_group_feature(radius, PNX_NSAMPLE, xyz, q, [leaf], valid=valid)
        return torch.autograd.grad(out, leaf, g)[0]

    check_scatter(f"{name} backward", None, sel, g, n, 3, backward, timed=False)
    return float(hits.float().median())


def phase_pnx_kernels(dev):
    """PointNeXt-XL's kernels at the shapes of s3dis_pnx_train's step, on the
    cell's crops, each against its plain version: FPS 24,000 -> 6,000 ->
    1,500 -> 375 -> 93; the ball grouping and its scatter backward of each
    stage's set abstraction and of one of its blocks' self-queries; the
    decoder's 3-NN."""
    from repsurf_torch.ops.gather import index_points
    from repsurf_torch.ops.kernels.fps import fps, fps_plain
    from repsurf_torch.ops.kernels.knn import knn_plain
    from repsurf_torch.ops.neighbors import knn

    print("pointnext kernels: FPS, ball grouping and its backward, 3-NN at the cell's shapes")
    xyz, valid = pnx_crops(dev)
    gen = torch.Generator(dev).manual_seed(25)
    xyzs, valids = [xyz], [valid]
    for _ in range(4):  # the four set abstractions' FPS, stride 4
        n = xyzs[-1].shape[1]
        idx = fps(xyzs[-1], n // 4, valid=valids[-1])
        pidx = fps_plain(xyzs[-1], n // 4, valid=valids[-1])
        torch.cuda.synchronize()
        if not torch.equal(idx, pidx):
            raise AssertionError(f"fps [{PNX_BATCH}x{n}->{n // 4}]: indices differ at "
                                 f"{int((idx != pidx).sum())} slots")
        xyzs.append(index_points(xyzs[-1], idx))
        valids.append(valids[-1] // 4)
    print(f"  fps {' -> '.join(str(x.shape[1]) for x in xyzs)} (x{PNX_BATCH}, valid counts): "
          f"indices equal to fps_plain at each stage")
    widths = [PNX_WIDTH * 2 ** i for i in range(5)]
    for s in range(1, 5):
        r = PNX_RADIUS * 2 ** (s - 1)
        sa = check_pnx_ball(f"stage {s} set abstraction", r, xyzs[s - 1], xyzs[s],
                            widths[s - 1] + 3, valids[s - 1], gen)
        block = check_pnx_ball(f"stage {s} block", 2 * r, xyzs[s], xyzs[s], widths[s] + 3,
                               valids[s], gen)
        print(f"  stage {s}: set abstraction and block grouping, forward and backward, equal "
              f"to the plain versions; median hits a ball {sa:g} and {block:g} of "
              f"{PNX_NSAMPLE}")
        torch.cuda.empty_cache()
    for s in range(4, 0, -1):  # the decoder: stage s's points onto stage s - 1's
        idx, dist = knn(3, xyzs[s], xyzs[s - 1], valid=valids[s])
        pidx, pdist = knn_plain(3, xyzs[s], xyzs[s - 1], valid=valids[s])
        torch.cuda.synchronize()
        if not (torch.equal(idx, pidx) and torch.equal(dist, pdist)):
            raise AssertionError(f"3-NN [{PNX_BATCH}x{xyzs[s].shape[1]}->"
                                 f"{xyzs[s - 1].shape[1]}]: differs from knn_plain")
    pairs = ", ".join(f"{xyzs[s].shape[1]} -> {xyzs[s - 1].shape[1]}" for s in range(4, 0, -1))
    print(f"  3-NN of the decoder ({pairs}): indices and distances equal to knn_plain")
    del xyzs, valids
    torch.cuda.empty_cache()


def phase_cls_train(dev, profile=False):
    """One epoch and 8 timed steps of the classification trainer, then the
    kernel path against the plain path over one SGD step."""
    from repsurf_torch.data.scanobjectnn import SyntheticClouds, iterate_batches
    from repsurf_torch.nn.blocks import SharedMLP, SurfaceAbstractionCD
    from repsurf_torch.nn.layers import Linear, MaskedBatchNorm
    from repsurf_torch.ops.kernels.ball_group import ball_group_feature
    from repsurf_torch.ops.kernels.fps import fps
    from repsurf_torch.train.train_cls import (
        ClsConfig,
        build_model,
        make_optimizer,
        train_epoch,
        train_step,
    )
    from repsurf_torch.utils import epoch_generator

    cfg = ClsConfig()
    model = build_model(cfg, generator=torch.Generator().manual_seed(cfg.seed)).to(dev)
    n_params = sum(p.numel() for p in model.parameters())
    if n_params != CLS_PARAMS:
        raise AssertionError(f"repsurf_ssg_umb has {n_params} parameters, not {CLS_PARAMS}")
    opt = make_optimizer(model, cfg)
    data = SyntheticClouds(n_samples=8 * cfg.batch_size, seed=0)

    counters = (fps, ball_group_feature)
    for k in counters:
        k.launches = 0
    reset_umbrella_counts()
    ball_group_feature.launches_by_channels.clear()
    ball_group_feature.backward_launches_by_channels.clear()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    epoch_loss, epoch_acc = train_epoch(model, opt, data, cfg, 0, epoch_generator(cfg.seed, 0, dev),
                                        rng=np.random.RandomState(0))
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in counters}
    launches["umbrella_tq"] = umbrella_counts()[0]["umbrella_tq"]
    fwd_c = dict(ball_group_feature.launches_by_channels)
    bwd_c = dict(ball_group_feature.backward_launches_by_channels)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    print(f"cls train slice: repsurf_ssg_umb ({n_params} parameters), ClsConfig defaults, "
          f"{len(data)} clouds, train_epoch of {len(data) // cfg.batch_size} steps "
          f"(batch {cfg.batch_size}, {RAW_POINTS}->{cfg.num_point}): {epoch_s:.3f} s, "
          f"loss {epoch_loss}, acc {epoch_acc}; launches {launches}, ball_feature by C "
          f"{fwd_c}, backward by C {bwd_c}; peak memory {peak_gb:.2f} GiB")
    if (min(launches.values()) == 0 or any(d.get(c, 0) == 0 for d in (fwd_c, bwd_c)
                                           for c in (13, 141))):
        raise AssertionError("a kernel of the cls train path was not launched")

    gen = epoch_generator(cfg.seed, 1, dev)
    batches = [(torch.from_numpy(p).to(dev), torch.from_numpy(t).to(dev)) for p, t in
               iterate_batches(data, cfg.batch_size, shuffle=True, drop_last=True,
                               rng=np.random.RandomState(1))]
    step_ms, losses = [], []
    for points, target in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _ = train_step(model, opt, points, target, cfg, generator=gen)
        losses.append(float(loss))  # synchronises
        step_ms.append((time.perf_counter() - t0) * 1e3)
    med = statistics.median(step_ms)
    print(f"  train steps (host clock, synchronised): {[round(t, 3) for t in step_ms]} ms, "
          f"median {med:.3f} ms = {cfg.batch_size / (med / 1e3):.3f} clouds/s")
    print(f"  losses {losses}")
    if not all(math.isfinite(x) for x in [*losses, epoch_loss]):
        raise AssertionError("a cls train loss is not finite")

    # one SGD step from the same weights on the kernel path and the plain path
    sgd = dataclasses.replace(cfg, optimizer="SGD", learning_rate=0.01, momentum=0.0,
                              head_dropout=0.0)
    mk = build_model(sgd, generator=torch.Generator().manual_seed(0)).to(dev)
    mk.load_state_dict(model.state_dict())
    mp = copy.deepcopy(mk)
    pre = {k: p.detach().clone() for k, p in mk.named_parameters()}
    points, target = batches[0]
    sign = torch.where(torch.arange(BATCH, device=dev) % 3 == 0, -1.0, 1.0)
    train_step(mk, make_optimizer(mk, sgd), points, target, sgd, signs=sign)
    with plain_kernels():
        train_step(mp, make_optimizer(mp, sgd), points, target, sgd, signs=sign)
    # a Linear bias feeding a train-mode BN has an exact gradient of 0 (the
    # BN removes the batch mean): its update is rounding noise on both paths
    zero_grad = set()
    for name, mod in mk.named_modules():
        if isinstance(mod, torch.nn.Sequential):
            kids = list(mod.named_children())
            zero_grad |= {f"{name}.{a}.bias" for (a, la), (_, lb) in zip(kids, kids[1:])
                          if isinstance(la, Linear) and la.bias is not None
                          and isinstance(lb, MaskedBatchNorm)}
        if isinstance(mod, SharedMLP):
            zero_grad |= {f"{name}.mlp_convs.{j}.bias" for j in range(len(mod.mlp_convs))}
        if isinstance(mod, SurfaceAbstractionCD):
            zero_grad |= {f"{name}.mlp_l0.bias", f"{name}.mlp_f0.bias"}
    kp, pp = dict(mk.named_parameters()), dict(mp.named_parameters())
    upd = {k: (kp[k].detach() - pre[k], pp[k].detach() - pre[k]) for k in pre}
    scale = max(float(dp.abs().max()) for _, dp in upd.values())
    err = {k: float((dk - dp).abs().max()) for k, (dk, dp) in upd.items()}
    leaf = {k: float(dp.abs().max()) for k, (_, dp) in upd.items()}
    ratios = {k: err[k] / max(leaf[k], UPDATE_FLOOR * scale) for k in upd if k not in zero_grad}
    noise = max(max(float(dk.abs().max()), leaf[k])
                for k, (dk, _) in upd.items() if k in zero_grad) / scale
    worst = max(ratios, key=ratios.get)
    print(f"  kernel path vs plain path, one SGD step (lr 0.01, dropout 0, fixed sign): "
          f"worst max |d update| / max(max |plain update|, {UPDATE_FLOOR} of the largest) "
          f"{ratios[worst]:.3g} at {worst} (limit {UPDATE_RTOL}) over {len(ratios)} "
          f"parameters; the {len(zero_grad)} BN-fed biases (exact gradient 0) move at most "
          f"{noise:.3g} of the largest update {scale:.4g}")
    for k in sorted(ratios, key=lambda k: err[k] / max(leaf[k], 1e-30))[-3:]:
        print(f"    {k}: max |d update| {err[k]:.3g}, max |plain update| {leaf[k]:.3g}")
    if ratios[worst] > UPDATE_RTOL or noise > UPDATE_RTOL:
        raise AssertionError("the cls train step differs between kernel and plain paths")
    if profile:
        points, target = batches[1]
        profile_train_step(lambda: train_step(model, opt, points, target, cfg, generator=gen))
    return launches, fwd_c, bwd_c


def kernel_counts(step):
    """{kernel name: launches a step} and kernel seconds a step from a
    checked trace (spin-kernel pads, torn traces taken again) of
    GRAPH_TRACED calls of ``step``; copies and fills by the runtime left
    out."""
    rows, _ = checked_trace(step, GRAPH_TRACED)
    if rows is None:
        raise AssertionError("step graph: no whole trace of a train step")
    rows = [r for r in rows if not r[0].startswith(("Memcpy", "Memset"))]
    return ({name: count / GRAPH_TRACED for name, _, count in rows},
            sum(ms for _, ms, _ in rows) / 1e3 / GRAPH_TRACED)


def graph_side(dev, cfg, base, step, batches, gen_seed):
    """``step`` over ``batches`` from a copy of ``base`` with a fresh Adam
    and generator -> (model, optimizer, generator, [(loss, correct)], step
    ms, step_graph counts of these steps, their kernel launches by
    counter)."""
    from repsurf_torch.ops.kernels import launch_counts, launches_since
    from repsurf_torch.train import step_graph
    from repsurf_torch.train.train_cls import make_optimizer

    model = copy.deepcopy(base)
    opt = make_optimizer(model, cfg)
    gen = torch.Generator(dev).manual_seed(gen_seed)
    before = dict(step_graph.counts)
    launched = launch_counts()
    outs, ms = [], []
    for points, target in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs.append(step(model, opt, points, target, cfg, generator=gen))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    counts = {k: v - before[k] for k, v in step_graph.counts.items()}
    launches = {f"{o.__name__}.{a}": d for o, a, d in launches_since(launched)}
    return model, opt, gen, outs, ms, counts, launches


def graph_differences(a, b):
    """Tensors that differ between two sides of ``graph_side``: losses and
    counts, parameters, buffers, Adam's moments and step counts, and the
    generators' states."""
    (ma, oa, ga, outs_a), (mb, ob, gb, outs_b) = a[:4], b[:4]
    off = [f"step {i} {k}" for i, (x, y) in enumerate(zip(outs_a, outs_b))
           for k, u, v in (("loss", x[0], y[0]), ("correct", x[1], y[1]))
           if not torch.equal(u, v)]
    sb = mb.state_dict()
    off += [k for k, v in ma.state_dict().items() if not torch.equal(v, sb[k])]
    for (name, pa), pb in zip(ma.named_parameters(), mb.parameters()):
        sa, st = oa.state[pa], ob.state[pb]
        off += [f"{name}.{k}" for k in ("exp_avg", "exp_avg_sq", "step")
                if not torch.equal(sa[k], st[k])]
    if not torch.equal(ga.get_state(), gb.get_state()):
        off.append("generator")
    return off


def phase_step_graph(dev):
    """The classification train step replayed as a CUDA graph against the
    same steps run eagerly, for the three classifiers, bit for bit; the
    kernels a profiler trace records of replayed and of eager steps; a
    capture that fails (a host copy put back in the forward) leaving the
    key eager and the results unchanged."""
    from repsurf_torch.data.scanobjectnn import SyntheticClouds, iterate_batches
    from repsurf_torch.geometry import polar
    from repsurf_torch.train.train_cls import ClsConfig, build_model, eager_step, train_step

    print(f"step graph: torch {torch.__version__}, register_generator_state "
          f"{hasattr(torch.cuda.CUDAGraph, 'register_generator_state')}")
    data = SyntheticClouds(n_samples=GRAPH_STEPS * BATCH, seed=3)
    batches = [(torch.from_numpy(p).to(dev), torch.from_numpy(t).to(dev)) for p, t in
               iterate_batches(data, BATCH, shuffle=True, drop_last=True,
                               rng=np.random.RandomState(3))]
    bad = 0
    for name in GRAPH_MODELS:
        cfg = ClsConfig(model=name)
        base = build_model(cfg, generator=torch.Generator().manual_seed(cfg.seed)).to(dev)
        eager = graph_side(dev, cfg, base, eager_step, batches, 11)
        graph = graph_side(dev, cfg, base, train_step, batches, 11)
        off = graph_differences(eager, graph)
        bad += len(off)
        print(f"  {name}: {GRAPH_STEPS} steps, losses {[float(o[0]) for o in graph[3]]}; "
              f"step_graph {graph[5]}; eager ms {[round(t, 3) for t in eager[4]]}, graph ms "
              f"{[round(t, 3) for t in graph[4]]}; tensors differing from the eager steps "
              f"{len(off)} {off[:6]}; kernel launches counted, graphed {graph[6]}, eager "
              f"{'the same' if graph[6] == eager[6] else eager[6]}")
        if graph[5] != {"captures": 1, "replays": GRAPH_STEPS - 1, "eager": 1}:
            raise AssertionError(f"{name}: the step was not captured once and replayed")
        if graph[6] != eager[6] or not graph[6]:
            raise AssertionError(f"{name}: the launch counters of graphed steps differ from "
                                 f"those of the eager steps")
        if name != GRAPH_MODELS[0]:
            del eager, graph, base
            torch.cuda.empty_cache()
            continue
        # timed steps and a trace of each side, on the models just stepped
        timed = {}
        for label, (model, opt, gen) in (("eager", eager[:3]), ("graph", graph[:3])):
            step = eager_step if label == "eager" else train_step
            ms = []
            for i in range(GRAPH_TIMED):
                points, target = batches[i % len(batches)]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                float(step(model, opt, points, target, cfg, generator=gen)[0])
                ms.append((time.perf_counter() - t0) * 1e3)
            points, target = batches[0]
            traced = kernel_counts(
                lambda: step(model, opt, points, target, cfg, generator=gen))
            timed[label] = (statistics.median(ms), *traced)
        (e_ms, e_k, e_busy), (g_ms, g_k, g_busy) = timed["eager"], timed["graph"]
        diff = {n: (e_k.get(n, 0), g_k.get(n, 0)) for n in set(e_k) | set(g_k)
                if e_k.get(n, 0) != g_k.get(n, 0)}
        # a replay first fills the registered generator's seed and offset
        fills = [n for n, (e, g) in diff.items() if "FillFunctor<long>" in n and g - e == 2]
        print(f"  the replay's fills of the generator's seed and offset: {len(fills)} kernel")
        for n in fills:
            del diff[n]
        mine = [n for n in g_k if any(s in n for s in GRAPH_TRACE_KERNELS)]
        print(f"  timed ({GRAPH_TIMED} steps a side, synchronised, host clock): eager median "
              f"{e_ms:.3f} ms, graph median {g_ms:.3f} ms ({BATCH / (e_ms / 1e3):.1f} -> "
              f"{BATCH / (g_ms / 1e3):.1f} clouds/s); kernel seconds a step {e_busy:.6f} / "
              f"{g_busy:.6f}")
        print(f"  profiler, {GRAPH_TRACED} steps a side: {len(g_k)} kernels a replayed step "
              f"({sum(g_k.values()):.0f} launches), {len(e_k)} an eager step "
              f"({sum(e_k.values()):.0f}); counts that differ {diff}; the port's kernels in "
              f"the replay {len(mine)}: {sorted(n[:40] for n in mine)[:8]}")
        if diff or not all(any(s in n for n in g_k) for s in GRAPH_TRACE_KERNELS):
            raise AssertionError("a trace of replayed steps does not record the eager kernels")
        del eager, graph, base
        torch.cuda.empty_cache()

    # a capture that fails: a blocking host copy back in ieee_div
    cfg = ClsConfig()
    base = build_model(cfg, generator=torch.Generator().manual_seed(cfg.seed)).to(dev)
    real = polar.ieee_div
    polar.ieee_div = lambda x, c: x / torch.tensor(c, dtype=x.dtype, device=x.device)
    try:
        eager = graph_side(dev, cfg, base, eager_step, batches[:3], 12)
        with warnings.catch_warnings(record=True) as warned:
            warnings.simplefilter("always")
            graph = graph_side(dev, cfg, base, train_step, batches[:3], 12)
    finally:
        polar.ieee_div = real
    warned = [str(w.message) for w in warned if "runs eagerly" in str(w.message)]
    off = graph_differences(eager, graph)
    bad += len(off)
    print(f"  a host copy in the forward: step_graph {graph[5]}; tensors differing from the "
          f"eager steps {len(off)} {off[:6]}; launch counters as the eager steps' "
          f"{graph[6] == eager[6]}; warnings {len(warned)}: {[w[:120] for w in warned]}")
    if (graph[5] != {"captures": 0, "replays": 0, "eager": 3} or graph[6] != eager[6]
            or len(warned) != 1):
        raise AssertionError("a failed capture did not warn once and leave its key eager")
    again = graph_side(dev, cfg, base, train_step, batches[:3], 12)
    print(f"  then a fresh optimizer: step_graph {again[5]}")
    if again[5] != {"captures": 1, "replays": 2, "eager": 1}:
        raise AssertionError("no capture after a failed one")
    if bad:
        raise AssertionError(f"step graph: {bad} tensors differ from the eager steps")


def phase_cli():
    """The training CLI on the card, then its resume."""
    here = Path(__file__).resolve().parent
    with tempfile.TemporaryDirectory() as root:
        base = [sys.executable, "-m", "repsurf_torch.cli.train_cls", "--synthetic",
                "--min_val", "0", "--log_root", root, "--device", "cuda"]
        runs = []
        for epochs in (2, 3):
            t0 = time.perf_counter()
            proc = subprocess.run([*base, "--epoch", str(epochs)], cwd=here, capture_output=True,
                                  text=True, timeout=CLI_TIMEOUT)
            runs.append((proc, time.perf_counter() - t0))
            if proc.returncode != 0:
                raise AssertionError(f"train_cls --epoch {epochs} exited {proc.returncode}:\n"
                                     f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
            if epochs == 2:
                ckpt = Path(root) / "ScanObjectNN" / "default" / "checkpoints" / "best.pt"
                saved = torch.load(ckpt, map_location="cpu", weights_only=True)["epoch"]
    for proc, secs in runs:
        for line in proc.stdout.splitlines():
            if " epoch " in line or "single " in line or "resumed" in line:
                print("  cli: " + line.split("] ", 1)[-1])
    print(f"cli: two runs of python -m repsurf_torch.cli.train_cls --synthetic --min_val 0, "
          f"--epoch 2 then --epoch 3: {runs[0][1]:.1f} s and {runs[1][1]:.1f} s (process start "
          f"and data included); the best checkpoint holds epoch {saved}")
    resumed = runs[1][0].stdout
    if f"resumed from epoch {saved}" not in resumed or "epoch 3/3" not in resumed:
        raise AssertionError("the second CLI run did not resume from the checkpoint")


def phase_seg_cli():
    """The seg training CLI on the card at full width (repsurf_umb_ssg,
    SegConfig defaults, batches padded to 80,000 points, batch 2, two
    synthetic rooms, one step an epoch, validation every epoch): --epoch 2,
    then --epoch 3 resumed from the best checkpoint, then the test CLI
    serving a room from that checkpoint."""
    here = Path(__file__).resolve().parent
    with tempfile.TemporaryDirectory() as root:
        ckpt_dir = Path(root) / "S3DIS" / "default" / "checkpoints"
        base = [sys.executable, "-m", "repsurf_torch.cli.train_seg", "--synthetic",
                "--synthetic_rooms", "2", "--batch_size", "2", "--batch_size_val", "2", "--loop",
                "1", "--min_val", "0", "--voxel_max", str(SEG_POINTS), "--device", "cuda",
                "--log_root", root]
        runs = []
        for epochs, extra in ((2, []), (3, ["--resume", str(ckpt_dir)])):
            t0 = time.perf_counter()
            proc = subprocess.run([*base, "--epoch", str(epochs), *extra], cwd=here,
                                  capture_output=True, text=True, timeout=CLI_TIMEOUT)
            secs = time.perf_counter() - t0
            if proc.returncode != 0:
                raise AssertionError(f"train_seg --epoch {epochs} exited {proc.returncode}:\n"
                                     f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
            runs.append(([ln.split("] ", 1)[-1] for ln in proc.stdout.splitlines()], secs))
            if epochs == 2:
                saved = torch.load(ckpt_dir / "best.pt", map_location="cpu", weights_only=True)
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "repsurf_torch.cli.test_s3dis", "--synthetic",
             "--synthetic_rooms", "1", "--device", "cuda", "--log_root", root],
            cwd=here, capture_output=True, text=True, timeout=CLI_TIMEOUT)
        test_secs = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"test_s3dis on the seg checkpoint exited {proc.returncode}:\n"
                                 f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        served = [ln.split("] ", 1)[-1] for ln in proc.stdout.splitlines()]
    for (lines, secs), name in zip(runs, ("--epoch 2", "--epoch 3 --resume")):
        epochs = [ln for ln in lines if ln.startswith("train epoch ")]
        for ln in lines:
            if (ln.startswith(("train epoch", "val epoch", "restored", "best mIoU",
                               "kernel launches")) or " parameters on " in ln):
                print("  cli: " + ln)
        losses = [float(ln.split(" loss ", 1)[1].split()[0])
                  for ln in lines if ln.startswith(("train epoch", "val epoch"))]
        steps = [float(ln.split("step median ", 1)[1].split()[0]) for ln in epochs]
        print(f"  train_seg {name}: {secs:.1f} s (process start and data included), "
              f"{len(epochs)} epochs, train step median {statistics.median(steps) * 1e3:.3f} ms "
              f"(each epoch's: {[round(t * 1e3, 3) for t in steps]} ms)")
        if not losses or not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"train_seg {name}: a loss is not finite: {losses}")
        if not any(f"{SEG_PARAMS} parameters on cuda" in ln for ln in lines):
            raise AssertionError(f"train_seg {name}: not repsurf_umb_ssg at full width on cuda")
        launches = json.loads(next(ln for ln in lines if ln.startswith("kernel launches "))
                              [len("kernel launches "):])
        if (not sum(launches["fps"].values()) or not launches["knn_window"]
                or not sum(launches["knn_brute"].values())):
            raise AssertionError(f"train_seg {name}: the seg kernels were not launched")
    first, second = runs[0][0], runs[1][0]
    best = [int(ln.rsplit("(epoch ", 1)[1].split()[0]) for ln in first if "best mIoU ->" in ln]
    if not best or saved["epoch"] != best[-1]:
        raise AssertionError(f"the best checkpoint holds epoch {saved['epoch']}, the first run "
                             f"saved {best}")
    starts = [int(ln.split()[2].split("/")[0]) for ln in second if ln.startswith("train epoch")]
    if (not any(f"(epoch {saved['epoch']}, best" in ln for ln in second)
            or starts[0] != saved["epoch"] + 1 or starts[-1] != 3):
        raise AssertionError(f"the resumed run did not start after epoch {saved['epoch']}: "
                             f"{starts}")
    for ln in served:
        if "checkpoint restored" in ln or "mIoU/mAcc/OA" in ln:
            print("  cli: " + ln)
    if not any("checkpoint restored" in ln for ln in served) or not any(
            "mIoU/mAcc/OA" in ln for ln in served):
        raise AssertionError("test_s3dis did not serve from the seg checkpoint")
    print(f"seg cli: python -m repsurf_torch.cli.train_seg --synthetic --synthetic_rooms 2 "
          f"--batch_size 2 --loop 1 --min_val 0 --voxel_max {SEG_POINTS}, --epoch 2 then --epoch "
          f"3 --resume: {runs[0][1]:.1f} s and {runs[1][1]:.1f} s; the best checkpoint holds "
          f"epoch {saved['epoch']} and the resume trained epochs {starts}; test_s3dis from it "
          f"{test_secs:.1f} s")


def check_polar(xyz):
    """The normalising divisions of xyz2sphere are IEEE divisions on the
    card: for one division, rounding through float64 is exact."""
    from repsurf_torch.geometry.polar import xyz2sphere

    v = xyz - xyz.mean(dim=1, keepdim=True)
    raw, got = xyz2sphere(v, normalize=False), xyz2sphere(v)
    f32 = lambda c: torch.tensor(c, dtype=torch.float32).double().item()  # noqa: E731
    theta = (raw[..., 1].double() / f32(math.pi)).float()
    phi = (raw[..., 2].double() / f32(2 * math.pi)).float() + 0.5
    ok = torch.equal(got[..., 1], theta) and torch.equal(got[..., 2], phi)
    print(f"  polar division: theta and phi of {v.shape[0] * v.shape[1]} vectors bit-equal "
          f"to the float64-rounded IEEE quotient: {ok}")
    if not ok:
        raise AssertionError("xyz2sphere's normalising division is not IEEE on the card")


def check_seg_fps(xyz, npoint, valid=None, plain_timer=None):
    from repsurf_torch.ops.gather import index_points
    from repsurf_torch.ops.kernels.fps import fps, fps_plain

    idx, sam = fps(xyz, npoint, valid=valid, return_xyz=True)
    pidx = fps_plain(xyz, npoint, valid=valid)
    torch.cuda.synchronize()
    if not torch.equal(idx, pidx):
        raise AssertionError(f"fps {tuple(xyz.shape)}->{npoint}: indices differ at "
                             f"{int((idx != pidx).sum())} slots")
    if valid is None and not torch.equal(sam, index_points(xyz, idx)):
        raise AssertionError("fps: sampled xyz differ from the gather")
    b, n = xyz.shape[0], xyz.shape[1]
    nv = b * n if valid is None else int(valid.sum())  # the valid points are the work
    entry = _entry(
        f"fps[{b}x{n}->{npoint}]", FPS_SRC, FPS_TPU, 0.0,
        lambda: fps(xyz, npoint, valid=valid), lambda: fps_plain(xyz, npoint, valid=valid),
        (FPS_FLOPS * npoint * nv, 4 * (3 * nv + b * npoint)), timer=adaptive_ms,
        plain_timer=plain_timer,
    )
    return sam, fps_rounds(entry, xyz, npoint)


def window_candidates(k, xyz, q, valid, resolved):
    """The squared distances the window kernel evaluates in one call: for
    each query, the points of the clipped 3 x 3 x 3 block of cells around
    its own, plus a whole-cloud rescan for each re-solved query."""
    from repsurf_torch.ops.kernels.knn_window import window_tables

    t = window_tables(k, xyz, q, valid)
    b, gxy, gz = xyz.shape[0], t["gxy"], t["gz"]
    counts = torch.diff(t["starts"], dim=1).double().reshape(b, 1, gxy, gxy, gz)
    block = torch.nn.functional.avg_pool3d(counts, 3, stride=1, padding=1,
                                           count_include_pad=True)[:, 0] * 27
    shape = torch.tensor([gxy - 1, gxy - 1, gz - 1], device=xyz.device)
    cell = torch.floor((q - t["lo"][:, None]) / t["cs"][:, None]).long()
    cell = torch.minimum(torch.clamp(cell, min=0), shape)
    per_q = block[torch.arange(b, device=xyz.device)[:, None], cell[..., 0], cell[..., 1],
                  cell[..., 2]]
    nv = t["starts"][:, -1].double()
    return int(torch.round(per_q.sum() + (resolved.double() * nv).sum()))


def window_split(name, k, xyz, q):
    """The window call's three steps timed apart: window_tables, the window
    pass and the re-solve pass, each by CUDA events (median), and the
    call's device time by kernel.  Returns the dict it prints."""
    from repsurf_torch.ops.kernels.knn_window import (
        knn_window,
        window_pass,
        window_resolve,
        window_tables,
    )

    t = window_tables(k, xyz, q)
    outs = window_pass(k, q, t)
    dev = device_split(lambda: knn_window(k, xyz, q),
                       {"pass": "knn_window_kernel", "resolve": "knn_resolve_kernel"})
    split = {"tables_ms": median_ms(lambda: window_tables(k, xyz, q)),
             "pass_ms": median_ms(lambda: window_pass(k, q, t)),
             "resolve_ms": median_ms(lambda: window_resolve(k, q, t, *outs)),
             "tables_device_ms": dev["other"], "pass_device_ms": dev["pass"],
             "resolve_device_ms": dev["resolve"]}
    print(f"    {name}: window_tables {split['tables_ms']:.4f} ms, window pass "
          f"{split['pass_ms']:.4f} ms, re-solve pass {split['resolve_ms']:.4f} ms (CUDA events); "
          f"device time (profiler) window pass {dev['pass']:.4f} ms, re-solve pass "
          f"{dev['resolve']:.4f} ms, the rest (tables) {dev['other']:.4f} ms")
    return split


def check_knn(kind, k, xyz, q, valid=None, lanes=None, plain_timer=None):
    """One kNN kernel against knn_plain (indices and distances equal), with
    its kernels-JSON entry; the window's re-solved queries per sample held
    to RESOLVE_LIMIT and its call split into its steps; ``lanes`` forces a
    brute route."""
    from repsurf_torch.ops.kernels import knn as knn_mod
    from repsurf_torch.ops.kernels.knn import knn_brute, knn_plain
    from repsurf_torch.ops.kernels.knn_window import knn_window

    b, n, m = xyz.shape[0], xyz.shape[1], q.shape[1]
    if kind == "knn_window":
        fn = knn_window
    else:
        lanes = lanes or knn_mod.brute_lanes(b * m, k, knn_mod._sm_count(xyz.device.index))
        fn = functools.partial(knn_brute, lanes=lanes)
    idx, dist = fn(k, xyz, q, valid=valid)
    pidx, pdist = knn_plain(k, xyz, q, valid=valid)
    torch.cuda.synchronize()
    name = f"{kind}[{b}x{n}->{m},k={k}{',thread' if lanes == 1 else ''}]"
    if not torch.equal(idx, pidx):
        raise AssertionError(f"{name}: indices differ at {int((idx != pidx).sum())} slots")
    err = float((dist - pdist).abs().max())
    if err != 0.0:
        raise AssertionError(f"{name}: distances differ by up to {err}")
    resolved = knn_window.resolved.tolist() if kind == "knn_window" else None
    if resolved is not None:
        print(f"  {name}: indices and distances equal; re-solved queries per sample {resolved} "
              f"(limit {RESOLVE_LIMIT})")
        if max(resolved) > RESOLVE_LIMIT:
            raise AssertionError(f"{name}: the window guard re-solved {resolved} queries per "
                                 f"sample, above {RESOLVE_LIMIT}")
    pairs = b * m * n if resolved is None else window_candidates(k, xyz, q, valid,
                                                                 knn_window.resolved)
    entry = _entry(name, WINDOW_SRC if kind == "knn_window" else KNN_SRC,
                   WINDOW_TPU if kind == "knn_window" else KNN_TPU, err,
                   lambda: fn(k, xyz, q, valid=valid), lambda: knn_plain(k, xyz, q, valid=valid),
                   (KNN_FLOPS * pairs, 4 * (3 * b * n + 3 * b * m + 2 * b * m * k)),
                   timer=adaptive_ms, plain_timer=plain_timer)
    if resolved is not None:
        entry["resolved_per_sample"] = resolved
        entry.update(window_split(name, k, xyz, q))
    else:
        entry.update(lanes=lanes, variant="thread" if lanes == 1 else "split",
                     plain_device_ms=device_ms(lambda: knn_plain(k, xyz, q, valid=valid)))
        print(f"    {name}: {'one thread' if lanes == 1 else f'{lanes} lanes'} a query; device "
              f"time (profiler) {entry['device_ms']:.4f} ms, plain version "
              f"{entry['plain_device_ms']:.4f} ms")
    return entry


def check_resolve(name, k, xyz, q, resolved_per_sample):
    """The re-solve kernel's own entry at one window shape: its time on
    the window pass's list against knn_plain over the listed queries."""
    from repsurf_torch.ops.kernels.knn import knn_plain
    from repsurf_torch.ops.kernels.knn_window import window_pass, window_resolve, window_tables

    t = window_tables(k, xyz, q)
    outs = window_pass(k, q, t)
    idx, dist, resolved, fails, _ = outs
    window_resolve(k, q, t, *outs)
    counts = resolved.tolist()
    listed = [(s, fails[s, :c].long()) for s, c in enumerate(counts) if c]
    torch.cuda.synchronize()
    if counts != resolved_per_sample:
        raise AssertionError(f"{name}: re-solved {counts}, the whole call {resolved_per_sample}")
    for s, rows in listed:
        pidx, pdist = knn_plain(k, xyz[s:s + 1], q[s:s + 1, rows])
        if not (torch.equal(idx[s:s + 1, rows], pidx) and torch.equal(dist[s:s + 1, rows], pdist)):
            raise AssertionError(f"{name}: a re-solved row differs from knn_plain")
    nv, total = xyz.shape[1], sum(counts)
    entry = _entry(name, WINDOW_SRC, WINDOW_TPU, 0.0,
                   lambda: window_resolve(k, q, t, *outs),
                   lambda: [knn_plain(k, xyz[s:s + 1], q[s:s + 1, rows]) for s, rows in listed],
                   # the listed queries against every valid point; the cloud
                   # in once, the listed rows out
                   (KNN_FLOPS * total * nv, 4 * (4 * xyz.shape[0] * nv + total * (3 + 2 * k))))
    entry["resolved_per_sample"] = counts
    print(f"    {name}: re-solved rows equal to knn_plain; device time (profiler) "
          f"{entry['device_ms']:.4f} ms")
    return entry


def check_brute_routes(dev, xyz):
    """Brute kNN on every route (1, 8, 16 and 32 lanes a query) at small M,
    each torch.equal to knn_plain: B = 2, M in {1, 17, 312}, k in {3, 32,
    256}, over the seg stage's 1,250-point cloud and over a cloud of every
    point twice (ties), each with every point valid and with valid =
    [N, 200] (k > valid at k = 256)."""
    from repsurf_torch.ops.kernels.knn import LANES, knn_brute, knn_plain

    n = xyz.shape[1]
    dup = torch.cat([xyz[:, :n // 2], xyz[:, :n // 2]], dim=1).contiguous()
    cases = 0
    for cloud_name, cloud in (("the 1,250-point cloud", xyz), ("every point twice", dup)):
        for m in (1, 17, 312):
            q = cloud[:, -m:].contiguous()
            for k in (3, 32, 256):
                for valid in (None, torch.tensor([n, 200], device=dev)):
                    want = knn_plain(k, cloud, q, valid=valid)
                    for lanes in LANES:
                        got = knn_brute(k, cloud, q, valid=valid, lanes=lanes)
                        torch.cuda.synchronize()
                        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
                            raise AssertionError(
                                f"knn brute {lanes} lanes [2x{n}->{m},k={k}] on {cloud_name}, "
                                f"valid {None if valid is None else valid.tolist()}: differs "
                                f"from knn_plain")
                        cases += 1
    print(f"  knn brute at small M: {cases} calls (M in (1, 17, 312), k in (3, 32, 256), valid "
          f"N and [N, 200], duplicates, lanes {LANES}) equal to knn_plain")


def brute_route_sweep(shapes):
    """Device time (torch.profiler) of brute kNN on every route at each
    (name, k, xyz, q), beside the route brute_lanes picks: the measurement
    behind its threshold."""
    from repsurf_torch.ops.kernels import knn as knn_mod
    from repsurf_torch.ops.kernels.knn import LANES, knn_brute

    print("  knn brute routes, device time (profiler) by lanes a query:")
    for name, k, xyz, q in shapes:
        b, m = xyz.shape[0], q.shape[1]
        times = {lanes: device_ms(lambda: knn_brute(k, xyz, q, lanes=lanes)) for lanes in LANES}
        pick = knn_mod.brute_lanes(b * m, k, knn_mod._sm_count(xyz.device.index))
        best = min(times, key=times.get)
        print(f"    {name} [{b}x{xyz.shape[1]}->{m},k={k}], B*M {b * m}: "
              + ", ".join(f"{lanes}: {ms:.4f} ms" for lanes, ms in times.items())
              + f"; picked {pick} ({times[pick] / times[best]:.2f} x the best, {best})")


def check_large_fps(dev):
    """FPS on the stream route at [1, 150,000] -> 2,048 and [2, 400,000] ->
    1,024 (synthetic rooms), equal to fps_plain, with its entries."""
    from repsurf_torch.data.synthetic_scene import synthetic_room

    rng = np.random.RandomState(3)
    entries = []
    for b, n, npoint, size in FPS_LARGE:
        xyz = torch.from_numpy(np.stack([synthetic_room(n, size=size, rng=rng)
                                         for _ in range(b)])).to(dev)
        _, e = check_seg_fps(xyz, npoint)
        e["fps_route"] = "stream"
        entries.append(e)
    return entries


def check_adversarial_window(dev):
    """Dense blobs, far outliers, every point twice (ties), queries past the
    bounding box, valid < N: the window kernel held to brute force."""
    from repsurf_torch.ops.kernels.knn import knn_plain
    from repsurf_torch.ops.kernels.knn_window import knn_window

    g = np.random.RandomState(1)
    clouds, queries = [], []
    for _ in range(2):
        centers = g.uniform(-5.0, 5.0, (4, 3))
        blobs = centers[g.randint(0, 4, 9800)] + g.randn(9800, 3) * 0.05
        outliers = g.uniform(-1.0, 1.0, (200, 3)) * 1000.0
        base = np.concatenate([blobs, outliers])
        clouds.append(np.concatenate([base, base]))
        queries.append(np.concatenate([
            base[g.choice(len(base), 2000, replace=False)],
            g.uniform(-1.0, 1.0, (500, 3)) * 3000.0,  # mostly past the bounding box
            centers[g.randint(0, 4, 500)] + g.randn(500, 3) * 0.5,
        ]))
    xyz = torch.from_numpy(np.stack(clouds).astype(np.float32)).to(dev)
    q = torch.from_numpy(np.stack(queries).astype(np.float32)).to(dev)
    valid = torch.tensor([20000, 15000], device=dev)
    idx, dist = knn_window(16, xyz, q, valid=valid)
    pidx, pdist = knn_plain(16, xyz, q, valid=valid)
    torch.cuda.synchronize()
    ok = torch.equal(idx, pidx) and torch.equal(dist, pdist)
    print(f"  adversarial window case [2x20000->3000,k=16, valid {valid.tolist()}]: "
          f"equal to brute force {ok}; re-solved per sample {knn_window.resolved.tolist()} "
          f"(exempt from the limit of {RESOLVE_LIMIT}: it forces re-solves)")
    if not ok:
        raise AssertionError("window kNN differs from brute force on the adversarial case")


def phase_seg_kernels(dev):
    from repsurf_torch.data.synthetic_scene import synthetic_room
    from repsurf_torch.ops.sector import sector_buffers

    print("seg kernels: each against its plain version on the card, at the seg step's shapes")
    rng = np.random.RandomState(0)
    room = torch.from_numpy(
        np.stack([synthetic_room(SEG_POINTS, rng=rng) for _ in range(SEG_BATCH)])
    ).to(dev)
    entries = []
    with torch.inference_mode():
        check_polar(room)
        xyz20, e = check_seg_fps(room, SEG_POINTS // 4)  # eval: no sectors
        entries.append(e)
        sec, counts, _, _ = sector_buffers(room, 4)  # training stage 1
        _, e = check_seg_fps(sec.reshape(-1, *sec.shape[2:]), 5003, valid=counts.reshape(-1))
        entries.append(e)
        xyz5, e = check_seg_fps(xyz20, 5000)
        entries.append(e)
        xyz1250, e = check_seg_fps(xyz5, 1250)
        entries.append(e)
        xyz312, e = check_seg_fps(xyz1250, 312)
        entries.append(e)
        check_fps_edges(dev)
        entries += check_large_fps(dev)
        window = {}
        for kind, k, p, q in (
            ("knn_window", 9, room, room),  # umbrella
            ("knn_window", 32, room, xyz20),  # SA1
            ("knn_window", 32, xyz20, xyz5),  # SA2
            ("knn_window", 3, xyz20, room),  # FP1
            ("knn", 32, xyz5, xyz1250),  # SA3
            ("knn", 32, xyz1250, xyz312),  # SA4
            ("knn", 3, xyz312, xyz1250),  # FP4
            ("knn", 3, xyz1250, xyz5),  # FP3
            ("knn", 3, xyz5, xyz20),  # FP2
        ):
            entries.append(check_knn(kind, k, p, q))
            if kind == "knn_window" and k == 32:
                window[entries[-1]["name"]] = (k, p, q, entries[-1])
        # the thread route beside the split one at SA4's shape
        entries.append(check_knn("knn", 32, xyz1250, xyz312, lanes=1))
        check_brute_routes(dev, xyz1250)
        brute_route_sweep((("SA3", 32, xyz5, xyz1250), ("SA4", 32, xyz1250, xyz312),
                           ("FP4", 3, xyz312, xyz1250), ("FP3", 3, xyz1250, xyz5),
                           ("FP2", 3, xyz5, xyz20), ("20k self", 32, xyz20, xyz20),
                           ("80k from 20k", 3, xyz20, room)))
        for name, (k, p, q, e) in window.items():
            entries.append(check_resolve(name.replace("knn_window", "knn_window_resolve"), k, p,
                                         q, e["resolved_per_sample"]))
        sa1 = next(e for e in entries if e["name"].startswith("knn_window[2x80000->20000"))
        print(f"  SA1 window call: re-solve pass {sa1['resolve_device_ms']:.4f} ms of device "
              f"time against the window pass's {sa1['pass_device_ms']:.4f} ms")
        if math.isnan(sa1["resolve_device_ms"] + sa1["pass_device_ms"]):
            print("  SA1 window call: device time not measured, the passes compared by CUDA events "
                  f"(re-solve {sa1['resolve_ms']:.4f} ms, window pass {sa1['pass_ms']:.4f} ms)")
            if not sa1["resolve_ms"] < sa1["pass_ms"]:
                raise AssertionError("SA1: the re-solve pass took longer than the window pass")
        elif not sa1["resolve_device_ms"] < sa1["pass_device_ms"]:
            raise AssertionError("SA1: the re-solve pass took more device time than the window "
                                 "pass")
        check_adversarial_window(dev)
    return entries


def profile_train_step(step):
    """torch.profiler table of one train step (after the timed ones)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    print(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=25))


def phase_seg_slice(dev, profile=False):
    from repsurf_torch.cli.common import seg_batch
    from repsurf_torch.data.s3dis import CLASS_WEIGHTS
    from repsurf_torch.ops.kernels.fps import fps
    from repsurf_torch.ops.kernels.knn import knn_brute
    from repsurf_torch.ops.kernels.knn_window import knn_window
    from repsurf_torch.train.train_seg import (
        SegConfig,
        build_model,
        eval_step,
        make_optimizer,
        train_step,
    )

    n, b = SEG_POINTS, SEG_BATCH
    cfg = SegConfig()
    model = build_model(cfg, generator=torch.Generator().manual_seed(cfg.seed)).to(dev)
    n_params = sum(p.numel() for p in model.parameters())
    if abs(n_params / 1e6 - 0.976) >= 0.01:
        raise AssertionError(f"repsurf_umb_ssg has {n_params} parameters, not 0.976 M")
    opt = make_optimizer(model, cfg)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in seg_batch(n, b).items()}
    w = torch.tensor(CLASS_WEIGHTS[5], dtype=torch.float32, device=dev)
    gen = torch.Generator(dev).manual_seed(1)

    counters = (fps, knn_window, knn_brute)
    for c in counters:
        c.launches = 0
    fps.launches_by_route.clear()
    knn_brute.launches_by_route.clear()
    knn_window.resolve_launches = 0
    torch.cuda.reset_peak_memory_stats()
    step_ms, losses = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _ = train_step(model, opt, batch, w, cfg, generator=gen)
        losses.append(float(loss))  # synchronises
        step_ms.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eval_loss, pred, _ = eval_step(model, batch, w, cfg)
    eval_loss = float(eval_loss)
    eval_ms = (time.perf_counter() - t0) * 1e3
    launches = {c.__name__: c.launches for c in counters}
    launches["knn_window_resolve"] = knn_window.resolve_launches
    routes = dict(fps.launches_by_route)
    brute_routes = dict(knn_brute.launches_by_route)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    print(f"seg slice: repsurf_umb_ssg ({n_params} parameters), batch {b} x {n} points, "
          f"3 train steps + 1 eval step; launches {launches}, fps by route {routes}, knn_brute "
          f"by route {brute_routes}; peak memory {peak_gb:.2f} GiB")
    if (min(launches.values()) == 0 or routes.get("cluster", 0) == 0
            or brute_routes.get("split", 0) == 0):
        raise AssertionError("a kernel of the seg path was not launched in the slice")
    launches.update({f"knn_brute_{r}": c for r, c in brute_routes.items()})
    print(f"  losses {losses}, eval loss {eval_loss}")
    if not all(math.isfinite(x) for x in [*losses, eval_loss]):
        raise AssertionError("a seg loss is not finite")
    if pred.shape != (b, n) or not ((pred >= 0) & (pred < cfg.num_class)).all():
        raise AssertionError("seg predictions out of range or of the wrong shape")

    with torch.no_grad():
        model.eval()
        args = (batch["coord"], batch["feat"], batch["valid"])
        logits = model(*args)
        with plain_kernels():
            plain_logits = model(*args)
        live = torch.arange(n, device=dev)[None, :] < batch["valid"][:, None]
        err = float((logits - plain_logits).abs()[live].max())
    print(f"  kernel path vs plain path, one eval forward: max |d logit| {err:.3g} "
          f"(limit {SEG_LOGIT_ATOL})")
    if not torch.isfinite(logits[live]).all() or err > SEG_LOGIT_ATOL:
        raise AssertionError("seg kernel path and plain path disagree")
    med = statistics.median(step_ms)
    print(f"  train step (host clock, synchronised): {[round(t, 3) for t in step_ms]} ms, "
          f"median {med:.3f} ms = {b / (med / 1e3):.3f} scenes/s; eval step {eval_ms:.3f} ms")
    if profile:
        profile_train_step(lambda: train_step(model, opt, batch, w, cfg, generator=gen))
    return launches


def phase_umbrella(dev, xyz1):
    """The three umbrella kernels against the plain composition at the cls
    shape (both C) and at a small room's pass, full and the slab's live
    rows bit-equal to tq, each timed tq beside its scan floor, full's block
    sweep, the slab's call split and its re-solve pass alone, the seg-style
    gradient; then the kernel entry driven with impl full and slab at both
    shapes (no model reaches them, as in the JAX package), the path their
    launch counts are read from."""
    from repsurf_torch.data.synthetic_scene import synthetic_room
    from repsurf_torch.ops.kernels.umbrella import umbrella_features_kernel

    print("umbrella kernels: tq, full and slab against the plain composition")
    rng = np.random.RandomState(5)
    seg = np.stack([synthetic_room(SEG_ROOM_POINTS, size=SEG_ROOM_SIZE, rng=rng)
                    for _ in range(2)])
    seg = torch.from_numpy(seg - seg.mean(axis=1, keepdims=True)).to(dev)
    valid = torch.tensor([SEG_ROOM_POINTS, R2_POINTS], device=dev)

    def live(xyz, v):
        b, n = xyz.shape[0], xyz.shape[1]
        if v is None:
            return torch.ones((b, n), dtype=torch.bool, device=xyz.device)
        return torch.arange(n, device=xyz.device)[None] < v[:, None]

    entries = []
    with torch.inference_mode():
        near = {"cls": umbrella_near_ties(xyz1, 9, "cls"),
                "seg": umbrella_near_ties(seg, 9, "seg", valid)}
        for style, xyz, v in (("cls", xyz1, None), ("seg", seg, valid)):
            args = dict(drop_self=style == "cls", rotate=style == "seg", return_dist=True,
                        style=style, valid=v)
            outs, got = {}, {}
            for impl in ("tq", "full", "slab"):
                outs[impl], got[impl] = check_umbrella(impl, xyz, style, valid=v,
                                                       near=near[style])
                entries.append(got[impl])
            rows = live(xyz, v)
            same = (torch.equal(outs["full"], outs["tq"]),
                    torch.equal(outs["slab"][rows], outs["tq"][rows]))
            print(f"  {style}: full bit-equal to tq: {same[0]}; the slab's live rows bit-equal "
                  f"to tq: {same[1]}")
            if not all(same):
                raise AssertionError(f"umbrella {style}: full or slab differs from tq")
            got["full"]["warps_device_ms"] = full_sweep(got["full"]["name"], xyz, 9, args,
                                                        outs["tq"], got["tq"]["device_ms"])
            got["slab"].update(slab_split(got["slab"]["name"], xyz, 9, args))
            e = check_slab_resolve(got["slab"]["name"].replace("umbrella_slab",
                                                               "umbrella_slab_resolve"),
                                   xyz, 9, args, near[style])
            e.update(impl="slab_resolve", style=style)
            entries.append(e)
            if style == "cls":
                want, e = check_umbrella("tq", xyz, style, return_dist=False, near=near[style])
                full9 = umbrella_features_kernel(xyz, 9, drop_self=True, return_dist=False,
                                                 impl="full")
                if not torch.equal(full9, want):
                    raise AssertionError("umbrella cls C=9: full differs from tq")
                entries.append(e)
        # other k (the 17-long list too) and samples with fewer valid points
        # than k, at a small shape, untimed
        small = torch.from_numpy(
            (np.random.RandomState(6).rand(4, 768, 3) * 2 - 1).astype(np.float32)).to(dev)
        few = torch.tensor([768, 700, 8, 5], device=dev)
        for k, style, dist, impls in ((5, "cls", True, ("tq", "full", "slab")),
                                      (13, "cls", True, ("tq", "full", "slab")),
                                      (14, "cls", False, ("tq", "full", "slab")),
                                      (12, "seg", True, ("tq", "full", "slab")),
                                      (17, "cls", True, ("tq",)), (16, "seg", False, ("tq",))):
            near_k = umbrella_near_ties(small, k, style, few)
            got = [check_umbrella(impl, small, style, return_dist=dist, valid=few, near=near_k,
                                  k=k, timed=False)[0] for impl in impls]
            rows = live(small, few)
            if len(got) > 1 and not (torch.equal(got[0], got[1])
                                     and torch.equal(got[2][rows], got[0][rows])):
                raise AssertionError(f"umbrella k={k} {style}: full or slab differs from tq")
        print("  small shapes (k in 5, 13, 14, 12, 17, 16; valid 8 and 5): full and the slab's "
              "live rows bit-equal to tq")
    check_umbrella_grad(seg, "seg")

    reset_umbrella_counts()
    with torch.inference_mode():
        for impl in ("full", "slab"):
            umbrella_features_kernel(xyz1, 9, drop_self=True, impl=impl)
            umbrella_features_kernel(seg, 9, rotate=True, style="seg", valid=valid, impl=impl)
    torch.cuda.synchronize()
    counts = umbrella_counts()[0]
    print(f"  umbrella_features_kernel driven with impl full and slab at both shapes: "
          f"launches {counts}")
    if min(counts[f"umbrella_{impl}"] for impl in ("full", "slab", "slab_resolve")) == 0:
        raise AssertionError("a full or slab umbrella kernel was not launched")
    return entries, counts


def labeled_room(n, size, rng):
    """A synthetic room's coordinates, random RGB 0..255 and the geometric
    labels of label_room."""
    from repsurf_torch.data.synthetic_scene import label_room, synthetic_room

    coord = synthetic_room(n, size=size, rng=rng)
    return coord, rng.uniform(0.0, 255.0, (n, 3)).astype(np.float32), label_room(coord, size)


def phase_scene(dev):
    """Whole-scene inference of repsurf_umb_ssg at full width, seeded random
    weights: predict_scene's device mode and the median filter on R1 (the
    JAX test CLI's synthetic room) and R2 (a small room whose passes take
    the seg-style umbrella kernel); device against host mode; one R2 batch
    on the kernel path against the plain path; then the test CLI."""
    from repsurf_torch.data.s3dis import pad_batch
    from repsurf_torch.ops.kernels.chunk_mean import chunk_mean
    from repsurf_torch.ops.kernels.fps import fps
    from repsurf_torch.ops.kernels.knn import knn_brute
    from repsurf_torch.ops.kernels.knn_window import knn_window
    from repsurf_torch.train.eval_s3dis import (
        chunk_scene,
        device_batches,
        median_filter,
        padded_size,
        scene_votes,
        voxel_passes,
    )
    from repsurf_torch.train.train_seg import SegConfig, build_model

    cfg = SegConfig()
    model = build_model(cfg, generator=torch.Generator().manual_seed(cfg.seed)).to(dev).eval()

    def forward_fn(batch):
        with torch.no_grad():
            return model(batch["coord"], batch["feat"], batch["valid"])

    rng = np.random.RandomState(7)
    rooms = {"R1": labeled_room(R1_POINTS, (8.0, 8.0, 3.0), rng),
             "R2": labeled_room(R2_POINTS, SEG_ROOM_SIZE, rng)}
    kw = dict(voxel_size=0.04, voxel_max=SEG_POINTS, batch_size=4, data_norm="mean", seed=1000)
    counters = (fps, knn_window, knn_brute, chunk_mean)
    launches = {}
    for name, (coord, rgb, _) in rooms.items():
        chunks = chunk_scene(coord, rgb, voxel_passes(coord, kw["voxel_size"]),
                             kw["voxel_max"], kw["data_norm"], seed=kw["seed"])
        n_pad = padded_size([len(c) for c in chunks[1]], kw["voxel_max"])
        for c in counters:
            c.launches = 0
        reset_umbrella_counts()
        device_batches.crops.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        votes = scene_votes(forward_fn, coord, rgb, cfg.num_class, accumulate="device",
                            device=dev, **kw)
        pred = votes.argmax(dim=1).cpu().numpy()
        t_pred = time.perf_counter() - t0
        window_before = knn_window.launches
        filtered = median_filter(coord, pred, 32, device=dev)
        t_all = time.perf_counter() - t0
        counts = {c.__name__: c.launches for c in counters}
        by_impl, by_style = umbrella_counts()
        counts.update(by_impl)
        filter_window = knn_window.launches - window_before
        print(f"scene {name}: {len(coord)} points, {len(chunks[0])} chunks padded to {n_pad}: "
              f"predict_scene (device votes) {t_pred:.3f} s, with the median filter "
              f"{t_all:.3f} s (host clock); launches {counts}, umbrella by style {by_style}, "
              f"window kNN in the median filter {filter_window}; crops by where they were "
              f"cut {dict(device_batches.crops)}")
        launches[name] = dict(counts, umbrella_seg=by_style["seg"])
        if not torch.isfinite(votes).all() or pred.shape != (len(coord),):
            raise AssertionError(f"{name}: votes not finite or of the wrong shape")
        if not ((filtered >= 0) & (filtered < cfg.num_class)).all():
            raise AssertionError(f"{name}: median-filtered labels out of range")
        if (by_style["seg"] > 0) != (name == "R2"):
            raise AssertionError(f"{name}: seg-style umbrella kernel launches {by_style['seg']}")
        if name == "R1" and (filter_window == 0 or min(counts[c.__name__] for c in counters) == 0):
            raise AssertionError("R1: a kernel of the scene path was not launched")
        host = scene_votes(forward_fn, coord, rgb, cfg.num_class, accumulate="host",
                           device=dev, **kw)
        top2 = np.sort(host, axis=1)[:, -2:]
        tie = (top2[:, 1] - top2[:, 0]) < VOTE_TIE
        differ = pred != host.argmax(1)
        print(f"  {name}: device-mode labels against host-mode labels: {int(differ.sum())} "
              f"differ, {int(tie.sum())} points with the top two vote averages within "
              f"{VOTE_TIE}")
        if (differ & ~tie).any():
            raise AssertionError(f"{name}: device and host votes disagree away from ties")

    # one R2 batch, kernel path against plain path
    coord, rgb, _ = rooms["R2"]
    idx_list, coord_list, feat_list = chunk_scene(coord, rgb, voxel_passes(coord, 0.04),
                                                  kw["voxel_max"], "mean", seed=kw["seed"])
    n_pad = padded_size([len(c) for c in coord_list], kw["voxel_max"])
    batch = pad_batch([(c, f, None) for c, f in zip(coord_list[:4], feat_list[:4])], n_pad)
    batch = {k: torch.from_numpy(batch[k]).to(dev) for k in ("coord", "feat", "valid")}
    logits = forward_fn(batch)
    with plain_kernels():
        plain = forward_fn(batch)
    live = torch.arange(n_pad, device=dev)[None] < batch["valid"][:, None]
    near = umbrella_near_ties(batch["coord"], 9, "seg", batch["valid"]) & live
    err = float((logits - plain).abs()[live & ~near].max())
    print(f"  R2 batch [{batch['coord'].shape[0]}x{n_pad}], kernel path vs plain path: max "
          f"|d logit| {err:.3g} away from {int(near.sum())} azimuth near-tie points "
          f"(limit {SEG_LOGIT_ATOL})")
    if not torch.isfinite(logits[live]).all() or err > SEG_LOGIT_ATOL:
        raise AssertionError("R2: kernel path and plain path disagree")
    if int(near.sum()) > NEAR_TIE_SHARE * int(live.sum()):
        raise AssertionError("R2: near-tie points exceed 0.1%")

    here = Path(__file__).resolve().parent
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "repsurf_torch.cli.test_s3dis", "--synthetic",
             "--synthetic_rooms", "1", "--filter", "--device", "cuda", "--log_root", root],
            cwd=here, capture_output=True, text=True, timeout=CLI_TIMEOUT)
        secs = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"test_s3dis exited {proc.returncode}:\n{proc.stdout[-3000:]}\n"
                             f"{proc.stderr[-3000:]}")
    result = [ln.split("] ", 1)[-1] for ln in proc.stdout.splitlines() if "scene " in ln
              or "mIoU/mAcc/OA" in ln]
    for ln in result:
        print("  cli: " + ln)
    print(f"cli: python -m repsurf_torch.cli.test_s3dis --synthetic --synthetic_rooms 1 "
          f"--filter: {secs:.1f} s (process start and data included)")
    if not any("mIoU/mAcc/OA" in ln for ln in result):
        raise AssertionError("test_s3dis printed no mIoU/mAcc/OA line")
    launches["large room"] = large_room_cli(here)
    return launches


def cell_rooms():
    """The scene cell's 8 frozen rooms (``benchmark/traffic/scene_rooms_220k``)
    and its protocol (the configuration's ``infer``)."""
    from benchmark.data.synthetic_scene import raw_room

    here = Path(__file__).resolve().parent
    traffic = json.loads((here / "benchmark/traffic/scene_rooms_220k.json").read_text())
    config = json.loads((here / "benchmark/configs/repsurf_umb_ssg.s3dis.json").read_text())
    content = np.random.RandomState(traffic["room_seed"])
    rooms = [raw_room(content, traffic["raw_points"], size)[:2]
             for size in traffic["room_sizes"]]
    return rooms, config["infer"]


def phase_scene_device(dev):
    """A room's chunks cut on the card (``eval_s3dis.device_batches``) on the
    scene cell's 8 rooms against the benchmark's numpy reference
    (``benchmark/reference/scene.chunks``): every chunk's rows and each row's
    colour equal, each row's coordinates the reference's normalisation of
    the chunk in the card's order bit for bit (so ``chunk_mean`` is numpy's
    ``np.mean`` on real crops), how far the order of tied points moved a
    chunk's mean from the reference's, the crops by where they were cut,
    and a room's preparation on the card against the host's (host clock
    around synchronised calls).  Then ``chunk_mean`` alone on the
    reference's crops in numpy's order, bit-equal to ``np.mean`` in float32
    and float64; one kernels-JSON entry, whose launches are one
    ``scene_votes`` on a cell room."""
    from benchmark.reference import scene
    from repsurf_torch.ops.kernels.chunk_mean import chunk_mean, chunk_mean_plain
    from repsurf_torch.train.eval_s3dis import device_batches, scene_batches, scene_votes

    rooms, inf = cell_rooms()
    kw = dict(voxel_size=inf["voxel_size"], voxel_max=inf["voxel_max"],
              batch_size=inf["batch_size"], data_norm="mean", seed=inf["chunk_seed"])
    stats = [np.array(inf[k], np.float32) for k in ("rgb_mean", "rgb_std")]
    device_batches.crops.clear()
    crops_raw, moved, ulps = [], 0, 0.0
    for j, (coord, rgb) in enumerate(rooms):
        ref = scene.chunks(coord, rgb, inf)
        batches = scene_batches(coord, rgb, device=dev, **kw)
        rows = torch.cat([r for _, r in batches]).cpu().numpy()
        xyz = torch.cat([b["coord"] for b, _ in batches]).cpu().numpy()
        fea = torch.cat([b["feat"] for b, _ in batches]).cpu().numpy()
        if rows.shape[0] != len(ref):
            raise AssertionError(f"room {j}: {rows.shape[0]} chunks on the card, {len(ref)} "
                                 f"in the reference")
        tied = 0
        for k, (idx, _, f) in enumerate(ref):
            m = len(idx)
            r = rows[k, :m]
            a, b = np.argsort(idx, kind="stable"), np.argsort(r, kind="stable")
            if not (np.array_equal(idx[a], r[b])
                    and np.array_equal(f[a].view(np.int32), fea[k, :m][b].view(np.int32))):
                raise AssertionError(f"room {j} chunk {k}: rows or colours differ from the "
                                     f"reference")
            mine = scene.normalize(coord[r], rgb[r], *stats)[0]
            if not np.array_equal(mine.view(np.int32), xyz[k, :m].view(np.int32)):
                raise AssertionError(f"room {j} chunk {k}: coordinates are not np.mean's "
                                     f"normalisation of the chunk in the card's order")
            if not ((xyz[k, m:] == xyz[k, 0]).all() and (fea[k, m:] == 0).all()
                    and (rows[k, m:] == len(coord)).all()):
                raise AssertionError(f"room {j} chunk {k}: padding differs from pad_batch's")
            tied += int((idx != r).sum())
            theirs, ours = np.mean(coord[idx], 0), np.mean(coord[r], 0)
            if not np.array_equal(theirs, ours):
                moved += 1
                ulps = max(ulps, float((np.abs(ours - theirs) / np.spacing(np.abs(theirs))).max()))
            crops_raw.append(coord[idx])
        print(f"  room {j}: {len(coord)} points, {len(ref)} chunks equal to the reference "
              f"(rows, colours, padding; coordinates np.mean's of the card's order; {tied} "
              f"slots hold a tied point in another order)")
    crops = dict(device_batches.crops)
    card_s, host_s = [], []
    for coord, rgb in rooms:  # warm: each room was cut once above
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scene_batches(coord, rgb, device=dev, **kw)
        torch.cuda.synchronize()
        card_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        scene_batches(coord, rgb, device="cpu", **kw)
        host_s.append(time.perf_counter() - t0)
    print(f"  a room prepared on the card, ms: {[round(t * 1e3, 1) for t in card_s]}; on the "
          f"host: {[round(t * 1e3, 1) for t in host_s]}")
    print(f"scene chunks on the card: {len(crops_raw)} chunks of {len(rooms)} rooms equal to the "
          f"reference; {moved} chunk means moved by the order of tied points, at most {ulps:g} "
          f"ulps; crops {crops}; a room prepared in {statistics.median(card_s) * 1e3:.1f} ms "
          f"on the card against {statistics.median(host_s) * 1e3:.1f} ms on the host (medians, "
          f"host clock)")

    chunk_mean.launches = 0
    coord, rgb = rooms[0]
    scene_votes(lambda batch: torch.zeros(batch["coord"].shape[:2] + (13,), device=dev),
                coord, rgb, 13, device=dev, **kw)
    launches = chunk_mean.launches
    print(f"  scene_votes on room 0: chunk_mean launched {launches} times")
    if launches != 1:
        raise AssertionError(f"scene_votes launched chunk_mean {launches} times, not once")

    x = torch.from_numpy(np.stack(crops_raw)).to(dev)
    errs = []
    for dtype in (torch.float32, torch.float64):
        xs = x.to(dtype)
        got, want = chunk_mean(xs), chunk_mean_plain(xs.cpu())
        errs.append(float((got.cpu() - want).abs().max()))
        if not torch.equal(got.cpu(), want):
            raise AssertionError(f"chunk_mean {dtype}: not bit-equal to np.mean "
                                 f"(max |diff| {errs[-1]:.3g})")
        print(f"  chunk_mean [{x.shape[0]}x{x.shape[1]}x3] {dtype}: bit-equal to np.mean")
    b, n, d = x.shape
    room = x[:28]  # about a room's chunks, one launch
    entry = _entry(
        f"chunk_mean[{room.shape[0]}x{n}x{d}]", "repsurf_torch/csrc/chunk_mean.cu",
        "none (numpy np.mean on the host)", max(errs), lambda: chunk_mean(room),
        lambda: chunk_mean_plain(room.cpu()),
        (room.numel(), room.numel() * 4 + room.shape[0] * d * 4), timer=adaptive_ms)
    # the bound that holds: one thread's chain of n dependent float32 adds
    entry["chain_bound_ms"] = n * FADD_CYCLES / SM_CLOCK_HZ * 1e3
    print(f"    chunk_mean: the chain of {n} dependent adds at {FADD_CYCLES} cycles and "
          f"{SM_CLOCK_HZ / 1e9:.2f} GHz takes {entry['chain_bound_ms']:.4f} ms")
    entry["launches"] = launches
    return entry


def large_room_cli(here):
    """python -m repsurf_torch.cli.test_s3dis --voxel_max 0 on one
    LARGE_ROOM_RAW-point synthetic room: whole voxel passes go to the model,
    each over the FPS registers' 131,072 points, so FPS takes the stream
    route.  Prints the pass sizes; the predictions (read back from the
    --visual dump) are labels of the model's classes, one a raw point;
    returns the CLI's kernel launches."""
    from repsurf_torch.data.synthetic_scene import SyntheticRooms
    from repsurf_torch.ops.kernels import build
    from repsurf_torch.train.eval_s3dis import PALETTE, voxel_passes

    room = SyntheticRooms("val", n_rooms=1, raw_points=LARGE_ROOM_RAW, seed=2000).raw(0)
    sizes = [len(p) for p in voxel_passes(room[:, :3], 0.04)]
    cap = build.library().repsurf_fps_register_points()
    print(f"large room: {LARGE_ROOM_RAW} points, voxel passes of {sizes} points (the FPS "
          f"registers hold {cap})")
    if max(sizes) <= cap:
        raise AssertionError("the large room's passes fit the FPS registers")
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "repsurf_torch.cli.test_s3dis", "--synthetic",
             "--synthetic_rooms", "1", "--synthetic_raw", str(LARGE_ROOM_RAW), "--voxel_max",
             "0", "--visual", "--device", "cuda", "--log_root", root],
            cwd=here, capture_output=True, text=True, timeout=CLI_TIMEOUT)
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"test_s3dis --voxel_max 0 exited {proc.returncode}:\n"
                                 f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        colors = np.loadtxt(Path(root) / "S3DIS" / "default" / "visual" / "synth_val_0_pred.txt",
                            usecols=(3, 4, 5), dtype=np.int64)
    labels = (colors[:, None, :] == PALETTE[None]).all(-1)
    if colors.shape[0] != LARGE_ROOM_RAW or not (labels.sum(1) >= 1).all():
        raise AssertionError("test_s3dis --voxel_max 0: predictions missing or out of range")
    found = np.unique(labels.argmax(1))
    lines = [ln.split("] ", 1)[-1] for ln in proc.stdout.splitlines()]
    launches = json.loads(next(ln for ln in lines if ln.startswith("kernel launches "))
                          [len("kernel launches "):])
    for ln in lines:
        if "scene " in ln or "mIoU/mAcc/OA" in ln:
            print("  cli: " + ln)
    print(f"cli: python -m repsurf_torch.cli.test_s3dis --synthetic --synthetic_rooms 1 "
          f"--synthetic_raw {LARGE_ROOM_RAW} --voxel_max 0 --visual: {secs:.1f} s (process start "
          f"and data included); {colors.shape[0]} predictions, labels {found.tolist()} of "
          f"{len(PALETTE)} classes; kernel launches {launches}")
    if launches["fps"].get("stream", 0) == 0:
        raise AssertionError("test_s3dis --voxel_max 0 did not take the FPS stream route")
    return launches


def family_clouds(dev):
    """The clouds the model families' kernels see: bench.py's two
    80,000-point rooms and their FPS subsets (20,000, 5,000, 1,250, 312
    points), and the cls clouds at 2048 -> 1024 -> 512 -> 128 points with
    the triangular constructor's normals."""
    from repsurf_torch.data.scanobjectnn import SyntheticClouds
    from repsurf_torch.data.synthetic_scene import synthetic_room
    from repsurf_torch.nn.triangular import SurfaceConstructor
    from repsurf_torch.ops.gather import index_points
    from repsurf_torch.ops.kernels.fps import fps

    rng = np.random.RandomState(0)
    seg = [torch.from_numpy(np.stack([synthetic_room(SEG_POINTS, rng=rng)
                                      for _ in range(SEG_BATCH)])).to(dev)]
    for m in (SEG_POINTS // 4, 5000, 1250, 312):
        seg.append(fps(seg[-1], m, return_xyz=True)[1])
    raw = torch.from_numpy(SyntheticClouds(n_samples=BATCH, seed=1).data).to(dev)
    _, xyz1 = fps(raw, NUM_POINT, return_xyz=True)
    idx2, xyz2 = fps(xyz1, 512, return_xyz=True)
    _, xyz3 = fps(xyz2, 128, return_xyz=True)
    normal1 = SurfaceConstructor(return_dist=True)(xyz1)
    feat2 = torch.randn((BATCH, 512, 128), generator=torch.Generator(dev).manual_seed(1),
                        device=dev)
    return seg, dict(xyz1=xyz1, xyz2=xyz2, xyz3=xyz3, normal1=normal1,
                     normal2=index_points(normal1, idx2), feat2=feat2)


def family_kernels(dev):
    """The kernels at the shapes only the model families give them, each
    against its plain version: window kNN at k = 16 over PointTransformer's
    80,000- and 20,000-point stages (re-solves held to RESOLVE_LIMIT), brute
    kNN at k = 16 over its smaller stages on the route the policy picks,
    brute kNN at k = 3 over the cls clouds (the triangular constructor), the
    ball-feature forward and its scatter backward at the triangular
    classifier's SA1 (C = 3 + 7) and SA2 (C = 3 + 7 + 128) widths.  Each
    entry carries (path, counter, key) for its launch count."""
    entries = []
    with torch.inference_mode():
        (room, xyz20, xyz5, xyz1250, xyz312), st = family_clouds(dev)
        for kind, p, q in (("knn_window", room, room), ("knn_window", room, xyz20),
                           ("knn_window", xyz20, xyz20), ("knn_window", xyz20, xyz5),
                           ("knn", xyz5, xyz5), ("knn", xyz5, xyz1250), ("knn", xyz1250, xyz1250),
                           ("knn", xyz1250, xyz312), ("knn", xyz312, xyz312)):
            e = check_knn(kind, 16, p, q)
            e["count"] = ("pointtransformer", f"{kind}_by_k" if kind == "knn_window"
                          else "knn_brute_by_k", "16")
            entries.append(e)
        e = check_knn("knn", 3, st["xyz1"], st["xyz1"])
        e["count"] = ("tri", "knn_brute_by_k", "3")
        entries.append(e)
        sa = ((0.2, 32, st["xyz1"], st["xyz2"], [st["normal1"]], BALL_FEAT_T_TPU),
              (0.4, 64, st["xyz2"], st["xyz3"], [st["normal2"], st["feat2"]], BALL_FEAT_TPU))
        for radius, nsample, xyz, q, rest, replaces in sa:
            e = check_ball(radius, nsample, xyz, q, [xyz, *rest], replaces=replaces)
            e["count"] = ("tri", "ball_feature_by_c", str(e.pop("channels")))
            entries.append(e)
    for radius, nsample, xyz, q, rest, _ in sa:
        tcat = torch.cat([xyz, *rest], dim=-1).clone()  # out of inference mode
        e = check_feature_backward(radius, nsample, xyz.clone(), q.clone(), tcat)
        e["count"] = ("tri", "ball_feature_bwd_by_c", str(e.pop("channels")))
        entries.append(e)
    # no gradient reaches SA1's inputs in repsurf_ssg_tri (its constructor
    # has no parameters): the backward at C = 10 is held but not launched
    entries[-2]["count"] += ("not on the path",)
    return entries


def timed_steps(step):
    """FAMILY_STEPS + 1 calls of ``step`` (the first a warm-up), each
    synchronised on the host clock -> (losses, warm step times in ms)."""
    losses, ms = [], []
    for _ in range(FAMILY_STEPS + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(step()))  # synchronises
        ms.append((time.perf_counter() - t0) * 1e3)
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"a loss is not finite: {losses}")
    return losses, ms[1:]


def run_clis(here, root, jobs):
    """CLI processes on the card, all started at once (one card holds them
    all: about 9, 5 and 11 GiB at the families' peaks) -> [(log lines,
    kernel launches)] in the order of ``jobs`` [(label, args)], and the
    seconds until the last one ended.  Each writes to a file under
    ``root``; every process is waited for, and on a failure the others are
    stopped."""
    procs = []
    t0 = time.perf_counter()
    try:
        for i, (label, args) in enumerate(jobs):
            out = open(Path(root) / f"cli{i}.out", "w+")
            procs.append((label, out, subprocess.Popen([sys.executable, "-m", *args], cwd=here,
                                                       stdout=out, stderr=subprocess.STDOUT,
                                                       text=True)))
        results = []
        for label, out, proc in procs:
            code = proc.wait(timeout=CLI_TIMEOUT)
            out.seek(0)
            text = out.read()
            if code != 0:
                raise AssertionError(f"{label} exited {code}:\n{text[-6000:]}")
            lines = [ln.split("] ", 1)[-1] for ln in text.splitlines()]
            launches = json.loads(next(ln for ln in lines if ln.startswith("kernel launches "))
                                  [len("kernel launches "):])
            results.append((lines, launches))
        return results, time.perf_counter() - t0
    finally:
        for _, out, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            out.close()


def tri_in_process(dev):
    """repsurf_ssg_tri at full width: FAMILY_STEPS timed train steps at
    ClsConfig defaults (batch 64, 2048 -> 1024), peak memory, one batch's
    log-probs on the kernel path against the plain path."""
    from repsurf_torch.data.scanobjectnn import SyntheticClouds
    from repsurf_torch.data.transforms import fps_sample
    from repsurf_torch.train.train_cls import ClsConfig, build_model, make_optimizer, train_step

    cfg = ClsConfig(model=TRI)
    model = build_model(cfg, generator=torch.Generator().manual_seed(cfg.seed)).to(dev)
    n_params = sum(p.numel() for p in model.parameters())
    if n_params != TRI_PARAMS:
        raise AssertionError(f"{TRI} has {n_params} parameters, not {TRI_PARAMS}")
    opt = make_optimizer(model, cfg)
    data = SyntheticClouds(n_samples=BATCH, seed=1)
    raw, target = torch.from_numpy(data.data).to(dev), torch.from_numpy(data.label).to(dev)
    gen = torch.Generator(dev).manual_seed(0)
    torch.cuda.reset_peak_memory_stats()
    losses, ms = timed_steps(lambda: train_step(model, opt, raw, target, cfg, generator=gen)[0])
    peak = torch.cuda.max_memory_allocated() / 2**30
    with torch.inference_mode():
        model.eval()
        pts = fps_sample(raw, cfg.num_point)
        sign = torch.where(torch.arange(BATCH, device=dev) % 3 == 0, -1.0, 1.0)
        logp = model(pts, inv_sign=sign)
        with plain_kernels():
            plain = model(pts, inv_sign=sign)
        err = float((logp - plain).abs().max())
    print(f"  {TRI} ({n_params} parameters), batch {BATCH}, {RAW_POINTS}->{cfg.num_point}: "
          f"losses {[round(x, 4) for x in losses]}, train step (host clock, synchronised) "
          f"{[round(t, 3) for t in ms]} ms, median {statistics.median(ms):.3f} ms; peak memory "
          f"{peak:.2f} GiB; kernel path vs plain path, one batch: max |d log-prob| {err:.3g} "
          f"(limit {LOGP_ATOL})")
    if not torch.isfinite(logp).all() or err > LOGP_ATOL:
        raise AssertionError(f"{TRI}: kernel path and plain path disagree")
    return {"steps_ms": ms, "peak_gib": peak}


def seg_in_process(dev, name, n_params_want):
    """A seg baseline at full width (SegConfig defaults, bench.py's two
    80,000-point rooms): FAMILY_STEPS timed train steps, peak memory, one
    eval forward's logits on the kernel path against the plain path on the
    live points."""
    from repsurf_torch.cli.common import seg_batch
    from repsurf_torch.data.s3dis import CLASS_WEIGHTS
    from repsurf_torch.train.train_seg import SegConfig, build_model, make_optimizer, train_step

    n, b = SEG_POINTS, SEG_BATCH
    cfg = SegConfig(model=name)
    model = build_model(cfg, generator=torch.Generator().manual_seed(cfg.seed)).to(dev)
    n_params = sum(p.numel() for p in model.parameters())
    if n_params != n_params_want:
        raise AssertionError(f"{name} has {n_params} parameters, not {n_params_want}")
    opt = make_optimizer(model, cfg)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in seg_batch(n, b).items()}
    w = torch.tensor(CLASS_WEIGHTS[5], dtype=torch.float32, device=dev)
    gen = torch.Generator(dev).manual_seed(1)
    torch.cuda.reset_peak_memory_stats()
    losses, ms = timed_steps(lambda: train_step(model, opt, batch, w, cfg, generator=gen)[0])
    peak = torch.cuda.max_memory_allocated() / 2**30
    with torch.no_grad():
        model.eval()
        args = (batch["coord"], batch["feat"], batch["valid"])
        logits = model(*args)
        with plain_kernels():
            plain = model(*args)
        live = torch.arange(n, device=dev)[None, :] < batch["valid"][:, None]
        err = float((logits - plain).abs()[live].max())
    print(f"  {name} ({n_params} parameters), batch {b} x {n} points: losses "
          f"{[round(x, 4) for x in losses]}, train step (host clock, synchronised) "
          f"{[round(t, 3) for t in ms]} ms, median {statistics.median(ms):.3f} ms; peak memory "
          f"{peak:.2f} GiB; kernel path vs plain path, one eval forward: max |d logit| "
          f"{err:.3g} (limit {SEG_LOGIT_ATOL})")
    if not torch.isfinite(logits[live]).all() or err > SEG_LOGIT_ATOL:
        raise AssertionError(f"{name}: kernel path and plain path disagree")
    return {"steps_ms": ms, "peak_gib": peak}


def check_tri_cli(lines, launches):
    """train_cls --model repsurf_ssg_tri: a finite loss, the vote line, the
    full-width model on the card, every kernel of its path launched."""
    for ln in lines:
        if ln.startswith(("epoch 1/1", "single ", "kernel launches")) or " parameters on " in ln:
            print("  cli: " + ln)
    epoch = next(ln for ln in lines if ln.startswith("epoch 1/1"))
    loss = float(epoch.split(" loss ")[1].split()[0])
    if (not math.isfinite(loss) or not any(ln.startswith("single ") for ln in lines)
            or not any(f"{TRI}: {TRI_PARAMS} parameters on cuda" in ln for ln in lines)):
        raise AssertionError(f"train_cls {TRI}: no finite loss, vote line or full-width model")
    need = (sum(launches["fps"].values()), launches["knn_brute_by_k"].get("3", 0),
            launches["ball_feature_by_c"].get("10", 0), launches["ball_feature_by_c"].get("138", 0),
            launches["ball_feature_bwd_by_c"].get("138", 0))
    if not all(need):
        raise AssertionError(f"train_cls {TRI}: a kernel of the path was not launched: {launches}")


def check_seg_cli(name, n_params, lines, launches, served):
    """train_seg --model: finite train and val losses, the full-width model
    on the card, a checkpoint, the seg kernels launched; test_s3dis: the
    checkpoint restored and a result line."""
    for ln in lines:
        if (ln.startswith(("train epoch", "val epoch", "best mIoU", "kernel launches"))
                or " parameters on " in ln):
            print("  cli: " + ln)
    losses = [float(ln.split(" loss ", 1)[1].split()[0]) for ln in lines
              if ln.startswith(("train epoch", "val epoch"))]
    if len(losses) != 2 or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"train_seg {name}: losses {losses}")
    if not any(f"{name}: {n_params} parameters on cuda" in ln for ln in lines):
        raise AssertionError(f"train_seg {name}: not the full-width model on cuda")
    if not any("best mIoU ->" in ln for ln in lines):
        raise AssertionError(f"train_seg {name}: no checkpoint saved")
    if (not sum(launches["fps"].values()) or not launches["knn_window"]
            or not sum(launches["knn_brute"].values())):
        raise AssertionError(f"train_seg {name}: the seg kernels were not launched: {launches}")
    for ln in served:
        if "checkpoint restored" in ln or "mIoU/mAcc/OA" in ln:
            print("  cli: " + ln)
    if not any("checkpoint restored" in ln for ln in served) or not any(
            "mIoU/mAcc/OA" in ln for ln in served):
        raise AssertionError(f"test_s3dis did not serve {name} from its checkpoint")


def phase_families(dev):
    """The model families the umbrella slices do not drive: the kernels at
    their shapes (family_kernels), each family at full width in process,
    then the three training CLIs at once (tri one epoch with votes; the
    seg baselines one epoch each: a step, validation, the best checkpoint)
    and the two test CLIs at once, each serving a room from its baseline's
    checkpoint.  Sets each family entry's launches from its path's CLI."""
    print("model families: the kernels at the families' shapes, then each family at full width")
    here = Path(__file__).resolve().parent
    torch.cuda.empty_cache()
    entries = family_kernels(dev)
    stats = {"tri": tri_in_process(dev), "pointnet2": seg_in_process(dev, PN2, PN2_PARAMS),
             "pointtransformer": seg_in_process(dev, PT, PT_PARAMS)}
    torch.cuda.empty_cache()
    seg = (("pointnet2", PN2, PN2_PARAMS), ("pointtransformer", PT, PT_PARAMS))
    with tempfile.TemporaryDirectory() as root:
        train_jobs = [(f"train_cls {TRI}", [
            "repsurf_torch.cli.train_cls", "--synthetic", "--model", TRI, "--epoch", "1",
            "--min_val", "0", "--device", "cuda", "--log_root", str(Path(root) / "tri")])]
        for key, name, _ in seg:
            train_jobs.append((f"train_seg {name}", [
                "repsurf_torch.cli.train_seg", "--synthetic", "--model", name,
                "--synthetic_rooms", "2", "--batch_size", "2", "--batch_size_val", "2",
                "--loop", "1", "--min_val", "0", "--voxel_max", str(SEG_POINTS), "--epoch", "1",
                "--device", "cuda", "--log_root", str(Path(root) / key)]))
        trained, train_secs = run_clis(here, root, train_jobs)
        served, serve_secs = run_clis(here, root, [(f"test_s3dis {name}", [
            "repsurf_torch.cli.test_s3dis", "--synthetic", "--synthetic_rooms", "1", "--model",
            name, "--device", "cuda", "--log_root", str(Path(root) / key)])
            for key, name, _ in seg])
    check_tri_cli(*trained[0])
    stats["tri"]["launches"] = trained[0][1]
    for (key, name, n_params), (lines, launches), (served_lines, _) in zip(seg, trained[1:],
                                                                          served):
        check_seg_cli(name, n_params, lines, launches, served_lines)
        stats[key]["launches"] = launches
    print(f"  CLIs on the card at once: train_cls {TRI}, train_seg {PN2} and {PT} in "
          f"{train_secs:.1f} s (process start and data included), then test_s3dis of both "
          f"from their checkpoints in {serve_secs:.1f} s")
    for e in entries:
        path, counter, key, *off_path = e.pop("count")
        e["launches"] = stats[path]["launches"][counter].get(key, 0)
        if off_path:
            print(f"  {e['name']}: {e['launches']} launches ({off_path[0]}: no gradient "
                  f"reaches SA1's inputs in {TRI})")
        elif not e["launches"]:
            raise AssertionError(f"{e['name']}: its path launched it no time")
    print("families: " + "; ".join(
        f"{k} train step median {statistics.median(v['steps_ms']):.3f} ms, peak "
        f"{v['peak_gib']:.2f} GiB" for k, v in stats.items()))
    return entries


def scannet_scenes(root):
    """SCANNET_SCENES ScanNet-format scenes (xyzrgbl rows of synthetic_room
    at 0.02 m spacing, labels 1..13 with a seeded few percent 0) under
    ``root``, the first half listed in train.txt, the rest in val.txt."""
    from repsurf_torch.data.scannet import synthetic_scan

    names = [f"scene{i:04d}_00" for i in range(SCANNET_SCENES)]
    for i, name in enumerate(names):
        np.save(Path(root) / f"{name}.npy", synthetic_scan(SCANNET_RAW, spacing=0.02, seed=i))
    half = SCANNET_SCENES // 2
    (Path(root) / "train.txt").write_text("\n".join(names[:half]) + "\n")
    (Path(root) / "val.txt").write_text("\n".join(names[half:]) + "\n")


def scannet_kernels(dev, data):
    """FPS, window kNN and brute kNN at the shapes of a ScanNet training
    step (batch 2 x 120,000 points, the CLI's first training batch) and its
    eval forward, each against its plain version (exact), the window's
    re-solved queries per sample held to RESOLVE_LIMIT; a plain version over
    ONCE_MS is timed once."""
    from repsurf_torch.data import scannet
    from repsurf_torch.data.s3dis import pad_batch
    from repsurf_torch.ops.sector import sector_buffers

    train = scannet.ScanNetDataset(str(data), "train")
    rng = np.random.RandomState(0)
    batch = pad_batch([train.get(i, rng=rng) for i in range(SEG_BATCH)], scannet.VOXEL_MAX,
                      scannet.IGNORE_LABEL)
    room = torch.from_numpy(batch["coord"]).to(dev)
    print(f"  the training batch: {list(batch['valid'])} points of {scannet.VOXEL_MAX} "
          f"(scenes of {SCANNET_RAW} raw points, voxel {scannet.VOXEL_SIZE})")
    if not (batch["valid"] == scannet.VOXEL_MAX).all():
        raise AssertionError("a ScanNet training sample holds fewer than voxel_max points")
    m1 = scannet.VOXEL_MAX // 4
    entries = []
    with torch.inference_mode():
        xyz30, e = check_seg_fps(room, m1, plain_timer=once_if_slow_ms)  # eval: no sectors
        entries.append(e)
        sec, counts, _, _ = sector_buffers(room, 4)  # training stage 1
        m_sec = min(m1 // 4 + m1 % 4 + 3, sec.shape[2])
        _, e = check_seg_fps(sec.reshape(-1, *sec.shape[2:]), m_sec, valid=counts.reshape(-1),
                             plain_timer=once_if_slow_ms)
        entries.append(e)
        xyz7500, e = check_seg_fps(xyz30, m1 // 4, plain_timer=once_if_slow_ms)
        entries.append(e)
        xyz1875, e = check_seg_fps(xyz7500, m1 // 16, plain_timer=once_if_slow_ms)
        entries.append(e)
        xyz468, e = check_seg_fps(xyz1875, m1 // 64, plain_timer=once_if_slow_ms)
        entries.append(e)
        for kind, k, p, q in (
            ("knn_window", 9, room, room),  # umbrella
            ("knn_window", 32, room, xyz30),  # SA1
            ("knn_window", 32, xyz30, xyz7500),  # SA2
            ("knn_window", 3, xyz30, room),  # FP1
            ("knn", 32, xyz7500, xyz1875),  # SA3
            ("knn", 32, xyz1875, xyz468),  # SA4
            ("knn", 3, xyz468, xyz1875),  # FP4
            ("knn", 3, xyz1875, xyz7500),  # FP3
            ("knn", 3, xyz7500, xyz30),  # FP2
        ):
            entries.append(check_knn(kind, k, p, q, plain_timer=once_if_slow_ms))
    for e in entries:
        e["shape"] = e["name"].split("[", 1)[1].rstrip("]")
    return entries


def cli_lines(proc, label):
    if proc.returncode != 0:
        raise AssertionError(f"{label} exited {proc.returncode}:\n{proc.stdout[-4000:]}\n"
                             f"{proc.stderr[-4000:]}")
    return [ln.split("] ", 1)[-1] for ln in proc.stdout.splitlines()]


def check_scannet_cli(lines, label, epochs):
    """Finite losses, no predicted 0 in validation, the epochs trained;
    returns (kernel launches, [(step median s, data s, peak GiB)] by
    epoch)."""
    train = [ln for ln in lines if ln.startswith("train epoch ")]
    val = [ln for ln in lines if ln.startswith("val epoch ")]
    predictions = [ln for ln in lines if ln.startswith("predicted points by class")]
    for ln in lines:
        if ln.startswith(("train epoch", "val epoch", "predicted points", "data-parallel",
                          "train rooms", "kernel launches")) or " parameters on " in ln:
            print(f"    {label}: {ln}")
    losses = [float(ln.split(" loss ", 1)[1].split()[0]) for ln in train + val]
    if len(train) != epochs or len(val) != epochs or len(predictions) != epochs:
        raise AssertionError(f"{label}: {len(train)} train and {len(val)} val epochs, not "
                             f"{epochs}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{label}: a loss is not finite: {losses}")
    for ln in predictions:
        predicted = json.loads(ln.split(": ", 1)[1])
        if predicted[0] != 0 or sum(predicted) == 0:
            raise AssertionError(f"{label}: validation predicted class 0 (or nothing): "
                                 f"{predicted}")
    if not any(f"{SEG_PARAMS_SCANNET} parameters on cuda" in ln for ln in lines):
        raise AssertionError(f"{label}: not repsurf_umb_ssg at 21 classes on cuda")
    steps = [(float(ln.split("step median ", 1)[1].split()[0]),
              float(ln.split(", data ", 1)[1].split()[0]),
              float(ln.split(", peak ", 1)[1].split()[0])) for ln in train]
    launches = json.loads(next(ln for ln in lines if ln.startswith("kernel launches "))
                          [len("kernel launches "):])
    return launches, steps


def reference_checkpoints(root):
    """A seeded repsurf_umb_ssg saved twice: the port's payload and the
    reference's layout (1x1 convolution weights, the module. prefix,
    num_batches_tracked) -> (port path, reference path)."""
    from repsurf_torch.train.checkpoint import train_state_dict
    from repsurf_torch.train.train_seg import SegConfig, build_model

    model = build_model(SegConfig(), generator=torch.Generator().manual_seed(5))
    port, ref = Path(root) / "best.pt", Path(root) / "reference.pth"
    torch.save(train_state_dict(model, torch.optim.SGD(model.parameters(), lr=0.1)), port)
    sd = {}
    for i, (k, v) in enumerate(model.state_dict().items()):
        if k.endswith("weight") and v.ndim == 2:
            v = v[..., None, None] if i % 2 else v[..., None]
        sd["module." + k] = v.clone()
        if k.endswith("running_mean"):
            sd["module." + k[:-len("running_mean")] + "num_batches_tracked"] = torch.tensor(3)
    torch.save({"state_dict": sd, "epoch": 3}, ref)
    return port, ref


def phase_scannet(dev):
    """ScanNet and data parallelism: ScanNet-format scenes written here;
    the seg kernels at the ScanNet step's shapes (scannet_kernels); the
    seg CLI on them at the ScanNet defaults (voxel 0.02, voxel_max
    120,000, batch 2, --loop 1, 2 epochs with validation) through the
    prefetch loader (--workers 2) and the data-parallel step (--n_devices 1
    --bn sync): finite losses, class 0 never predicted, the kernels launched
    by shape, step median, data seconds a step, peak memory; then at once:
    the same run with --bn per_device for one epoch, the cls CLI with
    --dp_mode shard_map --n_devices 1 for one epoch with votes, and the test
    CLI serving a room of R2's size from a reference-format checkpoint and
    from the port's checkpoint of the same weights, whose labels must be
    equal.  Sets each kernel entry's launches from the sync run's counts by
    shape."""
    print("scannet and data parallelism: ScanNet-format scenes, the kernels at their shapes, "
          "the seg CLI through the loader and the data-parallel step")
    here = Path(__file__).resolve().parent
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as root:
        data = Path(root) / "scannet"
        data.mkdir()
        t0 = time.perf_counter()
        scannet_scenes(data)
        print(f"  {SCANNET_SCENES} scenes of {SCANNET_RAW} points written in "
              f"{time.perf_counter() - t0:.1f} s")
        entries = scannet_kernels(dev, data)
        torch.cuda.empty_cache()
        base = ["repsurf_torch.cli.train_seg", "--dataset", "ScanNet", "--data_dir", str(data),
                "--batch_size", "2", "--batch_size_val", "2", "--loop", "1", "--min_val", "0",
                "--workers", "2", "--n_devices", "1", "--device", "cuda"]
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", *base, "--bn", "sync", "--epoch", "2",
                               "--log_root", str(Path(root) / "sync")], cwd=here,
                              capture_output=True, text=True, timeout=CLI_TIMEOUT)
        sync_secs = time.perf_counter() - t0
        launches, steps = check_scannet_cli(cli_lines(proc, "train_seg --bn sync"), "sync", 2)
        port_ckpt, ref_ckpt = reference_checkpoints(root)
        serve = ["repsurf_torch.cli.test_s3dis", "--synthetic", "--synthetic_rooms", "1",
                 "--synthetic_raw", str(R2_POINTS), "--visual", "--device", "cuda"]
        jobs = [("train_seg --bn per_device", [*base, "--bn", "per_device", "--epoch", "1",
                                               "--log_root", str(Path(root) / "per_device")]),
                ("train_cls --dp_mode shard_map", [
                    "repsurf_torch.cli.train_cls", "--synthetic", "--epoch", "1", "--min_val",
                    "0", "--dp_mode", "shard_map", "--n_devices", "1", "--device", "cuda",
                    "--log_root", str(Path(root) / "cls")]),
                ("test_s3dis port checkpoint", [*serve, "--model_path", str(port_ckpt),
                                                "--log_root", str(Path(root) / "port")]),
                ("test_s3dis reference checkpoint", [*serve, "--model_path", str(ref_ckpt),
                                                     "--log_root",
                                                     str(Path(root) / "reference")])]
        results, rest_secs = run_clis(here, root, jobs)
        _, per_device_steps = check_scannet_cli(results[0][0], "per_device", 1)
        cls_lines = results[1][0]
        for ln in cls_lines:
            if ln.startswith(("epoch ", "single ", "data-parallel")):
                print(f"    cls: {ln}")
        if (not any("data-parallel step over 1 processes" in ln for ln in cls_lines)
                or not any(ln.startswith("single ") for ln in cls_lines)):
            raise AssertionError("train_cls --dp_mode shard_map: no data-parallel epoch with votes")
        labels = {}
        for (label, _), (lines, _) in zip(jobs[2:], results[2:]):
            kind = "reference" if "reference" in label else "port"
            if not any(f"({kind} format)" in ln for ln in lines):
                raise AssertionError(f"{label}: the checkpoint was not read as {kind}")
            visual = Path(root) / kind / "S3DIS" / "default" / "visual"
            labels[kind] = np.loadtxt(next(visual.glob("*_pred.txt")), usecols=(3, 4, 5))
        differ = int((labels["port"] != labels["reference"]).any(axis=1).sum())
        print(f"  test_s3dis from the reference-format and the port-format checkpoint of one "
              f"model: {len(labels['port'])} labels each, {differ} differ")
        if differ or len(labels["port"]) != R2_POINTS:
            raise AssertionError("the two checkpoint formats served different labels")
    for e in entries:
        kind = e["name"].split("[")[0]
        counter = {"fps": "fps_by_shape", "knn_window": "knn_window_by_shape",
                   "knn": "knn_brute_by_shape"}[kind]
        e["launches"] = launches[counter].get(e.pop("shape"), 0)
        if not e["launches"]:
            raise AssertionError(f"{e['name']}: the ScanNet CLI run launched it no time")
    print("  launches by shape in the sync run: " + json.dumps(
        {k: launches[k] for k in ("fps_by_shape", "knn_window_by_shape", "knn_brute_by_shape")}))
    (med1, data1, _), (med2, data2, peak) = steps
    print(f"scannet: train_seg --dataset ScanNet --workers 2 --n_devices 1 --bn sync, 2 x "
          f"120,000 points: {sync_secs:.1f} s for 2 epochs (process start and data included); "
          f"train step median {med1 * 1e3:.3f} ms (epoch 1, cold) and {med2 * 1e3:.3f} ms "
          f"(epoch 2), data {data1:.4f} / {data2:.4f} s a step, peak {peak:.2f} GiB; "
          f"--bn per_device step {per_device_steps[0][0] * 1e3:.3f} ms (cold, beside the other "
          f"CLIs); the other CLIs at once {rest_secs:.1f} s")
    return entries


def printed_tables(text):
    """{label: (header, {kernel name: ms a call})} of the op tables a
    profiling CLI printed (``OpTable.lines``)."""
    tables, rows = {}, None
    for line in text.splitlines():
        if line.startswith("== "):
            label, _, header = line[3:].partition(": ")
            rows = {}
            tables[label] = (header, rows)
        elif rows is not None and (row := re.match(r"\s+([\d.]+) ms\s+[\d.]+x  (.*)$", line)):
            rows[row.group(2)] = rows.get(row.group(2), 0.0) + float(row.group(1))
        else:
            rows = None
    return tables


def table_kernels(tables, prefix, patterns):
    """(busy ms, host wall ms, {pattern: device ms}) of the printed table
    labelled ``prefix`` (or ``prefix (...)``); raises unless it came from a whole
    trace and names each pattern (a tuple: any one of its names) with
    device time above 0."""
    label = next((k for k in tables if k == prefix or k.startswith(prefix + " (")), None)
    if label is None:
        raise AssertionError(f"no table {prefix!r} printed")
    header, rows = tables[label]
    times = re.match(r"device self time \(torch.profiler, CUDA\) ([\d.]+) ms a call, host "
                     r"wall ([\d.]+) ms a call", header)
    if times is None:
        raise AssertionError(f"{label}: {header}")
    found = {}
    for pattern in patterns:
        names = pattern if isinstance(pattern, tuple) else (pattern,)
        ms = sum(v for k, v in rows.items() if any(n in k for n in names))
        if not ms > 0:
            raise AssertionError(f"{label}: no device time for {' or '.join(names)}")
        found["/".join(names)] = round(ms, 4)
    return float(times.group(1)), float(times.group(2)), found


def profiler_cli(here, args):
    """Run ``python -m <args>`` and return its printed tables."""
    proc = subprocess.run([sys.executable, "-m", *args], cwd=here, capture_output=True,
                          text=True, timeout=PROFILER_TIMEOUT)
    if proc.returncode:
        raise AssertionError(f"{' '.join(args)} exited {proc.returncode}:\n{proc.stderr[-3000:]}")
    for line in proc.stdout.splitlines():
        print(f"  {line}")
    return printed_tables(proc.stdout)


def modelnet_fixture(root):
    """A modelnet40_normal_resampled tree of MODELNET_SHAPES shapes, one a
    class: unit-sphere clouds of NUM_POINT x,y,z,nx,ny,nz rows.  The txt
    layout, since the card's machine has no h5py for the h5 one (the CPU
    tests cover both)."""
    rng = np.random.RandomState(40)
    names = [f"shape{i:02d}" for i in range(40)]
    (Path(root) / "modelnet40_shape_names.txt").write_text("\n".join(names) + "\n")
    ids = []
    for i in range(MODELNET_SHAPES):
        normal = rng.randn(NUM_POINT, 3)
        normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
        sid = f"{names[i]}_0001"
        (Path(root) / names[i]).mkdir()
        np.savetxt(Path(root) / names[i] / f"{sid}.txt",
                   np.concatenate([normal * rng.uniform(0.5, 1.0, 3), normal], -1),
                   delimiter=",", fmt="%.6f")
        ids.append(sid)
    (Path(root) / "modelnet40_test.txt").write_text("\n".join(ids) + "\n")


def check_modelnet(dev):
    """A ModelNet40Dataset batch through fps_sample and repsurf_ssg_umb with
    40 classes on the card, with no conversion: finite [32, 40]."""
    from repsurf_torch.data import ModelNet40Dataset
    from repsurf_torch.data.modelnet40 import NUM_CLASS
    from repsurf_torch.data.transforms import fps_sample
    from repsurf_torch.ops.kernels import kernel_launches
    from repsurf_torch.train.train_cls import ClsConfig, build_model

    with tempfile.TemporaryDirectory() as root:
        modelnet_fixture(root)
        ds = ModelNet40Dataset(root, "test", num_point=NUM_POINT)
        pts = np.stack([ds[i][0] for i in range(len(ds))])
    cfg = ClsConfig(num_class=NUM_CLASS)
    model = build_model(cfg, generator=torch.Generator().manual_seed(0)).to(dev).eval()
    before = kernel_launches()
    with torch.no_grad():
        logp = model(fps_sample(torch.from_numpy(pts).to(dev), cfg.num_point))
    after = kernel_launches()
    fps_n = sum(after["fps"].values()) - sum(before["fps"].values())
    tq_n = after["umbrella"]["tq"] - before["umbrella"]["tq"]
    print(f"  modelnet40: {len(ds)} shapes of {pts.shape[1]} points ({pts.dtype}) -> log-probs "
          f"{tuple(logp.shape)}, finite {bool(torch.isfinite(logp).all())}; fps {fps_n}, "
          f"umbrella_tq {tq_n} launches")
    if logp.shape != (len(ds), NUM_CLASS) or not torch.isfinite(logp).all() or not fps_n * tq_n:
        raise AssertionError("ModelNet40 batch: wrong shape, not finite or off the kernels")


def phase_tools(dev):
    """The profilers' op tables, each from its own process as a user runs
    it; the window guard diagnostics; ModelNet40."""
    from repsurf_torch.cli import knn_window_stats

    here = Path(__file__).resolve().parent
    seg = profiler_cli(here, ["repsurf_torch.cli.profile_seg", "--steps", "3", "--top", "25",
                              "--fwd", "--scene", str(SCENE_TABLE_RAW)])
    cls = profiler_cli(here, ["repsurf_torch.cli.profile_cls", "--ops"])
    found, busy = {}, {}
    for label, tables, prefix, patterns in (
            ("seg train step", seg, "train step", SEG_TABLE_KERNELS[:2]),
            ("seg eval forward", seg, "eval forward", SEG_TABLE_KERNELS),
            ("whole scene", seg, "whole scene", SEG_TABLE_KERNELS),
            ("cls eval pipeline", cls, "cls eval pipeline", CLS_TABLE_KERNELS)):
        busy_ms, wall_ms, found[label] = table_kernels(tables, prefix, patterns)
        busy[label] = [busy_ms, wall_ms, round(1.0 - busy_ms / wall_ms, 3)]
    print(f"  kernels in the op tables (device ms a call): {json.dumps(found)}")
    for label, resolved in knn_window_stats.main([]):
        if max(resolved) > RESOLVE_LIMIT:
            raise AssertionError(f"knn_window_stats {label}: {resolved} re-solved "
                                 f"(limit {RESOLVE_LIMIT})")
    check_modelnet(dev)
    print(f"tools: device busy ms, host wall ms and idle share a call {json.dumps(busy)}")


def check_batch_norm(dev, label, shape, mask_shape, relu, seed):
    """The batch-norm kernels at one shape against the module's torch
    composition on the card, element for element: the training output, the
    running buffers, the eval output, and dx, dweight, dbias from autograd
    (the ReLU applied after the norm, as before the fusion); the statistics
    against the plain mirror (the composition's operations); each kernel
    output twice, bit-equal.  Returns the counts of differing elements."""
    from repsurf_torch.nn.layers import MaskedBatchNorm
    from repsurf_torch.ops.kernels import batch_norm as bn

    gen = torch.Generator(dev).manual_seed(seed)
    c = shape[-1]
    x = (torch.randn(shape, generator=gen, device=dev)
         * (torch.rand(c, generator=gen, device=dev) * 2 + 0.5)
         + torch.randn(c, generator=gen, device=dev) * 2)
    mask = None
    if mask_shape is not None:
        n = mask_shape[1]
        valid = n - torch.randint(0, max(n // 8, 1), (mask_shape[0],), generator=gen, device=dev)
        mask = (torch.arange(n, device=dev) < valid[:, None])[..., None]
    m = MaskedBatchNorm(c).to(dev).train()
    with torch.no_grad():
        m.weight.copy_(torch.rand(c, generator=gen, device=dev) + 0.5)
        m.bias.copy_(torch.randn(c, generator=gen, device=dev) * 0.5)
        m.running_mean.copy_(torch.randn(c, generator=gen, device=dev))
        m.running_var.copy_(torch.rand(c, generator=gen, device=dev) + 0.5)
    g = torch.randn(shape, generator=gen, device=dev)
    w, b = m.weight.detach(), m.bias.detach()
    groups, s = bn.row_groups(mask, shape[:-1])
    runs = []
    for _ in range(2):
        rm, rv = m.running_mean.clone(), m.running_var.clone()
        mean, inv, cnt = bn.batch_norm_stats(x, groups, s, rm, rv, 0.1, 1e-5)
        y = bn.batch_norm_normalize(x, mean, inv, False, 1e-5, w, b, relu)
        ye = bn.batch_norm_normalize(x, rm, rv, True, 1e-5, w, b, relu)
        dx, dw, db = bn.batch_norm_backward(g, x, groups, s, mean, inv, False, 1e-5, w, b, cnt,
                                            relu)
        runs.append((mean, inv, cnt, rm, rv, y, ye, dx, dw, db))
    torch.cuda.synchronize()
    repeat = all(torch.equal(p, q) for p, q in zip(*runs))
    mean, inv, cnt, rm, rv, y, ye, dx, dw, db = runs.pop(0)
    del runs
    prm, prv = m.running_mean.clone(), m.running_var.clone()
    pm, pinv, pcnt = bn.batch_norm_stats_plain(x, groups, s, prm, prv, 0.1, 1e-5)
    xr = x.clone().requires_grad_(True)
    want = m._composition(xr, mask)
    want = torch.relu(want) if relu else want
    wdx, wdw, wdb = torch.autograd.grad(want, (xr, m.weight, m.bias), g)
    want = want.detach()
    m.eval()
    with torch.no_grad():
        we = m._composition(x, mask)
        we = torch.relu(we) if relu else we
    diff = {}
    for name, got, ref in (("mean", mean, pm), ("invstd", inv, pinv), ("cnt", cnt, pcnt),
                           ("y", y, want), ("running_mean", rm, m.running_mean),
                           ("running_var", rv, m.running_var), ("eval", ye, we), ("dx", dx, wdx),
                           ("dweight", dw, wdw), ("dbias", db, wdb)):
        diff[name] = (int((got != ref).sum()), float((got - ref).abs().max()))
    print(f"  batch_norm {label} {list(shape)}: {int(cnt.item())} counted rows, relu {relu}; "
          "differing elements (largest gap) "
          + ", ".join(f"{k} {n} ({gap:.3g})" for k, (n, gap) in diff.items())
          + f"; two runs bit-equal {repeat}")
    del want, wdx, we, xr, x, g, y, ye, dx
    torch.cuda.empty_cache()
    return sum(n for n, _ in diff.values()) + (not repeat)


def batch_norm_entries(dev, card_line):
    """Kernel-table row 11 at PT's attention shape, masked, ReLU'd: the
    forward (statistics + normalisation) and the backward, each against
    its bytes bound (each input read once, each output written once) and
    the bytes the kernels move (four passes of x's size forward, six
    backward), the plain mirrors, the module's torch composition
    (the route before the kernels) and torch.nn.functional.batch_norm + ReLU,
    unmasked, as the library's yardstick (timed here only; the port never
    calls it)."""
    import torch.nn.functional as F

    from repsurf_torch.nn.layers import MaskedBatchNorm
    from repsurf_torch.ops.kernels import batch_norm as bn

    label, shape, mask_shape, _ = BN_SHAPES[0]
    gen = torch.Generator(dev).manual_seed(0)
    c = shape[-1]
    x = torch.randn(shape, generator=gen, device=dev) + 1.0
    g = torch.randn(shape, generator=gen, device=dev)
    mask = (torch.arange(shape[1], device=dev) < shape[1] - 1000)[None, :, None].expand(
        mask_shape).contiguous()
    groups, s = bn.row_groups(mask, shape[:-1])
    m = MaskedBatchNorm(c).to(dev).train()
    w, b = m.weight.detach(), m.bias.detach()
    rm, rv = m.running_mean, m.running_var
    stats = bn.batch_norm_stats(x, groups, s, rm, rv, 0.1, 1e-5)

    def fwd():
        mean, inv, _ = bn.batch_norm_stats(x, groups, s, rm, rv, 0.1, 1e-5)
        return bn.batch_norm_normalize(x, mean, inv, False, 1e-5, w, b, True)

    def bwd():
        return bn.batch_norm_backward(g, x, groups, s, stats[0], stats[1], False, 1e-5, w, b,
                                      stats[2], True)

    def fwd_plain():
        mean, inv, _ = bn.batch_norm_stats_plain(x, groups, s, rm, rv, 0.1, 1e-5)
        return bn.batch_norm_normalize_plain(x, mean, inv, False, 1e-5, w, b, True)

    def bwd_plain():
        return bn.batch_norm_backward_plain(g, x, groups, s, stats[0], stats[1], False, 1e-5, w,
                                            b, stats[2], True)

    x2, g2 = x.view(-1, c), g.view(-1, c)
    lib_rm, lib_rv = rm.clone(), rv.clone()

    def fwd_library():
        return torch.relu(F.batch_norm(x2, lib_rm, lib_rv, w, b, True, 0.1, 1e-5))

    xr = x2.detach().requires_grad_(True)
    wr, br = w.clone().requires_grad_(True), b.clone().requires_grad_(True)

    def step_library():
        y = torch.relu(F.batch_norm(xr, lib_rm, lib_rv, wr, br, True, 0.1, 1e-5))
        return torch.autograd.grad(y, (xr, wr, br), g2)

    xc = x.detach().requires_grad_(True)
    mc = copy.deepcopy(m)

    def step_composition():
        y = torch.relu(mc._composition(xc, mask))
        return torch.autograd.grad(y, (xc, mc.weight, mc.bias), g)

    def step_kernels():
        y = bn.batch_norm(xc, mc.weight, mc.bias, mc.running_mean, mc.running_var, mask, True,
                          0.1, 1e-5, True)
        return torch.autograd.grad(y, (xc, mc.weight, mc.bias), g)

    nbytes, mask_bytes = x.numel() * 4, groups.numel()
    entries = []
    for name, kernel_fn, plain_fn, passes, least in (
            ("forward", fwd, fwd_plain, 4, 2), ("backward", bwd, bwd_plain, 6, 3)):
        e = _entry(f"batch_norm_{name}[{'x'.join(map(str, shape))},masked,relu]", BN_SRC,
                   "none (XLA fuses the JAX package's MaskedBatchNorm)", 0.0, kernel_fn, plain_fn,
                   (BN_FLOPS * x.numel(), least * nbytes + mask_bytes))
        moved = passes * nbytes + 2 * mask_bytes
        rate = moved / (e["ms"] / 1e3)
        dev_rate = moved / (e["device_ms"] / 1e3) if e["device_ms"] else float("nan")
        print(f"    moves {moved / 1e9:.3f} GB ({passes} passes of x): {rate / 1e12:.3f} TB/s = "
              f"{100 * rate / PEAK_BYTES_PER_S:.1f} % of 3.35 TB/s by events, "
              f"{100 * dev_rate / PEAK_BYTES_PER_S:.1f} % by device time; roofline share "
              f"{100 * e['bound_ms'] / e['ms']:.1f} %")
        e["launches"] = None
        entries.append(e)
    lib_fwd, lib_step = median_ms(fwd_library), median_ms(step_library)
    comp_step, kern_step = median_ms(step_composition), median_ms(step_kernels)
    comp_dev, kern_dev = device_ms(step_composition), device_ms(step_kernels)
    entries[0]["library_ms"], entries[1]["library_ms"] = lib_fwd, lib_step - lib_fwd
    print(f"    library (F.batch_norm + ReLU, unmasked, [{x2.shape[0]}, {c}]): forward "
          f"{lib_fwd:.4f} ms, forward + backward {lib_step:.4f} ms; the module's forward + "
          f"backward: kernels {kern_step:.4f} ms (device {kern_dev:.4f}), the torch composition "
          f"before them {comp_step:.4f} ms (device {comp_dev:.4f}); {card_line}")
    return entries


def bn_step_launches(dev):
    """The batch_norm launches of one training step and of one eval forward
    of the umbrella seg model, PointTransformer (2 x 20,000 points) and the
    classifier (batch 16) against the norms each called."""
    from repsurf_torch.data.synthetic_scene import synthetic_room
    from repsurf_torch.nn.layers import MaskedBatchNorm
    from repsurf_torch.ops.kernels import batch_norm as bn
    from repsurf_torch.train import train_cls, train_seg

    rng = np.random.RandomState(0)
    n = 20000
    coord = torch.from_numpy(np.stack([synthetic_room(n, rng=rng) for _ in range(2)])).to(dev)
    batch = {"coord": coord, "feat": torch.rand(2, n, 3, device=dev),
             "label": torch.randint(0, 13, (2, n), device=dev),
             "valid": torch.tensor([n, n - 3000], device=dev)}
    cls_pts = torch.rand(16, 2048, 3, device=dev) * 2 - 1
    cls_target = torch.randint(0, 15, (16,), device=dev)
    out = {}
    for name in ("repsurf.repsurf_umb_ssg", PT, "repsurf.repsurf_ssg_umb"):
        seg = name != "repsurf.repsurf_ssg_umb"
        cfg = train_seg.SegConfig(model=name) if seg else train_cls.ClsConfig()
        trainer = train_seg if seg else train_cls
        model = trainer.build_model(cfg, generator=torch.Generator().manual_seed(0)).to(dev)
        opt = trainer.make_optimizer(model, cfg)
        calls = [0]
        for mod in model.modules():
            if isinstance(mod, MaskedBatchNorm):
                mod.register_forward_hook(lambda *a: calls.__setitem__(0, calls[0] + 1))
        gen = torch.Generator(dev).manual_seed(1)
        for k in bn.batch_norm.launches:
            bn.batch_norm.launches[k] = 0
        if seg:
            trainer.train_step(model, opt, batch, torch.ones(13, device=dev), cfg, generator=gen)
        else:
            trainer.train_step(model, opt, cls_pts, cls_target, cfg, generator=gen)
        torch.cuda.synchronize()
        train = (calls[0], dict(bn.batch_norm.launches))
        calls[0] = 0
        for k in bn.batch_norm.launches:
            bn.batch_norm.launches[k] = 0
        model.eval()
        with torch.no_grad():
            if seg:
                model(batch["coord"], batch["feat"], batch["valid"])
            else:
                model(cls_pts[:, :1024])
        torch.cuda.synchronize()
        out[name] = (train, (calls[0], dict(bn.batch_norm.launches)))
        (tc, tl), (ec, el) = out[name]
        print(f"  batch_norm launches, {name}: a training step's {tc} norms -> {tl}; an eval "
              f"forward's {ec} -> {el}")
        if tl != {"stats": tc, "normalize": tc, "backward": tc, "eval": 0} or el != {
                "stats": 0, "normalize": 0, "backward": 0, "eval": ec} or not tc * ec:
            raise AssertionError(f"{name}: a norm ran off the batch_norm kernels")
    return out


def phase_batch_norm(dev, card_line):
    """The batch-norm kernels at the cells' shapes against their mirrors,
    kernel-table row 11, and the launches of one step of each model."""
    print("batch norm:")
    off = sum(check_batch_norm(dev, label, shape, mask_shape, relu, seed=i)
              for i, (label, shape, mask_shape, relu) in enumerate(BN_SHAPES))
    if off:
        raise AssertionError(f"batch_norm: {off} elements off the torch composition or unrepeated")
    entries = batch_norm_entries(dev, card_line)
    torch.cuda.empty_cache()
    launches = bn_step_launches(dev)
    torch.cuda.empty_cache()
    return entries, launches


def main():
    profile = "--profile" in sys.argv[1:]
    seconds = {}
    t0 = time.perf_counter()
    card_line = phase_card()
    dev = torch.device("cuda", 0)
    phase_build()
    seconds["card+build"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    bn_entries, _ = phase_batch_norm(dev, card_line)
    seconds["batch norm"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    entries, stages = phase_kernels(dev)
    seconds["kernels"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    umb_entries, umb_driven = phase_umbrella(dev, stages["xyz1"])
    seconds["umbrella kernels"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    launches, by_c = phase_slice(dev)
    seconds["slice"] = time.perf_counter() - t0
    for e in entries:
        if e["name"].startswith("ball_feature"):
            e["launches"] = by_c.get(e.pop("channels"), 0)
        else:
            e["launches"] = launches["fps"]
    t0 = time.perf_counter()
    train_entries, rows_fwd, rows_bwd = phase_train_kernels(stages)
    del stages
    seconds["train kernels"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    phase_pnx_kernels(dev)
    seconds["pointnext kernels"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, _, feat_bwd = phase_cls_train(dev, profile=profile)
    seconds["cls train slice"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    phase_step_graph(dev)
    seconds["step graph"] = time.perf_counter() - t0
    for e in train_entries:
        counts = {"ball_feature_bwd": feat_bwd, "ball_group": rows_fwd,
                  "ball_group_bwd": rows_bwd}[e["name"].split("[")[0]]
        e["launches"] = counts.get(e.pop("channels"), 0)
    t0 = time.perf_counter()
    phase_cli()
    seconds["cli"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    phase_seg_cli()
    seconds["seg cli"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    seg_entries = phase_seg_kernels(dev)
    seconds["seg kernels"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    seg_launches = phase_seg_slice(dev, profile=profile)
    seconds["seg slice"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    scene_launches = phase_scene(dev)
    seconds["scene"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    chunk_entry = phase_scene_device(dev)
    seconds["scene chunks on the card"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    family_entries = phase_families(dev)
    seconds["model families"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    scannet_entries = phase_scannet(dev)
    seconds["scannet+dp"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    phase_tools(dev)
    seconds["tools"] = time.perf_counter() - t0
    large = scene_launches["large room"]
    for e in seg_entries:
        kind = e["name"].split("[")[0]
        if e.pop("fps_route", None) == "stream":  # only the large room's passes take it
            e["launches"] = large["fps"].get("stream", 0)
        elif kind == "knn":  # the seg slice and the large room, by route
            e["launches"] = (seg_launches.get(f"knn_brute_{e['variant']}", 0)
                             + large["knn_brute"].get(e["variant"], 0))
        else:
            e["launches"] = seg_launches[kind]
    for e in umb_entries:
        impl, style = e.pop("impl"), e.pop("style")
        if impl != "tq":
            e["launches"] = umb_driven[f"umbrella_{impl}"]
        else:  # tq: the cls eval slice, the seg style on R2's forwards
            e["launches"] = (launches["umbrella_tq"] if style == "cls"
                             else scene_launches["R2"]["umbrella_seg"])
    print(f"torch.profiler (device_split): {PROFILER['traces']} traces, "
          f"{PROFILER['retaken']} empty or torn and taken again, "
          f"{PROFILER['given_up']} calls not measured, {PROFILER['pads_lost']} of the "
          f"{2 * PAD_KERNELS * PROFILER['traces']} spin kernels not recorded")
    print("phase seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()))
    kernels = (entries + umb_entries + train_entries + seg_entries + family_entries
               + scannet_entries + [chunk_entry] + bn_entries)
    print(json.dumps({"kernels": not_measured_as_null(kernels)}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    sys.exit(main())
