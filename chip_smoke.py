"""Smoke run of the PyTorch port (repsurf_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Run from the root of a checkout.  Phases, each printing its lines:

  1. card    - requires CUDA; prints the card's name and power limit as
               nvidia-smi gives them, the torch / CUDA versions, TF32 off;
  2. build   - compiles repsurf_torch/csrc/*.cu with nvcc, prints the time;
  3. kernels - each CUDA kernel against its plain PyTorch version on the
               card, at the shapes of the classification eval path, with
               kernel and plain times (CUDA events, median of 20 runs), the
               bound and, where one PyTorch call computes the same
               function, that call's time; each FPS line also its time a
               round and the round floor of its launch shape (the same
               rounds with the sweep removed);
  3b. umbrella kernels - tq, full and slab against the plain composition
               at the cls shape (C = 10, and C = 9 for tq) and at a small
               room's pass (the seg style), full bit-equal to tq, the slab's
               re-solved queries per sample equal to the plain guard
               replay's, the seg-style gradient; the kernel entry driven
               with impl full and slab for their launch counts;
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
               forward bit-equal to ball_query + index_points and its
               backward as above; the umbrella Function's gradient against
               the plain composition's; the runs and sums of a cloud too
               large for shared memory (the global-memory variant); then
               ops/neighbors.ball_group, the row kernel's entry point,
               driven forward and backward;
  6. cls train slice - repsurf_ssg_umb at full width, seeded random
               weights, ClsConfig defaults, one epoch of 8 train steps
               (batch 64, 2048 -> 1024) through train_epoch and 8 more timed
               one by one; launch counts, finite losses, peak memory; one
               SGD step on the kernel path against the plain path, per
               parameter (with --profile also a torch.profiler table of one
               train step);
  7. cli     - python -m repsurf_torch.cli.train_cls --synthetic for 2
               epochs with vote evaluation, then again to 3 epochs, which
               must resume from the checkpoint's epoch;
  8. seg kernels - the polar-division check; FPS, window kNN and brute kNN
               against their plain versions at every shape of the
               repsurf_umb_ssg step at 2 x 80,000 points (synthetic rooms
               and their FPS subsets), with the window kernel's re-solved
               queries per sample; FPS edge cases (duplicates across the
               blocks of a cluster, valid ending inside a block's share,
               npoint > valid, every one-block instantiation and every
               cluster size 2..16) equal to fps_plain; an adversarial
               window case held to brute force; kernel and plain times (CUDA events, median);
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
               --synthetic with its mIoU/mAcc/OA line;
  11. a JSON line of the kernels, then {"ok": true, "device": {...}}.

Any failed check raises, so the script exits non-zero and prints no
result line.
"""

import contextlib
import copy
import dataclasses
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

BATCH, RAW_POINTS, NUM_POINT = 64, 2048, 1024
REPS = 20
UMB_ATOL = 1e-5  # umbrella features: atan2/acos/sqrt/division chains
NEAR_TIE = 1e-6  # azimuth gap under which two fan neighbours may swap
NEAR_TIE_SHARE = 1e-3
POS_ATOL = 1e-6  # ball pos: xyz2sphere of the relative coordinates
LOGP_ATOL = 1e-4  # log-probs, kernel path against plain path
SEG_BATCH, SEG_POINTS = 2, 80000
SEG_LOGIT_ATOL = 1e-4  # seg logits, kernel path against plain path
SLOW_MS = 2000.0  # a plain version this slow is timed fewer times
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
CLI_TIMEOUT = 300
UMB_SRC, UMB_TPU = "repsurf_torch/csrc/umbrella.cu", "repsurf_tpu/ops/pallas/umbrella.py"
UMB_REPLACES = {"tq": UMB_TPU + ":302", "full": UMB_TPU + ":88", "slab": UMB_TPU + ":606"}
SEG_ROOM_POINTS, SEG_ROOM_SIZE = 12288, (3.0, 3.0, 2.6)  # a small room's pass, R2's shape
R1_POINTS, R2_POINTS = 120000, 12000
VOTE_TIE = 1e-6  # top-two vote-averaged probability gap, device against host mode
# H100 SXM data sheet: float32 outside the tensor cores, HBM3
PEAK_F32_FLOPS, PEAK_BYTES_PER_S = 67e12, 3.35e12
KNN_FLOPS = 8  # one squared distance: 3 differences, 3 products, 2 sums
FPS_FLOPS = 9  # a distance and the running minimum


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
    """Device time of one call of fn: the kernels' self time under
    torch.profiler over ``reps`` calls (after a warm-up), over reps.  Where
    a call's host work outlasts its kernels, CUDA events around the call
    measure the host; this measures the card."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a trace that caught no device time is taken again
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(getattr(e, "self_device_time_total", 0.0) for e in prof.key_averages())
        if us > 0:
            return us / 1e3 / reps
    raise AssertionError("torch.profiler recorded no device time")


def adaptive_ms(fn):
    """median_ms with one sizing run for warm-up: REPS runs, or as few as 3
    for a function slower than SLOW_MS / REPS."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    first = (time.perf_counter() - t0) * 1e3
    return median_ms(fn, reps=max(3, min(REPS, int(SLOW_MS / max(first, 1e-3)))), warm=1)


def bound(flops, nbytes):
    """(ms, 'operations' | 'bytes'): the least time the card could take for
    work of ``flops`` float32 operations moving ``nbytes`` (each input read
    once, each output written once)."""
    t_ops, t_mem = flops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_mem else (t_mem, "bytes")


def _entry(name, source, replaces, err, kernel_fn, plain_fn, work, timer=median_ms,
           library_fn=None):
    """One kernels-JSON entry: the kernel's and its plain version's times,
    ``work`` = (flops, bytes) of this call for the bound, and the time of
    ``library_fn``, one PyTorch call computing the same function, where one
    exists."""
    ms, plain_ms = timer(kernel_fn), timer(plain_fn)
    library_ms = None if library_fn is None else timer(library_fn)
    bound_ms, bound_by = bound(*work)
    lib = "" if library_ms is None else f", library {library_ms:.4f} ms"
    print(f"  {name}: max_abs_err {err:.3g}, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms{lib}, "
          f"bound {bound_ms:.4f} ms ({bound_by})")
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "max_abs_err": float(err), "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms}


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
    and every cluster size the wrapper picks, 2..16, the largest cloud
    included."""
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
    n_max = lib.repsurf_fps_max_points()
    seen[n_max] = run("the largest cloud", n_max, 48, dup=True)
    sizes = sorted(set(seen.values()))
    print(f"  fps edge cases: {len(seen)} clouds, duplicates across blocks, valid inside a "
          f"block's share and the last block, npoint > valid, N up to {n_max}: equal to "
          f"fps_plain on the defined slots; cluster sizes {sizes}")
    if sizes != list(range(1, 17)):
        raise AssertionError(f"fps edge cases reached cluster sizes {sizes}, not 1..16")


def umbrella_near_ties(xyz, k, style, valid=None):
    """[B, N] azimuth near-tie points of the style's fans (NEAR_TIE gap)."""
    from repsurf_torch.geometry.umbrella import azimuth_near_ties

    return azimuth_near_ties(xyz, k, drop_self=style == "cls", rotate=style == "seg",
                             valid=valid, gap=NEAR_TIE)


def check_umbrella(impl, xyz, style, return_dist=True, valid=None, near=None, k=9,
                   timed=True):
    """One umbrella kernel against the plain composition: within UMB_ATOL
    away from azimuth near-ties (at most 0.1 % of the points); the slab's
    re-solved queries per sample equal to the plain guard replay's.
    Returns (features, its kernels-JSON entry when ``timed``, else None)."""
    from repsurf_torch.ops.kernels.umbrella import (
        SLAB,
        fan_shape,
        slab_guard_plain,
        umbrella_fan_features_plain,
        umbrella_features_kernel,
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
        resolved = umbrella_features_kernel.slab_resolved
        replay = slab_guard_plain(xyz, k, valid).sum(dim=1)
        if not torch.equal(resolved, replay):
            raise AssertionError(f"{tag}: re-solved {resolved.tolist()}, the plain guard "
                                 f"replay {replay.tolist()}")
        extra = f"; re-solved queries per sample {resolved.tolist()} = the plain guard replay's"
        # the window's candidates, then the brute re-solve of each flagged query
        pairs = 3 * SLAB * n * b + int(resolved.sum()) * (nv // b)
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
    return feat, entry


def check_ball(radius, nsample, xyz, new_xyz, tensors, replaces):
    from repsurf_torch.ops.kernels.ball_group import (
        ball_group_feature,
        ball_group_feature_plain,
    )
    from repsurf_torch.ops.neighbors import ball_query

    args = (radius, nsample, xyz, new_xyz, tensors)
    pos, feat = ball_group_feature(*args, return_polar=True)
    ppos, pfeat = ball_group_feature_plain(*args, return_polar=True)
    # the selected indices, read back through an extra channel holding each
    # point's index (exact in f32)
    col = torch.arange(xyz.shape[1], device=xyz.device, dtype=torch.float32)
    col = col[None, :, None].expand(xyz.shape[0], -1, 1).contiguous()
    _, with_idx = ball_group_feature(radius, nsample, xyz, new_xyz, [*tensors, col])
    torch.cuda.synchronize()
    c = sum(t.shape[-1] for t in tensors)
    if not torch.equal(with_idx[..., -1].to(torch.int32),
                       ball_query(radius, nsample, xyz, new_xyz)):
        raise AssertionError(f"ball C={c}: selected indices differ")
    if not torch.equal(feat, pfeat):
        raise AssertionError(f"ball C={c}: feat not bit-equal")
    err = float((pos - ppos).abs().max())
    if err > POS_ATOL:
        raise AssertionError(f"ball C={c}: pos off by {err}")
    b, n, m = xyz.shape[0], xyz.shape[1], new_xyz.shape[1]
    entry = _entry(
        f"ball_feature[{b}x{n}->{m},S={nsample},C={c}]",
        "repsurf_torch/csrc/ball_group.cu", replaces, err,
        lambda: ball_group_feature(*args, return_polar=True),
        lambda: ball_group_feature_plain(*args, return_polar=True),
        # the ball query's distances; xyz, centers and channels in, pos (6)
        # and feat (C - 3) out
        (KNN_FLOPS * b * m * n, 4 * (3 * b * n + 3 * b * m + b * n * c
                                     + b * m * nsample * (6 + c - 3))),
    )
    entry["channels"] = c
    return entry


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
                                  "repsurf_tpu/ops/pallas/ball_group.py:374"))
        normal2 = index_points(normal1, idx2)
        feat2 = torch.randn((BATCH, 512, 128), generator=torch.Generator(dev).manual_seed(1),
                            device=dev)
        entries.append(check_ball(0.4, 64, xyz2, xyz3, [xyz2, normal2, feat2],
                                  "repsurf_tpu/ops/pallas/ball_group.py:208"))
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
    import repsurf_torch.ops.interpolate as interpolate
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

    swaps = [(sampling, "fps", fps_plain), (transforms, "fps", fps_plain),
             (geo_umbrella, "umbrella_features_kernel", umbrella_plain),
             (blocks, "ball_group_feature", ball_group_feature_plain),
             (neighbors, "ball_group", ball_group_plain),
             (geo_umbrella, "knn", knn_plain), (blocks, "knn", knn_plain),
             (interpolate, "knn", knn_plain)]
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


def umbrella_counts():
    """{'umbrella_tq': n, 'umbrella_full': n, 'umbrella_slab': n} and the
    launches by style, since the last reset."""
    from repsurf_torch.ops.kernels.umbrella import umbrella_features_kernel as umb

    return ({f"umbrella_{k}": v for k, v in umb.launches.items()},
            dict(umb.launches_by_style))


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


def check_scatter(name, replaces, sel, g, n, coff, backward_fn):
    """The backward kernel at one shape: ``backward_fn`` (the gradient as
    the autograd Function returns it) twice, bit-equal, and equal to the
    scatter kernel called on sel; its runs equal to selection_csr's and
    its sums bit-equal to the ordered float32 oracle; within SCATTER_RTOL
    of the sum of the |contributions| of each element of a float64
    scatter-add."""
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
    entry["device_ms"] = device_ms(lambda: ball_scatter(sel, g, n, coff))
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
    index_points, backward through check_scatter."""
    from repsurf_torch.ops.kernels.ball_group import (
        ball_group_channels,
        ball_group_channels_plain,
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
    fwd["channels"] = c
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


def check_seg_fps(xyz, npoint, valid=None):
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


def check_knn(kind, k, xyz, q, valid=None):
    from repsurf_torch.ops.kernels.knn import knn_brute, knn_plain
    from repsurf_torch.ops.kernels.knn_window import knn_window

    fn = knn_window if kind == "knn_window" else knn_brute
    idx, dist = fn(k, xyz, q, valid=valid)
    pidx, pdist = knn_plain(k, xyz, q, valid=valid)
    torch.cuda.synchronize()
    name = f"{kind}[{xyz.shape[0]}x{xyz.shape[1]}->{q.shape[1]},k={k}]"
    if not torch.equal(idx, pidx):
        raise AssertionError(f"{name}: indices differ at {int((idx != pidx).sum())} slots")
    err = float((dist - pdist).abs().max())
    if err != 0.0:
        raise AssertionError(f"{name}: distances differ by up to {err}")
    resolved = knn_window.resolved.tolist() if kind == "knn_window" else None
    if resolved is not None:
        print(f"  {name}: indices and distances equal; re-solved queries per sample {resolved}")
    b, n, m = xyz.shape[0], xyz.shape[1], q.shape[1]
    pairs = b * m * n if resolved is None else window_candidates(k, xyz, q, valid,
                                                                 knn_window.resolved)
    entry = _entry(name, WINDOW_SRC if kind == "knn_window" else KNN_SRC,
                   WINDOW_TPU if kind == "knn_window" else KNN_TPU, err,
                   lambda: fn(k, xyz, q, valid=valid), lambda: knn_plain(k, xyz, q, valid=valid),
                   (KNN_FLOPS * pairs, 4 * (3 * b * n + 3 * b * m + 2 * b * m * k)),
                   timer=adaptive_ms)
    if resolved is not None:
        entry["resolved_per_sample"] = resolved
    return entry


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
          f"equal to brute force {ok}; re-solved per sample {knn_window.resolved.tolist()}")
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
    from repsurf_torch.data.s3dis import CLASS_WEIGHTS, pad_batch
    from repsurf_torch.data.synthetic_scene import synthetic_room
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
    rng = np.random.RandomState(0)  # bench.py's batch
    samples = [(synthetic_room(n, rng=rng), rng.rand(n, 3).astype(np.float32),
                rng.randint(0, 13, n).astype(np.int64)) for _ in range(b)]
    batch = {k: torch.from_numpy(v).to(dev) for k, v in pad_batch(samples, n).items()}
    w = torch.tensor(CLASS_WEIGHTS[5], dtype=torch.float32, device=dev)
    gen = torch.Generator(dev).manual_seed(1)

    counters = (fps, knn_window, knn_brute)
    for c in counters:
        c.launches = 0
    fps.launches_by_route.clear()
    knn_window.resolved_total = 0
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
    routes = dict(fps.launches_by_route)
    resolved = int(knn_window.resolved_total)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    print(f"seg slice: repsurf_umb_ssg ({n_params} parameters), batch {b} x {n} points, "
          f"3 train steps + 1 eval step; launches {launches}, fps by route {routes}; "
          f"window re-solved queries in the slice {resolved}; peak memory {peak_gb:.2f} GiB")
    if min(launches.values()) == 0 or routes.get("cluster", 0) == 0:
        raise AssertionError("a kernel of the seg path was not launched in the slice")
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
    shape (both C) and at a small room's pass, full bit-equal to tq, the
    seg-style gradient; then the kernel entry driven with impl full and
    slab at both shapes (no model reaches them, as in the JAX package),
    the path their launch counts are read from."""
    from repsurf_torch.data.synthetic_scene import synthetic_room
    from repsurf_torch.ops.kernels.umbrella import umbrella_features_kernel

    print("umbrella kernels: tq, full and slab against the plain composition")
    rng = np.random.RandomState(5)
    seg = np.stack([synthetic_room(SEG_ROOM_POINTS, size=SEG_ROOM_SIZE, rng=rng)
                    for _ in range(2)])
    seg = torch.from_numpy(seg - seg.mean(axis=1, keepdims=True)).to(dev)
    valid = torch.tensor([SEG_ROOM_POINTS, R2_POINTS], device=dev)
    entries, outs = [], {}
    with torch.inference_mode():
        near = {"cls": umbrella_near_ties(xyz1, 9, "cls"),
                "seg": umbrella_near_ties(seg, 9, "seg", valid)}
        for style, xyz, v in (("cls", xyz1, None), ("seg", seg, valid)):
            for impl in ("tq", "full", "slab"):
                outs[style, impl], e = check_umbrella(impl, xyz, style, valid=v, near=near[style])
                entries.append(e)
            if style == "cls":
                entries.append(check_umbrella("tq", xyz, style, return_dist=False,
                                              near=near[style])[1])
            same = torch.equal(outs[style, "full"], outs[style, "tq"])
            print(f"  {style}: full bit-equal to tq: {same}")
            if not same:
                raise AssertionError(f"umbrella {style}: full differs from tq")
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
            if len(got) > 1 and not torch.equal(got[0], got[1]):
                raise AssertionError(f"umbrella k={k} {style}: full differs from tq")
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
    if counts["umbrella_full"] == 0 or counts["umbrella_slab"] == 0:
        raise AssertionError("the full or slab umbrella kernel was not launched")
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
    from repsurf_torch.ops.kernels.fps import fps
    from repsurf_torch.ops.kernels.knn import knn_brute
    from repsurf_torch.ops.kernels.knn_window import knn_window
    from repsurf_torch.train.eval_s3dis import (
        chunk_scene,
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
    counters = (fps, knn_window, knn_brute)
    launches = {}
    for name, (coord, rgb, _) in rooms.items():
        chunks = chunk_scene(coord, rgb, voxel_passes(coord, kw["voxel_size"]),
                             kw["voxel_max"], kw["data_norm"], seed=kw["seed"])
        n_pad = padded_size(chunks[1], kw["voxel_max"])
        for c in counters:
            c.launches = 0
        reset_umbrella_counts()
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
              f"window kNN in the median filter {filter_window}")
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
    n_pad = padded_size(coord_list, kw["voxel_max"])
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
    return launches


def main():
    profile = "--profile" in sys.argv[1:]
    seconds = {}
    t0 = time.perf_counter()
    phase_card()
    dev = torch.device("cuda", 0)
    phase_build()
    seconds["card+build"] = time.perf_counter() - t0
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
    _, _, feat_bwd = phase_cls_train(dev, profile=profile)
    seconds["cls train slice"] = time.perf_counter() - t0
    for e in train_entries:
        counts = {"ball_feature_bwd": feat_bwd, "ball_group": rows_fwd,
                  "ball_group_bwd": rows_bwd}[e["name"].split("[")[0]]
        e["launches"] = counts.get(e.pop("channels"), 0)
    t0 = time.perf_counter()
    phase_cli()
    seconds["cli"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    seg_entries = phase_seg_kernels(dev)
    seconds["seg kernels"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    seg_launches = phase_seg_slice(dev, profile=profile)
    seconds["seg slice"] = time.perf_counter() - t0
    for e in seg_entries:
        e["launches"] = seg_launches[{"fps": "fps", "knn_window": "knn_window",
                                      "knn": "knn_brute"}[e["name"].split("[")[0]]]
    t0 = time.perf_counter()
    scene_launches = phase_scene(dev)
    seconds["scene"] = time.perf_counter() - t0
    for e in umb_entries:
        impl, style = e.pop("impl"), e.pop("style")
        if impl != "tq":
            e["launches"] = umb_driven[f"umbrella_{impl}"]
        else:  # tq: the cls eval slice, the seg style on R2's forwards
            e["launches"] = (launches["umbrella_tq"] if style == "cls"
                             else scene_launches["R2"]["umbrella_seg"])
    print("phase seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()))
    print(json.dumps({"kernels": entries + umb_entries + train_entries + seg_entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    sys.exit(main())
