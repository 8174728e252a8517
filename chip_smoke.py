"""Smoke run of the PyTorch port (repsurf_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Run from the root of a checkout.  Phases, each printing its lines:

  1. card    - requires CUDA; prints the card's name and power limit as
               nvidia-smi gives them, the torch / CUDA versions, TF32 off;
  2. build   - compiles repsurf_torch/csrc/*.cu with nvcc, prints the time;
  3. kernels - each CUDA kernel against its plain PyTorch version on the
               card, at the shapes of the classification eval path, with
               kernel and plain times (CUDA events, median of 20 runs);
  4. slice   - repsurf_ssg_umb at full width, seeded random weights, vote
               evaluation (batch 64, 2048 -> 1024 points, 10 votes) through
               the kernels; launch counts, finite log-probs, kernel path
               against plain path on one batch, times per batch;
  5. seg kernels - the polar-division check; FPS, window kNN and brute kNN
               against their plain versions at every shape of the
               repsurf_umb_ssg step at 2 x 80,000 points (synthetic rooms
               and their FPS subsets), with the window kernel's re-solved
               queries per sample; an adversarial window case held to brute
               force; kernel and plain times (CUDA events, median);
  6. seg slice - repsurf_umb_ssg at full width, seeded random weights,
               3 train steps and one eval step on bench.py's batch of two
               80,000-point rooms; launch counts, finite losses, kernel path
               against plain path on one eval forward, step times (with
               --profile also a torch.profiler table of one train step);
  7. a JSON line of the kernels, then {"ok": true, "device": {...}}.

Any failed check raises, so the script exits non-zero and prints no
result line.
"""

import contextlib
import json
import math
import statistics
import subprocess
import sys
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


def adaptive_ms(fn):
    """median_ms with one sizing run for warm-up: REPS runs, or as few as 3
    for a function slower than SLOW_MS / REPS."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    first = (time.perf_counter() - t0) * 1e3
    return median_ms(fn, reps=max(3, min(REPS, int(SLOW_MS / max(first, 1e-3)))), warm=1)


def _entry(name, source, replaces, err, kernel_fn, plain_fn, timer=median_ms):
    ms, plain_ms = timer(kernel_fn), timer(plain_fn)
    print(f"  {name}: max_abs_err {err:.3g}, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "max_abs_err": float(err), "ms": ms, "plain_ms": plain_ms}


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
    return idx, sam, _entry(
        f"fps[{xyz.shape[0]}x{xyz.shape[1]}->{npoint}]",
        "repsurf_torch/csrc/fps.cu", "repsurf_tpu/ops/pallas/fps.py:36", 0.0,
        lambda: fps(xyz, npoint, return_xyz=True), lambda: fps_plain(xyz, npoint),
    )


def check_umbrella(xyz):
    from repsurf_torch.geometry.polar import xyz2sphere
    from repsurf_torch.ops.gather import index_points
    from repsurf_torch.ops.kernels.umbrella import (
        umbrella_fan_features,
        umbrella_fan_features_plain,
    )

    feat, knn_idx = umbrella_fan_features(xyz, 9, return_knn=True)
    pfeat, pknn = umbrella_fan_features_plain(xyz, 9, return_knn=True)
    torch.cuda.synchronize()
    if not torch.equal(knn_idx, pknn):
        raise AssertionError(f"umbrella: kNN differs at {(knn_idx != pknn).sum()} slots")
    rel = index_points(xyz, pknn[:, :, 1:]) - xyz[:, :, None, :]
    phi = torch.sort(xyz2sphere(rel)[..., 2], dim=-1).values
    near = torch.diff(phi, dim=-1).amin(-1) < NEAR_TIE  # [B, N]
    err = (feat - pfeat).abs().amax(dim=(2, 3))
    off = err > UMB_ATOL
    n_near, n_pts = int(near.sum()), near.numel()
    print(f"  umbrella near-tie points (azimuth gap < {NEAR_TIE}): {n_near} of {n_pts}; "
          f"points off by > {UMB_ATOL}: {int(off.sum())}")
    if (off & ~near).any():
        raise AssertionError(f"umbrella: {int((off & ~near).sum())} points differ "
                             f"beyond {UMB_ATOL} away from azimuth near-ties")
    if n_near > NEAR_TIE_SHARE * n_pts:
        raise AssertionError(f"umbrella: {n_near} near-tie points exceed 0.1%")
    return _entry(
        f"umbrella[{xyz.shape[0]}x{xyz.shape[1]},k=9]",
        "repsurf_torch/csrc/umbrella.cu", "repsurf_tpu/ops/pallas/umbrella.py:302",
        float(err[~near].max()),
        lambda: umbrella_fan_features(xyz, 9), lambda: umbrella_fan_features_plain(xyz, 9),
    )


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
    entry = _entry(
        f"ball_feature[{xyz.shape[0]}x{xyz.shape[1]}->{new_xyz.shape[1]},S={nsample},C={c}]",
        "repsurf_torch/csrc/ball_group.cu", replaces, err,
        lambda: ball_group_feature(*args, return_polar=True),
        lambda: ball_group_feature_plain(*args, return_polar=True),
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
        entries.append(check_umbrella(xyz1))
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
    return entries


@contextlib.contextmanager
def plain_kernels():
    """Route the model's kernel calls to the plain versions, for the
    kernel-path / plain-path comparison of the slice; restored on exit."""
    import repsurf_torch.geometry.umbrella as geo_umbrella
    import repsurf_torch.nn.blocks as blocks
    import repsurf_torch.ops.interpolate as interpolate
    import repsurf_torch.ops.sampling as sampling
    from repsurf_torch.ops.kernels.ball_group import ball_group_feature_plain
    from repsurf_torch.ops.kernels.fps import fps_plain
    from repsurf_torch.ops.kernels.knn import knn_plain
    from repsurf_torch.ops.kernels.umbrella import umbrella_fan_features_plain

    swaps = [(sampling, "fps", fps_plain),
             (geo_umbrella, "umbrella_fan_features", umbrella_fan_features_plain),
             (blocks, "ball_group_feature", ball_group_feature_plain),
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


def phase_slice(dev):
    from repsurf_torch.data.scanobjectnn import SyntheticClouds
    from repsurf_torch.data.transforms import fps_sample
    from repsurf_torch.ops.kernels.ball_group import ball_group_feature
    from repsurf_torch.ops.kernels.fps import fps
    from repsurf_torch.ops.kernels.umbrella import umbrella_fan_features
    from repsurf_torch.train.train_cls import ClsConfig, build_model, eval_step, evaluate

    cfg = ClsConfig()
    model = build_model(cfg, generator=torch.Generator().manual_seed(cfg.seed)).to(dev).eval()
    n_params = sum(p.numel() for p in model.parameters())
    data = SyntheticClouds(n_samples=2 * BATCH, seed=1)
    counters = (fps, umbrella_fan_features, ball_group_feature)

    for k in counters:
        k.launches = 0
    ball_group_feature.launches_by_channels.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    single_acc, vote_acc = evaluate(model, data, cfg, torch.Generator(dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in counters}
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
    entry = _entry(
        f"fps[{xyz.shape[0]}x{xyz.shape[1]}->{npoint}]", FPS_SRC, FPS_TPU, 0.0,
        lambda: fps(xyz, npoint, valid=valid), lambda: fps_plain(xyz, npoint, valid=valid),
        timer=adaptive_ms,
    )
    return sam, entry


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
    entry = _entry(name, WINDOW_SRC if kind == "knn_window" else KNN_SRC,
                   WINDOW_TPU if kind == "knn_window" else KNN_TPU, err,
                   lambda: fn(k, xyz, q, valid=valid), lambda: knn_plain(k, xyz, q, valid=valid),
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


def main():
    profile = "--profile" in sys.argv[1:]
    seconds = {}
    t0 = time.perf_counter()
    phase_card()
    dev = torch.device("cuda", 0)
    phase_build()
    seconds["card+build"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    entries = phase_kernels(dev)
    seconds["kernels"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    launches, by_c = phase_slice(dev)
    seconds["slice"] = time.perf_counter() - t0
    for e in entries:
        name = e["name"].split("[")[0]
        if name == "ball_feature":
            e["launches"] = by_c.get(e.pop("channels"), 0)
        else:
            e["launches"] = launches[{"fps": "fps", "umbrella": "umbrella_fan_features"}[name]]
    t0 = time.perf_counter()
    seg_entries = phase_seg_kernels(dev)
    seconds["seg kernels"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    seg_launches = phase_seg_slice(dev, profile=profile)
    seconds["seg slice"] = time.perf_counter() - t0
    for e in seg_entries:
        e["launches"] = seg_launches[{"fps": "fps", "knn_window": "knn_window",
                                      "knn": "knn_brute"}[e["name"].split("[")[0]]]
    print("phase seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()))
    print(json.dumps({"kernels": entries + seg_entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    sys.exit(main())
