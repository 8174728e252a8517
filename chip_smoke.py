"""Smoke run of the PyTorch port (repsurf_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

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
  5. a JSON line of the kernels, then {"ok": true, "device": {...}}.

Any failed check raises, so the script exits non-zero and prints no
result line.
"""

import contextlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

BATCH, RAW_POINTS, NUM_POINT = 64, 2048, 1024
REPS = 20
UMB_ATOL = 1e-5  # umbrella features: atan2/acos/sqrt/division chains
NEAR_TIE = 1e-6  # azimuth gap under which two fan neighbours may swap
NEAR_TIE_SHARE = 1e-3
POS_ATOL = 1e-6  # ball pos: xyz2sphere of the relative coordinates
LOGP_ATOL = 1e-4  # log-probs, kernel path against plain path


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


def median_ms(fn):
    """Median over REPS runs of fn, timed with CUDA events after warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def _entry(name, source, replaces, err, kernel_fn, plain_fn):
    ms, plain_ms = median_ms(kernel_fn), median_ms(plain_fn)
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
    import repsurf_torch.ops.sampling as sampling
    from repsurf_torch.ops.kernels.ball_group import ball_group_feature_plain
    from repsurf_torch.ops.kernels.fps import fps_plain
    from repsurf_torch.ops.kernels.umbrella import umbrella_fan_features_plain

    swaps = [(sampling, "fps", fps_plain),
             (geo_umbrella, "umbrella_fan_features", umbrella_fan_features_plain),
             (blocks, "ball_group_feature", ball_group_feature_plain)]
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


def main():
    phase_card()
    dev = torch.device("cuda", 0)
    phase_build()
    entries = phase_kernels(dev)
    launches, by_c = phase_slice(dev)
    for e in entries:
        name = e["name"].split("[")[0]
        if name == "ball_feature":
            e["launches"] = by_c.get(e.pop("channels"), 0)
        else:
            e["launches"] = launches[{"fps": "fps", "umbrella": "umbrella_fan_features"}[name]]
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    sys.exit(main())
