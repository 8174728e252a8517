"""The system's three headline numbers on one card (the root bench.py's
counterpart):

  1. ``s3dis_train_scenes_per_sec_per_chip``: the segmentation TRAIN step
     at production shape (batch 2 x 80,000-point rooms, the reference's
     per-GPU share of its global batch 8);
  2. ``s3dis_infer_scenes_per_sec_per_chip``: whole-scene inference, the
     complete test_s3dis protocol per scene (``cli/bench_infer_s3dis.py``,
     run as a subprocess with a timeout);
  3. ``scanobjectnn_eval_clouds_per_sec_per_chip``: the classification
     eval pipeline (FPS 2048 -> 1024 + umbrella RepSurf + 3 SA-CD stages +
     head, batch 64).

    python -m repsurf_torch.bench [--device cuda]

prints one JSON line a metric in that order, the classification line
last.  Each line has bench.py's keys (``metric``, ``value``, ``unit``,
``vs_baseline``, for cls ``vs_baseline_range``), one metric name a
measurement, success or failure, and adds ``device`` and ``power_limit``
as ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
them and ``launches``, the kernel launches of the measurement.  The JAX
tools' other names for the same numbers are ``s3dis_train_samples_per_sec_per_chip``
(tools/bench_seg.py) and ``s3dis_infer_scenes_per_sec``
(tools/bench_infer_s3dis.py).  It runs on the card unless the caller asks
for the CPU, and raises without one.

Baseline derivations
--------------------
Segmentation (measured reference wall clock, the only published timing):
the reference trains RepSurf-U on S3DIS in 9.18 h / 100 epochs at global
batch 8 on 4 x RTX 3090 (segmentation/README.md:81).  The Area-5 split
leaves 204 training rooms x loop 30 = 6120 samples an epoch -> 765 steps an
epoch -> 76500 steps -> 0.432 s a step of wall clock INCLUDING per-epoch
validation; the training loop's share is ~0.325 s a step -> 8 / 0.325 / 4
GPUs = 6.15 scenes/s per GPU.  The pure-step 6.15 is the harder target
(the wall-clock figure would be 4.63).

Whole-scene inference: the reference publishes no inference wall clock,
so ``vs_baseline`` is null.

Classification (an estimate: the reference publishes NO classification
throughput): the reference recipe per batch of 64 on an A100, PyTorch f32
with its CUDA pointops: MLP/conv FLOPs ~28 GFLOP a batch -> ~2.5 ms at a
realistic 60 % of 19.5 TFLOP/s f32; FPS 2048 -> 1024 is 1024 sequential
kernel rounds, ~2 ms; kNN k = 9 + ball queries (67 M pair distances x 3
stages) ~4-6 ms; gathers, BN/ReLU elementwise and the dispatch of ~40
kernel launches ~4-6 ms.  Total ~12-18 ms a batch => 3500-5300 clouds/s;
``vs_baseline`` takes the midpoint 4000, ``vs_baseline_range`` the bounds.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

REFERENCE_3090_SEG_SCENES_PER_SEC_PER_GPU = 6.15
A100_REFERENCE_CLOUDS_PER_SEC = 4000.0
A100_REFERENCE_CLOUDS_PER_SEC_RANGE = (3500.0, 5300.0)
STDERR_TAIL = 2000  # characters of a failed child's stderr kept in its marker
SEG_METRIC = "s3dis_train_scenes_per_sec_per_chip"
INFER_METRIC = "s3dis_infer_scenes_per_sec_per_chip"
CLS_METRIC = "scanobjectnn_eval_clouds_per_sec_per_chip"


def resolve_device(device):
    """torch.device(device); raises for a CUDA device where there is none
    (an entry point never falls back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r}: no CUDA device here "
                           "(ask for the CPU with device='cpu' / --device cpu)")
    return dev


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def card_fields(dev):
    """{"device": name, "power_limit": limit} as nvidia-smi gives them for
    a CUDA device; the CPU has no power limit."""
    if dev.type != "cuda":
        return {"device": "cpu", "power_limit": None}
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    smi = subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    name, limit = (s.strip() for s in smi.rsplit(",", 1))
    return {"device": name, "power_limit": limit}


def launch_counts():
    """Kernel launches of this process so far, by kernel: FPS, window kNN
    and its re-solve, brute kNN, the umbrella kernel's tq route (the one a
    model path takes), the ball-feature kernel."""
    from .ops.kernels import kernel_launches

    k = kernel_launches()
    return {"fps": sum(k["fps"].values()), "knn_window": k["knn_window"],
            "knn_window_resolve": k["knn_window_resolve"],
            "knn_brute": sum(k["knn_brute"].values()), "umbrella_tq": k["umbrella"]["tq"],
            "ball_feature": sum(k["ball_feature_by_c"].values())}


def launches_since(before):
    return {k: v - before[k] for k, v in launch_counts().items()}


def seg_batch(n=80000, b=2):
    """bench.py's batch: ``RandomState(0)``, then per sample a surface-
    sampled room (spatial pruning behaves as on voxelized S3DIS, which
    gaussian blobs misrepresent), random colours and labels, padded."""
    from .data.s3dis import pad_batch
    from .data.synthetic_scene import synthetic_room

    rng = np.random.RandomState(0)
    samples = [(synthetic_room(n, rng=rng), rng.rand(n, 3).astype(np.float32),
                rng.randint(0, 13, n).astype(np.int64)) for _ in range(b)]
    return pad_batch(samples, n)


def cls_points(batch=64, n_raw=2048):
    """bench.py's clouds: ``RandomState(0).randn(batch, n_raw, 3)``."""
    return np.random.RandomState(0).randn(batch, n_raw, 3).astype(np.float32)


def seg_train_setup(n, b, dev):
    """(cfg, model, optimizer, batch, class weights, generator) of bench_seg's
    step: ``SegConfig(voxel_max=n, batch_size=b)``, the model's parameters
    from seed 0, bench.py's batch on ``dev``."""
    from .data.s3dis import CLASS_WEIGHTS
    from .train.train_seg import SegConfig, build_model, make_optimizer

    cfg = SegConfig(voxel_max=n, batch_size=b)
    model = build_model(cfg, generator=torch.Generator().manual_seed(0)).to(dev)
    opt = make_optimizer(model, cfg)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in seg_batch(n, b).items()}
    w = torch.tensor(CLASS_WEIGHTS[5], dtype=torch.float32, device=dev)
    return cfg, model, opt, batch, w, torch.Generator(dev).manual_seed(1)


def bench_seg(n=80000, b=2, steps=6, device="cuda"):
    """Segmentation train step: one warm step, then ``steps`` timed steps,
    each ending in ``float(loss)``, which synchronises; the value is b over
    the median step.  Prints and returns the line."""
    from .train.train_seg import train_step

    dev = resolve_device(device)
    cfg, model, opt, batch, w, gen = seg_train_setup(n, b, dev)
    before = launch_counts()
    t0 = time.perf_counter()
    loss, _ = train_step(model, opt, batch, w, cfg, generator=gen)
    float(loss)
    first = time.perf_counter() - t0
    times = []
    for _ in range(steps):
        t0 = time.perf_counter()
        loss, _ = train_step(model, opt, batch, w, cfg, generator=gen)
        float(loss)
        times.append(time.perf_counter() - t0)
    sps = b / statistics.median(times)
    return emit({"metric": SEG_METRIC, "value": round(sps, 3), "unit": "scenes/sec",
                 "vs_baseline": round(sps / REFERENCE_3090_SEG_SCENES_PER_SEC_PER_GPU, 4),
                 "first_step_s": round(first, 3), **card_fields(dev),
                 "launches": launches_since(before)})


def bench_infer(scenes=3, timeout=1500, device="cuda"):
    """Whole-scene inference: ``python -m repsurf_torch.cli.bench_infer_s3dis
    --scenes N`` as a subprocess with a timeout, its JSON line passed on.
    On failure, a marker with a null value, ``status`` ``timeout`` or
    ``subprocess-failed-rc<N>`` and the last STDERR_TAIL characters of the
    child's stderr: a null value must never look like data."""
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cmd = [sys.executable, "-m", "repsurf_torch.cli.bench_infer_s3dis", "--scenes",
           str(scenes), "--device", str(device)]
    try:
        out = subprocess.run(cmd, cwd=here, capture_output=True, text=True, timeout=timeout)
    except subprocess.TimeoutExpired as e:
        status, err = "timeout", e.stderr
    else:
        for line in out.stdout.splitlines():
            if line.startswith("{"):
                return emit(json.loads(line))
        status = f"subprocess-failed-rc{out.returncode}" if out.returncode else "no-output"
        err = out.stderr
    if isinstance(err, bytes):
        err = err.decode(errors="replace")
    return emit({"metric": INFER_METRIC, "value": None, "status": status,
                 "unit": "scenes/sec", "vs_baseline": None,
                 "stderr_tail": (err or "")[-STDERR_TAIL:]})


def bench_cls(batch=64, n_raw=2048, iters=40, device="cuda"):
    """Classification eval pipeline, ``torch.no_grad()``: one warm call and
    a queued run of 5, then the better of two runs of ``iters`` forwards,
    each queued and synchronised once at the end (the card runs them in
    order, so the run's time over iters is the time a batch, without a
    host round trip a batch that a serving loop does not pay)."""
    from .data.transforms import fps_sample
    from .train.train_cls import ClsConfig, build_model

    dev = resolve_device(device)
    cfg = ClsConfig()
    model = build_model(cfg, generator=torch.Generator().manual_seed(0)).to(dev).eval()
    points = torch.from_numpy(cls_points(batch, n_raw)).to(dev)

    def forward():
        return model(fps_sample(points, cfg.num_point))

    def run(n_iter):
        t0 = time.perf_counter()
        for _ in range(n_iter):
            forward()
        sync(dev)
        return (time.perf_counter() - t0) / n_iter

    before = launch_counts()
    with torch.no_grad():
        forward()
        sync(dev)
        run(5)
        per_batch = min(run(iters), run(iters))
    clouds_per_sec = batch / per_batch
    lo, hi = A100_REFERENCE_CLOUDS_PER_SEC_RANGE
    return emit({"metric": CLS_METRIC, "value": round(clouds_per_sec, 2),
                 "unit": "clouds/sec",
                 "vs_baseline": round(clouds_per_sec / A100_REFERENCE_CLOUDS_PER_SEC, 4),
                 "vs_baseline_range": [round(clouds_per_sec / hi, 4),
                                       round(clouds_per_sec / lo, 4)],
                 **card_fields(dev), "launches": launches_since(before)})


def emit(line):
    print(json.dumps(line), flush=True)
    return line


def main(argv=None):
    p = argparse.ArgumentParser("repsurf_torch bench")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (cuda, cuda:1, cpu); the card by default")
    args = p.parse_args(argv)
    resolve_device(args.device)
    bench_seg(device=args.device)
    bench_infer(device=args.device)
    bench_cls(device=args.device)  # the headline metric last


if __name__ == "__main__":
    main()
