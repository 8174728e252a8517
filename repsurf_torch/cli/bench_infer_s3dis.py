"""Whole-scene S3DIS inference throughput on one card: the port's
counterpart of tools/bench_infer_s3dis.py.

    python -m repsurf_torch.cli.bench_infer_s3dis [--scenes 6] [--raw 220000] \\
        [--batch_size 4] [--device cuda]

Times the COMPLETE test_s3dis protocol per scene (voxel passes, potential-
field chunking, normalisation, padded batched forwards, softmax vote
accumulation, argmax) on surface-sampled synthetic rooms, with the model
at ``SegConfig()`` and random weights from seed 0.  Reference analog: the
per-scene loop of segmentation/tool/test_s3dis.py:186-251.

Prints one JSON line, ``s3dis_infer_scenes_per_sec_per_chip`` (the name
``repsurf_torch.bench`` gives both its success line and its failure
marker), and on stderr the seconds and points.  The reference publishes no
inference wall clock, so ``vs_baseline`` is null.
"""

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..bench import INFER_METRIC, card_fields, launch_counts, launches_since, resolve_device, sync


def parse_args(argv=None):
    p = argparse.ArgumentParser("RepSurf whole-scene inference bench (PyTorch)")
    p.add_argument("--scenes", type=int, default=6)
    p.add_argument("--raw", type=int, default=220000,
                   help="raw points a synthetic room (before voxelization)")
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (cuda, cuda:1, cpu); the card by default")
    return p.parse_args(argv)


def synthetic_scenes(n_scenes, raw):
    """The bench's rooms: ``RandomState(0)``, per scene ``synthetic_room``
    and colours in 0..255."""
    from ..data.synthetic_scene import synthetic_room

    rng = np.random.RandomState(0)
    scenes = []
    for _ in range(n_scenes):
        coord = synthetic_room(raw, rng=rng)
        scenes.append((coord, (rng.rand(raw, 3) * 255.0).astype(np.float32)))
    return scenes


def device_compute(cfg, forward_fn, scenes, batch_size, dev):
    """Scenes a second of the forwards and vote scatters alone: every chunk
    batch of every scene staged on ``dev`` first (``scene_batches``, chunk
    seed 1000, the batches padded by ``padded_size`` as the test CLI
    serves them), then each forward followed by its vote ``index_add_``,
    one read-back at the end.  A warm run, then a timed one.  Returns
    (scenes/s, [labels [N] int64 a scene])."""
    from ..train.eval_s3dis import add_votes, scene_batches

    staged = []
    for coord, feat in scenes:
        batches = scene_batches(coord, feat, cfg.voxel_size, cfg.voxel_max, batch_size,
                                cfg.data_norm, seed=1000)
        staged.append((coord.shape[0], [
            ({k: torch.from_numpy(v).to(dev) for k, v in batch.items()},
             torch.from_numpy(rows.reshape(-1)).to(dev)) for batch, rows in batches]))

    def run_all():
        labels = []
        for n_scene, batches in staged:
            pred = torch.zeros((n_scene + 1, cfg.num_class), dtype=torch.float64, device=dev)
            count = torch.zeros((n_scene + 1,), dtype=torch.float64, device=dev)
            for batch, idx in batches:
                add_votes(pred, count, forward_fn(batch), idx)
            labels.append((pred[:n_scene] / torch.clamp(count[:n_scene], min=1.0)[:, None])
                          .argmax(dim=1))
        return labels

    run_all()
    sync(dev)
    t0 = time.perf_counter()
    labels = [t.cpu() for t in run_all()]  # the one read-back
    dt = time.perf_counter() - t0
    return len(staged) / dt, [t.numpy() for t in labels]


def main(argv=None):
    args = parse_args(argv)
    from ..train.eval_s3dis import predict_scene
    from ..train.train_seg import SegConfig, build_model

    dev = resolve_device(args.device)
    build_s = 0.0
    if dev.type == "cuda":  # reuses a library another process built
        from ..ops.kernels import build

        _, build_s = build.build()
    cfg = SegConfig()
    model = build_model(cfg, generator=torch.Generator().manual_seed(0)).to(dev).eval()

    def forward_fn(batch):
        with torch.no_grad():
            return model(batch["coord"], batch["feat"], batch["valid"])

    scenes = synthetic_scenes(args.scenes, args.raw)

    def run(coord, feat):
        return predict_scene(forward_fn, coord, feat, cfg.num_class,
                             voxel_size=cfg.voxel_size, voxel_max=cfg.voxel_max,
                             batch_size=args.batch_size, data_norm=cfg.data_norm, device=dev)

    before = launch_counts()
    run(*scenes[0])  # warm-up: first launches, allocator
    t0 = time.perf_counter()
    npts = sum(run(coord, feat).shape[0] for coord, feat in scenes)
    dt = time.perf_counter() - t0
    sps = args.scenes / dt
    launches = launches_since(before)
    dev_sps, _ = device_compute(cfg, forward_fn, scenes, args.batch_size, dev)
    print(f"# {args.scenes} scenes x {args.raw} raw points in {dt:.3f} s "
          f"({npts / dt / 1e6:.3f} M points/s); device compute only {dev_sps:.3f} scenes/s; "
          f"kernel build {build_s:.1f} s", file=sys.stderr)
    print(json.dumps({
        "metric": INFER_METRIC,
        # wall clock of predict_scene a scene: host chunking and padding,
        # uploads, forwards, votes and the label read-back
        "value": round(sps, 3),
        # forwards and vote scatters alone, every batch already on the
        # device: what the card sustains without the host's share
        "device_compute_value": round(dev_sps, 3),
        "status": "ok", "unit": "scenes/sec", "vs_baseline": None,
        "kernel_build_s": round(build_s, 3), **card_fields(dev), "launches": launches,
    }), flush=True)


if __name__ == "__main__":
    main()
