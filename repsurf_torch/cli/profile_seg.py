"""Per-kernel device profile of the segmentation train step (batch 2 x
80,000 points): the port's counterpart of tools/profile_seg.py.

    python -m repsurf_torch.cli.profile_seg [--steps 6] [--top 40] [--fwd] \\
        [--scene RAW] [--points 80000] [--device cuda]

Two measurements, on ``SegConfig``'s model (seeded weights) and the root
bench.py's batch of two rooms:
  1. the first step's seconds (kernel build and first launches), then two
     queued runs of ``--steps`` steps, each synchronised once;
  2. ``utils.profiling.op_table`` of ``--steps`` steps: device self time a
     step by kernel from a checked trace, the busy total beside the host
     wall time, so the card's idle share can be read.
``--fwd`` also tables the eval forward (``eval_step``) and the train step
minus it, by kernel (about the backward and the optimizer).  ``--scene
RAW`` also tables whole-scene serving: ``predict_scene`` on the first of
``synthetic_scenes``' rooms at RAW raw points, chunks of ``--points``.
``--points`` shrinks the rooms for a run on the CPU (``--device cpu``),
where the tables list host operators.
"""

import argparse
import time

import numpy as np
import torch

from ..utils.profiling import OpTable, op_table
from .common import resolve_device, seg_batch, sync

SCENE_REPS = 2  # traced predict_scene calls


def parse_args(argv=None):
    p = argparse.ArgumentParser("RepSurf seg train-step profile (PyTorch)")
    p.add_argument("--steps", type=int, default=6)
    p.add_argument("--top", type=int, default=40)
    p.add_argument("--fwd", action="store_true", default=False,
                   help="also table the eval forward and the train step minus it")
    p.add_argument("--scene", type=int, default=0, metavar="RAW",
                   help="also table predict_scene on a room of RAW raw points")
    p.add_argument("--points", type=int, default=80000, help="points a room")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (cuda, cuda:1, cpu); the card by default")
    return p.parse_args(argv)


def seg_train_setup(n, b, dev):
    """(cfg, model, optimizer, batch, class weights, generator) of the
    profiled step: ``SegConfig(voxel_max=n, batch_size=b)``, the model's
    parameters from seed 0, bench.py's batch on ``dev``."""
    from ..data.s3dis import CLASS_WEIGHTS
    from ..train.train_seg import SegConfig, build_model, make_optimizer

    cfg = SegConfig(voxel_max=n, batch_size=b)
    model = build_model(cfg, generator=torch.Generator().manual_seed(0)).to(dev)
    opt = make_optimizer(model, cfg)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in seg_batch(n, b).items()}
    w = torch.tensor(CLASS_WEIGHTS[5], dtype=torch.float32, device=dev)
    return cfg, model, opt, batch, w, torch.Generator(dev).manual_seed(1)


def synthetic_scenes(n_scenes, raw):
    """tools/bench_infer_s3dis.py's rooms: ``RandomState(0)``, per scene
    ``synthetic_room`` and colours in 0..255."""
    from ..data.synthetic_scene import synthetic_room

    rng = np.random.RandomState(0)
    scenes = []
    for _ in range(n_scenes):
        coord = synthetic_room(raw, rng=rng)
        scenes.append((coord, (rng.rand(raw, 3) * 255.0).astype(np.float32)))
    return scenes


def difference(a, b):
    """``OpTable`` of a's rows minus b's by name, where positive (no wall
    time: the two windows' host work differs in kind, not by a part)."""
    if a.rows is None or b.rows is None:
        return OpTable(a.activity, None, float("nan"), float("nan"))
    ms_b = {name: ms for name, ms, _ in b.rows}
    calls_b = {name: calls for name, _, calls in b.rows}
    rows = [(name, ms - ms_b.get(name, 0.0), calls - calls_b.get(name, 0.0))
            for name, ms, calls in a.rows if ms - ms_b.get(name, 0.0) > 0]
    rows.sort(key=lambda r: -r[1])
    return OpTable(a.activity, rows, sum(r[1] for r in rows), float("nan"))


def main(argv=None):
    """Returns {"train": OpTable[, "forward": ..., "train minus forward": ...]
    [, "scene": ...]}."""
    args = parse_args(argv)
    from ..train.train_seg import eval_step, train_step

    dev = resolve_device(args.device)
    b = 2
    cfg, model, opt, batch, w, gen = seg_train_setup(args.points, b, dev)
    print(f"device={dev} batch {b} x {args.points} points")

    def one_step():
        return train_step(model, opt, batch, w, cfg, generator=gen)[0]

    t0 = time.perf_counter()
    float(one_step())
    print(f"first step (kernel build, first launches): {time.perf_counter() - t0:.3f} s")
    for _ in range(2):
        t0 = time.perf_counter()
        for _ in range(args.steps):
            one_step()
        sync(dev)
        dt = (time.perf_counter() - t0) / args.steps
        print(f"train step (queued x{args.steps}): {dt * 1e3:.3f} ms = {b / dt:.3f} scenes/s")

    tables = {"train": op_table(one_step, args.steps, device=dev)}
    print("\n".join(tables["train"].lines("train step", args.top)))
    if args.fwd:
        def fwd():
            return eval_step(model, batch, w, cfg)[0]

        tables["forward"] = op_table(fwd, args.steps, device=dev)
        tables["train minus forward"] = difference(tables["train"], tables["forward"])
        print("\n".join(tables["forward"].lines("eval forward", args.top)))
        print("\n".join(tables["train minus forward"].lines(
            "train step minus eval forward (about the backward and the optimizer)", args.top)))
    if args.scene:
        tables["scene"] = scene_table(model, cfg, args.scene, dev)
        print("\n".join(tables["scene"].lines(
            f"whole scene (predict_scene, {args.scene} raw points)", args.top)))
    return tables


def scene_table(model, cfg, raw, dev):
    """``OpTable`` of ``predict_scene`` (chunks of ``cfg.voxel_max``) on the
    first of ``synthetic_scenes``' rooms."""
    from ..train.eval_s3dis import predict_scene

    (coord, feat), = synthetic_scenes(1, raw)
    model.eval()

    def forward_fn(batch):
        with torch.no_grad():
            return model(batch["coord"], batch["feat"], batch["valid"])

    return op_table(lambda: predict_scene(forward_fn, coord, feat, cfg.num_class,
                                          voxel_max=cfg.voxel_max, device=dev),
                    SCENE_REPS, device=dev)


if __name__ == "__main__":
    main()
