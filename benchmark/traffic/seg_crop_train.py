"""Closed loop of the segmentation training step
(``repsurf_torch.train.train_seg.train_step``) on crops of rooms, as
PointNeXt's S3DIS recipe trains: one step after another on a pool of
batches made from the seed, each uploaded from pinned host memory, each
step's loss read back, as ``seg_train`` runs it.  Each sample is a crop
(``crop``) of a room of ``raw_points`` raw points, the rooms
``s3dis_scene_infer`` serves: the room voxelised at ``voxel`` (the first
point of each voxel kept), the ``points`` points nearest a point drawn from
the seed (S3DIS's ``voxel_max`` crop), shuffled, as openpoints' ``crop_pc``
leaves them; x and y centred and z from the crop's lowest point
(``PointCloudXYZAlign``), colours standardised.

The reference is the plan and forward the configuration's ``reference``
entry names; its loss is the label-smoothed cross-entropy
(``reference/pointnext.smoothed_ce``) at the configuration's
``train.label_smoothing``, and its generator draws the head's dropout
alone (no normal inversion)."""

import numpy as np
import torch

from benchmark.data.synthetic_scene import raw_room
from benchmark.harness import common, program, training
from benchmark.reference import models
from benchmark.reference.pointnext import smoothed_ce
from benchmark.traffic.seg_train import end_to_end, shapes, unit  # noqa: F401  the same loop


def voxel_first(coord, voxel):
    """Indices, ascending, of the first point of each occupied voxel of
    side ``voxel``."""
    d = np.floor((coord - coord.min(0)) / voxel).astype(np.int64)
    key = (d[:, 0] * (d[:, 1].max() + 1) + d[:, 1]) * (d[:, 2].max() + 1) + d[:, 2]
    return np.sort(np.unique(key, return_index=True)[1])


def crop(rng, coord, rgb, label, points, voxel):
    """One training sample of a raw room: (coord, rgb, label) of the
    ``points`` voxelised points nearest a point drawn from ``rng``, in an
    order drawn from it, coordinates aligned."""
    keep = voxel_first(coord, voxel)
    if len(keep) < points:
        raise ValueError(f"a room of {len(keep)} voxels cannot give a crop of {points} points")
    coord, rgb, label = coord[keep], rgb[keep], label[keep]
    d2 = np.square(coord - coord[rng.randint(len(coord))]).sum(1)
    near = np.argsort(d2, kind="stable")[:points]
    near = near[rng.permutation(points)]
    coord = coord[near].copy()
    coord[:, :2] -= coord[:, :2].mean(0)
    coord[:, 2] -= coord[:, 2].min()
    return coord, rgb[near], label[near]


def make_pool(ctx):
    """[{coord, feat, label, valid}] numpy batches of ``batch`` crops."""
    tp, inf = ctx.traffic, ctx.config["infer"]
    rng = np.random.RandomState(ctx.seeds.data)
    mean, std = (np.array(inf[k], np.float32) for k in ("rgb_mean", "rgb_std"))
    pool = []
    for _ in range(tp["pool"]):
        samples = [crop(rng, *raw_room(rng, tp["raw_points"]), tp["points"], tp["voxel"])
                   for _ in range(tp["batch"])]
        pool.append({
            "coord": np.stack([c for c, _, _ in samples]).astype(np.float32),
            "feat": np.stack([(rgb / 255.0 - mean) / std for _, rgb, _ in samples])
            .astype(np.float32),
            "label": np.stack([lab for _, _, lab in samples]).astype(np.int64),
            "valid": np.full(tp["batch"], tp["points"], np.int32)})
    return pool


def setup(ctx):
    from repsurf_torch.train import train_seg

    cfg = train_seg.SegConfig(**ctx.config["program"])
    dev = ctx.device
    model = train_seg.build_model(cfg).to(dev)
    program.init_weights(model, ctx.seeds.weights, ctx.config["init"]["weight_gain"], dev)
    state = {"ctx": ctx, "cfg": cfg, "model": model, "start": program.snapshot(model),
             "optimizer": train_seg.make_optimizer(model, cfg),
             "pool": make_pool(ctx),
             "gen": torch.Generator(dev).manual_seed(ctx.seeds.steps),
             "weight": torch.tensor(ctx.config["train"]["class_weights"], device=dev)}
    state["host"] = [{k: program.pinned(v) for k, v in b.items()} for b in state["pool"]]
    state["readings"] = training.program_readings(
        model, state["optimizer"], lambda i: unit(state, i)["loss"],
        ctx.config["train"]["betas"][0])
    ctx.log(f"first steps' losses {state['readings']['loss']}")
    return state


def reference_loss(ctx, pool, half=False, prec=models.Precision()):
    """loss_fn(p, i) of the reference's step i on pool batch i; ``half``:
    the first half of each batch only (a planted fault)."""
    dev, arch, tcfg = ctx.device, ctx.config["arch"], ctx.config["train"]
    plan_fn, forward = common.reference_model(ctx.config)
    gen = torch.Generator(dev).manual_seed(ctx.seeds.steps)

    def loss_fn(p, i):
        b = {k: torch.from_numpy(v).to(dev) for k, v in pool[i % len(pool)].items()}
        if half:
            b = {k: v[: v.shape[0] // 2] for k, v in b.items()}
        with torch.no_grad():
            plan = plan_fn(arch, b["coord"], b["valid"].long(), train=True)
        logits = forward(p, arch, plan, b["feat"], True, None, gen, prec)
        return smoothed_ce(logits, b["label"], tcfg["label_smoothing"], tcfg["ignore_label"])

    return loss_fn


free = program.free


def reference(state, **kw):
    return training.reference(state, reference_loss, **kw)


def check(state):
    free(state)
    return training.checks(state["readings"], reference(state), state["ctx"].spec.cell["limits"])
