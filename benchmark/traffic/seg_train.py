"""Closed loop of the segmentation training step
(``repsurf_torch.train.train_seg.train_step``): one step after another on
a pool of batches made from the seed, each uploaded from pinned host memory,
each step's loss read back as the training loop logs it.  The program's
model is the configuration's ``program.model``; the reference that checks
it is the one its ``reference`` entry names (a plan and a forward with
``models.seg_plan``'s and ``models.seg_forward``'s signatures)."""

import math

import numpy as np
import torch

from benchmark.data.synthetic_scene import raw_room
from benchmark.harness import common, program, training
from benchmark.reference import losses, models


def make_pool(ctx):
    """[{coord, feat, label, valid}] numpy batches: each sample a room of
    ``points`` points (the post-voxelisation look), centred, colours
    standardised."""
    tp, inf = ctx.traffic, ctx.config["infer"]
    rng = np.random.RandomState(ctx.seeds.data)
    mean, std = (np.array(inf[k], np.float32) for k in ("rgb_mean", "rgb_std"))
    pool = []
    for _ in range(tp["pool"]):
        samples = [raw_room(rng, tp["points"]) for _ in range(tp["batch"])]
        coord = np.stack([c - c.mean(0) for c, _, _ in samples]).astype(np.float32)
        feat = np.stack([(rgb / 255.0 - mean) / std for _, rgb, _ in samples]).astype(np.float32)
        label = np.stack([lab for _, _, lab in samples]).astype(np.int64)
        valid = np.full(tp["batch"], tp["points"], np.int32)
        pool.append({"coord": coord, "feat": feat, "label": label, "valid": valid})
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


def unit(state, i):
    from repsurf_torch.train import train_seg

    batch = program.upload(state["host"][i % len(state["host"])], state["ctx"].device)
    loss, _ = train_seg.train_step(state["model"], state["optimizer"], batch, state["weight"],
                                   state["cfg"], generator=state["gen"])
    value = float(loss)
    return {"samples": batch["coord"].shape[0], "ok": math.isfinite(value), "loss": value}


def end_to_end(state, records, window_s):
    return {"train_samples_per_s": sum(r["samples"] for r in records) / window_s}


def shapes(state, i):
    b = state["pool"][i % len(state["pool"])]
    return {"train": True, "votes": 1,
            "forwards": [{"points": b["coord"].shape[1], "valid": b["valid"].tolist()}]}


def reference_loss(ctx, pool, half=False, prec=models.Precision()):
    """loss_fn(p, i) of the reference's step i on pool batch i; ``half``:
    the first half of each batch only (a planted fault)."""
    dev, arch, tcfg = ctx.device, ctx.config["arch"], ctx.config["train"]
    plan_fn, forward = common.reference_model(ctx.config)
    weight = torch.tensor(tcfg["class_weights"], device=dev)
    gen = torch.Generator(dev).manual_seed(ctx.seeds.steps)

    def loss_fn(p, i):
        b = {k: torch.from_numpy(v).to(dev) for k, v in pool[i % len(pool)].items()}
        if half:
            b = {k: v[: v.shape[0] // 2] for k, v in b.items()}
        valid = b["valid"].long()
        with torch.no_grad():
            plan = plan_fn(arch, b["coord"], valid, train=True)
        sign = models.random_sign(b["coord"].shape[0], gen, dev)
        logits = forward(p, arch, plan, b["feat"], True, sign, gen, prec)
        return losses.weighted_ce(logits, b["label"], weight, tcfg["ignore_label"])

    return loss_fn


free = program.free


def reference(state, **kw):
    return training.reference(state, reference_loss, **kw)


def check(state):
    free(state)
    return training.checks(state["readings"], reference(state), state["ctx"].spec.cell["limits"])
