"""Closed loop of the classification training step
(``repsurf_torch.train.train_cls.train_step``): one step after another on a
pool of labelled batches of raw scans made from the seed, each uploaded from
pinned host memory, each step's loss read back as the training loop logs
it.  The reference that checks it is the one the configuration's
``reference`` entry names (``models.cls_plan``'s and ``models.cls_forward``'s
signatures)."""

import math

import numpy as np
import torch

from benchmark.data.synthetic_object import SyntheticObjects15
from benchmark.harness import common, program, training
from benchmark.reference import losses, models


def make_pool(ctx, split="train"):
    """[{points [B, raw, 3], target [B]}] numpy batches of scans."""
    tp = ctx.traffic
    n = tp["pool"] * tp["batch"]
    data = SyntheticObjects15(split, num_point=tp["raw_points"], size=n,
                              seed=ctx.seeds.data % 2**30)
    order = np.random.RandomState(ctx.seeds.data).permutation(n)
    items = [data[int(i)] for i in order]
    pool = []
    for s in range(0, n, tp["batch"]):
        part = items[s:s + tp["batch"]]
        pool.append({"points": np.stack([p for p, _ in part]).astype(np.float32),
                     "target": np.array([lab for _, lab in part], np.int64)})
    return pool


def build(ctx, **overrides):
    import dataclasses

    from repsurf_torch.train import train_cls

    cfg = dataclasses.replace(train_cls.ClsConfig(**ctx.config["program"]), **overrides)
    model = train_cls.build_model(cfg).to(ctx.device)
    program.init_weights(model, ctx.seeds.weights, ctx.config["init"]["weight_gain"],
                         ctx.device)
    return cfg, model


def setup(ctx):
    from repsurf_torch.train import train_cls

    cfg, model = build(ctx)
    state = {"ctx": ctx, "cfg": cfg, "model": model, "start": program.snapshot(model),
             "optimizer": train_cls.make_optimizer(model, cfg), "pool": make_pool(ctx),
             "gen": torch.Generator(ctx.device).manual_seed(ctx.seeds.steps)}
    state["host"] = [{k: program.pinned(v) for k, v in b.items()} for b in state["pool"]]
    state["readings"] = training.program_readings(
        model, state["optimizer"], lambda i: unit(state, i)["loss"],
        ctx.config["train"]["betas"][0])
    ctx.log(f"first steps' losses {state['readings']['loss']}")
    return state


def unit(state, i):
    from repsurf_torch.train import train_cls

    b = program.upload(state["host"][i % len(state["host"])], state["ctx"].device)
    loss, _ = train_cls.train_step(state["model"], state["optimizer"], b["points"],
                                   b["target"], state["cfg"], generator=state["gen"])
    value = float(loss)
    return {"samples": b["points"].shape[0], "ok": math.isfinite(value), "loss": value}


def end_to_end(state, records, window_s):
    return {"train_samples_per_s": sum(r["samples"] for r in records) / window_s}


def shapes(state, i, train=True, votes=1):
    points = state["pool"][i % len(state["pool"])]["points"]
    return {"train": train, "votes": votes,
            "forwards": [{"points": points.shape[1], "valid": [points.shape[1]] * len(points)}]}


def reference_loss(ctx, pool, half=False, prec=models.Precision()):
    dev, arch = ctx.device, ctx.config["arch"]
    plan_fn, forward = common.reference_model(ctx.config)
    gen = torch.Generator(dev).manual_seed(ctx.seeds.steps)
    eps = ctx.config["train"]["label_smoothing"]

    def loss_fn(p, i):
        b = {k: torch.from_numpy(v).to(dev) for k, v in pool[i % len(pool)].items()}
        if half:
            b = {k: v[: v.shape[0] // 2] for k, v in b.items()}
        with torch.no_grad():
            plan = plan_fn(arch, b["points"])
        sign = models.random_sign(b["points"].shape[0], gen, dev)
        logp = forward(p, arch, plan, True, sign, gen, prec)
        return losses.smooth_nll(logp, b["target"], eps)

    return loss_fn


free = program.free


def reference(state, **kw):
    return training.reference(state, reference_loss, **kw)


def check(state):
    free(state)
    return training.checks(state["readings"], reference(state), state["ctx"].spec.cell["limits"])
