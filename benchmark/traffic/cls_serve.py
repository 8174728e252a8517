"""One client serving classification requests in a closed loop: each
request uploads a batch of raw scans from pinned host memory, runs
``repsurf_torch.train.train_cls.eval_step`` (FPS to ``num_point``, the
umbrella constructor, the SA stages, the head) with ``num_votes`` votes, and
reads the summed log-probabilities back; the latency of a request runs from
its upload to its answer on the host.  The check samples answers and holds
them to the reference's log-probabilities for the same scans and normal
inversions, from the reference the configuration names."""

import math
import time

import numpy as np
import torch

from benchmark.harness import common, program
from benchmark.reference import models
from benchmark.traffic import cls_train


def setup(ctx):
    tp = ctx.traffic
    cfg, model = cls_train.build(ctx, num_votes=tp["num_votes"])
    model.eval()
    pool = cls_train.make_pool(ctx, split="test")
    rng = np.random.RandomState(ctx.seeds.data)
    for b in pool:
        b["signs"] = (rng.randint(0, 2, (tp["num_votes"], tp["batch"])) * 2 - 1).astype(np.float32)
    state = {"ctx": ctx, "cfg": cfg, "model": model, "start": program.snapshot(model),
             "pool": pool, "answers": [],
             "gen": torch.Generator(ctx.device).manual_seed(ctx.seeds.steps)}
    state["host"] = [{k: program.pinned(v) for k, v in b.items()} for b in pool]
    for i in range(tp["warmup"]):
        unit(state, i)
    state["answers"].clear()
    return state


def unit(state, i):
    from repsurf_torch.train import train_cls

    t0 = time.perf_counter()
    b = program.upload(state["host"][i % len(state["host"])], state["ctx"].device)
    _, _, vote_sum = train_cls.eval_step(state["model"], b["points"], b["target"], state["cfg"],
                                         generator=state["gen"], signs=b["signs"])
    answer = vote_sum.cpu()
    latency = time.perf_counter() - t0
    state["answers"].append(answer)
    return {"samples": b["points"].shape[0], "latency_s": latency,
            "ok": bool(torch.isfinite(answer).all())}


def end_to_end(state, records, window_s):
    lat = sorted(r["latency_s"] for r in records)
    p95 = lat[min(len(lat) - 1, math.ceil(0.95 * len(lat)) - 1)]
    state["ctx"].log(f"requests {len(lat)}; latency median {lat[len(lat) // 2] * 1e3:.4f} ms, "
                     f"p95 {p95 * 1e3:.4f} ms over {len(lat)} samples "
                     f"({len(lat) - math.ceil(0.95 * len(lat))} beyond it)")
    return {"serve_clouds_per_s": sum(r["samples"] for r in records) / window_s,
            "serve_request_ms_p95": p95 * 1e3}


def shapes(state, i):
    return cls_train.shapes(state, i, train=False, votes=state["ctx"].traffic["num_votes"])


def reference_answer(ctx, p, batch, prec=models.Precision()):
    """Summed log-probabilities [B, classes] of the reference's votes (vote
    0 unscaled; the cells here take one vote)."""
    dev, arch = ctx.device, ctx.config["arch"]
    plan_fn, forward = common.reference_model(ctx.config)
    pts = torch.from_numpy(batch["points"]).to(dev)
    signs = torch.from_numpy(batch["signs"]).to(dev)
    if signs.shape[0] != 1:
        raise ValueError("the reference answers one vote a request")
    with torch.no_grad():
        plan = plan_fn(arch, pts)
        return forward(p, arch, plan, False, signs[0], prec=prec).cpu()


def sample(state):
    """Request indices to check: ``check_requests`` of those answered,
    drawn from the seed."""
    n = len(state["answers"])
    k = min(state["ctx"].traffic["check_requests"], n)
    return sorted(np.random.RandomState(state["ctx"].seeds.sample).choice(n, k, replace=False))


def gap(answers, refs):
    """Widest gap between an answer's log-probabilities and the
    reference's; an answer of the wrong shape is infinitely far."""
    worst = 0.0
    for a, r in zip(answers, refs):
        if a.shape != r.shape:
            return math.inf
        worst = max(worst, float((a.double() - r.double()).abs().max()))
    return worst


def check(state):
    picks = sample(state)
    answers = [state["answers"][i] for i in picks]
    program.free(state)
    ctx, pool = state["ctx"], state["pool"]
    cache = {}
    refs = []
    for i in picks:
        j = i % len(pool)
        if j not in cache:
            cache[j] = reference_answer(ctx, state["start"], pool[j])
        refs.append(cache[j])
    state["checked"] = (picks, refs)
    return [("logp_gap", gap(answers, refs), ctx.spec.cell["limits"]["logp_gap"])]


def control(state):
    """The control's reading: the reference with TF32 products in the
    program's place, on the requests the check compared."""
    picks, refs = state["checked"]
    pool = state["pool"]
    tf32 = models.Precision(tf32=True)
    answers = [reference_answer(state["ctx"], state["start"], pool[i % len(pool)], tf32)
               for i in picks]
    return gap(answers, refs)
