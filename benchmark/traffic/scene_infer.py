"""Whole-room inference in a closed loop: one room after another through
``repsurf_torch.train.eval_s3dis``'s ``predict_scene`` at the test CLI's
defaults (voxel passes, chunks of at most ``voxel_max`` points, batches of
``batch_size`` chunks, votes on the device), each room ending in its labels
on the host.  The loop calls ``scene_votes`` and takes the argmax where the
votes are, as ``predict_scene`` does, so that the check can read the votes
too.  The pool holds one room of ``raw_points`` raw points a floor size
(``room_sizes``), made from the mix's ``room_seed`` so that every seed
serves the same rooms (a room's content sets its voxels and chunks, and so
its work), in an order drawn from the seed; a window holds whole rounds of
the pool (``cycle``).  The check samples served rooms and holds their votes
and labels to the vote-averaged probabilities of the reference the
configuration names."""

import math

import numpy as np
import torch

from benchmark.data.synthetic_scene import raw_room
from benchmark.harness import common, program
from benchmark.reference import models, scene


def setup(ctx):
    from repsurf_torch.train import train_seg

    tp = ctx.traffic
    cfg = train_seg.SegConfig(**ctx.config["program"])
    model = train_seg.build_model(cfg).to(ctx.device).eval()
    program.init_weights(model, ctx.seeds.weights, ctx.config["init"]["weight_gain"], ctx.device)
    content = np.random.RandomState(tp["room_seed"])
    made = [raw_room(content, tp["raw_points"], size)[:2] for size in tp["room_sizes"]]
    rooms = [made[i] for i in np.random.RandomState(ctx.seeds.data).permutation(len(made))]
    state = {"ctx": ctx, "cfg": cfg, "model": model, "start": program.snapshot(model),
             "rooms": rooms, "answers": [], "votes": {}, "shapes": {}}
    for i in range(tp["warmup"]):
        unit(state, i)
    state["answers"].clear()
    return state


def unit(state, i):
    from repsurf_torch.train import eval_s3dis

    ctx, model = state["ctx"], state["model"]
    inf = ctx.config["infer"]

    def forward(batch):
        with torch.no_grad():
            return model(batch["coord"], batch["feat"], batch["valid"])

    j = i % len(state["rooms"])
    coord, rgb = state["rooms"][j]
    votes = eval_s3dis.scene_votes(
        forward, coord, rgb, ctx.config["arch"]["num_class"], voxel_size=inf["voxel_size"],
        voxel_max=inf["voxel_max"], batch_size=inf["batch_size"], data_norm="mean",
        seed=inf["chunk_seed"], accumulate="device", device=ctx.device)
    labels = votes.argmax(dim=1).cpu().numpy()
    state["answers"].append(labels.astype(np.int16))
    state["votes"][j] = (i, votes)  # the room's latest votes, held where they are
    return {"samples": 1, "ok": labels.shape == (coord.shape[0],)}


def end_to_end(state, records, window_s):
    return {"infer_rooms_per_s": len(records) / window_s}


def cycle(state):
    """Units in one round of the pool: a window serves whole rounds, so
    every seed serves the same rooms, in another order."""
    return len(state["rooms"])


def shapes(state, i):
    """The forwards that serve unit i's room, from the reference's own
    chunking: each chunk's real points and the padded size."""
    j = i % len(state["rooms"])
    if j not in state["shapes"]:
        coord, rgb = state["rooms"][j]
        inf = state["ctx"].config["infer"]
        state["shapes"][j] = {"train": False, "votes": 1,
                              "forwards": scene.batch_shapes(scene.chunks(coord, rgb, inf), inf)}
    return state["shapes"][j]


def sample(state):
    """Served rooms to check, ``check_rooms`` of them drawn from the seed:
    the latest serve of each of as many pool rooms."""
    served = sorted(state["votes"])
    rng = np.random.RandomState(state["ctx"].seeds.sample)
    picks = rng.choice(len(served), min(state["ctx"].traffic["check_rooms"], len(served)),
                       replace=False)
    return [state["votes"][served[k]] for k in sorted(picks)]


def answer_gap(votes, labels, probs):
    """The widest gap between a served room and the reference's
    vote-averaged probabilities ``probs`` [N, C]: the largest difference of
    a served vote, and the largest shortfall of a served label's probability
    below the reference's best.  An answer of the wrong shape is infinitely
    far."""
    if labels.shape != (probs.shape[0],) or tuple(votes.shape) != tuple(probs.shape):
        return math.inf
    lab = torch.from_numpy(labels.astype(np.int64)).to(probs.device)
    if bool(((lab < 0) | (lab >= probs.shape[1])).any()):
        return math.inf
    short = (probs.max(1).values - probs.gather(1, lab[:, None])[:, 0]).max()
    return max(float((votes.to(probs) - probs).abs().max()), float(short))


def check(state):
    picks = sample(state)
    program.free(state)
    ctx = state["ctx"]
    worst, state["checked"] = 0.0, []
    for i, votes in picks:
        probs = reference_probs(state, i)
        state["checked"].append((i, probs))
        worst = max(worst, answer_gap(votes, state["answers"][i], probs))
    return [("answer_gap", worst, ctx.spec.cell["limits"]["answer_gap"])]


def reference_probs(state, i, prec=models.Precision()):
    ctx = state["ctx"]
    coord, rgb = state["rooms"][i % len(state["rooms"])]
    return scene.room_probs(state["start"], ctx.config["arch"], coord, rgb, ctx.config["infer"],
                            ctx.device, common.reference_model(ctx.config), prec)


def control(state):
    """The control's reading: the reference with TF32 products in the
    program's place, its votes and labels, on the rooms the check compared."""
    tf32 = models.Precision(tf32=True)
    worst = 0.0
    for i, probs in state["checked"]:
        votes = reference_probs(state, i, tf32)
        worst = max(worst, answer_gap(votes, votes.argmax(1).cpu().numpy(), probs))
    return worst
