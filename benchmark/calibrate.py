"""Readings that the limits of ``correct`` are set from, on the card, at
each cell's own size; not part of a benchmark run.

    python3 benchmark/calibrate.py --workload <cell> --seeds 101 102 ... \\
        [--controls 3] [--seconds 4]

For each seed: the program as a run drives it (a training cell: its first
three steps; a serving cell: a short window of ``--seconds`` at the cell's
load), then the plain reference, and the gaps the check compares (the
lower readings).  On the first ``--controls`` seeds also the control, the
reference with TF32 products in the program's place (the upper readings),
and, in a training cell, the planted fault of half of each batch left out.
One JSON line a seed.
"""

import argparse
import importlib
import json
import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark.harness import common, runner, training  # noqa: E402
from benchmark.reference import models  # noqa: E402


def leaves(prog, ref):
    """The leaves behind the worst gradient and change gaps, and the median
    leaf's change gap (a steadier number, for the look at a noisy one)."""
    med_g = statistics.median(ref["grad"].values())
    moving = [n for n in ref["grad"] if ref["grad"][n] >= training.QUIET * med_g]
    med_c = statistics.median(ref["change"][n] for n in moving)
    per = {n: abs(prog["change"][n] - ref["change"][n]) / max(ref["change"][n], med_c)
           for n in moving}
    grad = {n: abs(prog["grad"][n] - ref["grad"][n]) / max(ref["grad"][n], med_g)
            for n in ref["grad"]}
    return {"change_worst": max(per, key=per.get), "change_median": statistics.median(
        per.values()), "grad_worst": max(grad, key=grad.get), "quiet": len(ref["grad"]) -
        len(moving)}


def main(argv=None):
    p = argparse.ArgumentParser("benchmark calibration")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--controls", type=int, default=3)
    p.add_argument("--seconds", type=float, default=4.0)

    args = p.parse_args(argv)
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec = common.load_spec(args.workload)
    kind = importlib.import_module(f"benchmark.traffic.{spec.traffic['kind']}")
    for n, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        ctx = runner.Context(spec, seed, "cuda")
        state = kind.setup(ctx)
        line = {"workload": args.workload, "seed": seed}
        if hasattr(kind, "reference"):
            prog = state["readings"]
            kind.free(state)
            ref = kind.reference(state)
            line["program"] = training.gaps(prog, ref)
            if n < args.controls:
                line["control"] = training.gaps(
                    kind.reference(state, prec=models.Precision(tf32=True)), ref)
                line["half"] = training.gaps(kind.reference(state, half=True), ref)
            line["losses"] = {"program": prog["loss"], "reference": ref["loss"]}
            line["leaves"] = leaves(prog, ref)
        else:
            records, window_s = runner.run_window(kind, state, args.seconds, "calibrate")
            line["units"] = len(records)
            line["program"] = [v for _, v, _ in kind.check(state)]
            if n < args.controls:
                line["control"] = kind.control(state)
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
        del state
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
