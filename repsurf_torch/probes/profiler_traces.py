"""Probe: how complete torch.profiler's device traces are.  For three
calls, many traces of ``reps`` calls each in one process: a trace is
empty (no device time), torn (some kernel's count is not a multiple of
reps, or the trace's kernel count differs from the most common one), or
whole.  Prints one JSON line a call: the counts, the device time a call
of the whole traces (min, median, max) and of the torn ones.

The calls: FPS [2,5000]→1250 with brute kNN on its result, a matmul and a
sort (5 reps); FPS's stream route [2,400000]→1024 (20 reps); the row
grouping kernel at [64,512]→128, S=64, C=141 (20 reps).

Usage, from the root of the repo on a machine with a GPU:
    python3 repsurf_torch/probes/profiler_traces.py [seconds a call]"""
import collections
import json
import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repsurf_torch.ops.kernels.ball_group import ball_group_channels  # noqa: E402
from repsurf_torch.ops.kernels.fps import fps  # noqa: E402
from repsurf_torch.ops.kernels.knn import knn_brute  # noqa: E402


def traces(name, fn, reps, seconds):
    fn()
    torch.cuda.synchronize()
    rows, t0 = [], time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ms, count, torn = 0.0, 0, False
        for e in prof.key_averages():
            t = getattr(e, "self_device_time_total", 0.0)
            if t > 0:
                ms += t / 1e3 / reps
                count += e.count
                torn |= e.count % reps != 0
        rows.append((ms, count, torn))
    mode = collections.Counter(c for ms, c, _ in rows if ms > 0).most_common(1)
    mode = mode[0][0] if mode else None
    empty = [i for i, (ms, _, _) in enumerate(rows) if ms <= 0]
    torn = [i for i, (ms, c, t) in enumerate(rows) if ms > 0 and (t or c != mode)]
    whole = [ms for i, (ms, _, _) in enumerate(rows) if ms > 0 and i not in torn]

    def spread(v):
        return [min(v), statistics.median(v), max(v)] if v else None

    print(json.dumps({"call": name, "reps": reps, "traces": len(rows), "kernels_a_trace": mode,
                      "empty": len(empty), "first_empty": empty[:8], "torn": len(torn),
                      "first_torn": torn[:8], "torn_counts": [rows[i][1] for i in torn[:8]],
                      "whole_ms": spread(whole), "torn_ms": spread([rows[i][0] for i in torn])}),
          flush=True)


def main():
    seconds = float(sys.argv[1]) if len(sys.argv) > 1 else 40.0
    dev = torch.device("cuda", 0)
    gen = torch.Generator(dev).manual_seed(0)
    small = torch.rand((2, 5000, 3), generator=gen, device=dev)
    a = torch.rand((512, 512), generator=gen, device=dev)

    def short():
        i = fps(small, 1250)
        q = torch.gather(small, 1, i.long()[..., None].expand(-1, -1, 3))
        knn_brute(32, small, q)
        (a @ a).sort(dim=1)

    large = torch.rand((2, 400000, 3), generator=gen, device=dev) * 16
    xyz = torch.rand((64, 512, 3), generator=gen, device=dev) * 2 - 1
    tcat = torch.rand((64, 512, 141), generator=gen, device=dev)
    print(torch.cuda.get_device_name(0), torch.__version__, torch.version.cuda, flush=True)
    traces("fps+knn+mm+sort [2,5000]", short, 5, seconds)
    traces("fps stream [2,400000]->1024", lambda: fps(large, 1024), 20, seconds)
    traces("ball_group [64,512]->128 S=64 C=141",
           lambda: ball_group_channels(0.4, 64, xyz, xyz[:, :128], tcat), 20, seconds)


if __name__ == "__main__":
    main()
