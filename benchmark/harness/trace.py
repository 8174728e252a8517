"""The traced span of a ``--trace 1`` run: a few whole units of the cell's
work under ``torch.profiler`` (host and device), reduced to the device's
busy time, its idle gaps and its time by kernel.

The checks are copies of the program's ``utils/profiling.py`` arithmetic
(kept here so that a change to the program cannot move them): the span sits
between ``PAD_KERNELS`` spin kernels at either end, left out of every time;
a trace that lost any of them, recorded no device work, or (for units that
repeat the same work) holds a kernel whose count is not a multiple of the
units traced, is torn, and the span is taken again, up to ``TRIES`` times.
Busy time is the union of the device's kernel, copy and set intervals
inside the span; the span is the time from the last leading spin kernel's
end to the first trailing one's start.  The host's labelled intervals
(``record_function`` spans: the harness's unit labels, the program's and
torch's own) that overlap the span are kept for readers, clipped to it.
"""

import json
import os
import tempfile
import time

import torch

PAD_KERNELS = 32
TRIES = 3
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("user_annotation", "cpu_op")
TOP = 10


def _pad():
    for _ in range(PAD_KERNELS):
        torch.cuda._sleep(1000)
    torch.cuda.synchronize()


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarize(events, units, uniform):
    """One trace's events (chrome-trace dicts) -> (record or None, why)."""
    dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    pads = sorted((e for e in dev if "spin_kernel" in e["name"]), key=lambda e: e["ts"])
    if len(pads) != 2 * PAD_KERNELS:
        return None, f"{len(pads)} of {2 * PAD_KERNELS} spin kernels recorded"
    lo = pads[PAD_KERNELS - 1]["ts"] + pads[PAD_KERNELS - 1]["dur"]
    hi = pads[PAD_KERNELS]["ts"]
    work = [e for e in dev if "spin_kernel" not in e["name"] and lo <= e["ts"] < hi]
    if not work:
        return None, "no device work recorded"
    kernel_s, counts = {}, {}
    for e in work:
        kernel_s[e["name"]] = kernel_s.get(e["name"], 0.0) + e["dur"] * 1e-6
        counts[e["name"]] = counts.get(e["name"], 0) + 1
    if uniform:
        torn = [f"{n[:48]} x{c}" for n, c in counts.items() if c % units]
        if torn:
            return None, f"torn ({', '.join(torn[:3])})"
    busy = _merge([(e["ts"], min(e["ts"] + e["dur"], hi)) for e in work])
    host = [e for e in events if e.get("ph") == "X" and e.get("cat") in HOST_CATS]
    gaps, t = [], lo
    for s, e in busy + [[hi, hi]]:
        if s > t:
            gaps.append((s - t, (s + t) / 2))
        t = max(t, e)
    gaps.sort(key=lambda g: -g[0])
    gaps = [(us, _label(host, mid)) for us, mid in gaps[:TOP]]
    ops = sorted(kernel_s.items(), key=lambda kv: -kv[1])
    spans = sorted([e["name"], (max(e["ts"], lo) - lo) * 1e-6,
                    (min(e["ts"] + e["dur"], hi) - max(e["ts"], lo)) * 1e-6]
                   for e in host if e["cat"] == "user_annotation"
                   and e["ts"] < hi and e["ts"] + e["dur"] > lo)
    return {
        "busy_s": sum(e - s for s, e in busy) * 1e-6,
        "window_s": (hi - lo) * 1e-6,
        "kernel_s": kernel_s,
        "kernel_calls": counts,
        "host_spans": [s for s in spans if s[2] > 0],
        "device_ops": [[n, s] for n, s in ops[:TOP]],
        "idle_gaps": [[name, us * 1e-6] for us, name in gaps],
    }, "whole"


def _label(host, t):
    """What the host was doing at time t: the harness's own label and the
    innermost operator open at t."""
    open_ = [e for e in host if e["ts"] <= t < e["ts"] + e["dur"]]
    if not open_:
        return "host: outside any labelled call"
    ann = [e for e in open_ if e["cat"] == "user_annotation"]
    inner = max(open_, key=lambda e: e["ts"])
    outer = min(ann, key=lambda e: e["ts"])["name"] if ann else "-"
    return outer if inner["cat"] == "user_annotation" else f"{outer} > {inner['name']}"


def traced_span(run_units, units, uniform):
    """Profile ``run_units(units)``, retaking a torn trace -> (record or
    None, the trace's history)."""
    from torch.profiler import ProfilerActivity, profile

    history = []
    for attempt in range(TRIES):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _pad()
            t0 = time.perf_counter()
            run_units(units)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            _pad()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        record, why = summarize(events, units, uniform)
        history.append(f"try {attempt + 1}: {why}, host wall {wall:.6f} s")
        if record is not None:
            return record, history
    return None, history
