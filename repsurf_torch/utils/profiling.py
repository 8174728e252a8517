"""Checked ``torch.profiler`` traces: device self time by kernel.

Now and then a trace records no device activity at all (about one in 2,400
on an H100; CHANGES.md, under the entry that added these checks), or only
part of it: a trace in which some kernel's count is not a multiple of the
calls traced is torn.
Late in a long run every trace came back short by the same few records, so
each traced window sits between ``PAD_KERNELS`` spin kernels at either end,
which are left out of the times.  A torn or empty trace is taken again
after a pause, up to ``PROFILE_TRIES`` times; if none is whole, every time
is NaN (not measured).  After such a call the next takes one trace until
one is whole again.

``device_split`` sums a call's device time into named groups of kernels;
``op_table`` lists it by kernel, beside the busy total and the host wall
time of the traced window, so the card's idle share can be read.  On a CPU
device both trace ``ProfilerActivity.CPU`` (operator self times), with no
spin kernels.
"""

import math
import time
from typing import NamedTuple

import torch

PROFILE_TRIES = 5  # traces of one call taken before its device time is given up
PAD_KERNELS = 32  # spin kernels at either end of each traced window

# the traces of this process: "silent" while the last call found no whole trace
PROFILER = {"silent": False, "traces": 0, "retaken": 0, "given_up": 0, "pads_lost": 0}


def _on_cpu(device):
    return device is not None and torch.device(device).type == "cpu"


def _self_ms(event, cpu):
    """An averaged event's self time in ms, summed over its calls."""
    us = event.self_cpu_time_total if cpu else getattr(event, "self_device_time_total", 0.0)
    return us / 1e3


def check_trace(events, reps, cpu=False):
    """Read one trace's ``key_averages()``: ([(name, self ms, count)] for
    every event with self time, the spin kernels left out; the torn events,
    those whose count is not a multiple of ``reps``, as "name xcount"; the
    number of spin kernels recorded)."""
    rows, torn, pads = [], [], 0
    for e in events:
        if "spin_kernel" in e.key:
            pads += e.count
            continue
        ms = _self_ms(e, cpu)
        if ms <= 0:
            continue
        rows.append((e.key, ms, e.count))
        if e.count % reps:
            torn.append(f"{e.key[:48]} x{e.count}")
    return rows, torn, pads


def _take_trace(fn, reps, cpu):
    """One trace of ``reps`` calls of fn: (its key_averages(), host wall
    seconds of the calls, the card synchronised at both ends)."""
    from torch.profiler import ProfilerActivity, profile

    def pad():
        if not cpu:
            for _ in range(PAD_KERNELS):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()

    activity = ProfilerActivity.CPU if cpu else ProfilerActivity.CUDA
    with profile(activities=[activity]) as prof:
        pad()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        if not cpu:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        pad()
    return prof.key_averages(), wall


def checked_trace(fn, reps, device=None):
    """([(name, ms, count)] summed over ``reps`` calls of fn after a
    warm-up call, host wall seconds of the calls) from the first whole
    trace (see the module doc), or (None, NaN) when none was whole.
    ``device``: a CPU device traces the host; anything else the card."""
    cpu = _on_cpu(device)
    fn()
    if not cpu:
        torch.cuda.synchronize()
    tries = 1 if PROFILER["silent"] else PROFILE_TRIES
    expected_pads = 0 if cpu else 2 * PAD_KERNELS
    for attempt in range(tries):
        events, wall = _take_trace(fn, reps, cpu)
        rows, torn, pads = check_trace(events, reps, cpu)
        PROFILER["traces"] += 1
        PROFILER["pads_lost"] += expected_pads - pads
        if rows and not torn:
            PROFILER["silent"] = False
            return rows, wall
        PROFILER["retaken"] += 1
        what = f"is torn ({', '.join(torn[:3])})" if torn else "recorded no device time"
        print(f"  torch.profiler: a trace of {reps} calls {what}, {pads} of "
              f"{expected_pads} spin kernels (try {attempt + 1} of {tries})")
        if attempt + 1 < tries:
            time.sleep(0.25 * 2 ** attempt)
    PROFILER["silent"] = True
    PROFILER["given_up"] += 1
    print("  torch.profiler: no whole trace; this call's device times are not measured")
    return None, math.nan


def device_split(fn, groups, reps=20, device=None):
    """Device time of one call of fn, split by kernel: {group: ms} for each
    group whose pattern is a substring of a kernel's name, and "other" for
    the rest (self times over ``reps`` calls of a checked trace, over
    reps), every value NaN when no trace was whole.  Where a call's host
    work outlasts its kernels, CUDA events around the call measure the
    host; this measures the card."""
    rows, _ = checked_trace(fn, reps, device)
    if rows is None:
        return dict.fromkeys([*groups, "other"], math.nan)
    out = dict.fromkeys([*groups, "other"], 0.0)
    for name, ms, _ in rows:
        key = next((g for g, pattern in groups.items() if pattern in name), "other")
        out[key] += ms / reps
    return out


class OpTable(NamedTuple):
    """Self time a call by kernel (or by operator on the CPU)."""

    activity: str  # "cuda" (kernels on the card) or "cpu" (host operators)
    rows: list  # [(name, ms a call, launches a call)], slowest first
    busy_ms: float  # the rows' sum: time the card was busy, a call
    wall_ms: float  # host clock over the traced calls, a call (NaN: not timed)

    def lines(self, label, top=40):
        """The table as text: a header (what was traced, busy and wall
        time, the idle share), then the ``top`` slowest rows."""
        if self.rows is None:
            return [f"== {label}: no whole trace ({self.activity}); not measured =="]
        what = ("device self time (torch.profiler, CUDA)" if self.activity == "cuda"
                else "host operator self time (torch.profiler, CPU: no card)")
        wall = ""
        if self.wall_ms > 0:  # NaN for a difference of two tables
            wall = (f", host wall {self.wall_ms:.3f} ms a call, idle share "
                    f"{1.0 - self.busy_ms / self.wall_ms:.3f}")
        out = [f"== {label}: {what} {self.busy_ms:.3f} ms a call{wall}; top {top} of "
               f"{len(self.rows)} =="]
        for name, ms, calls in self.rows[:top]:
            out.append(f"  {ms:9.4f} ms {calls:8.2f}x  {name[:110]}")
        return out


def op_table(fn, reps=20, top=None, device=None):
    """``OpTable`` of one call of fn: the self time of each kernel name,
    summed over ``reps`` calls of a checked trace and divided by reps,
    sorted slowest first (the first ``top`` rows when given); the busy
    total and the host wall time of the window, each a call.  On a CPU
    device it traces the host's operators.  Rows None and times NaN when
    no trace was whole."""
    cpu = _on_cpu(device)
    activity = "cpu" if cpu else "cuda"
    rows, wall = checked_trace(fn, reps, device)
    if rows is None:
        return OpTable(activity, None, math.nan, math.nan)
    per_call = sorted(((name, ms / reps, count / reps) for name, ms, count in rows),
                      key=lambda r: -r[1])
    busy = sum(ms for _, ms, _ in per_call)
    return OpTable(activity, per_call[:top] if top else per_call, busy, wall / reps * 1e3)


def not_measured_as_null(obj):
    """obj with every NaN (a time not measured) replaced by None, so a
    JSON line stays strict JSON."""
    if isinstance(obj, dict):
        return {k: not_measured_as_null(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [not_measured_as_null(v) for v in obj]
    return None if isinstance(obj, float) and math.isnan(obj) else obj
