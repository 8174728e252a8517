"""One run of one cell: set-up, the measured window, the traced span, the
check of what the window produced, and the result line.

A traffic kind (``traffic/<kind>.py``) supplies:

* ``setup(ctx) -> state``: the program's objects, the inputs, warm-up (a
  training kind also its first steps, whose readings the check compares);
* ``unit(state, i) -> dict``: one unit of work (a step, a request, a room),
  ended on the host; ``samples`` it completed, ``ok`` False for a non-finite
  answer, ``latency_s`` where requests are timed;
* ``end_to_end(state, units, window_s) -> {metric: value}``;
* ``shapes(state, i) -> {"train", "votes", "forwards": [{"points",
  "valid"}]}``: what unit i computes (``work/__init__.py``);
* ``check(state) -> [(name, value, limit)]``: after the window, with the
  program's state freed, the plain reference against what was produced;
* optionally ``cycle(state) -> n``: the window ends after a multiple of n
  units (a pool of units of different sizes served round-robin).

A traced run hands each per-layer metric's reader (``metrics/<name>.py``)
one record: the traced span's device times (``trace.py``: ``busy_s``,
``window_s``, ``kernel_s``, ``kernel_calls``, ``idle_gaps``, ``host_spans``),
``spec`` (the cell's name, configuration, traffic and cell files),
``units`` (the traced units' shapes) and their analytic ``work``, and
``window``: the untraced window's ``wall_s``, ``units`` and ``work``.
"""

import importlib
import json
import math
import statistics
import sys
import time

import torch
from torch.profiler import record_function

from . import common, trace
from .. import work


class Context:
    """What a traffic kind is given: the cell, its seeds and device."""

    def __init__(self, spec, seed, device):
        self.spec = spec
        self.seed = seed
        self.seeds = common.Seeds.of(seed)
        self.device = torch.device(device)
        self.config = spec.config
        self.traffic = spec.traffic

    def log(self, msg):
        print(msg, file=sys.stderr, flush=True)


def run_window(kind, state, seconds, label, cycle=1):
    """Units back to back until ``seconds`` have passed -> (records,
    window seconds): the window ends when the unit that crosses it ends,
    or the last of its round of ``cycle`` units.  Each record gets the
    unit's host seconds (``unit_s``)."""
    records, t0 = [], time.perf_counter()
    while True:
        t = time.perf_counter()
        with record_function(label):
            records.append(kind.unit(state, len(records)))
        now = time.perf_counter()
        records[-1]["unit_s"] = now - t
        if now - t0 >= seconds and len(records) % cycle == 0:
            return records, now - t0


def unit_lines(records, cycle):
    """Lines on the units' host seconds: the spread over the window, its
    halves (a drift), and each position of a round."""
    secs = [r["unit_s"] for r in records]
    half = len(secs) // 2
    lines = [f"units {len(secs)}: seconds median {statistics.median(secs):.6f}, "
             f"min {min(secs):.6f}, max {max(secs):.6f}; halves' medians "
             f"{statistics.median(secs[:max(half, 1)]):.6f} / {statistics.median(secs[half:]):.6f}"]
    if cycle > 1:
        means = [statistics.mean(secs[k::cycle]) for k in range(min(cycle, len(secs)))]
        lines.append("units by position in a round, mean seconds: "
                     + " ".join(f"{m:.4f}" for m in means))
    return lines


def run(workload, seed, seconds, trace_on, device="cuda", t_start=None, overrides=None):
    """-> (result dict, [(name, value, limit)]).  ``device`` 'cpu' runs the
    program's plain path; ``overrides`` {"traffic" | "infer" | "cell": {..}}
    replaces entries of the cell's files (the tests shrink a cell with it).
    The entry point allows only the card and no overrides."""
    t_start = time.perf_counter() if t_start is None else t_start
    spec = common.load_spec(workload)
    for key, values in (overrides or {}).items():
        target = spec.config["infer"] if key == "infer" else getattr(spec, key)
        target.update(values)
    ctx = Context(spec, seed, device)
    kind = importlib.import_module(f"benchmark.traffic.{spec.traffic['kind']}")
    on_card = ctx.device.type == "cuda"
    if on_card:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        card = common.card_fields()
        ctx.log(f"card: {card['device']}, power limit {card['power_limit']}")
        ctx.log(f"card before: {common.card_state()}")
    state = kind.setup(ctx)
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start
    ctx.log(f"set-up {setup_s:.3f} s")

    cycle = kind.cycle(state) if hasattr(kind, "cycle") else 1
    records, window_s = run_window(kind, state, seconds, f"bench:{workload}", cycle)
    for line in unit_lines(records, cycle):
        ctx.log(line)
    first_traced = len(records)
    record = None
    if trace_on:
        if not on_card:
            raise RuntimeError("a traced run needs the card")
        units = spec.cell["trace_units"]

        def traced(n):
            for _ in range(n):
                with record_function(f"bench:{workload}"):
                    records.append(kind.unit(state, len(records)))

        before = len(records)
        record, history = trace.traced_span(traced, units, spec.traffic.get("uniform", True))
        for line in history:
            ctx.log(f"trace: {line}")
        if record is not None:
            first_traced = len(records) - units
            add_work(record, kind, state, spec, range(first_traced, len(records)), before,
                     window_s)
    memory_peak = torch.cuda.max_memory_allocated() if on_card else 0
    attempted = len(records)
    failed = sum(1 for r in records if not r["ok"])
    if on_card:
        ctx.log(f"card after: {common.card_state()}")
        from repsurf_torch.ops.kernels import kernel_launches

        ctx.log(f"kernel launches: {json.dumps(kernel_launches())}")
    ctx.log(f"window {window_s:.6f} s, {first_traced} units; peak {memory_peak} bytes")

    metrics = {}
    if trace_on:
        for m in spec.per_layer:
            reader = common.load_module(common.BENCH / "metrics" / f"{m['name']}.py",
                                        f"metric_{m['name']}")
            value = None if record is None else reader.read(record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = kind.end_to_end(state, records[:first_traced], window_s)
        values["setup_s"] = setup_s
        for m in spec.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}

    checks = kind.check(state)
    correct = all(math.isfinite(v) and v <= limit for _, v, limit in checks)
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics,
              "device": device_fields(ctx.device, memory_peak, spec.chips, record)}
    if record is not None:
        result["breakdown"] = {"device_ops": record["device_ops"],
                               "idle_gaps": record["idle_gaps"]}
    result["compared"] = {name: {"value": v, "limit": limit} for name, v, limit in checks}
    return result, checks


def add_work(record, kind, state, spec, traced, window_units, window_s):
    """Complete a traced span's record for the readers: the cell's files,
    the shapes and analytic work of the ``traced`` units, and the window's
    (its first ``window_units`` units, ``window_s`` seconds)."""
    record["spec"] = {"cell": spec.name, "config": spec.config, "traffic": spec.traffic,
                      "workload": spec.cell}
    record["units"] = [kind.shapes(state, i) for i in traced]
    record["work"] = work.of_units(spec.config, record["units"])
    units = [kind.shapes(state, i) for i in range(window_units)]
    record["window"] = {"wall_s": window_s, "units": units, **work.of_units(spec.config, units)}
    return record


def device_fields(dev, memory_peak, chips, record):
    if dev.type != "cuda":
        out = {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    else:
        out = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": chips,
               "memory_peak_bytes": memory_peak}
    if record is not None:
        out["busy_s"] = record["busy_s"]
        out["window_s"] = record["window_s"]
    return out


def limit_lines(checks):
    return [f"compared {name}: {value!r} (limit {limit!r})" for name, value, limit in checks]
