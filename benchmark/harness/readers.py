"""The arithmetic of the per-layer metrics, over the record of a traced run:

* ``busy_s``, ``window_s``, ``kernel_s`` {kernel name: device seconds},
  ``kernel_calls`` {kernel name: launches}, ``host_spans`` [[label, start
  s, seconds]]: the traced span (``trace.py``);
* ``spec``: the cell's ``cell`` name, ``config``, ``traffic``, ``workload``;
* ``units``: the traced units' shapes (``work/__init__.py``), ``work``:
  their analytic work (``model_flops``, ``fps_bound_s``);
* ``window``: the untraced window's ``wall_s``, ``units`` and ``work``.

A reader of a new quantity computes it from ``spec`` and ``units`` with
the functions of ``work/`` (or a new file there), and reads its time from
``kernel_s`` or ``host_spans``.

A reader that finds nothing to read returns None and the metric is left out
of the line; a share of a peak or a roofline is never given as 0 for
nothing."""

from .roofline import PEAK_F32_FLOPS


def idle_pct(record):
    """100 * (1 - busy / span) of the traced span."""
    if record["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - record["busy_s"] / record["window_s"])


def mfu_pct(record):
    """100 * analytic model FLOPs of the untraced window's units / (its wall
    seconds * the float32 peak)."""
    w = record["window"]
    if w["wall_s"] <= 0 or w["model_flops"] <= 0:
        return None
    return 100.0 * w["model_flops"] / (w["wall_s"] * PEAK_F32_FLOPS)


def kernel_roofline_pct(record, pattern, bound_key):
    """100 * the least time of the traced units' work for a kernel / the
    device seconds of the kernels whose name holds ``pattern``."""
    seconds = sum(s for name, s in record["kernel_s"].items() if pattern in name)
    bound = record["work"].get(bound_key, 0.0)
    if seconds <= 0 or bound <= 0:
        return None
    return 100.0 * bound / seconds
