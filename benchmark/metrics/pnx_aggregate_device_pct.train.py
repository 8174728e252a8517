"""pnx_aggregate_device_pct.train: the share of a replayed train step's
device time inside the program's ``pnx.aggregate`` spans (PointNeXt's
local aggregations, forward: ball query, gather, Linear, BN + ReLU, max
over the slots), in %, timed by the program's own events in the step's
CUDA graph (``harness/graph_spans.py``)."""

from benchmark.harness import graph_spans


def read(record):
    return graph_spans.share_pct(("pnx.aggregate",))
