"""pnx_group_device_pct.train: the share of a replayed train step's device
time inside the program's ``pnx.group`` spans (each local aggregation's
ball query and gather, forward, nested in ``pnx.aggregate``), in %, timed
by the program's own events in the step's CUDA graph
(``harness/graph_spans.py``)."""

from benchmark.harness import graph_spans


def read(record):
    return graph_spans.share_pct(("pnx.group",))
