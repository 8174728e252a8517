"""pt_transition_device_pct.train: the share of a replayed train step's
device time inside the program's ``pt.down`` and ``pt.up`` spans (Point
Transformer's transitions, forward: FPS, kNN grouping, Linear, BN and
max-pool down; interpolation up), in %, timed by the program's own events
in the step's CUDA graph (``harness/graph_spans.py``)."""

from benchmark.harness import graph_spans


def read(record):
    return graph_spans.share_pct(("pt.down", "pt.up"))
