"""pt_attention_device_pct.train: the share of a replayed train step's
device time inside the program's ``pt.attention`` spans (Point
Transformer's vector attention layers, forward: their kNN, gathers, MLPs,
softmax and weighted sum), in %, timed by the program's own events in the
step's CUDA graph (``harness/graph_spans.py``)."""

from benchmark.harness import graph_spans


def read(record):
    return graph_spans.share_pct(("pt.attention",))
