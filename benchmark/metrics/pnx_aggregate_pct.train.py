"""pnx_aggregate_pct.train: the share of the traced span the host spent in
the program's ``pnx.aggregate`` spans (PointNeXt's local aggregations,
forward: their ball queries and gathers, Linears, batch norms and maxes
over the slots), in %.  Issuing their work, and waiting inside them when
the card's queue is full."""

from benchmark.harness import spans


def read(record):
    return spans.share_pct(record, ("pnx.aggregate",))
