"""pnx_group_pct.train: the share of the traced span the host spent in the
program's ``pnx.group`` spans (each local aggregation's ball query and
gather, forward, nested in ``pnx.aggregate``), in %.  Issuing their work,
and waiting inside them when the card's queue is full."""

from benchmark.harness import spans


def read(record):
    return spans.share_pct(record, ("pnx.group",))
