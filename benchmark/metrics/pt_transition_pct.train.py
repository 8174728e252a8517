"""pt_transition_pct.train: the share of the traced span the host spent in
the program's ``pt.down`` and ``pt.up`` spans (Point Transformer's strided
TransitionDown: FPS, kNN grouping, Linear, BN, max-pool; and TransitionUp:
3-NN interpolation or the head's cloud mean), forward, in %."""

from benchmark.harness import spans


def read(record):
    return spans.share_pct(record, ("pt.down", "pt.up"))
