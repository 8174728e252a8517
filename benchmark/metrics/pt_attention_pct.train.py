"""pt_attention_pct.train: the share of the traced span the host spent in
the program's ``pt.attention`` spans (Point Transformer's vector attention
layers, forward: their kNN, gathers, MLPs, softmax and weighted sum), in %.
Issuing their work, and waiting inside them when the card's queue is full."""

from benchmark.harness import spans


def read(record):
    return spans.share_pct(record, ("pt.attention",))
