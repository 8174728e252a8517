"""host_issue_pct.train: the share of the traced span the host spent
issuing a train step's work, in the program's ``train.forward``,
``train.backward`` and ``train.update`` spans, in %."""

from benchmark.harness import spans


def read(record):
    return spans.share_pct(record, spans.TRAIN_ISSUE)
