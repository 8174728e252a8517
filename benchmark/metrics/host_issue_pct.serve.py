"""host_issue_pct.serve: the share of the traced span the host spent
issuing a request's work, in the program's ``serve.sample`` and
``serve.forward`` spans, in %."""

from benchmark.harness import spans


def read(record):
    return spans.share_pct(record, spans.SERVE_ISSUE)
