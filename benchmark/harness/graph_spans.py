"""Device seconds under the program's spans in a train step replayed as a
CUDA graph.

A replayed step issues none of the model's spans from the host, so the
host-span readers (``spans.py``) find none of them there.  The program
times them on the card instead: its capture records a pair of timing
events around each span, which every replay records again, and
``repsurf_torch.train.step_graph.span_seconds()`` gives {span name: device
seconds} of the latest replayed step, the whole step under
``train.step``.  Read after a traced run, that step is the traced span's
last unit.

A program without ``span_seconds``, or whose latest train step on the card
was not a replay, gives None, never 0."""


def seconds():
    """The program's {span name: device seconds} of its latest replayed
    step, or {}."""
    try:
        from repsurf_torch.train import step_graph
    except ImportError:
        return {}
    read = getattr(step_graph, "span_seconds", None)
    return {} if read is None else read()


def share_pct(labels, secs=None):
    """100 * the device seconds under the spans named in ``labels`` / the
    whole step's, or None.  ``secs`` defaults to ``seconds()``."""
    secs = seconds() if secs is None else secs
    step = secs.get("train.step", 0.0)
    found = [secs[name] for name in labels if name in secs]
    if not found or step <= 0:
        return None
    return 100.0 * sum(found) / step
