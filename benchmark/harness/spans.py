"""Host seconds under the program's own spans, from a traced run's record.

The program marks its layer boundaries with ``record_function`` spans
named ``<layer>.<stage>`` (``repsurf_torch/utils/spans.py``): a room's host
preprocessing is ``scene.prepare``; a train step's issue ``train.forward``,
``train.backward`` and ``train.update``; a served request's
``serve.sample`` and ``serve.forward``.  The trace keeps every such span
that overlaps the traced span in ``host_spans`` as ``[label, start s,
seconds]``, clipped to it (``trace.py``), on the device's clock.

A program without these spans leaves nothing under their labels: the
readers then give None, never 0."""

SCENE_PREP = ("scene.prepare",)
TRAIN_ISSUE = ("train.forward", "train.backward", "train.update")
SERVE_ISSUE = ("serve.sample", "serve.forward")


def seconds(record, labels):
    """Seconds of the traced span covered by the host spans whose label is
    in ``labels`` (the union of their intervals, so a span nested in
    another of the set counts once), or None when there is none."""
    found = sorted((start, start + secs) for name, start, secs in record["host_spans"]
                   if name in labels)
    if not found:
        return None
    total, end = 0.0, float("-inf")
    for s, e in found:
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def share_pct(record, labels):
    """100 * ``seconds(record, labels)`` / the traced span, or None."""
    secs = seconds(record, labels)
    if secs is None or record["window_s"] <= 0:
        return None
    return 100.0 * secs / record["window_s"]


def ms_per_unit(record, labels):
    """1000 * ``seconds(record, labels)`` / the traced units, or None."""
    secs = seconds(record, labels)
    if secs is None or not record["units"]:
        return None
    return 1e3 * secs / len(record["units"])
