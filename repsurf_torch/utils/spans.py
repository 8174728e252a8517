"""Named spans at the port's layer boundaries, for ``torch.profiler``.

``span(name)`` is ``torch.profiler.record_function(name)`` while a profiler
records, and one shared ``contextlib.nullcontext()`` otherwise: a bare
``record_function`` costs several microseconds a span even with no
profiler running, the check well under one.  A span shows in the
profiler's trace as a ``user_annotation`` interval beside the operators
and kernels it issued, on the same clock; spans nest by call.

Names are ``<layer>.<stage>``:

* ``scene.prepare`` (``eval_s3dis.scene_batches``: a room's
  preprocessing), inside it ``scene.voxel_passes``, ``scene.chunk`` (the
  cropper; one ``scene.crop`` a crop) and ``scene.pad``; then a batch's
  ``scene.upload``, ``scene.forward`` and ``scene.vote`` (``scene_votes``).
  On a CUDA device the chunks are cut on the card (``device_batches``):
  ``scene.prepare`` then holds device work and one sync a crop, the room's
  one ``scene.upload`` comes before ``scene.chunk``, and a crop cut again
  on the host by ``np.argsort`` at a boundary tie is a ``scene.crop_host``
  inside its ``scene.crop``; the batches need no upload;
* ``train.forward``, ``train.backward``, ``train.update`` (both train
  steps; the forward and the update also in the data-parallel steps).  A
  train step replayed as a CUDA graph (``train/step_graph.py``) holds only
  ``train.forward``, around the copy of its inputs in and the replay: the
  host issues nothing for the backward and the update there, nor for the
  model's own spans below, which only the eager step and the capture
  record, so the spans still cover the host's real issue time;
  ``train.step`` is the whole captured step, timed on the card only (see
  the end);
* ``serve.sample`` and one ``serve.forward`` a vote (``train_cls.eval_step``);
* ``pt.attention`` (a ``PointTransformerLayer``: its kNN, gathers, both
  MLPs, softmax and weighted sum), ``pt.down`` (a strided
  ``TransitionDown``: FPS, kNN grouping, Linear, BN, max-pool) and
  ``pt.up`` (a ``TransitionUp``), inside ``train.forward`` or a forward of
  PointTransformer (``nn/pointtransformer.py``);
* ``pnx.aggregate`` (a PointNeXt local aggregation, a set abstraction's or
  an inverted-residual block's: from the ball query to the max over the
  slots), inside it ``pnx.group`` (its ball query and gather), and
  ``pnx.mlp`` (an inverted-residual block's two pointwise layers and its
  residual), inside ``train.forward`` or a forward of PointNeXt
  (``nn/pointnext.py``).

Counts come from the spans: the number of ``scene.crop`` spans is the
number of crops.  Apart from PointTransformer's and PointNeXt's, no model
or kernel holds a span: a model span's host time is its launch time, and the time the host
waits inside it for the card when the launch queue is full.

A replayed graph issues no span, so a capture keeps the card's side of
them instead: inside ``timing()`` (``step_graph`` captures a step in it)
each span records a pair of CUDA timing events, which the graph holds as
event nodes around the span's kernels and records again at every replay.
``device_seconds`` reads a replay's device seconds under each name.
"""

import contextlib

import torch

_NULL = contextlib.nullcontext()
_timed = None  # inside ``timing()``: the list the spans' event pairs go to


class _Timed:
    """A span's pair of CUDA timing events, recorded on the current stream
    (a capturing one: the events become the graph's nodes)."""

    def __init__(self, name):
        self.name = name
        self.start = torch.cuda.Event(enable_timing=True, external=True)
        self.end = torch.cuda.Event(enable_timing=True, external=True)

    def __enter__(self):
        self.start.record()
        return self

    def __exit__(self, *exc):
        self.end.record()


def span(name):
    """A context manager that times ``name`` on the card inside
    ``timing()``, marks it in a recording profiler's trace, and does
    nothing otherwise."""
    if _timed is not None:
        timed = _Timed(name)
        _timed.append(timed)
        return timed
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NULL


@contextlib.contextmanager
def timing():
    """Within it every span is timed on the card -> the list of the spans'
    event pairs, in the order they open."""
    global _timed
    outer, _timed = _timed, []
    try:
        yield _timed
    finally:
        _timed = outer


def device_seconds(timed):
    """{name: device seconds between each of its spans' events, summed}
    for the event pairs ``timing()`` gave, once all have been recorded;
    waits for the last of them."""
    out = {}
    for t in timed:
        t.end.synchronize()
        out[t.name] = out.get(t.name, 0.0) + t.start.elapsed_time(t.end) * 1e-3
    return out
