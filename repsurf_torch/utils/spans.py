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
  classification step replayed as a CUDA graph (``train/step_graph.py``)
  holds only ``train.forward``, around the copy of its inputs in and the
  replay: the host issues nothing for the backward and the update there,
  so the spans still cover the host's real issue time;
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
"""

import contextlib

import torch

_NULL = contextlib.nullcontext()


def span(name):
    """A context manager that marks ``name`` in a recording profiler's
    trace, and does nothing when none records."""
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NULL
