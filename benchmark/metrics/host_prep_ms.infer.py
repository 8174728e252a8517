"""host_prep_ms.infer: the host's milliseconds a room in the program's
``scene.prepare`` span (voxel passes, the chunk cropper, padding the
batches), over the traced rooms."""

from benchmark.harness import spans


def read(record):
    return spans.ms_per_unit(record, spans.SCENE_PREP)
