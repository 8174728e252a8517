"""host_prep_pct.infer: the share of the traced span the host spent in the
program's ``scene.prepare`` span, in %.  The card has nothing queued then
(the room before ended in a read-back), so this is the part of
device_idle_pct.infer that a room's host preprocessing explains."""

from benchmark.harness import spans


def read(record):
    return spans.share_pct(record, spans.SCENE_PREP)
