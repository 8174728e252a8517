"""The analytic work of a run's units, from the configuration: its
``work`` entry names the functions (``model.seg_flops``: the function
``seg_flops`` of ``work/model.py``) that count a forward's FLOPs
(``flops(arch, valid)``) and its FPS calls (``fps(arch, valid, train,
votes)``).  A unit (a step, a request, a room) is described by the traffic
kind's ``shapes``: ``{"train", "votes", "forwards": [{"points", "valid"}]}``,
``points`` the padded size the program launches at, ``valid`` each
cloud's real points."""

from ..harness import common
from . import fps


def of_units(config, units):
    """{"model_flops", "fps_bound_s"} of ``units``: a training step counts
    three forwards (the backward's two products a Linear), each vote one."""
    arch = config["arch"]
    flops_fn = common.named("work", config["work"]["flops"])
    fps_fn = common.named("work", config["work"]["fps"])
    flops, bound = 0, 0.0
    for unit in units:
        passes = (3 if unit["train"] else 1) * unit["votes"]
        for fwd in unit["forwards"]:
            flops += passes * flops_fn(arch, fwd["valid"])
            bound += fps.bound_s(fps_fn(arch, fwd["valid"], unit["train"], unit["votes"]))
    return {"model_flops": flops, "fps_bound_s": bound}
