"""The readings of a training cell and the plain optimizers that the
reference steps with.

Set-up drives the program's own training step, the one the window calls,
through its first three steps on three different batches and reads: each
step's loss, the first gradient as the optimizer got it (Adam's first
moment after one step over 1 - beta1), and each leaf's change after the
third step.  The reference follows the same three steps from the same
weights and draws.  Gaps are taken by the worst leaf: the gap between the
two norms of a leaf over the larger of the reference's norm of that leaf
and of the median leaf.  A leaf whose reference gradient lies under a
thousandth of the median leaf's moves by round-off alone and is left out of
the change.
"""

import math
import statistics

import torch

STEPS = 3
QUIET = 1e-3


def program_readings(model, optimizer, step_fn, beta1):
    """Run ``step_fn(i) -> loss float`` for the first STEPS steps ->
    {"loss": [..], "grad": {name: norm}, "change": {name: norm}}."""
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    losses, grad = [], {}
    for i in range(STEPS):
        losses.append(step_fn(i))
        if i == 0:
            grad = {n: _first_moment(optimizer, p) / (1.0 - beta1)
                    for n, p in model.named_parameters()}
    change = {n: float((p.detach() - start[n]).double().norm())
              for n, p in model.named_parameters()}
    return {"loss": losses, "grad": grad, "change": change}


def _first_moment(optimizer, p):
    """Norm of Adam's first moment of p; 0 where the optimizer kept none (a
    step that never reached it)."""
    m = optimizer.state.get(p, {}).get("exp_avg")
    return 0.0 if m is None else float(m.double().norm())


class Adam:
    """torch's Adam (coupled L2) and AdamW (decoupled decay), written out."""

    def __init__(self, params, tcfg):
        self.params = params
        self.lr, self.wd, self.eps = tcfg["lr"], tcfg["weight_decay"], tcfg["eps"]
        self.b1, self.b2 = tcfg["betas"]
        self.decoupled = tcfg["decoupled"]
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.t = 0

    @torch.no_grad()
    def step(self, grads):
        """Apply one step; returns the gradients as the moments took them."""
        self.t += 1
        bc1, bc2 = 1.0 - self.b1 ** self.t, 1.0 - self.b2 ** self.t
        taken = []
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            if self.decoupled:
                p.mul_(1.0 - self.lr * self.wd)
            else:
                g = g + self.wd * p
            taken.append(g)
            m.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            p.addcdiv_(m, (v.sqrt() / math.sqrt(bc2)).add_(self.eps), value=-self.lr / bc1)
        return taken


BUFFERS = ("running_mean", "running_var", "num_batches_tracked")


def reference_readings(state0, loss_fn, tcfg, steps=STEPS):
    """Follow ``steps`` steps of the reference from ``state0`` (names ->
    tensors; every entry but the norms' running buffers is a parameter):
    ``loss_fn(p, i) -> loss`` of step i.  Same readings as
    ``program_readings``."""
    p = {k: v.clone() for k, v in state0.items()}
    names = [k for k in p if not k.endswith(BUFFERS)]
    for n in names:
        p[n].requires_grad_(True)
    opt = Adam([p[n] for n in names], tcfg)
    losses, grad = [], {}
    for i in range(steps):
        loss = loss_fn(p, i)
        grads = torch.autograd.grad(loss, [p[n] for n in names])
        taken = opt.step(grads)
        losses.append(float(loss.detach()))
        if i == 0:
            grad = {n: float(g.double().norm()) for n, g in zip(names, taken)}
        del loss, grads, taken
    change = {n: float((p[n].detach() - state0[n]).double().norm()) for n in names}
    return {"loss": losses, "grad": grad, "change": change}


def leaf_gap(prog, ref, leaves):
    floor = statistics.median(ref[n] for n in leaves)
    return max(abs(prog[n] - ref[n]) / max(ref[n], floor) for n in leaves)


def gaps(prog, ref):
    """(loss_gap, grad_gap, change_gap) of two sets of readings."""
    loss = max(abs(a - r) / abs(r) for a, r in zip(prog["loss"], ref["loss"]))
    names = list(ref["grad"])
    missing = [n for n in names if n not in prog["grad"]]
    if missing:
        return math.inf, math.inf, math.inf
    med = statistics.median(ref["grad"].values())
    moving = [n for n in names if ref["grad"][n] >= QUIET * med]
    return loss, leaf_gap(prog["grad"], ref["grad"], names), leaf_gap(prog["change"],
                                                                         ref["change"], moving)


def checks(prog, ref, limits):
    loss, grad, change = gaps(prog, ref)
    return [("loss_gap", loss, limits["loss_gap"]), ("grad_gap", grad, limits["grad_gap"]),
            ("change_gap", change, limits["change_gap"])]


def reference(state, loss_factory, **kw):
    """The reference's readings of a training driver's state: its start,
    its pool and ``loss_factory(ctx, pool, **kw)``'s steps."""
    ctx = state["ctx"]
    return reference_readings(state["start"], loss_factory(ctx, state["pool"], **kw),
                              ctx.config["train"])
