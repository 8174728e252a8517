"""What the harness hands the program and takes from it: seeded weights
made on the card, the state the reference starts from, pinned inputs."""

import math

import torch


def init_weights(model, seed, gain, device):
    """Every Linear's weight U(-gain/sqrt(fan_in), +) and bias
    U(-1/sqrt(fan_in), +), from one draw of a generator on ``device``; the
    norms keep their initial values.  Returns the model."""
    entries = []
    for m in model.modules():
        if isinstance(m, torch.nn.Linear):
            entries.append((m.weight, gain / math.sqrt(m.in_features)))
            if m.bias is not None:
                entries.append((m.bias, 1.0 / math.sqrt(m.in_features)))
    gen = torch.Generator(device).manual_seed(seed)
    u = torch.rand(sum(p.numel() for p, _ in entries), generator=gen, device=device)
    off = 0
    with torch.no_grad():
        for p, bound in entries:
            n = p.numel()
            p.copy_((u[off:off + n].view_as(p) * 2.0 - 1.0) * bound)
            off += n
    return model


def snapshot(model):
    """Parameters and buffers by name, copied: what the reference starts
    from, made by the harness before the program runs."""
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def pinned(array):
    t = torch.from_numpy(array)
    return t.pin_memory() if torch.cuda.is_available() else t


def upload(tensors, device):
    return {k: v.to(device, non_blocking=True) for k, v in tensors.items()}


def free(state):
    """Drop the program's objects from a driver's state, so that the
    reference runs in the memory they held."""
    for k in ("model", "optimizer", "host", "gen"):
        state.pop(k, None)
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
