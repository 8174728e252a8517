"""Seeding (repsurf_tpu/utils/seed.py).

The JAX package threads keys derived from one root key; the port threads
explicit ``torch.Generator``s derived the same way from (seed, path), so a
run resumed at epoch e draws what an unbroken run draws there.
"""

import random

import numpy as np
import torch


def set_seed(seed):
    """Seed the host's ``random`` and NumPy global generators, as the JAX
    package does, and return a CPU ``torch.Generator`` seeded with ``seed``
    (the root for parameter initialisation).  Nothing in the port reads the
    global generators."""
    np.random.seed(seed)
    random.seed(seed)
    return torch.Generator().manual_seed(seed)


def derive_seed(seed, *path):
    """A 63-bit seed for the integer path under ``seed`` (the counterpart of
    ``jax.random.fold_in``), from NumPy's ``SeedSequence``."""
    state = np.random.SeedSequence([seed, *path]).generate_state(2, dtype=np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def epoch_generator(seed, epoch, device, *path):
    """A ``torch.Generator`` on ``device`` for (seed, epoch, *path)."""
    return torch.Generator(device).manual_seed(derive_seed(seed, epoch, *path))


def worker_rng(seed, worker_id):
    """Per-worker NumPy generator (the reference's worker_init_fn,
    segmentation/util/utils.py:99-105)."""
    return np.random.RandomState(seed + worker_id)
