"""What the profiling CLIs and ``chip_smoke.py`` share: the device check,
the sync, and the root bench.py's two-room segmentation batch."""

import numpy as np
import torch


def resolve_device(device):
    """torch.device(device); raises for a CUDA device where there is none
    (an entry point never falls back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r}: no CUDA device here "
                           "(ask for the CPU with device='cpu' / --device cpu)")
    return dev


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def seg_batch(n=80000, b=2):
    """bench.py's batch: ``RandomState(0)``, then per sample a surface-
    sampled room (spatial pruning behaves as on voxelized S3DIS, which
    gaussian blobs misrepresent), random colours and labels, padded."""
    from ..data.s3dis import pad_batch
    from ..data.synthetic_scene import synthetic_room

    rng = np.random.RandomState(0)
    samples = [(synthetic_room(n, rng=rng), rng.rand(n, 3).astype(np.float32),
                rng.randint(0, 13, n).astype(np.int64)) for _ in range(b)]
    return pad_batch(samples, n)
