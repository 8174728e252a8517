"""Synthetic ScanObjectNN-shaped clouds and a host-side batcher
(repsurf_tpu/data/scanobjectnn.py, numpy only).

The same seed gives the same clouds as the JAX package's
``SyntheticClouds``.
"""

import numpy as np

NUM_CLASS = 15
NUM_POINT_RAW = 2048


class SyntheticClouds:
    """Deterministic class-structured random clouds with ScanObjectNN
    shapes: each class is a mixture of four Gaussian blobs with its own
    geometry, so a model can fit it."""

    def __init__(self, n_samples=256, n_points=NUM_POINT_RAW, n_class=NUM_CLASS,
                 seed=0, centers_seed=42):
        rng = np.random.RandomState(seed)
        self.label = rng.randint(0, n_class, size=n_samples).astype(np.int64)
        # class geometry comes from its own seed so differently-seeded train
        # and test splits share the same classes
        centers = np.random.RandomState(centers_seed).randn(n_class, 4, 3).astype(
            np.float32
        ) * 0.5
        data = []
        for s in range(n_samples):
            c = centers[self.label[s]]
            pick = rng.randint(0, 4, size=n_points)
            pts = c[pick] + rng.randn(n_points, 3).astype(np.float32) * 0.1
            data.append(pts)
        self.data = np.stack(data).astype(np.float32)

    def __len__(self):
        return self.data.shape[0]

    def __getitem__(self, index):
        return self.data[index], self.label[index]


def iterate_batches(dataset, batch_size, shuffle=False, drop_last=False, rng=None):
    """Yield (points [B, N, 3], labels [B]) numpy batches."""
    n = len(dataset)
    order = np.arange(n)
    if shuffle:
        (rng or np.random).shuffle(order)
    stop = n - (n % batch_size) if drop_last else n
    for s in range(0, stop, batch_size):
        idx = order[s : s + batch_size]
        pts = np.stack([dataset[i][0] for i in idx])
        lbl = np.array([dataset[i][1] for i in idx])
        yield pts, lbl
