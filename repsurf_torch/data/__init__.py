"""Data: synthetic ScanObjectNN-shaped clouds, batching, FPS
preprocessing and the vote rescale; synthetic S3DIS-style rooms, the S3DIS
per-sample pipeline (augmentations, data_prepare, S3DISDataset), class
weights and padded scene batches; the ModelNet40 loader (numpy copies of
the JAX package's helpers)."""

from .modelnet40 import ModelNet40Dataset

__all__ = ["ModelNet40Dataset"]
