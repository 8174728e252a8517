"""Data: synthetic ScanObjectNN-shaped clouds, batching, FPS
preprocessing and the vote rescale."""
