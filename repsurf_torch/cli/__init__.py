"""Command-line entry points, run as ``python -m repsurf_torch.cli.<name>``."""
