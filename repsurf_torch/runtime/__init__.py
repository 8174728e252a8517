"""Host runtime: the prefetching batch loader (repsurf_tpu/runtime)."""

from .loader import PrefetchLoader

__all__ = ["PrefetchLoader"]
