"""Logging, scalar records and seeding (repsurf_tpu/utils), without jax."""

from .logging import ScalarWriter, get_logger
from .seed import derive_seed, epoch_generator, set_seed

__all__ = ["ScalarWriter", "derive_seed", "epoch_generator", "get_logger", "set_seed"]
