"""Logging, meters, scalar records and seeding (repsurf_tpu/utils), without
jax."""

from .logging import AverageMeter, ScalarWriter, StepTimer, get_logger, profile_trace
from .seed import derive_seed, epoch_generator, set_seed, worker_rng

__all__ = ["AverageMeter", "ScalarWriter", "StepTimer", "derive_seed", "epoch_generator",
           "get_logger", "profile_trace", "set_seed", "worker_rng"]
