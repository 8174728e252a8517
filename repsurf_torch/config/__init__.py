"""Configuration presets (repsurf_tpu/config); the dataclass configs live in
``train/``."""

from .presets import S3DIS_AUG_ARGS

__all__ = ["S3DIS_AUG_ARGS"]
