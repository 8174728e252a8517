"""Configuration presets (repsurf_tpu/config); the dataclass configs live in
``train/``."""

from .presets import PRESETS, S3DIS_AUG_ARGS, SCANOBJECTNN_AUG_ARGS, get_preset

__all__ = ["PRESETS", "S3DIS_AUG_ARGS", "SCANOBJECTNN_AUG_ARGS", "get_preset"]
