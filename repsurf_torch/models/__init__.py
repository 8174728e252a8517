"""Model registry, keyed by the reference's dotted names
(repsurf_tpu/models/__init__.py)."""

from .repsurf_cls import RepSurfClassifier, repsurf_ssg_umb, repsurf_ssg_umb_2x
from .repsurf_seg import RepSurfSegmentor, repsurf_umb_ssg

_REGISTRY = {
    "repsurf.repsurf_ssg_umb": repsurf_ssg_umb,
    "repsurf.repsurf_ssg_umb_2x": repsurf_ssg_umb_2x,
    "repsurf.repsurf_umb_ssg": repsurf_umb_ssg,
}


def get_model(name, **kwargs):
    """Build a model by reference-style dotted name."""
    try:
        factory = _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown model {name!r}; available: {sorted(_REGISTRY)}") from None
    return factory(**kwargs)


__all__ = [
    "RepSurfClassifier",
    "RepSurfSegmentor",
    "get_model",
    "repsurf_ssg_umb",
    "repsurf_ssg_umb_2x",
    "repsurf_umb_ssg",
]
