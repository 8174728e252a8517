"""Model registry, keyed by the reference's dotted names
(repsurf_tpu/models/__init__.py)."""

from .pointnet2_seg import PointNet2Segmentor, pointnet2_ssg
from .pointtransformer_seg import PointTransformerSegmentor, pointtransformer
from .repsurf_cls import RepSurfClassifier, repsurf_ssg_tri, repsurf_ssg_umb, repsurf_ssg_umb_2x
from .repsurf_seg import RepSurfSegmentor, repsurf_umb_ssg

CLS_MODELS = {
    "repsurf.repsurf_ssg_umb": repsurf_ssg_umb,
    "repsurf.repsurf_ssg_umb_2x": repsurf_ssg_umb_2x,
    "repsurf.repsurf_ssg_tri": repsurf_ssg_tri,
}
SEG_MODELS = {
    "repsurf.repsurf_umb_ssg": repsurf_umb_ssg,
    "pointnet2.pointnet2_ssg": pointnet2_ssg,
    "pointtransformer.pointtransformer": pointtransformer,
}
_REGISTRY = {**CLS_MODELS, **SEG_MODELS}


def get_model(name, **kwargs):
    """Build a model by reference-style dotted name."""
    try:
        factory = _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown model {name!r}; available: {sorted(_REGISTRY)}") from None
    return factory(**kwargs)


__all__ = [
    "PointNet2Segmentor",
    "PointTransformerSegmentor",
    "RepSurfClassifier",
    "RepSurfSegmentor",
    "CLS_MODELS",
    "SEG_MODELS",
    "get_model",
    "pointnet2_ssg",
    "pointtransformer",
    "repsurf_ssg_tri",
    "repsurf_ssg_umb",
    "repsurf_ssg_umb_2x",
    "repsurf_umb_ssg",
]
