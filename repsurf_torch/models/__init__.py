"""Model registry, keyed by the reference's dotted names
(repsurf_tpu/models/__init__.py)."""

from .pointnet2_seg import PointNet2Segmentor, pointnet2_ssg
from .pointnext_seg import RECIPE as POINTNEXT_RECIPE
from .pointnext_seg import PointNeXtSegmentor, pointnext_xl
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
    "pointnext.pointnext_xl": pointnext_xl,
}
_REGISTRY = {**CLS_MODELS, **SEG_MODELS}
# a seg model's training-recipe fields of train_seg.SegConfig, where they
# differ from RepSurf's defaults; the CLIs apply them on --model (a model
# not listed trains on the defaults)
SEG_RECIPES = {"pointnext.pointnext_xl": POINTNEXT_RECIPE}


def get_model(name, **kwargs):
    """Build a model by reference-style dotted name."""
    try:
        factory = _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown model {name!r}; available: {sorted(_REGISTRY)}") from None
    return factory(**kwargs)


__all__ = [
    "PointNet2Segmentor",
    "PointNeXtSegmentor",
    "PointTransformerSegmentor",
    "RepSurfClassifier",
    "RepSurfSegmentor",
    "CLS_MODELS",
    "SEG_MODELS",
    "SEG_RECIPES",
    "get_model",
    "pointnet2_ssg",
    "pointnext_xl",
    "pointtransformer",
    "repsurf_ssg_tri",
    "repsurf_ssg_umb",
    "repsurf_ssg_umb_2x",
    "repsurf_umb_ssg",
]
