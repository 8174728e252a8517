"""k-NN inverse-distance feature interpolation for feature propagation
(repsurf_tpu/ops/interpolate.py): Euclidean distances with the reference's
1e-8 epsilon."""

from .gather import index_points
from .neighbors import knn


def interpolate_weights(k, xyz_src, xyz_dst, valid_src=None):
    """kNN indices and normalised inverse-distance weights.

    Args:
      k: neighbours per target (3 in the models).
      xyz_src: [B, M, 3] coarse points, where the features live.
      xyz_dst: [B, N, 3] fine points, the interpolation targets.
      valid_src: optional [B] counts of the coarse cloud.

    Returns:
      idx [B, N, k] indices into M and weight [B, N, k].
    """
    idx, dist = knn(k, xyz_src, xyz_dst, valid=valid_src)
    recip = 1.0 / (dist + 1e-8)
    return idx, recip / recip.sum(dim=-1, keepdim=True)


def three_interpolate(xyz_src, xyz_dst, feat_src, valid_src=None, k=3):
    """Inverse-distance weighted interpolation of features onto a finer
    cloud: xyz_src [B, M, 3], xyz_dst [B, N, 3], feat_src [B, M, C] ->
    [B, N, C]."""
    idx, weight = interpolate_weights(k, xyz_src, xyz_dst, valid_src)
    return (index_points(feat_src, idx) * weight[..., None]).sum(dim=2)
