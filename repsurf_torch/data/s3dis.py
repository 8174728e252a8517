"""S3DIS class weights, colour statistics and padded batching
(repsurf_tpu/data/s3dis.py, ``CLASS_WEIGHTS``, ``S3DIS_RGB_MEAN`` /
``S3DIS_RGB_STD`` and ``pad_batch``), numpy only.

A copy, not an import: importing ``repsurf_tpu.data`` pulls in jax, and the
machine with the card has none.  The training-time ``data_prepare`` is not
ported yet; voxelising is ``data/voxelize.py``.
"""

import numpy as np

NUM_CLASS = 13

S3DIS_RGB_MEAN = np.array([0.52146571, 0.50457911, 0.44939377], dtype=np.float32)
S3DIS_RGB_STD = np.array([0.19645595, 0.19576158, 0.20104336], dtype=np.float32)

# per-area class weights, segmentation/util/utils.py:159-189
CLASS_WEIGHTS = {
    1: [0.27362621, 0.3134626, 0.18798782, 1.38965602, 1.44210271, 0.86639497,
        1.07227331, 1.0, 1.05912352, 1.92726327, 0.52329938, 2.04783419, 0.5104427],
    2: [0.29036634, 0.34709631, 0.19514767, 1.20129272, 1.39663689, 0.87889087,
        1.11586938, 1.0, 1.54599972, 1.87057415, 0.56458097, 1.87316536, 0.51576885],
    3: [0.27578885, 0.32039725, 0.19055443, 1.14914046, 1.46885687, 0.85450877,
        1.05414776, 1.0, 1.09680025, 2.09280004, 0.59355243, 1.95746691, 0.50429199],
    4: [0.27667177, 0.32612854, 0.19886974, 1.18282174, 1.52145143, 0.8793782,
        1.14202999, 1.0, 1.0857859, 1.89738584, 0.5964717, 1.95820557, 0.52113351],
    5: [0.28459923, 0.32990557, 0.1999722, 1.20798185, 1.33784535, 1.0, 0.93323316,
        1.0753585, 1.00199521, 1.53657772, 0.7987055, 1.82384844, 0.48565471],
    6: [0.29442441, 0.37941846, 0.21360804, 0.9812721, 1.40968965, 0.88577139, 1.0,
        1.09387107, 1.53238009, 1.61365643, 1.15693894, 1.57821041, 0.47342451],
}


def pad_batch(samples, n_max, ignore_index=255):
    """Pack variable-size (coord, feat, label) samples into a padded batch.

    Replaces collate_fn (data_util.py:15-23).  Samples longer than n_max are
    truncated (callers crop first); padding rows repeat the first point's
    coordinates (harmless for kNN since valid counts mask them) and carry the
    ignore label.

    Returns:
      dict(coord [B,n,3], feat [B,n,C], label [B,n], valid [B]).
    """
    B = len(samples)
    c_dim = samples[0][1].shape[1]
    coord = np.zeros((B, n_max, 3), np.float32)
    feat = np.zeros((B, n_max, c_dim), np.float32)
    label = np.full((B, n_max), ignore_index, np.int64)
    valid = np.zeros((B,), np.int32)
    for b, (c, f, l) in enumerate(samples):
        n = min(len(c), n_max)
        coord[b, :n] = c[:n]
        feat[b, :n] = f[:n]
        if l is not None:
            label[b, :n] = l[:n]
        if n < n_max:
            coord[b, n:] = c[0]
        valid[b] = n
    return {"coord": coord, "feat": feat, "label": label, "valid": valid}
