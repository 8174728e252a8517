"""ScanNet segmentation (repsurf_tpu/data/scannet.py), numpy only.

The reference carries ScanNet as a second segmentation target
(segmentation/tool/train.py:458-468: 21 classes, voxel 0.02 m, at most
120,000 points, ignore label 0, loop 6; class weights in util/utils.py:179-186;
RGB statistics in :195-196) but ships no dataset class.  As in the JAX
package, ``ScanNetDataset`` reads the common preprocessed layout, one
``scene*.npy`` of xyzrgbl rows (N x 7) per scene, through the S3DIS
pipeline.  Class 0 is "unannotated": the trainer ignores it in the loss and
never predicts it (``SegConfig.pred_ignore0``).
"""

import os
import zlib

import numpy as np

from .s3dis import S3DISDataset

NUM_CLASS = 21
VOXEL_SIZE = 0.02
VOXEL_MAX = 120000
IGNORE_LABEL = 0
LOOP = 6

SCANNET_RGB_MEAN = np.array([0.08400667, 0.08400667, 0.08400667], np.float32)
SCANNET_RGB_STD = np.array([0.28983903, 0.28983903, 0.28983903], np.float32)

# segmentation/util/utils.py:179-186 (train == trainval in the reference)
CLASS_WEIGHTS = [
    0.32051547, 0.1980627, 0.2621471, 0.74563083, 0.52141879, 0.65918949,
    0.73560561, 1.03624985, 1.00063147, 0.90604468, 0.43435155, 3.91494446,
    1.94558718, 1.0, 0.54871637, 2.13587716, 1.13931665, 2.06423695,
    5.59103054, 1.08557339, 1.35027497,
]


class ScanNetDataset(S3DISDataset):
    """Per-scene ``.npy`` ScanNet dataset with the reference's constants.

    Reads the ``.npy`` files of ``data_dir``, named ``scene*.npy`` in the
    common layout (xyzrgbl rows).  The split is the scene list
    ``<data_dir>/<split>.txt`` when it exists, else a crc32 bucket of the
    file name (one fifth of the scenes for ``val``), stable across
    processes.
    """

    def __init__(self, data_dir, split="train", **kw):
        kw.setdefault("voxel_size", VOXEL_SIZE)
        kw.setdefault("voxel_max", VOXEL_MAX)
        kw.setdefault("loop", LOOP)
        kw.setdefault("rgb_mean", SCANNET_RGB_MEAN)
        kw.setdefault("rgb_std", SCANNET_RGB_STD)
        # the base's area filter passes nothing of ScanNet; the scene list
        # is installed below
        super().__init__(data_dir, split="train", test_area=-1, **kw)
        names = sorted(f[:-4] for f in os.listdir(data_dir) if f.endswith(".npy"))
        list_file = os.path.join(data_dir, f"{split}.txt")
        if os.path.exists(list_file):
            with open(list_file) as f:
                wanted = {ln.strip() for ln in f if ln.strip()}
            self.rooms = [n for n in names if n in wanted]
        else:
            held_out = split != "train"
            self.rooms = [n for n in names if (zlib.crc32(n.encode()) % 5 == 4) == held_out]
        self.split = split


def synthetic_scan(n_points, size=(8.0, 8.0, 3.0), spacing=0.02, unannotated=0.03, seed=0):
    """A ScanNet-format scene without a dataset: [n_points, 7] float32
    xyzrgbl rows of ``synthetic_room`` (``spacing`` its grid), the room's
    labels plus one (classes 1..13 of the 21), colours 0..255 and a seeded
    ``unannotated`` share of the points labelled 0."""
    from .synthetic_scene import label_room, synthetic_room

    rng = np.random.RandomState(seed)
    coord = synthetic_room(n_points, size=size, spacing=spacing, rng=rng)
    label = label_room(coord, size) + 1
    label[rng.rand(n_points) < unannotated] = IGNORE_LABEL
    rgb = np.clip(label[:, None] * 12.0 + rng.randn(n_points, 3) * 25.0, 0.0, 255.0)
    return np.concatenate([coord, rgb, label[:, None]], axis=1).astype(np.float32)
