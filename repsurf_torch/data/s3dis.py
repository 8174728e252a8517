"""S3DIS scenes (repsurf_tpu/data/s3dis.py), numpy only: class weights,
colour statistics, the per-sample pipeline ``data_prepare``, the room
dataset ``S3DISDataset`` and padded batching.

A copy, not an import: importing ``repsurf_tpu.data`` pulls in jax, and the
machine with the card has none.  The ragged ``[sum(N), C] + offset``
collate of segmentation/util/data_util.py is replaced, as in the JAX
package, by padding every scene into ``[B, N_max, C]`` with per-sample
valid counts (padding rows carry the ignore label).  Every draw of the
pipeline comes from the ``rng`` handed to it, in the JAX package's order.
"""

import os

import numpy as np

from .voxelize import voxelize

NUM_CLASS = 13
S3DIS_LOOP = 30  # segmentation/util/utils.py:150-156

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


def data_prepare(
    coord,
    feat,
    label,
    split="train",
    voxel_size=0.04,
    voxel_max=80000,
    coord_transform=None,
    rgb_transform=None,
    rgb_mean=S3DIS_RGB_MEAN,
    rgb_std=S3DIS_RGB_STD,
    data_norm="mean",
    shuffle_index=True,
    stop_transform=False,
    rng=None,
):
    """Per-sample pipeline (segmentation/util/data_util.py:26-73): aug ->
    voxel grid sample -> crop around a random seed -> shuffle -> coord
    mean-center -> rgb /255 + standardize."""
    rng = rng or np.random
    if coord_transform is not None and not stop_transform:
        coord, _, _ = coord_transform(coord, None, None, rng)
    if rgb_transform is not None and not stop_transform:
        _, feat, _ = rgb_transform(None, feat, None, rng)

    if voxel_size:
        uniq_idx = voxelize(coord - np.min(coord, 0), voxel_size, rng=rng)
        coord, feat = coord[uniq_idx], feat[uniq_idx]
        if label is not None:
            label = label[uniq_idx]

    if split != "val" and voxel_max and coord.shape[0] > voxel_max:
        init_idx = (
            rng.randint(coord.shape[0]) if "train" in split else coord.shape[0] // 2
        )
        crop_idx = np.argsort(np.sum(np.square(coord - coord[init_idx]), 1))[:voxel_max]
        coord, feat = coord[crop_idx], feat[crop_idx]
        if label is not None:
            label = label[crop_idx]

    if shuffle_index:
        shuf = np.arange(coord.shape[0])
        rng.shuffle(shuf)
        coord, feat = coord[shuf], feat[shuf]
        if label is not None:
            label = label[shuf]

    if data_norm == "mean":
        coord = coord - np.mean(coord, 0)
    elif data_norm == "min":
        coord = coord - np.min(coord, 0)

    feat = feat / 255.0
    if rgb_mean is not None and rgb_std is not None:
        feat = (feat - rgb_mean) / rgb_std

    return (
        coord.astype(np.float32),
        feat.astype(np.float32),
        None if label is None else label.astype(np.int64),
    )


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


class S3DISDataset:
    """Room-per-item dataset with the reference's Area split and loop factor.

    Rooms are memory-cached in-process (the analog of the reference's
    /dev/shm SharedArray store).  ``get(idx, rng)`` runs ``data_prepare``
    with the draws of ``rng``; augmentations only in the train split.
    """

    def __init__(
        self,
        data_dir,
        split="train",
        test_area=5,
        loop=S3DIS_LOOP,
        voxel_size=0.04,
        voxel_max=80000,
        coord_transform=None,
        rgb_transform=None,
        shuffle_index=True,
        cache=True,
        rgb_mean=S3DIS_RGB_MEAN,
        rgb_std=S3DIS_RGB_STD,
    ):
        self.data_dir = data_dir
        self.split = split
        self.voxel_size = voxel_size
        self.voxel_max = voxel_max
        self.coord_transform = coord_transform
        self.rgb_transform = rgb_transform
        self.shuffle_index = shuffle_index
        self.loop = loop
        self.rgb_mean = rgb_mean
        self.rgb_std = rgb_std
        names = sorted(
            f[:-4] for f in os.listdir(data_dir) if f.endswith(".npy") and "Area_" in f
        )
        marker = f"Area_{test_area}"
        if split == "train":
            self.rooms = [n for n in names if marker not in n]
        else:
            self.rooms = [n for n in names if marker in n]
        self._cache = {} if cache else None

    def _load(self, name):
        if self._cache is not None and name in self._cache:
            return self._cache[name]
        data = np.load(os.path.join(self.data_dir, name + ".npy")).astype(np.float32)
        if self._cache is not None:
            self._cache[name] = data
        return data

    def __len__(self):
        return len(self.rooms) * self.loop

    def __getitem__(self, idx):
        return self.get(idx)

    def get(self, idx, rng=None):
        name = self.rooms[idx % len(self.rooms)]
        data = self._load(name)
        coord, feat, label = data[:, 0:3], data[:, 3:6], data[:, 6]
        return data_prepare(
            coord.copy(),
            feat.copy(),
            label.copy(),
            split=self.split,
            voxel_size=self.voxel_size,
            voxel_max=self.voxel_max,
            coord_transform=self.coord_transform,
            rgb_transform=self.rgb_transform,
            rgb_mean=self.rgb_mean,
            rgb_std=self.rgb_std,
            shuffle_index=self.shuffle_index,
            stop_transform=(self.split != "train"),
            rng=rng,
        )
