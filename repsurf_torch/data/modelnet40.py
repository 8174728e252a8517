"""ModelNet40 dataset (classification), a numpy copy of
repsurf_tpu/data/modelnet40.py.

The reference advertises ModelNet40 results but ships no loader.  This one
reads the two common distributions:

  * modelnet40_normal_resampled: per-shape txt files of
    x,y,z,nx,ny,nz rows + modelnet40_<split>.txt shape lists +
    modelnet40_shape_names.txt;
  * h5 batches (ply_data_{train,test}*.h5 with 'data'/'label'), taken when
    the root holds any.

Items are channels-last float32 [num_point, 3] clouds ([num_point, 6] with
``use_normal``) and int64 labels: the arrays ``fps_sample`` and the
classifiers take once on the device.
"""

import glob
import os

import numpy as np

NUM_CLASS = 40


class ModelNet40Dataset:
    def __init__(self, root, split="train", num_point=1024, use_normal=False):
        if split not in ("train", "test"):
            raise ValueError(f"split must be train or test, got {split!r}")
        self.num_point = num_point
        self.use_normal = use_normal
        h5_files = sorted(glob.glob(os.path.join(root, f"ply_data_{split}*.h5")))
        if h5_files:
            self._load_h5(h5_files)
        else:
            self._load_txt(root, split)

    def _load_h5(self, files):
        import h5py

        datas, labels = [], []
        for f in files:
            with h5py.File(f, "r") as h:
                datas.append(h["data"][:].astype(np.float32))
                labels.append(h["label"][:].astype(np.int64).reshape(-1))
        self.data = np.concatenate(datas)[:, : self.num_point]
        if not self.use_normal:
            self.data = self.data[..., :3]
        self.label = np.concatenate(labels)
        self._paths = None

    def _load_txt(self, root, split):
        with open(os.path.join(root, "modelnet40_shape_names.txt")) as f:
            classes = [ln.strip() for ln in f if ln.strip()]
        cls_index = {c: i for i, c in enumerate(classes)}
        with open(os.path.join(root, f"modelnet40_{split}.txt")) as f:
            shape_ids = [ln.strip() for ln in f if ln.strip()]
        self._paths, labels = [], []
        for sid in shape_ids:
            cls = "_".join(sid.split("_")[:-1])
            self._paths.append(os.path.join(root, cls, sid + ".txt"))
            labels.append(cls_index[cls])
        self.label = np.asarray(labels, np.int64)
        self.data = None

    def __len__(self):
        return len(self.label)

    def __getitem__(self, index):
        if self.data is not None:
            return self.data[index], self.label[index]
        pts = np.loadtxt(self._paths[index], delimiter=",").astype(np.float32)
        pts = pts[: self.num_point]
        if not self.use_normal:
            pts = pts[:, :3]
        return pts, self.label[index]
