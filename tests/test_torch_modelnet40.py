"""The port's ModelNet40 loader against the JAX package's on the CPU: the h5
and the txt (modelnet40_normal_resampled) layouts, with and without
normals, ``num_point`` under the file's rows.  Both are numpy, so lengths,
arrays, dtypes and labels must be equal exactly."""

import h5py
import numpy as np
import pytest
import torch

from repsurf_torch.data import ModelNet40Dataset
from repsurf_torch.data.modelnet40 import NUM_CLASS
from repsurf_tpu.data.modelnet40 import NUM_CLASS as J_NUM_CLASS
from repsurf_tpu.data.modelnet40 import ModelNet40Dataset as JModelNet40Dataset

torch.set_num_threads(1)

ROWS = 300  # points a shape in the fixtures
CLASSES = ["airplane", "night_stand", "bathtub", "flower_pot"]  # two with "_" in the name


def write_h5(root, split, shapes=(5, 3), seed=0):
    """ply_data_<split><i>.h5 files of [n, ROWS, 6] clouds and [n, 1] labels."""
    rs = np.random.RandomState(seed)
    for i, n in enumerate(shapes):
        with h5py.File(root / f"ply_data_{split}{i}.h5", "w") as h:
            h["data"] = rs.randn(n, ROWS, 6).astype(np.float32)
            h["label"] = rs.randint(0, NUM_CLASS, (n, 1)).astype(np.uint8)


def write_txt(root, seed=1):
    """modelnet40_normal_resampled: names, split lists, x,y,z,nx,ny,nz rows."""
    rs = np.random.RandomState(seed)
    (root / "modelnet40_shape_names.txt").write_text("\n".join(CLASSES) + "\n")
    ids = {"train": [], "test": []}
    for ci, cls in enumerate(CLASSES):
        (root / cls).mkdir()
        for j in range(2):
            sid = f"{cls}_{ci * 10 + j + 1:04d}"
            np.savetxt(root / cls / f"{sid}.txt", rs.randn(ROWS, 6), delimiter=",", fmt="%.6f")
            ids["train" if j == 0 else "test"].append(sid)
    for split, sids in ids.items():
        (root / f"modelnet40_{split}.txt").write_text("\n".join(sids) + "\n")


def assert_same(root, split, num_point, use_normal):
    t = ModelNet40Dataset(str(root), split, num_point=num_point, use_normal=use_normal)
    j = JModelNet40Dataset(str(root), split, num_point=num_point, use_normal=use_normal)
    assert len(t) == len(j) > 0
    np.testing.assert_array_equal(t.label, j.label)
    for i in range(len(t)):
        (tp, tl), (jp, jl) = t[i], j[i]
        assert tp.dtype == jp.dtype == np.float32 and tp.shape == (num_point,
                                                                   6 if use_normal else 3)
        np.testing.assert_array_equal(tp, jp)
        assert tl == jl and np.asarray(tl).dtype == np.asarray(jl).dtype
    return t


@pytest.mark.parametrize("split", ["train", "test"])
@pytest.mark.parametrize("use_normal", [False, True])
def test_h5_layout_matches_jax(tmp_path, split, use_normal):
    write_h5(tmp_path, split, seed=0 if split == "train" else 5)
    assert_same(tmp_path, split, num_point=256, use_normal=use_normal)


@pytest.mark.parametrize("split", ["train", "test"])
@pytest.mark.parametrize("use_normal", [False, True])
def test_txt_layout_matches_jax(tmp_path, split, use_normal):
    write_txt(tmp_path)
    ds = assert_same(tmp_path, split, num_point=200, use_normal=use_normal)
    assert sorted(ds.label) == list(range(len(CLASSES)))  # "night_stand_0021" -> night_stand


def test_h5_files_take_precedence_over_txt(tmp_path):
    write_txt(tmp_path)
    write_h5(tmp_path, "train", shapes=(4,))
    ds = assert_same(tmp_path, "train", num_point=128, use_normal=False)
    assert len(ds) == 4 and ds.data is not None


def test_constants_and_a_bad_split():
    assert NUM_CLASS == J_NUM_CLASS == 40
    with pytest.raises(ValueError, match="split"):
        ModelNet40Dataset("unused", "val")


def test_loader_arrays_feed_fps_and_the_classifier(tmp_path):
    """A batch of the loader's arrays goes through ``fps_sample`` and a
    narrow repsurf_ssg_umb with 40 classes without conversion: finite
    [B, 40] log-probabilities."""
    from repsurf_torch.data.transforms import fps_sample
    from repsurf_torch.models import get_model

    from .test_torch_model import NARROW

    write_h5(tmp_path, "test", shapes=(4,))
    ds = ModelNet40Dataset(str(tmp_path), "test", num_point=ROWS)
    pts = torch.from_numpy(np.stack([ds[i][0] for i in range(len(ds))]))
    model = get_model("repsurf.repsurf_ssg_umb", num_class=NUM_CLASS,
                      generator=torch.Generator().manual_seed(0), **NARROW).eval()
    with torch.no_grad():
        logp = model(fps_sample(pts, 128))
    assert logp.shape == (4, NUM_CLASS) and torch.isfinite(logp).all()
