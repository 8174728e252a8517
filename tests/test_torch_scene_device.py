"""A room's chunks cut, normalised and padded by ``eval_s3dis.device_batches``
(run here on CPU tensors, where ``chunk_mean`` is numpy's ``np.mean``)
against the numpy protocol ``chunk_scene`` / ``scene_batches``."""

import numpy as np
import pytest
import torch

from repsurf_torch.data.synthetic_scene import SyntheticRooms
from repsurf_torch.ops.kernels.chunk_mean import chunk_mean
from repsurf_torch.train import eval_s3dis as te

torch.set_num_threads(1)


def smooth_room():
    """About 19,000 points a pass at continuous float32 coordinates: no
    crop ties the point at its boundary."""
    data = SyntheticRooms("val", n_rooms=1, raw_points=20000, seed=3).raw(0)
    return data[:, :3], data[:, 3:6], 3000


def grid_room():
    """A small room on a 2^-8 grid (as the JAX-parity tests' room): many
    equal distances, so crops tie at their boundary."""
    data = SyntheticRooms("val", n_rooms=1, raw_points=3000, seed=3).raw(0)
    data[:, :3] = np.round(data[:, :3] * 0.3 * 256) / 256
    return data[:, :3], data[:, 3:6], 500


def both(coord, feat, voxel_max, data_norm="mean"):
    """(numpy chunks (idx, coord, feat), device batches on the CPU, crop
    counts)."""
    passes = te.voxel_passes(coord, 0.04)
    want = list(zip(*te.chunk_scene(coord, feat, passes, voxel_max, data_norm, seed=1000)))
    te.device_batches.crops.clear()
    got = te.device_batches(coord, feat, passes, voxel_max, 4, data_norm, 1000, "cpu")
    return want, got, dict(te.device_batches.crops)


def flat(batches):
    rows = torch.cat([r for _, r in batches]).numpy()
    xyz = torch.cat([b["coord"] for b, _ in batches]).numpy()
    rgb = torch.cat([b["feat"] for b, _ in batches]).numpy()
    valid = torch.cat([b["valid"] for b, _ in batches]).numpy()
    return rows, xyz, rgb, valid


def assert_same_chunks(coord, feat, want, got, data_norm="mean"):
    """Each chunk holds numpy's rows; each row's colour is bit-equal to
    numpy's; its coordinates are numpy's ``input_normalize`` of the chunk in
    the cropper's order, bit for bit, and so numpy's own wherever the two
    orders give the same mean.  Tied points in another order move the mean
    by a few ulps at most (3 on the rooms below, 2 on the scene cell's).
    Returns the chunks whose mean moved."""
    rows, xyz, rgb, valid = flat(got)
    assert rows.shape[0] == len(want)
    moved = 0
    for k, (idx, c, f) in enumerate(want):
        m = len(idx)
        r = rows[k, :m]
        assert valid[k] == m
        a, b = np.argsort(idx, kind="stable"), np.argsort(r, kind="stable")
        np.testing.assert_array_equal(idx[a], r[b])  # the same rows
        np.testing.assert_array_equal(f[a].view(np.int32), rgb[k, :m][b].view(np.int32))
        mine = te.input_normalize(coord[r], feat[r], data_norm)[0]
        np.testing.assert_array_equal(mine.view(np.int32), xyz[k, :m].view(np.int32))
        if not np.array_equal(c[a].view(np.int32), xyz[k, :m][b].view(np.int32)):
            assert data_norm == "mean" and (idx != r).any()
            theirs, ours = np.mean(coord[idx], 0), np.mean(coord[r], 0)
            assert (np.abs(ours - theirs) <= 4 * np.spacing(np.abs(theirs))).all()
            moved += 1
    return moved


@pytest.mark.parametrize("data_norm", ["mean", "min"])
def test_device_cropper_gives_numpys_chunks_on_a_smooth_room(data_norm):
    coord, feat, vmax = smooth_room()
    want, got, crops = both(coord, feat, vmax, data_norm)
    assert crops.get("device", 0) > 0 and crops.get("host", 0) == 0
    assert assert_same_chunks(coord, feat, want, got, data_norm) == 0  # all bit-equal
    rows = flat(got)[0]
    for k, (idx, _, _) in enumerate(want):
        # the same order wherever the distances to the crop's centre differ
        d_np = np.sum(np.square(coord[idx] - coord[idx[0]]), 1)
        d_dev = np.sum(np.square(coord[rows[k, :len(idx)]] - coord[idx[0]]), 1)
        np.testing.assert_array_equal(d_np, d_dev)
        moved = idx != rows[k, :len(idx)]
        tied = np.r_[d_np[1:] == d_np[:-1], False] | np.r_[False, d_np[1:] == d_np[:-1]]
        assert not (moved & ~tied).any()


def test_device_batches_pad_as_scene_batches():
    coord, feat, vmax = smooth_room()
    want = te.scene_batches(coord, feat, 0.04, vmax, 4, "mean", 1000, device="cpu")
    got = te.device_batches(coord, feat, te.voxel_passes(coord, 0.04), vmax, 4, "mean", 1000,
                            "cpu")
    assert len(want) == len(got)
    for (bw, rw), (bg, rg) in zip(want, got):
        assert bw["coord"].shape == tuple(bg["coord"].shape)
        assert bw["feat"].shape == tuple(bg["feat"].shape)
        np.testing.assert_array_equal(bw["valid"], bg["valid"].numpy())
        rg = rg.numpy()
        for r in range(rw.shape[0]):  # up to the order of tied points
            a, b = np.argsort(rw[r], kind="stable"), np.argsort(rg[r], kind="stable")
            np.testing.assert_array_equal(rw[r][a], rg[r][b])
            np.testing.assert_array_equal(bw["feat"][r][a], bg["feat"][r].numpy()[b])
            m = int(bw["valid"][r])  # the padding repeats the chunk's first point
            np.testing.assert_array_equal(bg["coord"][r, m:].numpy(),
                                          np.broadcast_to(bg["coord"][r, 0].numpy(),
                                                          bw["coord"][r, m:].shape))
    assert_same_chunks(coord, feat, list(zip(*te.chunk_scene(
        coord, feat, te.voxel_passes(coord, 0.04), vmax, "mean", seed=1000))), got)


@pytest.mark.parametrize("data_norm", ["mean", "min"])
def test_boundary_ties_are_cut_again_on_the_host(data_norm):
    coord, feat, vmax = grid_room()
    want, got, crops = both(coord, feat, vmax, data_norm)
    assert crops.get("host", 0) > 0
    assert_same_chunks(coord, feat, want, got, data_norm)


@pytest.mark.parametrize("seed", [3, 6])
def test_tied_points_in_another_order_move_the_mean_by_ulps(seed):
    """Rooms on a 2^-12 grid where the order of tied points moves some
    chunk's sequential mean (numpy's and the card's alike)."""
    data = SyntheticRooms("val", n_rooms=1, raw_points=20000, seed=seed).raw(0)
    coord = (np.round(data[:, :3] * 4096) / 4096).astype(np.float32)
    want, got, _ = both(coord, data[:, 3:6], 3000)
    assert assert_same_chunks(coord, data[:, 3:6], want, got) > 0


def test_whole_passes_and_no_crop_limit():
    coord, feat, _ = grid_room()
    for vmax in (0, 100000):  # no pass is cropped
        want, got, crops = both(coord, feat, vmax)
        assert not any(crops.values())
        assert assert_same_chunks(coord, feat, want, got) == 0
        rows = flat(got)[0]
        for k, (idx, _, _) in enumerate(want):
            np.testing.assert_array_equal(idx, rows[k, :len(idx)])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_plain_chunk_mean_is_numpys_mean(dtype):
    rs = np.random.RandomState(4)
    x = (rs.rand(3, 5000, 3) * 9 - 2).astype(dtype)
    valid = torch.tensor([5000, 4096, 17])
    got = chunk_mean(torch.from_numpy(x), valid)
    assert got.dtype == torch.from_numpy(x).dtype
    for b, m in enumerate(valid.tolist()):
        np.testing.assert_array_equal(got[b].numpy(), np.mean(x[b, :m], 0))


def test_padded_size_rounds_up_to_the_bucket():
    assert te.padded_size([1, 4096], 80000) == 4096
    assert te.padded_size([4097, 10], 80000) == 2 * te.BUCKET
    assert te.padded_size([79000], 80000) == 80000
    assert te.padded_size([90000], 0) == 90112
