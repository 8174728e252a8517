"""The port's whole-scene inference (data/voxelize, train/eval_s3dis,
nn/metrics.iou_from_counts, SyntheticRooms, the checkpoint's partial
restore, cli/test_s3dis) against the JAX package, on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repsurf_torch.cli import test_s3dis as cli
from repsurf_torch.data.synthetic_scene import SyntheticRooms
from repsurf_torch.data.voxelize import voxelize as t_voxelize
from repsurf_torch.models import get_model as t_get_model
from repsurf_torch.nn.metrics import iou_from_counts as t_iou_from_counts
from repsurf_torch.train import eval_s3dis as te
from repsurf_torch.train.checkpoint import restore_weights, train_state_dict
from repsurf_torch.train.jax_params import state_dict_from_flax
from repsurf_torch.train.train_seg import SegConfig, build_model, make_optimizer
from repsurf_tpu.data.synthetic_scene import SyntheticRooms as JSyntheticRooms
from repsurf_tpu.data.voxelize import voxelize as j_voxelize
from repsurf_tpu.models import get_model as j_get_model
from repsurf_tpu.nn.metrics import iou_from_counts as j_iou_from_counts
from repsurf_tpu.train import eval_s3dis as je

from .test_torch_seg import NARROW, _random_variables

torch.set_num_threads(1)

NEAR_TIE = 1e-4  # vote-averaged probability gap: logits agree to 1e-4


def _room(n=3000, seed=3):
    """A raw labeled room shrunk to about 3 m: xyz on a 2^-8 grid, where
    both frameworks' kNN distance forms are exact, rgb, label."""
    data = SyntheticRooms("val", n_rooms=1, raw_points=n, seed=seed).raw(0)
    data[:, :3] = np.round(data[:, :3] * 0.3 * 256) / 256
    return data


@pytest.mark.parametrize("hash_type", ["fnv", "ravel"])
def test_voxelize_both_modes_match_jax(hash_type):
    coord = _room()[:, :3]
    coord = coord - coord.min(0)
    for mode in (0, 1):
        got = t_voxelize(coord, 0.04, hash_type, mode, rng=np.random.RandomState(5))
        want = j_voxelize(coord, 0.04, hash_type, mode, rng=np.random.RandomState(5))
        if mode == 0:
            got, want = (got,), (want,)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_voxel_passes_and_chunks_match_jax():
    data = _room()
    coord, feat = data[:, :3], data[:, 3:6]
    passes = te.voxel_passes(coord, 0.04)
    jpasses = je.voxel_passes(coord, 0.04)
    assert len(passes) == len(jpasses) > 1
    for a, b in zip(passes, jpasses):
        np.testing.assert_array_equal(a, b)
    got = te.chunk_scene(coord, feat, passes, voxel_max=700, seed=9)
    want = je.chunk_scene(coord, feat, jpasses, voxel_max=700, seed=9)
    assert len(got[0]) == len(want[0]) > len(passes)
    for part_a, part_b in zip(got, want):
        for a, b in zip(part_a, part_b):
            np.testing.assert_array_equal(a, b)


def test_host_mode_with_a_shared_forward_matches_jax():
    data = _room()
    w = np.random.RandomState(1).randn(6, 13).astype(np.float32)

    def logits(coord, feat):  # the one numpy forward both packages call
        return np.concatenate([coord, feat], -1) @ w

    got = te.predict_scene(lambda b: torch.from_numpy(logits(b["coord"].numpy(),
                                                             b["feat"].numpy())),
                           data[:, :3], data[:, 3:6], 13, voxel_max=700, accumulate="host")
    want = je.predict_scene(lambda b: logits(b["coord"], b["feat"]), data[:, :3],
                            data[:, 3:6], 13, voxel_max=700, accumulate="host")
    np.testing.assert_array_equal(got, want)
    # the device-buffer mode, here on the CPU: the same votes, summed
    # in another order
    dev = te.scene_votes(lambda b: torch.from_numpy(logits(b["coord"].numpy(),
                                                          b["feat"].numpy())),
                         data[:, :3], data[:, 3:6], 13, voxel_max=700, accumulate="device")
    host = te.scene_votes(lambda b: torch.from_numpy(logits(b["coord"].numpy(),
                                                           b["feat"].numpy())),
                          data[:, :3], data[:, 3:6], 13, voxel_max=700, accumulate="host")
    np.testing.assert_allclose(dev.numpy(), host, rtol=1e-12, atol=0)


def test_median_filter_matches_jax():
    data = _room()
    coord = (data[:, :3] - data[:, :3].min(0)).astype(np.float32)
    labels = np.random.RandomState(2).randint(0, 13, len(coord)).astype(np.int64)
    got = te.median_filter(coord, labels, 32)
    want = je.median_filter(coord, labels, 32)
    assert got.dtype == labels.dtype
    np.testing.assert_array_equal(got, want)


def test_narrow_model_scene_labels_match_jax():
    """predict_scene end to end: the narrow repsurf_umb_ssg on transferred
    weights in both packages, min-normalised chunks of 1,024 points."""
    jm = j_get_model("repsurf.repsurf_umb_ssg", **NARROW)
    variables = _random_variables(jm, 64, 4)
    tm = t_get_model("repsurf.repsurf_umb_ssg", **NARROW)
    tm.load_state_dict(state_dict_from_flax(variables), strict=True)
    tm.eval()
    data = _room(2500)
    coord, feat = data[:, :3], data[:, 3:6]
    kw = dict(voxel_max=1024, batch_size=2, data_norm="min", seed=3)
    jfwd = jax.jit(lambda c, f, v: jm.apply(variables, c, f, v, train=False))
    want = je.predict_scene(lambda b: jfwd(jnp.asarray(b["coord"]), jnp.asarray(b["feat"]),
                                           jnp.asarray(b["valid"])),
                            coord, feat, 13, accumulate="host", **kw)
    with torch.no_grad():
        votes = te.scene_votes(lambda b: tm(b["coord"], b["feat"], b["valid"]), coord, feat,
                               13, accumulate="host", **kw)
    top2 = np.sort(votes, axis=1)[:, -2:]
    near = (top2[:, 1] - top2[:, 0]) < NEAR_TIE
    assert near.mean() <= 1e-2, f"{near.sum()} near-tie points"
    np.testing.assert_array_equal(votes.argmax(1)[~near], want[~near])


def test_iou_and_synthetic_rooms_match_jax():
    rs = np.random.RandomState(6)
    inter = rs.randint(0, 50, 13).astype(np.float32)
    union = inter + rs.randint(0, 50, 13)
    target = inter + rs.randint(0, 50, 13)
    got = t_iou_from_counts(*(torch.from_numpy(x) for x in (inter, union, target)))
    want = j_iou_from_counts(*(jnp.asarray(x) for x in (inter, union, target)))
    for a, b in zip(got, want):
        assert abs(float(a) - float(b)) < 1e-6
    rooms = SyntheticRooms("val", n_rooms=2, raw_points=500, seed=7)
    jrooms = JSyntheticRooms("val", n_rooms=2, raw_points=500, seed=7)
    assert rooms.rooms == jrooms.rooms
    np.testing.assert_array_equal(rooms.raw(1), jrooms._make(1))


def test_cli_restores_weights_and_reports_metrics(tmp_path, capsys):
    cfg = SegConfig()
    trained = build_model(cfg, generator=torch.Generator().manual_seed(11))
    ckpt = tmp_path / "best.pt"
    torch.save(train_state_dict(trained, make_optimizer(trained, cfg), 3, 0.5), ckpt)
    fresh = build_model(cfg, generator=torch.Generator().manual_seed(12))
    restore_weights(fresh, ckpt)
    for k, v in trained.state_dict().items():
        assert torch.equal(v, fresh.state_dict()[k]), k

    argv = ["--synthetic", "--synthetic_rooms", "1", "--synthetic_raw", "2000",
            "--voxel_max", "1024", "--device", "cpu", "--filter", "--visual",
            "--log_root", str(tmp_path / "log"), "--model_path", str(ckpt)]
    miou, macc, allacc = cli.main(argv)
    log = (tmp_path / "log" / "S3DIS" / "default" / "logs" / "test_s3dis.txt").read_text()
    assert "checkpoint restored" in log and "result: mIoU/mAcc/OA" in log
    assert all(0.0 <= x <= 1.0 for x in (miou, macc, allacc))
    visual = tmp_path / "log" / "S3DIS" / "default" / "visual"
    assert sorted(p.name for p in visual.iterdir()) == ["synth_val_0_label.txt",
                                                       "synth_val_0_pred.txt"]
    capsys.readouterr()
