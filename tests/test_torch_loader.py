"""The port's prefetch loader (``repsurf_torch/runtime/loader.py``) against
the JAX package's ``PrefetchLoader`` on the CPU, and the seg CLI's
``--workers``.

Both loaders get the same ``make_batch`` (the seg CLI's padded batches of
small synthetic rooms), seed and epochs.  The port yields the epoch's
batches in order with any number of workers; JAX's yields them in the order
its workers finish, so its 2-worker epoch is compared as a set.  JAX's
in-process path (no workers) seeds the first epoch it serves one batch
late: it builds batch 0 with the base seed to size its slots, then restarts
its count at the second batch, which gets batch 0's seed too.  Its later
epochs, and every epoch with workers, take seed + epoch * 100003 + i, as
the port always does.
"""

import os

import numpy as np
import pytest
import torch

from repsurf_torch.cli.train_seg import PaddedBatches
from repsurf_torch.data.synthetic_scene import SyntheticRooms
from repsurf_torch.models import _REGISTRY, RepSurfSegmentor
from repsurf_torch.runtime import PrefetchLoader
from repsurf_torch.utils import worker_rng
from repsurf_tpu.runtime import PrefetchLoader as JPrefetchLoader
from repsurf_tpu.utils.seed import worker_rng as j_worker_rng

from .test_torch_seg import NARROW

torch.set_num_threads(1)

SEED = 11


def _make_batch():
    rooms = SyntheticRooms("train", n_rooms=3, raw_points=1500, loop=2, voxel_size=0.04,
                           voxel_max=1024, shuffle_index=True, seed=3)
    return PaddedBatches(rooms, 1024, 255), len(rooms)


def _epochs(loader, epochs=(0, 1)):
    """Every batch of the epochs as numpy copies (slots are reused)."""
    out = []
    try:
        for e in epochs:
            out.append([{k: np.array(v) for k, v in b.items()} for b in loader.epoch(e)])
    finally:
        loader.close()
    return out


def _key(batch):
    return batch["coord"].tobytes()


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.fixture(scope="module")
def jax_epochs():
    make, n = _make_batch()
    return {w: _epochs(JPrefetchLoader(make, n, 2, n_workers=w, seed=SEED, name=f"tl{w}"))
            for w in (0, 1, 2)}


@pytest.mark.parametrize("workers", [0, 1, 2])
def test_batches_equal_jax(jax_epochs, workers):
    make, n = _make_batch()
    got = _epochs(PrefetchLoader(make, n, 2, n_workers=workers, seed=SEED))
    for e, batches in enumerate(got):
        assert len(batches) == n // 2
        _assert_batches_equal(batches, jax_epochs[1][e])  # one JAX worker keeps the order
        _assert_batches_equal(sorted(batches, key=_key), sorted(jax_epochs[2][e], key=_key))
    _assert_batches_equal(got[1], jax_epochs[0][1])


def test_jax_in_process_first_epoch_seeds_one_batch_late(jax_epochs):
    make, n = _make_batch()
    order = PrefetchLoader(make, n, 2, n_workers=0, seed=SEED).batches_for_epoch(0)
    late = [SEED] + [SEED + i for i in range(len(order) - 1)]
    _assert_batches_equal(jax_epochs[0][0], [make(idx, s) for idx, s in zip(order, late)])


def test_workers_joined_and_slots_released():
    make, n = _make_batch()
    before = set(os.listdir("/dev/shm"))
    loader = PrefetchLoader(make, n, 2, n_workers=2, n_slots=3, seed=SEED)
    first = next(iter(loader.epoch(0)))  # stopped early: the ring is drained
    assert first["coord"].is_shared()
    procs = list(loader._procs)
    assert len(procs) == 2 and all(p.is_alive() for p in procs)
    again = [np.array(b["coord"]) for b in loader.epoch(0)]
    loader.close()
    assert all(p.exitcode is not None for p in procs) and loader._procs == []
    assert set(os.listdir("/dev/shm")) <= before
    np.testing.assert_array_equal(again[0], make(loader.batches_for_epoch(0)[0],
                                                 loader.batch_seed(0, 0))["coord"])


def test_a_failing_worker_raises_in_the_trainer(tmp_path):
    """A scene file that disappears after the first batch: the worker's
    error is raised in the trainer, with its traceback."""
    from repsurf_torch.data.scannet import ScanNetDataset, synthetic_scan

    for i in range(2):
        np.save(tmp_path / f"scene000{i}_00.npy", synthetic_scan(2000, size=(3.0, 3.0, 2.5),
                                                                 seed=i))
    (tmp_path / "train.txt").write_text("scene0000_00\nscene0001_00\n")
    rooms = ScanNetDataset(str(tmp_path), "train", loop=1, voxel_max=512, cache=False)
    loader = PrefetchLoader(PaddedBatches(rooms, 512, 0), 2, 1, n_workers=1, seed=SEED,
                            shuffle=False)
    try:
        batches = loader.epoch(0)
        next(batches)
        os.remove(tmp_path / "scene0001_00.npy")
        with pytest.raises(RuntimeError, match="scene0001_00.npy"):
            next(batches)
    finally:
        loader.close()


def test_worker_rng_matches_jax():
    np.testing.assert_array_equal(worker_rng(5, 3).rand(4), j_worker_rng(5, 3).rand(4))


def test_cli_losses_do_not_depend_on_the_worker_count(tmp_path, monkeypatch):
    """Two seg CLI micro-runs (narrow model, 4 synthetic rooms, batch 2, 2
    epochs) with --workers 2 and --workers 1: the same batches, so equal
    losses and parameters."""
    from repsurf_torch.cli import train_seg as cli

    monkeypatch.setitem(_REGISTRY, "repsurf.repsurf_umb_ssg",
                        lambda num_class=13, **kw: RepSurfSegmentor(num_class, **kw, **NARROW))
    base = ["--synthetic", "--synthetic_rooms", "4", "--synthetic_raw", "3000", "--voxel_max",
            "1024", "--batch_size", "2", "--loop", "1", "--min_val", "9", "--epoch", "2",
            "--device", "cpu"]
    runs = [cli.main([*base, "--workers", str(w), "--log_root", str(tmp_path / str(w))])
            for w in (2, 1)]
    assert sorted(runs[0].losses) == [1, 2] and runs[0].losses == runs[1].losses
    a, b = (r.model.state_dict() for r in runs)
    assert all(torch.equal(a[k], b[k]) for k in a)
