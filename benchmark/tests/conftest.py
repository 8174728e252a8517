"""The benchmark's tests.  ``card`` marks a test that needs a CUDA device;
whether there is one is decided inside the ``card`` fixture, never while a
module is imported."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device; skips without one")
    import torch

    # several workers share the cores: one thread each keeps them from
    # oversubscribing them
    torch.set_num_threads(1)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device here: this test runs on the card")
    return torch.device("cuda")


# cells shrunk to what a CPU test can hold (the program's plain path).  At
# these sizes three AdamW / Adam steps amplify rounding far more than at the
# cells' own, so a training cell gets limits of its own here, set as the
# cells' are: 15 seeds of sound tiny runs on the CPU read loss, gradient
# and change gaps of at most 9.3e-3, 2.7e-3, 2.9e-2 (seg) and 4.4e-3,
# 5.3e-5, 3.3e-2 (cls); the control (TF32 products) reads at least 4.1e-3,
# 4.4e-2, 3.7e-2 (seg) and 6.7e-3, 6.4e-2, 4.3e-2 (cls); half of each batch
# at least 1.5e-2, 0.59 (seg) and 4.1e-2, 0.96, 0.30 (cls) on the first two;
# a state left unchanged reads 1.  The gradient's gap separates them.
TINY = {
    "s3dis_seg_train": {"traffic": {"batch": 2, "points": 2048},
                        "cell": {"limits": {"loss_gap": 3e-2, "grad_gap": 1e-2,
                                            "change_gap": 0.1}}},
    "s3dis_scene_infer": {"traffic": {"raw_points": 6000, "room_sizes": [[6.0, 7.0], [8.0, 6.5]],
                                      "check_rooms": 2},
                          "infer": {"voxel_max": 2048, "voxel_size": 0.1}},
    "scanobjectnn_cls_serve": {"traffic": {"batch": 4, "pool": 3, "warmup": 1,
                                           "check_requests": 3}},
    "scanobjectnn_cls_train": {"traffic": {"batch": 4, "pool": 4},
                               "cell": {"limits": {"loss_gap": 1.5e-2, "grad_gap": 1e-3,
                                                   "change_gap": 0.1}}},
}


def tiny(cell):
    import copy

    return copy.deepcopy(TINY[cell])
