"""Named configuration presets (repsurf_tpu/config/presets.py), copied, not
imported: importing ``repsurf_tpu.config`` pulls in jax, and the machine
with the card has none.  The reference's shell-script recipes
(classification/scripts/scanobjectnn/*.sh, segmentation/scripts/s3dis/*.sh)
as constructors on the port's ``ClsConfig`` and ``SegConfig``, plus the
per-dataset augmentation constants.
"""

import dataclasses

from ..train.train_cls import ClsConfig
from ..train.train_seg import SegConfig

# segmentation/util/utils.py:125-133
S3DIS_AUG_ARGS = {
    "scale_factor": 0.1,
    "scale_ani": True,
    "scale_prob": 1.0,
    "pert_factor": 0.03,
    "pert_prob": 1.0,
    "rot_prob": 0.5,
    "shifts": [0.1, 0.1, 0.1],
    "shift_prob": 1.0,
}

SCANOBJECTNN_AUG_ARGS = {"scale_factor": 0.5, "shift_factor": 0.3}


def cls_repsurf_ssg_umb(**overrides):
    """scripts/scanobjectnn/repsurf_ssg_umb.sh: batch 64, 250 epochs,
    1024 pts, group 8, sum pool, center+dist+polar, no augmentation."""
    return ClsConfig(
        model="repsurf.repsurf_ssg_umb",
        batch_size=64,
        epoch=250,
        num_point=1024,
        group_size=8,
        umb_pool="sum",
        return_center=True,
        return_dist=True,
        return_polar=True,
        **overrides,
    )


def cls_repsurf_ssg_umb_2x(**overrides):
    return dataclasses.replace(cls_repsurf_ssg_umb(**overrides), model="repsurf.repsurf_ssg_umb_2x")


def seg_repsurf_umb(test_area=5, **overrides):
    """scripts/s3dis/train_repsurf_umb.sh: batch 8 global, AdamW 6e-3,
    wd 1e-2, 100 epochs, decay [60, 80] x0.1, freeze 10, color aug."""
    return SegConfig(
        model="repsurf.repsurf_umb_ssg",
        test_area=test_area,
        batch_size=8,
        batch_size_val=8,
        epoch=100,
        optimizer="AdamW",
        learning_rate=6e-3,
        weight_decay=1e-2,
        lr_decay=0.1,
        lr_decay_epochs=(60, 80),
        min_val=60,
        freeze_epoch=10,
        color_contrast=True,
        color_shift=True,
        color_jitter=True,
        hs_shift=True,
        **overrides,
    )


def seg_pointnet2(test_area=5, **overrides):
    """scripts/s3dis/train_pointnet2.sh (adds aug_scale, no freeze)."""
    return dataclasses.replace(seg_repsurf_umb(test_area=test_area),
                               model="pointnet2.pointnet2_ssg", freeze_epoch=int(1e6),
                               aug_scale=True, **overrides)


def seg_pointtransformer(test_area=5, **overrides):
    return dataclasses.replace(seg_repsurf_umb(test_area=test_area),
                               model="pointtransformer.pointtransformer",
                               freeze_epoch=int(1e6), aug_scale=True, **overrides)


PRESETS = {
    "scanobjectnn/repsurf_ssg_umb": cls_repsurf_ssg_umb,
    "scanobjectnn/repsurf_ssg_umb_2x": cls_repsurf_ssg_umb_2x,
    "s3dis/repsurf_umb": seg_repsurf_umb,
    "s3dis/pointnet2": seg_pointnet2,
    "s3dis/pointtransformer": seg_pointtransformer,
}


def get_preset(name, **overrides):
    return PRESETS[name](**overrides)
