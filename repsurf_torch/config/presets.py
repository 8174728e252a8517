"""Named configuration constants (repsurf_tpu/config/presets.py), copied,
not imported: importing ``repsurf_tpu.config`` pulls in jax, and the
machine with the card has none.  The recipe constructors wait for the
baselines and ScanNet."""

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
