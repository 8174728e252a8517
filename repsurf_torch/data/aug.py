"""Host-side point-cloud augmentations (repsurf_tpu/data/aug.py), numpy only.

A copy, not an import: importing ``repsurf_tpu.data`` pulls in jax, and the
machine with the card has none.  The coordinate transforms (rotate,
perturb, scale, shift, flip, jitter) and the chromatic ones (auto-contrast,
translation, jitter, hue-saturation, drop) of
segmentation/modules/aug_utils.py:9-319, composed from the reference CLI's
flags.  Each transform draws only from the ``rng`` it is handed, in the
JAX package's order, so the same ``RandomState`` gives the same arrays.
"""

import numpy as np


class Compose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, coord, feat, label, rng=None):
        rng = rng or np.random
        for t in self.transforms:
            coord, feat, label = t(coord, feat, label, rng)
        return coord, feat, label

    def __len__(self):
        return len(self.transforms)


def _rot_xyz(angle_x, angle_y, angle_z):
    cx, sx = np.cos(angle_x), np.sin(angle_x)
    cy, sy = np.cos(angle_y), np.sin(angle_y)
    cz, sz = np.cos(angle_z), np.sin(angle_z)
    rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return rz @ ry @ rx


class RandomRotate:
    def __init__(self, rot=(np.pi / 24, np.pi / 24, np.pi / 4), prob=1.0):
        self.rot, self.prob = rot, prob

    def __call__(self, coord, feat, label, rng):
        if rng.rand() < self.prob:
            r = _rot_xyz(
                rng.uniform(-self.rot[0], self.rot[0]),
                rng.uniform(-self.rot[1], self.rot[1]),
                rng.uniform(-self.rot[2], self.rot[2]),
            )
            coord = coord @ r.T
        return coord, feat, label


class RandomRotateAligned:
    def __init__(self, rot=np.pi, prob=1.0):
        self.rot, self.prob = rot, prob

    def __call__(self, coord, feat, label, rng):
        if rng.rand() < self.prob:
            a = rng.uniform(-self.rot, self.rot)
            c, s = np.cos(a), np.sin(a)
            r = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
            coord = coord @ r
        return coord, feat, label


class RandomRotatePerturb:
    def __init__(self, sigma=0.03, clip=0.09, prob=1.0):
        self.sigma, self.clip, self.prob = sigma, clip, prob

    def __call__(self, coord, feat, label, rng):
        if rng.rand() < self.prob:
            ang = np.clip(rng.normal(size=3) * self.sigma, -self.clip, self.clip)
            coord = coord @ _rot_xyz(*ang).T
        return coord, feat, label


class RandomRotatePerturbAligned:
    def __init__(self, sigma=0.03, clip=0.09, prob=1.0):
        self.sigma, self.clip, self.prob = sigma, clip, prob

    def __call__(self, coord, feat, label, rng):
        if rng.rand() < self.prob:
            a = np.clip(rng.normal() * self.sigma, -self.clip, self.clip)
            c, s = np.cos(a), np.sin(a)
            coord = coord @ np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
        return coord, feat, label


class RandomScale:
    def __init__(self, scale=0.1, anisotropic=False, prob=1.0):
        self.scale, self.anisotropic, self.prob = scale, anisotropic, prob

    def __call__(self, coord, feat, label, rng):
        if rng.rand() < self.prob:
            s = rng.uniform(
                1 - self.scale, 1 + self.scale, 3 if self.anisotropic else 1
            )
            coord = coord * s
        return coord, feat, label


class RandomShift:
    def __init__(self, shift=(0.2, 0.2, 0), prob=0.95):
        self.shift, self.prob = shift, prob

    def __call__(self, coord, feat, label, rng):
        if rng.rand() < self.prob:
            coord = coord + [
                rng.uniform(-self.shift[0], self.shift[0]),
                rng.uniform(-self.shift[1], self.shift[1]),
                rng.uniform(-self.shift[2], self.shift[2]),
            ]
        return coord, feat, label


class RandomFlip:
    def __init__(self, prob=1.0):
        self.prob = prob

    def __call__(self, coord, feat, label, rng):
        if rng.rand() < self.prob:
            coord = coord.copy()
            if rng.rand() < 0.5:
                coord[:, 0] = -coord[:, 0]
            if rng.rand() < 0.5:
                coord[:, 1] = -coord[:, 1]
        return coord, feat, label


class RandomJitter:
    def __init__(self, sigma=0.01, clip=0.05, prob=1.0, is_lidar=False):
        self.sigma, self.clip, self.prob, self.is_lidar = sigma, clip, prob, is_lidar

    def __call__(self, coord, feat, label, rng):
        if rng.rand() < self.prob:
            jitter = np.clip(
                self.sigma * rng.randn(coord.shape[0], 3), -self.clip, self.clip
            )
            if self.is_lidar:
                jitter[:, 2] *= 0.1
            coord = coord + jitter
        return coord, feat, label


class ChromaticAutoContrast:
    def __init__(self, prob=0.2, blend_factor=None):
        self.prob, self.blend_factor = prob, blend_factor

    def __call__(self, coord, feat, label, rng):
        if rng.rand() < self.prob:
            feat = feat.copy()
            lo = np.min(feat, 0, keepdims=True)
            hi = np.max(feat, 0, keepdims=True)
            scale = 255 / np.maximum(hi - lo, 1e-12)
            contrast = (feat[:, :3] - lo) * scale
            blend = rng.rand() if self.blend_factor is None else self.blend_factor
            feat[:, :3] = (1 - blend) * feat[:, :3] + blend * contrast
        return coord, feat, label


class ChromaticTranslation:
    def __init__(self, prob=0.95, ratio=0.05):
        self.prob, self.ratio = prob, ratio

    def __call__(self, coord, feat, label, rng):
        if rng.rand() < self.prob:
            tr = (rng.rand(1, feat.shape[1]) - 0.5) * 255 * 2 * self.ratio
            feat = feat.copy()
            feat[:, :3] = np.clip(tr[:, :3] + feat[:, :3], 0, 255)
        return coord, feat, label


class ChromaticJitter:
    def __init__(self, prob=0.95, std=0.005):
        self.prob, self.std = prob, std

    def __call__(self, coord, feat, label, rng):
        if rng.rand() < self.prob:
            noise = rng.randn(*feat.shape) * self.std * 255
            feat = feat.copy()
            feat[:, :3] = np.clip(noise[:, :3] + feat[:, :3], 0, 255)
        return coord, feat, label


class HueSaturationTranslation:
    """HSV-space hue/saturation shift with the reference's own RGB<->HSV
    conversion (aug_utils.py:244-309)."""

    @staticmethod
    def rgb_to_hsv(rgb):
        rgb = rgb.astype("float")
        hsv = np.zeros_like(rgb)
        hsv[..., 3:] = rgb[..., 3:]
        r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
        maxc = np.max(rgb[..., :3], axis=-1)
        minc = np.min(rgb[..., :3], axis=-1)
        hsv[..., 2] = maxc
        mask = maxc != minc
        denom = np.where(mask, maxc - minc, 1.0)
        hsv[mask, 1] = (maxc - minc)[mask] / np.maximum(maxc[mask], 1e-12)
        rc = np.where(mask, (maxc - r) / denom, 0.0)
        gc = np.where(mask, (maxc - g) / denom, 0.0)
        bc = np.where(mask, (maxc - b) / denom, 0.0)
        hsv[..., 0] = np.select(
            [r == maxc, g == maxc], [bc - gc, 2.0 + rc - bc], default=4.0 + gc - rc
        )
        hsv[..., 0] = (hsv[..., 0] / 6.0) % 1.0
        return hsv

    @staticmethod
    def hsv_to_rgb(hsv):
        rgb = np.empty_like(hsv)
        rgb[..., 3:] = hsv[..., 3:]
        h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
        i = (h * 6.0).astype("uint8")
        f = (h * 6.0) - i
        p = v * (1.0 - s)
        q = v * (1.0 - s * f)
        t = v * (1.0 - s * (1.0 - f))
        i = i % 6
        conds = [s == 0.0, i == 1, i == 2, i == 3, i == 4, i == 5]
        rgb[..., 0] = np.select(conds, [v, q, p, p, t, v], default=v)
        rgb[..., 1] = np.select(conds, [v, v, v, q, p, p], default=t)
        rgb[..., 2] = np.select(conds, [v, p, t, v, v, q], default=p)
        return rgb.astype("uint8")

    def __init__(self, hue_max=0.5, saturation_max=0.2, prob=1.0):
        self.hue_max, self.saturation_max, self.prob = hue_max, saturation_max, prob

    def __call__(self, coord, feat, label, rng):
        if rng.rand() < self.prob:
            feat = feat.copy()
            hsv = self.rgb_to_hsv(feat[:, :3])
            hue_val = (rng.rand() - 0.5) * 2 * self.hue_max
            sat_ratio = 1 + (rng.rand() - 0.5) * 2 * self.saturation_max
            hsv[..., 0] = np.remainder(hue_val + hsv[..., 0] + 1, 1)
            hsv[..., 1] = np.clip(sat_ratio * hsv[..., 1], 0, 1)
            feat[:, :3] = np.clip(self.hsv_to_rgb(hsv), 0, 255)
        return coord, feat, label


class RandomDropColor:
    def __init__(self, prob=0.2):
        self.prob = prob

    def __call__(self, coord, feat, label, rng):
        if rng.rand() < self.prob:
            feat = feat.copy()
            feat[:, :3] = 0
        return coord, feat, label


def coord_transform_from_flags(cfg, aug_args):
    """Build the coordinate Compose from config flags (mirrors
    transform_point_cloud_coord, aug_utils.py:9-35)."""
    ts = []
    if cfg.aug_scale:
        ts.append(
            RandomScale(
                aug_args["scale_factor"], aug_args["scale_ani"], aug_args["scale_prob"]
            )
        )
    if cfg.aug_rotate:
        if cfg.aug_rotate == "pert":
            ts.append(
                RandomRotatePerturb(
                    aug_args["pert_factor"],
                    3 * aug_args["pert_factor"],
                    aug_args["pert_prob"],
                )
            )
        elif cfg.aug_rotate == "pert_z":
            ts.append(
                RandomRotatePerturbAligned(
                    aug_args["pert_factor"],
                    3 * aug_args["pert_factor"],
                    aug_args["pert_prob"],
                )
            )
        elif cfg.aug_rotate == "rot":
            ts.append(RandomRotate(prob=aug_args["rot_prob"]))
        elif cfg.aug_rotate == "rot_z":
            ts.append(RandomRotateAligned(prob=aug_args["rot_prob"]))
    if cfg.aug_jitter:
        ts.append(
            RandomJitter(
                aug_args["jitter_factor"],
                5 * aug_args["jitter_factor"],
                aug_args["jitter_prob"],
            )
        )
    if cfg.aug_flip:
        ts.append(RandomFlip())
    if cfg.aug_shift:
        ts.append(RandomShift(aug_args["shifts"], aug_args["shift_prob"]))
    return Compose(ts) if ts else None


def rgb_transform_from_flags(cfg):
    """Chromatic Compose (mirrors transform_point_cloud_rgb)."""
    ts = []
    if cfg.color_contrast:
        ts.append(ChromaticAutoContrast())
    if cfg.color_shift:
        ts.append(ChromaticTranslation())
    if cfg.color_jitter:
        ts.append(ChromaticJitter())
    if cfg.hs_shift:
        ts.append(HueSaturationTranslation())
    if cfg.color_drop:
        ts.append(RandomDropColor())
    return Compose(ts) if ts else None
