"""Synthetic scanned objects, a frozen copy of the program's
``repsurf_torch/data/synthetic_object.py`` (``synthetic_object``,
``SyntheticObjects15``): surface scans of parametric primitives with scan
jitter, optional floor or wall clutter, a z-rotation and unit-sphere
normalisation, 2,048 points, 15 shape families standing in for
ScanObjectNN's classes.  Numpy only.
"""

import numpy as np

NUM_CLASS = 15

CLASS_NAMES = (
    "bag", "bin", "box", "bed", "chair", "desk", "display", "door",
    "shelf", "table", "cabinet", "pillow", "sink", "sofa", "toilet",
)


def _sample_quad(rng, origin, u, v, n):
    """n points on the parallelogram origin + a*u + b*v."""
    a = rng.rand(n, 1)
    b = rng.rand(n, 1)
    return np.asarray(origin)[None, :] + a * np.asarray(u) + b * np.asarray(v)


def _box_quads(center, size, top=True, bottom=True):
    cx, cy, cz = center
    sx, sy, sz = size
    o = np.array([cx - sx / 2, cy - sy / 2, cz - sz / 2])
    quads = [
        (o, [sx, 0, 0], [0, 0, sz]),
        (o + [0, sy, 0], [sx, 0, 0], [0, 0, sz]),
        (o, [0, sy, 0], [0, 0, sz]),
        (o + [sx, 0, 0], [0, sy, 0], [0, 0, sz]),
    ]
    if top:
        quads.append((o + [0, 0, sz], [sx, 0, 0], [0, sy, 0]))
    if bottom:
        quads.append((o, [sx, 0, 0], [0, sy, 0]))
    return quads


def _cylinder(rng, center, radius, height, n, axis=2, caps=True):
    theta = rng.rand(n) * 2 * np.pi
    z = rng.rand(n) * height - height / 2
    pts = np.stack(
        [radius * np.cos(theta), radius * np.sin(theta), z], axis=1
    )
    if caps and n > 8:
        m = n // 4
        r = radius * np.sqrt(rng.rand(m))
        t = rng.rand(m) * 2 * np.pi
        cap = np.stack(
            [r * np.cos(t), r * np.sin(t),
             np.where(rng.rand(m) > 0.5, height / 2, -height / 2)],
            axis=1,
        )
        pts = np.concatenate([pts[: n - m], cap])
    if axis != 2:
        pts[:, [axis, 2]] = pts[:, [2, axis]]
    return pts + np.asarray(center)[None, :]


def _sphere(rng, center, radius, n, squash=(1, 1, 1)):
    v = rng.randn(n, 3)
    v /= np.maximum(np.linalg.norm(v, axis=1, keepdims=True), 1e-9)
    return center + v * radius * np.asarray(squash)[None, :]


def _quads_points(rng, quads, n):
    areas = np.array(
        [np.linalg.norm(np.cross(u, v)) for _, u, v in quads], np.float64
    )
    counts = rng.multinomial(n, areas / areas.sum())
    out = [
        _sample_quad(rng, o, u, v, c) for (o, u, v), c in zip(quads, counts)
        if c
    ]
    return np.concatenate(out) if out else np.zeros((0, 3))


def _shape_parts(rng, label):
    """Return (quads, extra_points_fn) composing the class geometry.

    Dimensions are randomized within a family so the class boundary is
    geometric, not template-matching.
    """
    u = rng.uniform
    quads, extra = [], []
    if label == 0:  # bag: squashed open box + handle arc
        quads += _box_quads((0, 0, 0.3), (u(0.5, 0.9), u(0.2, 0.4), 0.6), top=False)
        extra.append(lambda n: _cylinder(rng, (0, 0, 0.75), u(0.15, 0.25), 0.05, n, axis=1, caps=False))
    elif label == 1:  # bin: open cylinder
        extra.append(lambda n: _cylinder(rng, (0, 0, 0.4), u(0.25, 0.4), u(0.6, 0.9), n, caps=False))
    elif label == 2:  # box: closed cuboid
        quads += _box_quads((0, 0, 0.4), (u(0.5, 1.0), u(0.4, 0.9), u(0.4, 0.8)))
    elif label == 3:  # bed: low broad slab + headboard
        quads += _box_quads((0, 0, 0.2), (u(1.2, 1.6), u(0.8, 1.1), u(0.25, 0.4)))
        quads += _box_quads((-u(0.6, 0.8), 0, 0.5), (0.08, u(0.8, 1.1), u(0.5, 0.7)))
    elif label == 4:  # chair: seat + back + 4 legs
        s = u(0.4, 0.55)
        quads += _box_quads((0, 0, 0.45), (s, s, 0.08))
        quads += _box_quads((-s / 2, 0, 0.75), (0.06, s, u(0.5, 0.7)))
        for dx in (-1, 1):
            for dy in (-1, 1):
                quads += _box_quads((dx * s / 2.4, dy * s / 2.4, 0.22), (0.05, 0.05, 0.45), top=False, bottom=False)
    elif label == 5:  # desk: top + two side panels
        w = u(1.0, 1.4)
        quads += _box_quads((0, 0, 0.7), (w, u(0.5, 0.7), 0.06))
        for dx in (-1, 1):
            quads += _box_quads((dx * w / 2.2, 0, 0.35), (0.05, u(0.5, 0.7), 0.7), top=False, bottom=False)
    elif label == 6:  # display: thin upright panel + stand
        quads += _box_quads((0, 0, 0.6), (u(0.7, 1.1), 0.05, u(0.4, 0.7)))
        extra.append(lambda n: _cylinder(rng, (0, 0, 0.2), 0.04, 0.4, n, caps=False))
        quads += _box_quads((0, 0, 0.02), (0.35, 0.25, 0.04))
    elif label == 7:  # door: tall thin slab + knob
        quads += _box_quads((0, 0, 0.9), (u(0.6, 0.9), 0.06, u(1.6, 2.0)))
        extra.append(lambda n: _sphere(rng, np.array([u(0.2, 0.35), 0.08, 0.9]), 0.04, n))
    elif label == 8:  # shelf: open box + 2-3 inner boards
        w, d, h = u(0.8, 1.1), u(0.25, 0.4), u(1.0, 1.4)
        quads += _box_quads((0, 0, h / 2), (w, d, h), top=True, bottom=True)
        for i in range(rng.randint(2, 4)):
            quads.append((np.array([-w / 2, -d / 2, h * (i + 1) / 4]), [w, 0, 0], [0, d, 0]))
    elif label == 9:  # table: top + 4 corner legs (taller/thinner than chair)
        w, d = u(0.9, 1.3), u(0.9, 1.3)
        quads += _box_quads((0, 0, 0.72), (w, d, 0.06))
        for dx in (-1, 1):
            for dy in (-1, 1):
                quads += _box_quads((dx * w / 2.3, dy * d / 2.3, 0.36), (0.06, 0.06, 0.72), top=False, bottom=False)
    elif label == 10:  # cabinet: tall closed cuboid + thin door seam boxes
        quads += _box_quads((0, 0, 0.8), (u(0.7, 1.0), u(0.4, 0.6), u(1.4, 1.8)))
        quads += _box_quads((u(0.1, 0.2), 0.31, 0.8), (0.03, 0.02, 1.2), top=False, bottom=False)
    elif label == 11:  # pillow: squashed ellipsoid
        extra.append(lambda n: _sphere(rng, np.zeros(3), u(0.4, 0.6), n, squash=(1.0, u(0.6, 0.8), u(0.25, 0.4))))
    elif label == 12:  # sink: open box basin + tap cylinder
        quads += _box_quads((0, 0, 0.45), (u(0.5, 0.7), u(0.4, 0.6), 0.25), top=False)
        extra.append(lambda n: _cylinder(rng, (0, -0.2, 0.7), 0.03, 0.3, n, caps=False))
    elif label == 13:  # sofa: seat slab + back + two arm slabs
        w = u(1.2, 1.6)
        quads += _box_quads((0, 0, 0.3), (w, u(0.6, 0.8), 0.35))
        quads += _box_quads((0, -0.35, 0.65), (w, 0.15, 0.5))
        for dx in (-1, 1):
            quads += _box_quads((dx * w / 2.1, 0, 0.5), (0.12, u(0.6, 0.8), 0.4))
    else:  # toilet: bowl cylinder + tank box + seat ring
        extra.append(lambda n: _cylinder(rng, (0, 0, 0.25), u(0.18, 0.25), 0.5, n, caps=True))
        quads += _box_quads((0, -0.3, 0.55), (0.45, 0.18, u(0.3, 0.45)))
        extra.append(lambda n: _cylinder(rng, (0, 0, 0.52), u(0.2, 0.28), 0.04, n, caps=False))
    return quads, extra


def synthetic_object(
    rng, n_points=2048, label=None, jitter=0.01, background_prob=0.5
):
    """One surface-sampled object cloud: ([n_points, 3] float32, label).

    Composition: the class geometry (80-90% of points) plus, with
    ``background_prob``, a floor/wall patch (mimicking PB_T50_RS background
    clutter), scan jitter, a random z-rotation, and unit-sphere
    normalization (the ScanObjectNN convention).
    """
    if label is None:
        label = int(rng.randint(NUM_CLASS))
    quads, extra = _shape_parts(rng, label)

    n_bg = 0
    if rng.rand() < background_prob:
        n_bg = int(n_points * rng.uniform(0.1, 0.25))
    n_obj = n_points - n_bg

    n_extra = int(n_obj * (0.25 if extra else 0.0))
    parts = []
    if quads:
        parts.append(_quads_points(rng, quads, n_obj - n_extra))
    elif extra:
        n_extra = n_obj
    if extra:
        per = np.full(len(extra), n_extra // len(extra))
        per[: n_extra % len(extra)] += 1
        for f, c in zip(extra, per):
            if c:
                parts.append(f(int(c)))
    pts = np.concatenate(parts)
    if len(pts) < n_obj:  # degenerate sampling rounding
        pts = np.concatenate([pts, pts[: n_obj - len(pts)]])
    pts = pts[:n_obj]

    if n_bg:
        # floor patch under the object and/or wall slab behind it
        ext = 1.6
        if rng.rand() < 0.5:
            bg = _sample_quad(rng, [-ext / 2, -ext / 2, 0], [ext, 0, 0], [0, ext, 0], n_bg)
        else:
            bg = _sample_quad(rng, [-ext / 2, 0.5, 0], [ext, 0, 0], [0, 0, ext], n_bg)
        pts = np.concatenate([pts, bg])

    pts = pts + rng.randn(*pts.shape) * jitter
    theta = rng.rand() * 2 * np.pi
    c, s = np.cos(theta), np.sin(theta)
    rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    pts = pts.astype(np.float32) @ rot.T

    # unit-sphere normalization (ScanObjectNN convention)
    pts -= pts.mean(axis=0, keepdims=True)
    pts /= max(np.linalg.norm(pts, axis=1).max(), 1e-9)

    perm = rng.permutation(len(pts))
    return pts[perm].astype(np.float32), label


class SyntheticObjects15:
    """Deterministic procedural 15-class dataset (ScanObjectNN stand-in).

    Same item protocol as ScanObjectNNDataset: returns ([N, 3] float32
    cloud, int label).  Train/test splits use disjoint seed ranges so the
    test set is genuinely held out.
    """

    def __init__(self, split="train", num_point=2048, size=None, seed=0):
        assert split in ("train", "test")
        self.num_point = num_point
        self.size = size if size is not None else (9000 if split == "train" else 2000)
        self._base = seed + (0 if split == "train" else 10_000_000)

    def __len__(self):
        return self.size

    def __getitem__(self, index):
        rng = np.random.RandomState(self._base + index)
        label = index % NUM_CLASS  # balanced classes
        pts, _ = synthetic_object(rng, self.num_point, label=label)
        return pts, label
