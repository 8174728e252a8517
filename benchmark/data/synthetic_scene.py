"""Surface-sampled synthetic rooms, frozen copies of the program's
``repsurf_torch/data/synthetic_scene.py`` (``synthetic_room``,
``label_room``, the draws of ``SyntheticRooms.raw``), so that a later change
to the program cannot move the benchmark's traffic.  Numpy only.
"""

import numpy as np


def synthetic_room(
    n_points,
    size=(8.0, 8.0, 3.0),
    spacing=0.04,
    n_furniture=6,
    rng=None,
):
    """Surface-sampled room cloud: [n_points, 3] float32.

    Points are drawn uniformly from the room's wall/floor/ceiling planes
    and a few random furniture boxes, snapped to a `spacing` grid with
    +-spacing/2 jitter, then exactly n_points are kept (with replacement
    if the surfaces undersample).
    """
    rng = rng or np.random.RandomState(0)
    sx, sy, sz = size

    planes = [
        # (origin, u-vector, v-vector): floor, ceiling, 4 walls
        ((0, 0, 0), (sx, 0, 0), (0, sy, 0)),
        ((0, 0, sz), (sx, 0, 0), (0, sy, 0)),
        ((0, 0, 0), (sx, 0, 0), (0, 0, sz)),
        ((0, sy, 0), (sx, 0, 0), (0, 0, sz)),
        ((0, 0, 0), (0, sy, 0), (0, 0, sz)),
        ((sx, 0, 0), (0, sy, 0), (0, 0, sz)),
    ]
    for _ in range(n_furniture):
        w, d, h = rng.uniform(0.4, 2.0, 3)
        x0 = rng.uniform(0.2, sx - 2.2)
        y0 = rng.uniform(0.2, sy - 2.2)
        planes.append(((x0, y0, h), (w, 0, 0), (0, d, 0)))  # top
        planes.append(((x0, y0, 0), (w, 0, 0), (0, 0, h)))  # sides
        planes.append(((x0, y0, 0), (0, d, 0), (0, 0, h)))

    areas = np.array(
        [np.linalg.norm(np.cross(u, v)) for _, u, v in planes], np.float64
    )
    weights = areas / areas.sum()
    counts = rng.multinomial(n_points, weights)
    pts = []
    for (o, u, v), c in zip(planes, counts):
        if c == 0:
            continue
        a = rng.rand(c, 1)
        b = rng.rand(c, 1)
        p = np.asarray(o) + a * np.asarray(u) + b * np.asarray(v)
        pts.append(p)
    cloud = np.concatenate(pts, axis=0)
    # snap to the voxel pitch + jitter (the post-voxelization look)
    cloud = np.round(cloud / spacing) * spacing
    cloud += rng.uniform(-spacing / 2, spacing / 2, cloud.shape)
    idx = rng.permutation(len(cloud))[:n_points]
    if len(idx) < n_points:
        extra = rng.randint(0, len(cloud), n_points - len(idx))
        idx = np.concatenate([idx, extra])
    return cloud[idx].astype(np.float32)


# -- labeled synthetic rooms: the no-dataset stand-in for S3DIS ------------

# geometric classes reachable from coordinates alone (S3DIS label ids:
# ceiling 0, floor 1, wall 2, chair 7, table 8) plus RGB base colors so the
# color branch carries signal too
_SYNTH_BASE_RGB = {
    0: (200.0, 200.0, 210.0),
    1: (120.0, 90.0, 60.0),
    2: (180.0, 170.0, 150.0),
    7: (60.0, 60.0, 140.0),
    8: (140.0, 40.0, 40.0),
}


def label_room(coord, size, tol=0.06):
    """Deterministic geometric labeling of a synthetic_room cloud.

    The rule is a function of position only (height bands + boundary
    proximity), so a segmentation model CAN learn it — which is what makes
    SyntheticRooms usable as convergence evidence for the full training
    protocol when the real S3DIS data is unreachable.
    """
    sx, sy, sz = size
    x, y, z = coord[:, 0], coord[:, 1], coord[:, 2]
    label = np.full(len(coord), 7, np.int64)  # default: low furniture
    label[z > 0.9] = 8  # high furniture (table tops / sides)
    wall = (x < tol) | (x > sx - tol) | (y < tol) | (y > sy - tol)
    label[wall] = 2
    label[z < tol] = 1  # floor
    label[z > sz - tol] = 0  # ceiling
    return label


def raw_room(rng, n_points, floor=None):
    """A room as a raw S3DIS room file holds it: (coord [n, 3], rgb [n, 3]
    in 0..255, label [n]), float32, float32, int64; the draws of
    ``SyntheticRooms.raw`` from ``rng``, or, with ``floor`` (x, y) given,
    of that floor size and the rest as there."""
    size = ((rng.uniform(6.0, 10.0), rng.uniform(6.0, 10.0)) if floor is None
            else tuple(floor)) + (3.0,)
    coord = synthetic_room(n_points, size=size, rng=rng)
    label = label_room(coord, size)
    base = np.zeros((len(coord), 3), np.float32)
    for cls, c in _SYNTH_BASE_RGB.items():
        base[label == cls] = c
    rgb = np.clip(base + rng.randn(len(coord), 3) * 25.0, 0.0, 255.0)
    return coord, rgb.astype(np.float32), label
