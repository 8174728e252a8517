"""Triangle-surface geometry: normals, centroids, plane constants, repair
(repsurf_tpu/geometry/surface.py).

As in the JAX package, degenerate (zero-area) triangles produce a zero
normal and an explicit ``degenerate`` mask instead of NaNs;
``repair_invalid_group`` overwrites them with each point's first good fan,
``repair_invalid_points`` with each sample's first good point.
"""

import math

import torch

from ..ops.gather import select_group
from .polar import ieee_div


def cal_normal(group_xyz, random_inv_sign=None, is_group=False):
    """Unit triangle normals, sign-fixed (x > 0) with optional inversion.

    Args:
      group_xyz: [..., 3, 3] triangle vertex coordinates ([B, N, G, 3, 3]
        for the umbrella path with ``is_group=True``).
      random_inv_sign: optional [B] float (+1/-1) per-sample inversion.
      is_group: True when a G fan axis is present; the x > 0 sign fix then
        uses fan 0's normal for all fans of a point.

    Returns:
      (unit_normal [..., 3], degenerate [...] bool).
    """
    a = group_xyz[..., 1, :] - group_xyz[..., 0, :]
    b = group_xyz[..., 2, :] - group_xyz[..., 0, :]
    # cross product written out in jnp.cross's operand order
    nx = a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1]
    ny = a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2]
    nz = a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]
    nor = torch.stack([nx, ny, nz], dim=-1)
    s = (nx * nx + ny * ny + nz * nz)[..., None]
    degenerate = s[..., 0] == 0.0
    norm = torch.sqrt(torch.where(s == 0.0, torch.ones_like(s), s))
    unit = torch.where(s == 0.0, torch.zeros_like(nor), nor / norm)

    ref_x = unit[..., 0:1, 0] if is_group else unit[..., 0]
    sign = torch.where(ref_x > 0, 1.0, -1.0).to(unit.dtype)
    unit = unit * sign[..., None]

    if random_inv_sign is not None:
        extra = unit.ndim - 2  # broadcast [B] over point/fan axes
        unit = unit * random_inv_sign.reshape((-1,) + (1,) * extra + (1,))
    return unit, degenerate


def cal_center(group_xyz):
    """Triangle centroid of (v0, v1, v2), summed left to right then / 3."""
    v = group_xyz
    return ieee_div(v[..., 0, :] + v[..., 1, :] + v[..., 2, :], 3.0)


def cal_const(normal, center, is_normalize=True):
    """Plane constant n.c (normalized by sqrt(3))."""
    n, c = normal, center
    const = (n[..., 0:1] * c[..., 0:1] + n[..., 1:2] * c[..., 1:2]) + n[..., 2:3] * c[..., 2:3]
    return ieee_div(const, math.sqrt(3.0)) if is_normalize else const


def cal_area(group_xyz):
    """Twice the triangle area, as the JAX package computes it: the root of
    the summed squares of the three projected homogeneous determinants.

    Args:
      group_xyz: [..., 3, 3] triangle vertex coordinates.

    Returns:
      [..., 1].
    """
    x, y, z = (group_xyz[..., d] for d in range(3))  # each [..., 3 vertices]

    def det3(a, b):
        # |a b 1| over the three vertices' (a, b) coordinates
        return (a[..., 0] * (b[..., 1] - b[..., 2]) - b[..., 0] * (a[..., 1] - a[..., 2])
                + (a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1]))

    det_xy, det_yz, det_zx = det3(x, y), det3(y, z), det3(z, x)
    return torch.sqrt(det_xy**2 + det_yz**2 + det_zx**2)[..., None]


def pca(x, k, center=True):
    """Principal components of [n, d] points by SVD: a dict with 'x', 'k',
    'components' [d, k] and 'explained_variance' [k].  Each component's
    sign is the SVD's own."""
    n = x.shape[0]
    xc = x - x.mean(dim=0, keepdim=True) if center else x
    _, s, vt = torch.linalg.svd(xc, full_matrices=False)
    return {"x": x, "k": k, "components": vt[:k].T,
            "explained_variance": (s[:k] * s[:k]) / (n - 1)}


def _first_good(bad):
    """Index of the first False along the last axis of ``bad`` (0 when
    every entry is bad)."""
    g = bad.shape[-1]
    pos = torch.arange(g, device=bad.device)
    first_ok = torch.where(~bad, pos, g).amin(dim=-1)
    return torch.where(first_ok == g, 0, first_ok)


def repair_invalid_group(bad, *tensors):
    """Replace bad fans with each point's first good fan.

    For every point, fans flagged ``bad`` are overwritten, jointly across
    all given tensors, by the values of the first non-bad fan (argmax of
    ~bad; fan 0 if all fans are bad).

    Args:
      bad: [B, N, G] bool.
      *tensors: [B, N, G, C].

    Returns:
      tuple of repaired tensors (same order).
    """
    first_ok = _first_good(bad)
    out = []
    for t in tensors:
        repl = select_group(t, first_ok)[:, :, None, :]
        out.append(torch.where(bad[..., None], repl, t))
    return tuple(out)


def repair_invalid_points(bad, *tensors):
    """Replace bad points with each sample's first good point (point 0 when
    every point is bad), jointly across the given tensors.

    Args:
      bad: [B, N] bool.
      *tensors: [B, N, C].

    Returns:
      tuple of repaired tensors (same order).
    """
    first_ok = _first_good(bad)
    out = []
    for t in tensors:
        repl = torch.gather(t, 1, first_ok[:, None, None].expand(-1, 1, t.shape[-1]))
        out.append(torch.where(bad[..., None], repl, t))
    return tuple(out)
