"""Triangle-surface geometry: normals, centroids, plane constants, repair
(repsurf_tpu/geometry/surface.py).

As in the JAX package, degenerate (zero-area) triangles produce a zero
normal and an explicit ``degenerate`` mask instead of NaNs, and
``repair_invalid_group`` overwrites them with each point's first good fan.
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
    g = bad.shape[-1]
    fan = torch.arange(g, device=bad.device)
    # first index of a good fan; g (-> 0) when every fan is bad
    first_ok = torch.where(~bad, fan, g).amin(dim=-1)
    first_ok = torch.where(first_ok == g, 0, first_ok)
    out = []
    for t in tensors:
        repl = select_group(t, first_ok)[:, :, None, :]
        out.append(torch.where(bad[..., None], repl, t))
    return tuple(out)
