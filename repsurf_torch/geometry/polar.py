"""Coordinate transforms (repsurf_tpu/geometry/polar.py).

The degenerate inputs are guarded with ``torch.where`` on safe inputs
(sqrt at 0, acos at +-1, atan2 at the origin), as the JAX version does, so
values and gradients stay finite there.

The normalising divisions divide by 0-dim tensors on the data's device, not
by Python floats: on CUDA PyTorch turns ``x / c`` for a Python float into
``x * (1 / c)``, which can differ from the IEEE division of the JAX package
and of the CUDA kernels by an ulp.  The divisor is filled on the device
(``new_full``): a ``torch.tensor`` there would be a blocking copy from the
host, which drains the launch queue and cannot be captured in a CUDA graph.
"""

import math

import torch


def ieee_div(x, c):
    """x / c for a Python float c, as an IEEE division on every device."""
    return x / x.new_full((), c)


def xyz2sphere(xyz, normalize=True):
    """XYZ -> (rho, theta, phi).

    theta in [0, pi] (angle from +z), phi in [-pi, pi]; when ``normalize``,
    theta -> theta/pi in [0, 1] and phi -> phi/(2 pi) + 0.5 in [0, 1].
    rho == 0 yields theta = 0.

    Args:
      xyz: [..., 3].
    Returns:
      [..., 3] spherical coordinates.
    """
    x, y, z = xyz[..., 0:1], xyz[..., 1:2], xyz[..., 2:3]
    # the three squares summed left to right, as the CUDA kernels do
    s = x * x + y * y + z * z
    zero = s == 0.0
    one = torch.ones_like(s)
    rho = torch.where(zero, torch.zeros_like(s), torch.sqrt(torch.where(zero, one, s)))
    u = torch.clamp(z / torch.where(zero, one, rho), -1.0, 1.0)
    at_pole = torch.abs(u) >= 1.0
    theta = torch.acos(torch.where(at_pole, torch.zeros_like(u), u))
    pole_theta = torch.where(u > 0, torch.zeros_like(u), torch.full_like(u, math.pi))
    theta = torch.where(at_pole, pole_theta, theta)
    theta = torch.where(zero, torch.zeros_like(theta), theta)  # 0 at rho == 0
    if normalize:
        return torch.cat([rho, ieee_div(theta, math.pi), azimuth(x, y)], dim=-1)
    return torch.cat([rho, theta, _atan2(y, x)], dim=-1)


def _atan2(y, x):
    """atan2 with atan2(0, 1) at the origin."""
    return torch.atan2(y, torch.where((x == 0.0) & (y == 0.0), torch.ones_like(x), x))


def azimuth(x, y):
    """xyz2sphere's normalised phi, atan2(y, x) / (2 pi) + 0.5."""
    return ieee_div(_atan2(y, x), 2 * math.pi) + 0.5


def xyz2cylind(xyz, normalize=True):
    """XYZ -> (rho_xy clipped to [0, 1], phi, z clipped to [-1, 1]); when
    ``normalize``, phi -> phi/(2 pi) + 0.5 and z -> (z + 1)/2, both in
    [0, 1].  As in the JAX package, no guard at the axis."""
    x, y, z = xyz[..., 0:1], xyz[..., 1:2], xyz[..., 2:3]
    rho = torch.clamp(torch.sqrt(x * x + y * y), 0.0, 1.0)
    phi = torch.atan2(y, x)
    z = torch.clamp(z, -1.0, 1.0)
    if normalize:
        phi = ieee_div(phi, 2 * math.pi) + 0.5
        z = (z + 1.0) / 2.0
    return torch.cat([rho, phi, z], dim=-1)
