"""Sectorized furthest-point sampling (repsurf_tpu/ops/sector.py).

The JAX package's static-shape form of the reference's azimuth sectors:

  1. sort the points by azimuth ``atan2(x, y)``, padding last (a stable
     sort, as ``jnp.argsort``);
  2. split the sorted ranks into ``num_sectors`` equal-count contiguous
     runs: sector s covers ranks [ceil(s n / S), ceil((s + 1) n / S));
  3. run masked FPS over all B * S sectors at once, each a fixed-size
     buffer of ceil(N / S) rows, for ``npoint // S + npoint % S + S - 1``
     picks (at most the buffer size);
  4. take ``m // S`` picks from each sector, the last sector also the
     remainder, each clipped at its population, and pack them into
     [B, npoint]; rows past the total repeat the first pick.
"""

import math

import torch

from .sampling import farthest_point_sample


def sector_buffers(xyz, num_sectors, valid=None):
    """Steps 1-2 and the buffers of step 3.

    Returns (sector_xyz [B, S, ceil(N / S), 3] azimuth-sorted runs, zero
    past the cloud; counts [B, S] points per sector; starts [B, S] each
    sector's first rank; order [B, N] rank -> original index).
    """
    b, n, _ = xyz.shape
    s = num_sectors
    dev = xyz.device
    ar = torch.arange(n, device=dev)
    valid = torch.full((b,), n, device=dev) if valid is None else valid.to(dev).long()
    count = torch.clamp(valid, min=1)

    # 1. azimuth order, padding last
    angle = torch.atan2(xyz[..., 0], xyz[..., 1])
    angle = torch.where(ar[None, :] < valid[:, None], angle, float("inf"))
    order = torch.sort(angle, dim=-1, stable=True).indices  # rank -> index

    # 2. equal-count runs of ranks (ceil division)
    s_ar = torch.arange(s + 1, device=dev)
    bounds = -((-s_ar[None, :] * count[:, None]) // s)  # [B, S + 1]
    starts = bounds[:, :-1]
    counts = bounds[:, 1:] - starts

    # 3. fixed-size sector buffers of the azimuth-sorted cloud
    n_sec = math.ceil(n / s)
    xyz_sorted = torch.gather(xyz, 1, order[..., None].expand(-1, -1, 3))
    xyz_sorted = torch.cat([xyz_sorted, xyz.new_zeros((b, n_sec, 3))], dim=1)
    rows = (starts[:, :, None] + torch.arange(n_sec, device=dev)).reshape(b, -1)
    sector_xyz = torch.gather(xyz_sorted, 1, rows[..., None].expand(-1, -1, 3))
    return sector_xyz.reshape(b, s, n_sec, 3), counts, starts, order


def sectorized_fps(xyz, npoint, num_sectors, valid=None, m_valid=None):
    """Sector-parallel masked FPS.

    Args:
      xyz: [B, N, 3].
      npoint: samples per cloud (the output width).
      num_sectors: S.
      valid: optional [B] counts of real input points.
      m_valid: optional [B] samples wanted per cloud (<= npoint); npoint
        when None.

    Returns:
      idx [B, npoint] int32 indices into N.
    """
    b, n, _ = xyz.shape
    s = num_sectors
    dev = xyz.device
    m_valid = (torch.full((b,), npoint, device=dev) if m_valid is None
               else m_valid.to(dev).long())
    sector_xyz, counts, starts, order = sector_buffers(xyz, s, valid)
    n_sec = sector_xyz.shape[2]
    m_sec = min(npoint // s + npoint % s + (s - 1), n_sec)
    idx_sec = farthest_point_sample(
        sector_xyz.reshape(b * s, n_sec, 3), m_sec, valid=counts.reshape(b * s),
    ).reshape(b, s, m_sec).long()

    # sector-local index -> sorted rank -> original index
    rank = torch.clamp(starts[:, :, None] + idx_sec, max=n - 1)
    orig = torch.gather(order, 1, rank.reshape(b, -1)).reshape(b, s, m_sec)

    # 4. per-sector take counts and packing
    take = (m_valid // s)[:, None].repeat(1, s)
    take[:, -1] += m_valid % s
    take = torch.minimum(take, counts)
    offs = torch.cumsum(take, dim=1) - take  # exclusive prefix sum
    j_ar = torch.arange(m_sec, device=dev)
    keep = j_ar[None, None, :] < take[:, :, None]
    # dropped picks land in a spare column npoint, cut off below
    pos = torch.where(keep, offs[:, :, None] + j_ar, npoint).reshape(b, -1)
    out = torch.zeros((b, npoint + 1), dtype=torch.long, device=dev)
    out.scatter_(1, pos, orig.reshape(b, -1))
    out = out[:, :npoint]
    total = take.sum(dim=1)
    out = torch.where(torch.arange(npoint, device=dev)[None, :] < total[:, None],
                      out, out[:, :1])
    return out.to(torch.int32)
