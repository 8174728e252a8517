"""Plain PyTorch point-cloud operations of the reference.

Written from RepSurf's published definitions (hancyran/RepSurf
``modules/pointnet2_utils.py``, ``modules/repsurface_utils.py``,
``modules/polar_utils.py``) with the semantics the program states for its
padded batches: ``valid`` [B] counts of real points, rows past them never
chosen.  Nothing here imports the program.

* distances are direct differences, ``dx*dx + dy*dy + dz*dz`` summed left to
  right, each an op of its own (no fused multiply-add);
* FPS starts at index 0 and takes the lowest index of the largest running
  minimum;
* kNN is ascending with the lowest index first on ties; a missing slot
  (fewer than k real points) is index 0 at distance sqrt(1e10);
* a ball takes the first ``nsample`` real points within float32(r**2), in
  index order, a short ball padded with its first hit, an empty one with 0.
"""

import math

import torch

BIG = 1e10


def counts_mask(valid, n):
    """[B] counts -> [B, n] bool, True for a real point."""
    return torch.arange(n, device=valid.device)[None, :] < valid[:, None]


def dist2(q, p):
    """[B, M, 3], [B, N, 3] -> [B, M, N] squared distances."""
    dx = p[:, None, :, 0] - q[:, :, None, 0]
    dy = p[:, None, :, 1] - q[:, :, None, 1]
    dz = p[:, None, :, 2] - q[:, :, None, 2]
    return dx * dx + dy * dy + dz * dz


def gather(points, idx):
    """points [B, N, C], idx [B, M] or [B, M, K] -> [B, M(, K), C]."""
    b, c = points.shape[0], points.shape[-1]
    flat = idx.reshape(b, -1).long()
    return torch.gather(points, 1, flat[..., None].expand(-1, -1, c)).reshape(*idx.shape, c)


def knn(k, xyz, q, valid=None, block_bytes=2**31):
    """k nearest of xyz [B, N, 3] to each query q [B, M, 3] -> (idx [B, M, k]
    int64, dist [B, M, k]).  Queries go in blocks; each block's squared
    distances become int64 keys ``bits(d2) << 32 | index``, unique and
    ordered as (distance, index), so the k smallest keys are exact."""
    b, n, _ = xyz.shape
    m = q.shape[1]
    step = max(1, block_bytes // (8 * b * n))
    col = torch.arange(n, device=xyz.device, dtype=torch.int64)
    ok = None if valid is None else counts_mask(valid, n)
    kk = min(k, n)
    idx_out, d_out = [], []
    for s in range(0, m, step):
        d = dist2(q[:, s:s + step], xyz)
        if ok is not None:
            d = torch.where(ok[:, None, :], d, BIG)
        key = (d.view(torch.int32).to(torch.int64) << 32) | col
        key = torch.topk(key, kk, dim=-1, largest=False, sorted=True).values
        idx_out.append(key & 0xFFFFFFFF)
        d_out.append((key >> 32).to(torch.int32).view(torch.float32))
    idx, d = torch.cat(idx_out, 1), torch.cat(d_out, 1)
    if kk < k:
        pad = (b, m, k - kk)
        idx = torch.cat([idx, idx.new_zeros(pad)], -1)
        d = torch.cat([d, d.new_full(pad, BIG)], -1)
    missing = d >= BIG
    return torch.where(missing, 0, idx), torch.sqrt(torch.clamp(d, max=BIG))


def fps(xyz, m, valid=None):
    """Furthest-point sampling of m points from xyz [B, N, 3] -> [B, m]
    int64.  Past ``valid`` nothing is picked; when m exceeds it, the slots
    past ``valid`` are not defined (callers use the first min(m, valid))."""
    b, n, _ = xyz.shape
    dev = xyz.device
    col = torch.arange(n, device=dev)
    if valid is None:
        dist = torch.full((b, n), BIG, device=dev)
    else:
        dist = torch.where(counts_mask(valid, n), BIG, -1.0).float()
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    rows = torch.arange(b, device=dev)
    far = torch.zeros(b, dtype=torch.long, device=dev)
    out = torch.empty((b, m), dtype=torch.long, device=dev)
    for i in range(m):
        out[:, i] = far
        dx = x - x[rows, far][:, None]
        dy = y - y[rows, far][:, None]
        dz = z - z[rows, far][:, None]
        dist = torch.minimum(dist, dx * dx + dy * dy + dz * dz)
        top = dist.amax(dim=1, keepdim=True)
        far = torch.where(dist == top, col, n).amin(dim=1)
    return out


def sectorized_fps(xyz, m, sectors, valid, m_valid):
    """FPS over azimuth sectors, as the segmentation recipe samples its
    first stage in training (the reference's ``sectorized_fps``, in the
    static-shape form the program defines): the real points sorted by
    ``atan2(x, y)`` (stable), cut into ``sectors`` runs of equal count
    (ceil bounds), FPS of ``m // S + m % S + S - 1`` picks (at most a run's
    buffer) in each run, ``m_valid // S`` taken from each run and the
    remainder from the last, each clipped at the run's count, packed in
    sector order; slots past the total repeat the first pick -> [B, m]."""
    b, n, _ = xyz.shape
    s = sectors
    dev = xyz.device
    count = torch.clamp(valid, min=1)
    angle = torch.atan2(xyz[..., 0], xyz[..., 1])
    angle = torch.where(counts_mask(valid, n), angle, float("inf"))
    order = torch.sort(angle, dim=-1, stable=True).indices
    bounds = -((-torch.arange(s + 1, device=dev)[None, :] * count[:, None]) // s)
    starts, counts = bounds[:, :-1], bounds[:, 1:] - bounds[:, :-1]
    n_sec = math.ceil(n / s)
    srt = torch.cat([gather(xyz, order), xyz.new_zeros((b, n_sec, 3))], 1)
    rows = (starts[:, :, None] + torch.arange(n_sec, device=dev)).reshape(b, -1)
    buf = gather(srt, rows).reshape(b * s, n_sec, 3)
    m_sec = min(m // s + m % s + s - 1, n_sec)
    picks = fps(buf, m_sec, counts.reshape(-1)).reshape(b, s, m_sec)
    orig = torch.gather(order, 1, torch.clamp(starts[:, :, None] + picks, max=n - 1)
                        .reshape(b, -1)).reshape(b, s, m_sec)
    take = (m_valid // s)[:, None].repeat(1, s)
    take[:, -1] += m_valid % s
    take = torch.minimum(take, counts)
    offs = torch.cumsum(take, 1) - take
    j = torch.arange(m_sec, device=dev)
    pos = torch.where(j[None, None] < take[:, :, None], offs[:, :, None] + j, m).reshape(b, -1)
    out = torch.zeros((b, m + 1), dtype=torch.long, device=dev)
    out.scatter_(1, pos, orig.reshape(b, -1))
    out = out[:, :m]
    total = take.sum(1)
    return torch.where(torch.arange(m, device=dev)[None] < total[:, None], out, out[:, :1])


def ball_query(radius, nsample, xyz, q, valid=None):
    """-> [B, M, nsample] int64 (module doc)."""
    n = xyz.shape[1]
    r2 = torch.tensor(float(radius) ** 2, dtype=torch.float32).item()
    within = dist2(q, xyz) <= r2
    if valid is not None:
        within = within & counts_mask(valid, n)[:, None, :]
    order = torch.sort((~within).to(torch.uint8), dim=-1, stable=True).indices
    if n < nsample:
        order = torch.cat([order, order.new_zeros(order.shape[:-1] + (nsample - n,))], -1)
    sel = order[..., :nsample]
    hits = within.sum(-1, keepdim=True)
    slot = torch.arange(nsample, device=xyz.device)
    return torch.where(slot < hits, sel, torch.where(hits > 0, sel[..., :1], 0))


def div(x, c):
    """x / c for a Python float c, an IEEE division (not x * (1 / c))."""
    return x / torch.tensor(c, dtype=x.dtype, device=x.device)


def atan2_safe(y, x):
    return torch.atan2(y, torch.where((x == 0.0) & (y == 0.0), torch.ones_like(x), x))


def azimuth(x, y):
    """atan2(y, x) / (2 pi) + 0.5."""
    return div(atan2_safe(y, x), 2 * math.pi) + 0.5


def sphere(xyz):
    """[..., 3] -> [..., 3] (rho, theta / pi, phi / (2 pi) + 0.5), theta 0
    at the origin, guarded so values and gradients stay finite."""
    x, y, z = xyz[..., 0:1], xyz[..., 1:2], xyz[..., 2:3]
    s = x * x + y * y + z * z
    zero = s == 0.0
    one = torch.ones_like(s)
    rho = torch.where(zero, torch.zeros_like(s), torch.sqrt(torch.where(zero, one, s)))
    u = torch.clamp(z / torch.where(zero, one, rho), -1.0, 1.0)
    pole = torch.abs(u) >= 1.0
    theta = torch.acos(torch.where(pole, torch.zeros_like(u), u))
    theta = torch.where(pole, torch.where(u > 0, 0.0, math.pi).to(u.dtype), theta)
    theta = torch.where(zero, torch.zeros_like(theta), theta)
    return torch.cat([rho, div(theta, math.pi), azimuth(x, y)], -1)


# 45 degrees about y then 45 about z, with the reference's literals, for
# the segmentation umbrella's azimuth sort
ROT = ((0.5, -0.5, 0.7071), (0.7071, 0.7071, 0.0), (-0.5, 0.5, 0.7071))


def umbrella(xyz, k, style, valid=None, sign=None):
    """Umbrella fan features of every point of xyz [B, N, 3] -> [B, N, G, 10]
    (RepSurf ``UmbrellaSurfaceConstructor``'s geometry).  'cls': the k - 1
    neighbours past the point itself, sorted by azimuth, channels [centroid,
    polar(centroid), normal, constant]; 'seg': all k, sorted in the ROT
    frame, channels [polar, normal, constant, centroid].  Normals are unit,
    sign-fixed by fan 0's x, times ``sign`` [B]; degenerate fans take the
    point's first good fan."""
    idx, _ = knn(k, xyz, xyz, valid)
    if style == "cls":
        idx = idx[:, :, 1:]
    rel = gather(xyz, idx) - xyz[:, :, None, :]
    x, y, z = rel.unbind(-1)
    if style == "seg":
        (r00, r01, _), (r10, r11, _), (r20, r21, _) = ROT
        x, y = x * r00 + y * r10 + z * r20, x * r01 + y * r11 + z * r21
    order = torch.argsort(azimuth(x, y), dim=-1, stable=True)
    a = torch.gather(rel, 2, order[..., None].expand(-1, -1, -1, 3))
    bvec = torch.roll(a, -1, dims=2)
    nx = a[..., 1] * bvec[..., 2] - a[..., 2] * bvec[..., 1]
    ny = a[..., 2] * bvec[..., 0] - a[..., 0] * bvec[..., 2]
    nz = a[..., 0] * bvec[..., 1] - a[..., 1] * bvec[..., 0]
    nor = torch.stack([nx, ny, nz], -1)
    s2 = (nx * nx + ny * ny + nz * nz)[..., None]
    bad = s2[..., 0] == 0.0
    unit = torch.where(s2 == 0.0, 0.0, nor / torch.sqrt(torch.where(s2 == 0.0, 1.0, s2)))
    unit = unit * torch.where(unit[:, :, 0:1, 0] > 0, 1.0, -1.0)[..., None]
    if sign is not None:
        unit = unit * sign[:, None, None, None]
    zero = torch.zeros_like(a)
    center = div(zero + a + bvec, 3.0)
    polar = sphere(center)
    const = div((unit[..., 0:1] * center[..., 0:1] + unit[..., 1:2] * center[..., 1:2])
                + unit[..., 2:3] * center[..., 2:3], math.sqrt(3.0))
    g = bad.shape[-1]
    pos = torch.arange(g, device=xyz.device)
    first = torch.where(~bad, pos, g).amin(-1)
    first = torch.where(first == g, 0, first)
    fixed = []
    for t in (unit, center, const):
        rep = torch.gather(t, 2, first[:, :, None, None].expand(-1, -1, 1, t.shape[-1]))
        fixed.append(torch.where(bad[..., None], rep, t))
    unit, center, const = fixed
    if style == "seg":
        return torch.cat([polar, unit, const, center], -1)
    return torch.cat([center, polar, unit, const], -1)


def interpolation(xyz_src, xyz_dst, valid_src, k=3):
    """(idx [B, N, k], weights [B, N, k]) of inverse-distance interpolation
    from the coarse cloud onto the fine one, distance + 1e-8."""
    idx, d = knn(k, xyz_src, xyz_dst, valid_src)
    recip = 1.0 / (d + 1e-8)
    return idx, recip / recip.sum(-1, keepdim=True)
