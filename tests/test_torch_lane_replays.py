"""The umbrella tq kernel's lane split and the ball-feature kernel's
output mapping, replayed step by step on the CPU and held to the plain
versions (and, at one shape each, to the JAX package's Pallas kernels in
interpret mode).

The replays follow csrc/umbrella.cu (umbrella_tq_kernel, lane_fan_features)
and csrc/ball_group.cu (ball_body), which run only on the card:

  * umbrella: each of L = 4 lanes scans every L-th candidate into its own
    k-best list, 32 candidates at a time screened against an upper bound on
    the query's k-th distance and the marked ones inserted in index order;
    the group merges the lists in k rounds of an arg-min over the lanes'
    heads; lane s then takes the neighbours and fans g = s (mod L): the
    azimuths and the sorted neighbours meet in a shared row, the
    sign comes from fan 0's lane, the first good fan is the minimum over
    the lanes of each lane's lowest non-degenerate fan, a degenerate fan
    takes it, rebuilt from the row.  The per-fan arithmetic is the kernel's
    (make_fan, put_fan), in torch's float32 ops, and the result must equal
    the plain composition bit for bit.
  * ball feature and row grouping (ball_feature_kernel, ball_group_kernel,
    one body): blocks of 8 queries of one sample, the sample's valid
    points staged 2,048 at a time, the selection four ballots of 32
    candidates a step (staged_select); the feature kernel's pos written 32
    slots at a time through a stage offset by the span's alignment; the
    grouped channels walked by each lane four elements at a time with its
    (slot, channel) stepped by 128 elements with a carry (walk_span: the
    feature kernel's channels 3.., every channel for the row grouping, its
    selection written as a span of S ints); each span as a scalar head,
    16-byte-aligned float4s and a scalar tail.  Every output element must
    be written once.

Coordinates lie on a 2^-10 grid, so every squared distance and cross
product is exact and ties are common.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repsurf_torch.geometry.polar import ieee_div
from repsurf_torch.geometry.umbrella import azimuth_near_ties, fan_azimuth
from repsurf_torch.ops.gather import index_points
from repsurf_torch.ops.kernels.ball_group import (
    ball_group_channels,
    ball_group_channels_plain,
    ball_group_feature_plain,
    ball_group_feature_selection,
)
from repsurf_torch.ops.kernels.knn import pairwise_dist2
from repsurf_torch.ops.kernels.umbrella import (
    fan_shape,
    umbrella_fan_features_plain,
    umbrella_features_kernel,
)
from repsurf_torch.ops.neighbors import ball_query
from repsurf_tpu.ops.pallas.ball_group import ball_group_feature_pallas, ball_group_pallas
from repsurf_tpu.ops.pallas.umbrella import umbrella_features_pallas

torch.set_num_threads(1)

BIG = np.float32(1e10)
SENTINEL = (0x7F800000 << 32) | 0x7FFFFFFF  # an empty list slot, (inf, INT_MAX)
UMB_ATOL = 1e-5  # the Pallas atan2/acos are ~2 ulp (as tests/test_torch_umbrella.py)
NEAR_TIE = 1e-6
POS_ATOL = 1e-6  # pos: numpy's and torch's acos / atan2 differ by an ulp


def _grid(seed, shape):
    rs = np.random.RandomState(seed)
    return (np.round((rs.rand(*shape) * 2 - 1) * 1024) / 1024).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _umbrella_cloud():
    """Three samples of 160 points: distinct grid points; every point twice
    (zero-length neighbours, so degenerate fans, and tied distances); 4
    valid points, fewer than k (missing kNN slots take point 0)."""
    xyz = _grid(70, (3, 160, 3))
    xyz[1, 80:] = xyz[1, :80]
    return xyz, np.array([160, 160, 4], np.int32)


# --- the umbrella tq kernel --------------------------------------------------


TQ_TILE = 512  # the candidates of a shared tile (kTile), tq and full alike
TQ_LANES = 4  # umbrella_tq_kernel's lanes per query (kTqLanes)
TQ_QUERIES = 32  # its queries per block (kTqQueries)
FULL_LANES = 32  # umbrella_full_kernel: a warp per query
FULL_WARPS = 8  # its queries (warps) per block (kFullWarps)


def _scan_lists(xyz, valid, lanes, kmax, tile=TQ_TILE):
    """The kernels' screened scan (screened_scan): lane s of a query's group
    takes candidates j = s (mod L) of each tile; per chunk of U = min(32,
    tile / L) of them, those within the group's least k-th distance (min
    over the lanes' list ends, taken at the chunk's start) are marked, then
    each marked one enters the lane's list (insert_in_order) if it beats the
    lane's current k-th, in index order.  Returns the lists as int64 keys
    bits(d^2) << 32 | index, a sentinel column appended: [B, N, L, kmax + 1]."""
    x = _t(xyz)
    b, n, _ = x.shape
    d2all = pairwise_dist2(x, x)
    nv = _t(valid).long()[:, None, None]
    dl = torch.full((b, n, lanes, kmax), math.inf)
    il = torch.full((b, n, lanes, kmax), 0x7FFFFFFF, dtype=torch.long)
    sub = torch.arange(lanes)
    chunk_len = min(32, tile // lanes)
    for base in range(0, n, tile):
        length = min(tile, n - base)
        for t0 in range(0, length, chunk_len * lanes):
            w = dl[..., -1].amin(-1, keepdim=True)  # the group's least k-th
            chunk = []
            for u in range(chunk_len):
                t = t0 + sub + u * lanes
                j = base + torch.clamp(t, max=length - 1)
                d2 = torch.where(j[None, None, :] < nv, d2all[..., j], torch.tensor(BIG))
                chunk.append((d2, j, (t < length)[None, None, :] & (d2 <= w)))
            for d2, j, marked in chunk:  # index order
                enter = marked & (d2 < dl[..., -1])
                lt = d2[..., None] < dl
                prev = torch.cat([torch.zeros_like(lt[..., :1]), lt[..., :-1]], -1)
                new_d = torch.where(prev, torch.cat([dl[..., :1], dl[..., :-1]], -1),
                                    torch.where(lt, d2[..., None], dl))
                new_i = torch.where(prev, torch.cat([il[..., :1], il[..., :-1]], -1),
                                    torch.where(lt, j.expand_as(d2)[..., None], il))
                dl = torch.where(enter[..., None], new_d, dl)
                il = torch.where(enter[..., None], new_i, il)
    keys = (dl.view(torch.int32).to(torch.int64) << 32) | il
    return torch.cat([keys, keys.new_full(keys.shape[:-1] + (1,), SENTINEL)], dim=-1)


def _merge(lists, k):
    """merge_lanes: k rounds of the arg-min over the lanes' heads; every lane
    whose head is the winner pops it.  [B, N, k] keys."""
    heads = torch.zeros(lists.shape[:-1], dtype=torch.long)
    won = []
    for _ in range(k):
        cand = torch.gather(lists, -1, heads[..., None])[..., 0]
        win = cand.amin(dim=-1)
        won.append(win)
        heads = torch.clamp(heads + (cand == win[..., None]), max=lists.shape[-1] - 1)
    return torch.stack(won, dim=-1)


def _make_fan(a, b, sign):
    """The kernel's make_fan on [..., 3] tensors: (centroid, signed unit
    normal, plane constant, degenerate), op by op."""
    ax, ay, az = a.unbind(-1)
    bx, by, bz = b.unbind(-1)
    nx, ny, nz = ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx
    s2 = nx * nx + ny * ny + nz * nz
    deg = s2 == 0.0
    norm = torch.sqrt(torch.where(deg, torch.ones_like(s2), s2))
    u = [torch.where(deg, torch.zeros_like(v), v / norm) * sign for v in (nx, ny, nz)]
    c = [ieee_div(p + q, 3.0) for p, q in ((ax, bx), (ay, by), (az, bz))]
    pv = ieee_div(u[0] * c[0] + u[1] * c[1] + u[2] * c[2], math.sqrt(3.0))
    return torch.stack(c, -1), torch.stack(u, -1), pv, deg


def _put_fan(c_own, rep, style, return_dist):
    """The kernel's put_fan: the polar channels from the fan's own centroid,
    center, normal and constant from ``rep`` = (center, normal, const)."""
    cx, cy, cz = c_own.unbind(-1)
    s2 = cx * cx + cy * cy + cz * cz
    zero = s2 == 0.0
    rho = torch.where(zero, torch.zeros_like(s2), torch.sqrt(torch.where(zero, 1.0, s2)))
    u = torch.clamp(cz / torch.where(zero, torch.ones_like(rho), rho), -1.0, 1.0)
    pole = torch.where(u > 0.0, 0.0, math.pi).to(u.dtype)
    th = torch.where(u.abs() >= 1.0, pole, torch.acos(torch.where(u.abs() >= 1.0, 0.0, u)))
    xy0 = (cx == 0.0) & (cy == 0.0)
    phi = ieee_div(torch.atan2(cy, torch.where(xy0, 1.0, cx)), 2 * math.pi) + 0.5
    polar = torch.stack([rho, ieee_div(torch.where(zero, 0.0, th), math.pi), phi], -1)
    center, normal, pv = rep
    if not return_dist:
        return torch.cat([center, polar, normal], -1)
    if style == "seg":
        return torch.cat([polar, normal, pv[..., None], center], -1)
    return torch.cat([center, polar, normal, pv[..., None]], -1)


def _kmax(k):
    return 9 if k <= 9 else 17


def _lane_epilogue(xyz, keys, style, return_dist, lanes):
    """lane_fan_features<L> over each query's merged list ``keys`` [B, N, k]:
    [B, N, G, C]."""
    drop_self = style == "cls"
    g_fans, _ = fan_shape(keys.shape[-1], drop_self, return_dist)
    d2 = (keys >> 32).to(torch.int32).view(torch.float32)
    nb = torch.where(d2 >= BIG, 0, keys & 0xFFFFFFFF)[..., int(drop_self):]  # the row, [B, N, G]
    x = _t(xyz)
    rel = index_points(x, nb) - x[:, :, None, :]
    own = [list(range(s, g_fans, lanes)) for s in range(lanes)]  # lane s's neighbours and fans
    # azimuths into the shared row, by lanes
    phi = torch.zeros(rel.shape[:-1])
    for fans in own:
        for g in fans:
            phi[..., g] = fan_azimuth(rel[..., g, :], rotate=style == "seg")
    # each lane ranks its own neighbours against the row, then places them
    row = torch.zeros_like(rel)
    j = torch.arange(g_fans)
    for fans in own:
        for g in fans:
            p = phi[..., g:g + 1]
            rank = ((phi < p) | ((phi == p) & (j < g))).sum(-1)
            row.scatter_(2, rank[..., None, None].expand(-1, -1, 1, 3), rel[..., g:g + 1, :])

    def fan_ends(g):
        return row[..., g, :], row[..., (g + 1) % g_fans, :]

    # the sign from fan 0 (lane 0); each lane's lowest good fan, the group's minimum
    sign = torch.where(_make_fan(*fan_ends(0), 1.0)[1][..., 0] > 0.0, 1.0, -1.0)
    first = torch.full(sign.shape, g_fans)
    for fans in own:
        mine = torch.full(sign.shape, g_fans)
        for g in reversed(fans):
            mine = torch.where(_make_fan(*fan_ends(g), 1.0)[3], mine, g)
        first = torch.minimum(first, mine)
    rg = torch.where(first == g_fans, 0, first)
    a_rep = torch.gather(row, 2, rg[..., None, None].expand(-1, -1, 1, 3))[..., 0, :]
    b_rep = torch.gather(row, 2, ((rg + 1) % g_fans)[..., None, None].expand(-1, -1, 1, 3))
    c_rep, u_rep, pv_rep, _ = _make_fan(a_rep, b_rep[..., 0, :], sign)
    out = [None] * g_fans
    for fans in own:
        for g in fans:
            c, u, pv, deg = _make_fan(*fan_ends(g), sign)
            pick = deg[..., None]
            rep = (torch.where(pick, c_rep, c), torch.where(pick, u_rep, u),
                   torch.where(deg, pv_rep, pv))
            out[g] = _put_fan(c, rep, style, return_dist)
    return torch.stack(out, dim=2)


def _block_spans(feat, queries):
    """group_block's stores: each block's queries, one contiguous span of
    the output, staged at the span's 16-byte phase (a stage of
    span_floats(Q) floats) and written by store_span; every element once.
    [B, N, G, C] back."""
    b, n, g, c = feat.shape
    gc = g * c
    vals = feat.numpy().reshape(b, n * gc)
    flat = np.full(b * n * gc, np.nan, np.float32)
    written = np.zeros(flat.size, np.int64)
    for bi in range(b):
        for q0 in range(0, n, queries):
            off = (bi * n + q0) * gc  # the output's base is 16-byte aligned
            total = min(queries, n - q0) * gc
            stage = np.full((queries * gc + 6) & ~3, np.nan, np.float32)
            stage[off % 4:off % 4 + total] = vals[bi, q0 * gc:q0 * gc + total]
            _store_span(flat, off, stage, off % 4, total, written)
    assert (written == 1).all(), "an output element written other than once"
    return torch.from_numpy(flat.reshape(b, n, g, c))


def _replay_group(xyz, valid, k, style, return_dist, lanes, queries):
    """group_block<L, Q, KMAX> on the CPU (tq: L = 4, Q = 32; full: L = 32,
    Q = kFullWarps): [B, N, G, C]."""
    keys = _merge(_scan_lists(xyz, valid, lanes, _kmax(k)), k)
    return _block_spans(_lane_epilogue(xyz, keys, style, return_dist, lanes), queries)


def _replay_tq(xyz, valid, k, style, return_dist):
    """umbrella_tq_kernel<KMAX> on the CPU: [B, N, G, C]."""
    return _replay_group(xyz, valid, k, style, return_dist, TQ_LANES, TQ_QUERIES)


# G = 2 and 3: lanes without a fan; G = 4: a fan a lane; G > 4: several
STYLE_K = [(3, "cls"), (3, "seg"), (5, "cls"), (5, "seg"), (9, "cls"), (9, "seg"), (17, "cls"),
           (16, "seg")]


@pytest.mark.parametrize("return_dist", [True, False])
@pytest.mark.parametrize("k,style", STYLE_K)
def test_tq_lane_replay_is_bit_equal_to_the_plain_composition(k, style, return_dist):
    xyz, valid = _umbrella_cloud()
    args = dict(drop_self=style == "cls", rotate=style == "seg", return_dist=return_dist,
                style=style, valid=_t(valid))
    want = umbrella_fan_features_plain(_t(xyz), k, **args)
    got = _replay_tq(xyz, valid, k, style, return_dist)
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, atol=0, rtol=0)


def test_tq_lane_replay_matches_the_jax_tq_kernel():
    """At one small shape, the replay against
    umbrella_features_pallas(impl='tq') in interpret mode, within UMB_ATOL
    away from azimuth near-ties."""
    xyz = _grid(71, (2, 256, 3))
    valid = np.array([256, 150], np.int32)
    want = np.asarray(umbrella_features_pallas(
        jnp.asarray(xyz), 9, drop_self=True, style="cls", valid=jnp.asarray(valid), impl="tq",
        interpret=True))
    skip = azimuth_near_ties(_t(xyz), 9, drop_self=True, valid=_t(valid), gap=NEAR_TIE).numpy()
    assert skip.mean() <= 1e-2
    got = _replay_tq(xyz, valid, 9, "cls", True).numpy()
    np.testing.assert_allclose(got[~skip], want[~skip], atol=UMB_ATOL, rtol=0)


def _full_cloud():
    """Three samples of 604 points (a tile of 512 and a ragged one; blocks of
    8 queries and a ragged one): distinct grid points; the first 302
    points twice, valid 550 (inside the second tile); 4 valid points."""
    xyz = _grid(73, (3, 604, 3))
    xyz[1, 302:] = xyz[1, :302]
    return xyz, np.array([604, 550, 4], np.int32)


# the shapes the full kernel takes (G * C <= 128) among k 5, 9, 13, 14
FULL_CASES = [(k, style, dist) for k in (5, 9, 13, 14) for style in ("cls", "seg")
              for dist in (True, False)
              if fan_shape(k, style == "cls", dist)[0] * fan_shape(k, True, dist)[1] <= 128]


@pytest.mark.parametrize("k,style,return_dist", FULL_CASES)
def test_full_lane_replay_is_bit_equal_to_the_plain_composition(k, style, return_dist):
    """umbrella_full_kernel: the screened scan over 32 lanes (16 candidates a
    lane a tile), the 32-list merge, one fan a lane, the block's span."""
    xyz, valid = _full_cloud()
    want = umbrella_fan_features_plain(_t(xyz), k, drop_self=style == "cls",
                                       rotate=style == "seg", return_dist=return_dist,
                                       style=style, valid=_t(valid))
    got = _replay_group(xyz, valid, k, style, return_dist, FULL_LANES, FULL_WARPS)
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, atol=0, rtol=0)


def test_tq_entry_on_the_cpu_stays_plain():
    x = _t(_grid(72, (2, 64, 3)))
    want = umbrella_fan_features_plain(x, 9, drop_self=True)
    for impl in ("auto", "tq"):
        torch.testing.assert_close(umbrella_features_kernel(x, 9, drop_self=True, impl=impl),
                                   want, atol=0, rtol=0)


# --- the ball-feature kernel -------------------------------------------------

WARPS, STAGE, LANE_COUNT = 8, 2048, 32  # ball_feature_kernel's block, stage, warp


def _store_span(flat, off, stage, pad, total, written):
    """knn_topk::store_span: element e of the span at flat[off + e] from
    stage[pad + e]; a head up to the first 16-byte boundary, float4s whose
    destination and stage index are both multiples of 4, a tail."""
    assert off % 4 == pad
    head = min((4 - pad) & 3, total)
    body = (total - head) >> 2
    for e in range(head):
        flat[off + e] = stage[pad + e]
        written[off + e] += 1
    for v in range(body):
        d, s = off + head + 4 * v, pad + head + 4 * v
        assert d % 4 == 0 and s % 4 == 0
        flat[d:d + 4] = stage[s:s + 4]
        written[d:d + 4] += 1
    for e in range(head + 4 * body, total):
        flat[off + e] = stage[pad + e]
        written[off + e] += 1


def _polar(r):
    """The kernel's xyz2sphere of slot offsets r [S, 3], in numpy float32."""
    rx, ry, rz = r[:, 0], r[:, 1], r[:, 2]
    s2 = rx * rx + ry * ry + rz * rz
    zero = s2 == 0
    rho = np.where(zero, np.float32(0), np.sqrt(np.where(zero, np.float32(1), s2)))
    u = np.clip(rz / np.where(zero, np.float32(1), rho), -1, 1).astype(np.float32)
    th = np.where(np.abs(u) >= 1, np.where(u > 0, 0, np.pi), np.arccos(u)).astype(np.float32)
    xy0 = (rx == 0) & (ry == 0)
    phi = np.arctan2(ry, np.where(xy0, np.float32(1), rx)) / np.float32(2 * np.pi) + np.float32(0.5)
    return np.stack([rho, np.where(zero, 0, th).astype(np.float32) / np.float32(np.pi),
                     phi.astype(np.float32)], -1)


def _replay_select(xyz_b, nv, qv, r2, nsample, stage_points=STAGE):
    """staged_select for one query: the staged points, four ballots of 32
    candidates a step, hits in index order, stop after the step that
    reaches nsample hits.  Returns the picks [S] (short balls padded with
    the first hit, an empty ball point 0)."""
    slots, count = [], 0
    for base in range(0, nv, stage_points):  # the staged points
        if count >= nsample:
            break
        length = min(stage_points, nv - base)
        for t0 in range(0, length, 4 * LANE_COUNT):  # four ballots of 32 a step
            if count >= nsample:
                break
            t = t0 + np.arange(4 * LANE_COUNT)
            ok = t < length
            d = xyz_b[base + np.where(ok, t, 0)] - qv
            hit = ok & (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2] <= r2)
            slots += [base + int(i) for i in t[hit]][:max(0, nsample - count)]
            count += int(hit.sum())
    filled = min(count, nsample)
    first = slots[0] if count else 0
    return np.array([slots[s] if s < filled else first for s in range(nsample)])


def _replay_walk(flat, written, off, tcat_b, picks, coff, w):
    """walk_span: the [S, w] span at flat[off:] of channels coff .. coff+w
    of the picked rows, a scalar head up to the first 16-byte boundary,
    each lane's float4s with its (slot, channel) stepped by 128 elements
    with a carry, a scalar tail."""
    lanes = np.arange(LANE_COUNT)
    total = len(picks) * w
    head = min((4 - off % 4) & 3, total)
    body = (total - head) >> 2

    def value(s, ch):
        return tcat_b[picks[s], coff + ch]

    for e in list(range(head)) + list(range(head + 4 * body, total)):
        flat[off + e] = value(e // w, e % w)
        written[off + e] += 1
    step_s, step_ch = 128 // w, 128 - (128 // w) * w
    s, ch = np.divmod(head + 4 * lanes, w)  # once a lane
    for it in range((body + LANE_COUNT - 1) // LANE_COUNT):
        v = lanes + LANE_COUNT * it
        act = v < body
        ss, cc = s.copy(), ch.copy()
        for u in range(4):
            dst = off + head + 4 * v[act] + u
            assert ((dst - u) % 4 == 0).all()
            flat[dst] = value(ss[act], cc[act])
            written[dst] += 1
            cc += 1
            wrap = cc == w
            cc[wrap], ss[wrap] = 0, ss[wrap] + 1
        s, ch = s + step_s, ch + step_ch
        carry = ch >= w
        ch[carry], s[carry] = ch[carry] - w, s[carry] + 1


def _queries(m, b_, valid, n):
    """The (b, mq, nv) of every live warp: blocks of 8 queries of one
    sample (a warp past M only shares the stage's barriers)."""
    for b in range(b_):
        nv = n if valid is None else int(valid[b])
        for bx in range((m + WARPS - 1) // WARPS):
            for w in range(WARPS):
                if bx * WARPS + w < m:
                    yield b, bx * WARPS + w, nv


def _replay_ball(radius, nsample, xyz, q, tcat, valid, stage_points=STAGE):
    """ball_feature_kernel on the CPU, return_polar: (pos [B, M, S, 6],
    feat [B, M, S, C-3], sel [B, M, S]) through flat outputs whose every
    element must be written once."""
    b_, n, c = tcat.shape
    m = q.shape[1]
    fc, pc = c - 3, 6
    r2 = np.float32(float(radius) ** 2)
    pos = np.full(b_ * m * nsample * pc, np.nan, np.float32)
    feat = np.full(b_ * m * nsample * fc, np.nan, np.float32)
    sel = np.full((b_, m, nsample), -1, np.int64)
    pw, fw = np.zeros(pos.size, np.int64), np.zeros(feat.size, np.int64)
    for b, mq, nv in _queries(m, b_, valid, n):
        query = b * m + mq
        qv = q[b, mq]
        picks = _replay_select(xyz[b], nv, qv, r2, nsample, stage_points)
        sel[b, mq] = picks
        # pos: rounds of 32 slots through the stage
        off = query * nsample * pc
        pad = off % 4
        for s0 in range(0, nsample, LANE_COUNT):
            cnt = min(LANE_COUNT, nsample - s0)
            stage = np.full(LANE_COUNT * pc + 4, np.nan, np.float32)
            r = xyz[b, picks[s0:s0 + cnt]] - qv
            vals = np.concatenate([r, _polar(r)], -1).reshape(-1)
            stage[pad:pad + cnt * pc] = vals
            _store_span(pos, off + s0 * pc, stage, pad, cnt * pc, pw)
        # feat: the walk over the [S, C-3] span at channel offset 3
        _replay_walk(feat, fw, query * nsample * fc, tcat[b], picks, 3, fc)
    assert (pw == 1).all() and (fw == 1).all(), "an output element written other than once"
    return (pos.reshape(b_, m, nsample, pc), feat.reshape(b_, m, nsample, fc), sel)


def _replay_rows(radius, nsample, xyz, q, tcat, valid, stage_points=STAGE):
    """ball_group_kernel on the CPU: (out [B, M, S, C], sel [B, M, S]), the
    shared selection, sel as a span of S ints, the walk over every channel
    (offset 0, width C); every element written once."""
    b_, n, c = tcat.shape
    m = q.shape[1]
    r2 = np.float32(float(radius) ** 2)
    out = np.full(b_ * m * nsample * c, np.nan, np.float32)
    sel = np.full(b_ * m * nsample, -1, np.int64)
    ow, sw = np.zeros(out.size, np.int64), np.zeros(sel.size, np.int64)
    for b, mq, nv in _queries(m, b_, valid, n):
        query = b * m + mq
        picks = _replay_select(xyz[b], nv, q[b, mq], r2, nsample, stage_points)
        for s0 in range(0, nsample, LANE_COUNT):  # lane l writes slot s0 + l
            s = np.arange(s0, min(nsample, s0 + LANE_COUNT))
            sel[query * nsample + s] = picks[s]
            sw[query * nsample + s] += 1
        _replay_walk(out, ow, query * nsample * c, tcat[b], picks, 0, c)
    assert (ow == 1).all() and (sw == 1).all(), "an output element written other than once"
    return out.reshape(b_, m, nsample, c), sel.reshape(b_, m, nsample)


def _ball_case(c, nsample, n=300, m=37, seed=0):
    """Grid cloud, queries on cloud points (the first three far away: empty
    balls), M = 37 (not a multiple of a block's 8), valid [N, 151]."""
    rs = np.random.RandomState(seed)
    xyz = _grid(80 + seed, (2, n, 3))
    q = xyz[:, rs.choice(n, m, replace=False)].copy()
    q[:, :3] += 3.0  # outside the cloud by more than any radius here
    tcat = np.concatenate([xyz, rs.randn(2, n, c - 3).astype(np.float32)], -1)
    return xyz, q, tcat, np.array([n, 151], np.int32)


@pytest.mark.parametrize("stage", [STAGE, 64])
@pytest.mark.parametrize("nsample", [1, 33, 64])
@pytest.mark.parametrize("c", [4, 13, 141, 142])
def test_ball_feature_replay_matches_the_plain_version(c, nsample, stage):
    xyz, q, tcat, valid = _ball_case(c, nsample, seed=c + nsample)
    pos, feat, sel = _replay_ball(0.45, nsample, xyz, q, tcat, valid, stage_points=stage)
    tensors = [_t(xyz), _t(tcat[..., 3:])]
    ppos, pfeat = ball_group_feature_plain(0.45, nsample, _t(xyz), _t(q), tensors,
                                           valid=_t(valid), return_polar=True)
    np.testing.assert_array_equal(sel, ball_query(0.45, nsample, _t(xyz), _t(q),
                                                  valid=_t(valid)).numpy())
    np.testing.assert_array_equal(feat, pfeat.numpy())
    np.testing.assert_allclose(pos, ppos.numpy(), atol=POS_ATOL, rtol=0)
    assert (sel[:, :3] == 0).all()  # the empty balls gather point 0
    assert nsample == 1 or (sel[:, 3:] != sel[:, 3:, :1]).any()  # some balls hold several points


@pytest.mark.parametrize("n_feat", [0, 128])  # C = 13 and C = 141
def test_ball_feature_replay_matches_the_jax_kernel(n_feat):
    c = 13 + n_feat
    xyz, q, tcat, valid = _ball_case(c, 32, n=256, m=21, seed=90 + n_feat)
    pos, feat, _ = _replay_ball(0.4, 32, xyz, q, tcat, valid)
    jpos, jfeat = ball_group_feature_pallas(
        0.4, 32, jnp.asarray(xyz), jnp.asarray(q),
        [jnp.asarray(xyz), jnp.asarray(tcat[..., 3:13]), jnp.asarray(tcat[..., 13:]), None],
        valid=jnp.asarray(valid), return_polar=True, interpret=True)
    np.testing.assert_array_equal(feat, np.asarray(jfeat))
    np.testing.assert_allclose(pos, np.asarray(jpos), atol=POS_ATOL, rtol=0)


def test_ball_feature_selection_entry_on_the_cpu():
    xyz, q, tcat, valid = _ball_case(13, 16, n=120, m=9, seed=95)
    tensors = [_t(xyz), _t(tcat[..., 3:])]
    pos, feat, sel = ball_group_feature_selection(0.45, 16, _t(xyz), _t(q), tensors,
                                                  valid=_t(valid), return_polar=True)
    ppos, pfeat = ball_group_feature_plain(0.45, 16, _t(xyz), _t(q), tensors, valid=_t(valid),
                                           return_polar=True)
    torch.testing.assert_close((pos, feat), (ppos, pfeat), atol=0, rtol=0)
    assert torch.equal(sel, ball_query(0.45, 16, _t(xyz), _t(q), valid=_t(valid)))


# --- the row-grouping kernel --------------------------------------------------


def _rows_case(c, nsample, seed):
    """A grid cloud of 2,300 points (past the 2,048-point stage, so balls
    short of S are scanned over two stages), valid [2300, 1500], M = 37
    queries on cloud points, the first three far away (empty balls)."""
    rs = np.random.RandomState(seed)
    n, m = 2300, 37
    xyz = _grid(200 + seed, (2, n, 3))
    q = xyz[:, rs.choice(n, m, replace=False)].copy()
    q[:, :3] += 3.0
    tcat = rs.randn(2, n, c).astype(np.float32)
    return xyz, q, tcat, np.array([n, 1500], np.int32)


# about S points in a ball of the 2,300-point cloud: some balls full, some short
ROWS_RADIUS = {16: 0.25, 32: 0.3, 64: 0.38}


@pytest.mark.parametrize("nsample", [16, 32, 64])
@pytest.mark.parametrize("c", [1, 3, 13, 141])
def test_ball_rows_replay_is_bit_equal_to_the_plain_version(c, nsample):
    xyz, q, tcat, valid = _rows_case(c, nsample, seed=c + nsample)
    radius = ROWS_RADIUS[nsample]
    out, sel = _replay_rows(radius, nsample, xyz, q, tcat, valid)
    want_sel = ball_query(radius, nsample, _t(xyz), _t(q), valid=_t(valid)).numpy()
    np.testing.assert_array_equal(sel, want_sel)
    want = ball_group_channels_plain(radius, nsample, _t(xyz), _t(q), _t(tcat),
                                     valid=_t(valid))
    np.testing.assert_array_equal(out, want.numpy())
    assert (sel[:, :3] == 0).all()  # the empty balls gather point 0
    short = (sel[:, 3:] == sel[:, 3:, :1]).sum(-1) > 1  # padded with the first hit
    assert short.any() and (~short).any()
    assert (sel[0] >= 2048).any()  # hits from the second stage
    assert (sel[1] < 1500).all()  # valid < N


def test_ball_rows_replay_matches_the_jax_kernel():
    xyz, q, tcat, valid = _rows_case(13, 32, seed=7)
    xyz, tcat = xyz[:, :700], tcat[:, :700]
    valid = np.array([700, 512], np.int32)
    out, _ = _replay_rows(0.45, 32, xyz, q, tcat, valid)
    (jout,) = ball_group_pallas(0.45, 32, jnp.asarray(xyz), jnp.asarray(q), [jnp.asarray(tcat)],
                                valid=jnp.asarray(valid), interpret=True)
    np.testing.assert_array_equal(out, np.asarray(jout))


def test_ball_rows_entry_on_the_cpu_stays_plain():
    xyz, q, tcat, valid = _rows_case(13, 16, seed=9)
    got = ball_group_channels(0.3, 16, _t(xyz), _t(q), _t(tcat), valid=_t(valid))
    want = index_points(_t(tcat), ball_query(0.3, 16, _t(xyz), _t(q), valid=_t(valid)))
    torch.testing.assert_close(got, want, atol=0, rtol=0)
