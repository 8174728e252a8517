"""The algorithms of two CUDA kernels replayed on the CPU, and the plain FPS
held to the JAX package on the cases that stress the kernel's exchange.

* The scatter backward (csrc/ball_group.cu, ball_scatter_kernel) groups
  each cloud's slots by point with a counting sort of its own: a per-warp
  histogram, a key-major warp-minor scan, and a placement ranked within
  each tile of 32 slots.  ``_replay_runs`` replays it step by step in numpy,
  block by block as the kernel splits a cloud's points, and must give
  ``selection_csr``'s runs exactly (the card check holds the kernel's own
  runs to them too).
* FPS (csrc/fps.cu) takes its argmax as the max of one 64-bit key a
  candidate: the order-preserving bits of the distance over the inverted
  index.  ``_fps_key`` replays the key; it must order as (distance, -index)
  does, -1 (invalid points) and -FLT_MAX (slots past N) included.
* A cloud over the card's 131,072 register points (the stream route) takes
  the plain FPS on the CPU, as every size does, and agrees with the JAX
  package's XLA FPS.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repsurf_torch.ops.kernels.ball_group import ball_scatter, selection_csr
from repsurf_torch.ops.kernels.fps import fps, fps_plain
from repsurf_torch.ops.neighbors import ball_query as t_ball_query
from repsurf_tpu.ops.neighbors import ball_query as j_ball_query
from repsurf_tpu.ops.pallas.fps import fps_pallas
from repsurf_tpu.ops.sampling import farthest_point_sample_xla

torch.set_num_threads(1)

WARPS = 16  # warps of a scatter block
UNROLL = 8  # tiles of 32 keys a warp loads at once


def _replay_runs(sel, n, splits):
    """The scatter kernel's runs, computed as its blocks compute them:
    ``splits`` blocks a cloud, each over its own points [k0, k0 + len)
    and a scan of all the cloud's keys.  Returns (order, starts) in
    selection_csr's layout."""
    b, q = sel.shape[0], sel.shape[1] * sel.shape[2]
    keys = sel.reshape(b, q)
    length = -(-n // splits)
    seg = -(-q // (WARPS * 32)) * 32
    order = np.full(b * q, -1, np.int64)
    starts = np.full(b * n + 1, -1, np.int64)
    starts[-1] = b * q
    for c in range(b):
        for k0 in range(0, n, length):
            nk = min(n, k0 + length) - k0
            table = np.zeros((WARPS, nk), np.int64)
            below = 0
            segs = [(min(q, w * seg), min(q, min(q, w * seg) + seg)) for w in range(WARPS)]
            for w, (lo, hi) in enumerate(segs):  # the per-warp histogram
                for p in range(lo, hi):
                    k = keys[c, p]
                    below += 0 <= k < k0
                    if k0 <= k < k0 + nk:
                        table[w, k - k0] += 1
            totals = table.sum(axis=0)  # key-major, warp-minor scan
            table = np.cumsum(table, axis=0) - table
            run_start = np.cumsum(totals) - totals
            local = np.full(int(totals.sum()), -1, np.int64)
            for w, (lo, hi) in enumerate(segs):  # placement, tile by tile
                for p0 in range(lo, hi, 32 * UNROLL):
                    for t0 in range(p0, min(hi, p0 + 32 * UNROLL), 32):
                        tile = keys[c, t0:min(hi, t0 + 32)]
                        for lane, k in enumerate(tile):
                            if not k0 <= k < k0 + nk:
                                continue
                            rank = int((tile[:lane] == k).sum())  # __match_any_sync
                            local[run_start[k - k0] + table[w, k - k0] + rank] = t0 + lane
                        for k in np.unique(tile):
                            if k0 <= k < k0 + nk:
                                table[w, k - k0] += int((tile == k).sum())
            assert (local >= 0).all()
            order[c * q + below:c * q + below + len(local)] = c * q + local
            starts[c * n + k0:c * n + k0 + nk] = c * q + below + run_start
    return order, starts


def _cloud_case(seed, b=2, n=300, m=70, s=16):
    """A cloud on a 2^-10 grid (exact distances in both packages), queries
    from it plus far ones (empty balls: point 0 takes all their slots), the
    second cloud padded (points past valid are never selected)."""
    rs = np.random.RandomState(seed)
    xyz = (np.round((rs.rand(b, n, 3) * 2 - 1) * 1024) / 1024).astype(np.float32)
    q = np.concatenate([xyz[:, :m - 6], xyz[:, :6] + 8.0], axis=1)
    valid = np.array([n, n // 3], np.int32)
    sel = t_ball_query(0.3, s, torch.from_numpy(xyz), torch.from_numpy(q),
                       valid=torch.from_numpy(valid))
    want = np.asarray(j_ball_query(0.3, s, jnp.asarray(xyz), jnp.asarray(q),
                                   valid=jnp.asarray(valid)))
    np.testing.assert_array_equal(sel.numpy(), want)  # the selection JAX makes
    return sel, n, valid


@pytest.mark.parametrize("splits", [1, 3, 7])
def test_scatter_counting_sort_replay_equals_selection_csr(splits):
    sel, n, valid = _cloud_case(3)
    s = sel.shape[2]
    flat = sel.numpy().reshape(2, -1, s)
    # the case holds what the sort must get right: short balls padded with
    # their first hit, empty balls gathering point 0, padded points unused
    assert (flat[:, :, -1] == flat[:, :, 0]).any()
    assert (flat[:, -6:] == 0).all()
    assert (flat[1] < valid[1]).all()
    order, starts = _replay_runs(sel.numpy(), n, splits)
    corder, cstarts = selection_csr(sel, n)
    np.testing.assert_array_equal(order, corder.numpy())
    np.testing.assert_array_equal(starts, cstarts.numpy())


@pytest.mark.parametrize("splits", [1, 4])
def test_scatter_replay_long_runs_and_whole_tiles_of_one_key(splits):
    """Random keys with every tenth ball all on point 0 and every tenth
    padded from its third slot, so tiles hold up to 32 equal keys and the
    runs reach hundreds of slots; 700 slots a cloud cover warp segments
    that end inside a tile."""
    rs = np.random.RandomState(8)
    n, m, s = 90, 35, 20
    sel = rs.randint(0, n, (2, m, s)).astype(np.int32)
    sel[:, ::10] = 0
    sel[:, 1::10, 2:] = sel[:, 1::10, :1]
    order, starts = _replay_runs(sel, n, splits)
    corder, cstarts = selection_csr(torch.from_numpy(sel), n)
    np.testing.assert_array_equal(order, corder.numpy())
    np.testing.assert_array_equal(starts, cstarts.numpy())


def test_ball_scatter_cpu_returns_selection_csr_runs():
    """``return_runs`` on the CPU: the plain sum and selection_csr's runs,
    the layout the kernel's debug output follows."""
    sel, n, _ = _cloud_case(4)
    g = torch.from_numpy(np.random.RandomState(1).randn(*sel.shape, 5).astype(np.float32))
    out, order, starts = ball_scatter(sel, g, n, coff=2, return_runs=True)
    corder, cstarts = selection_csr(sel, n)
    assert torch.equal(order, corder) and torch.equal(starts, cstarts)
    assert torch.equal(out, ball_scatter(sel, g, n, coff=2))
    assert out.shape == (2, n, 7) and (out[..., :2] == 0).all()


def _fps_key(dist, idx):
    """The FPS kernel's candidate key: order-preserving float bits in the
    high word, 0xFFFFFFFF - index in the low word."""
    u = np.asarray(dist, np.float32).view(np.uint32).astype(np.uint64)
    u = np.where(u & 0x80000000, ~u & 0xFFFFFFFF, u | 0x80000000)
    return (u << np.uint64(32)) | (np.uint64(0xFFFFFFFF) - np.asarray(idx, np.uint64))


def test_fps_key_orders_as_distance_then_lowest_index():
    rs = np.random.RandomState(0)
    special = np.array([-np.finfo(np.float32).max, -1.0, 0.0, 1e-30, 1.0, 1e10], np.float32)
    dist = np.concatenate([special, rs.rand(200).astype(np.float32) * 4.0,
                           np.repeat(np.float32(0.5), 6)])  # equal distances too
    idx = rs.permutation(131072)[:len(dist)]
    key = _fps_key(dist, idx)
    d1, d2 = dist[:, None], dist[None, :]
    i1, i2 = idx[:, None], idx[None, :]
    want = (d1 > d2) | ((d1 == d2) & (i1 < i2))
    np.testing.assert_array_equal(key[:, None] > key[None, :], want)


@pytest.mark.parametrize("seed", [0, 1])
def test_fps_key_max_is_the_plain_argmax(seed):
    """The max key over a cloud split into blocks and warps (max of maxes)
    picks what fps_plain's argmax picks: the lowest index among the
    largest distances, invalid points (-1) and slots past N (-FLT_MAX)
    never."""
    rs = np.random.RandomState(seed)
    n, chunk = 3000, 1024
    dist = rs.randint(0, 4, n).astype(np.float32)  # many ties
    dist[rs.rand(n) < 0.3] = -1.0
    padded = np.concatenate([dist, np.full(3 * chunk - n, -np.finfo(np.float32).max,
                                           np.float32)])
    key = _fps_key(padded, np.arange(len(padded)))
    best = max(key[r:r + chunk].reshape(-1, 32).max(axis=1).max() for r in range(0, 3 * chunk,
                                                                                 chunk))
    win = int(np.uint64(0xFFFFFFFF) - (best & np.uint64(0xFFFFFFFF)))
    assert win == int(np.flatnonzero(dist == dist.max())[0])


def _fps_case(kind):
    """Clouds that stress the FPS kernel's exchange, at a CPU size: points
    duplicated across what would be block boundaries (1,024 points apart),
    valid counts ending inside a block's share and inside the last block,
    N not a multiple of 1,024, and npoint beyond a valid count."""
    rs = np.random.RandomState(11)
    n = 3 * 1024 - 5
    if kind == "duplicates":
        base = rs.rand(2, 1024, 3).astype(np.float32)
        xyz = np.concatenate([base, base, base[:, :n - 2048]], axis=1)
        return xyz, 96, None
    xyz = rs.rand(2, n, 3).astype(np.float32)
    if kind == "valid_mid_share":
        return xyz, 128, np.array([1500, n - 40], np.int32)
    return xyz, 80, np.array([50, n], np.int32)  # npoint > valid


@pytest.mark.parametrize("kind", ["duplicates", "valid_mid_share", "npoint_over_valid"])
def test_fps_plain_matches_pallas_on_exchange_cases(kind):
    xyz, npoint, valid = _fps_case(kind)
    got = fps_plain(torch.from_numpy(xyz), npoint,
                    valid=None if valid is None else torch.from_numpy(valid)).numpy()
    want = np.asarray(fps_pallas(jnp.asarray(xyz), npoint, valid=valid, interpret=True))
    for i in range(2):  # only the first min(npoint, valid) slots are defined
        m = npoint if valid is None else min(npoint, int(valid[i]))
        np.testing.assert_array_equal(got[i, :m], want[i, :m])
    if kind == "duplicates":  # every tie went to the lower of the two copies
        assert (got < 1024).all() and len(np.unique(got[0])) == npoint


def test_fps_over_the_register_points_takes_the_plain_path_on_the_cpu():
    """[1, 140,000] points, more than the kernel's registers hold: on the
    CPU ``fps`` is the plain version (no launch counted) and equals the JAX
    XLA FPS.  Coordinates on a 2^-10 grid make every squared distance exact
    in both packages."""
    rs = np.random.RandomState(4)
    xyz = (np.round((rs.rand(1, 140000, 3) * 2 - 1) * 1024) / 1024).astype(np.float32)
    before = (fps.launches, dict(fps.launches_by_route))
    got = fps(torch.from_numpy(xyz), 64)
    assert (fps.launches, dict(fps.launches_by_route)) == before
    np.testing.assert_array_equal(got.numpy(), fps_plain(torch.from_numpy(xyz), 64).numpy())
    want = np.asarray(farthest_point_sample_xla(jnp.asarray(xyz), 64))
    np.testing.assert_array_equal(got.numpy(), want)
