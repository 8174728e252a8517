"""The port's kNN, sectorized FPS and interpolation against the JAX package
on the CPU, and the kNN kernels' algorithms (the window kernel's two passes,
the brute kernel's lane-split scan and merge) replayed in numpy against the
plain kNN.

Coordinates lie on a 2^-10 grid in [-1, 1]: every squared distance is then
exact in float32 in both distance forms (the port's and the Pallas kernels'
direct differences, the XLA twin's |q|^2 + |p|^2 - 2 q.p), so neighbour
indices must agree exactly, ties included.
"""

import bisect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repsurf_torch.data.s3dis import CLASS_WEIGHTS as T_CLASS_WEIGHTS
from repsurf_torch.data.s3dis import pad_batch as t_pad_batch
from repsurf_torch.data.synthetic_scene import label_room as t_label_room
from repsurf_torch.data.synthetic_scene import synthetic_room as t_synthetic_room
from repsurf_torch.ops import neighbors as t_neighbors
from repsurf_torch.ops.interpolate import three_interpolate as t_three_interpolate
from repsurf_torch.ops.kernels.knn import brute_lanes, knn_brute, knn_plain
from repsurf_torch.ops.kernels.knn_window import knn_window as t_knn_window
from repsurf_torch.ops.kernels.knn_window import window_grid, window_tables
from repsurf_torch.ops.sector import sectorized_fps as t_sectorized_fps
from repsurf_tpu.data.s3dis import CLASS_WEIGHTS as J_CLASS_WEIGHTS
from repsurf_tpu.data.s3dis import pad_batch as j_pad_batch
from repsurf_tpu.data.synthetic_scene import label_room as j_label_room
from repsurf_tpu.data.synthetic_scene import synthetic_room as j_synthetic_room
from repsurf_tpu.ops.interpolate import three_interpolate as j_three_interpolate
from repsurf_tpu.ops.pallas.knn import knn_pallas
from repsurf_tpu.ops.pallas.knn_window import knn_window as j_knn_window
from repsurf_tpu.ops.sector import sectorized_fps as j_sectorized_fps

torch.set_num_threads(1)

DIST_ATOL = 1e-6  # sqrt of the same float32 squared distance, two libms
NEAR_TIE = 1e-6  # azimuth gap under which two points may sort either way


def _grid_cloud(seed, b, n):
    rs = np.random.RandomState(seed)
    return (np.round((rs.rand(b, n, 3) * 2 - 1) * 1024) / 1024).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _knn_cases():
    base = _grid_cloud(0, 2, 600)
    dup = np.concatenate([base[:, :300], base[:, :300]], axis=1)  # every point twice
    return {
        "plain": (9, base, base[:, :200], None),
        "valid": (32, base, base[:, ::3], np.array([600, 251], np.int32)),
        "duplicates": (7, dup, dup[:, ::4], None),
        "k_over_valid": (12, base, base[:, :50], np.array([600, 5], np.int32)),
    }


@pytest.fixture(scope="module")
def knn_results():
    """Per case: (the port's plain kNN, knn_pallas, knn_window), both JAX
    kernels in interpret mode."""
    out = {}
    for name, (k, xyz, q, valid) in _knn_cases().items():
        port = knn_plain(k, _t(xyz), _t(q), valid=None if valid is None else _t(valid))
        jp = knn_pallas(k, jnp.asarray(xyz), jnp.asarray(q), valid=valid, interpret=True)
        jw = j_knn_window(k, jnp.asarray(xyz), jnp.asarray(q), valid=valid, grid2d=4,
                          interpret=True)
        out[name] = (port, jp, jw)
    return out


@pytest.mark.parametrize("case", list(_knn_cases()))
@pytest.mark.parametrize("jax_kernel", ["knn_pallas", "knn_window"])
def test_plain_knn_matches_pallas_kernels(knn_results, case, jax_kernel):
    (idx, dist), jp, jw = knn_results[case]
    jidx, jdist = jp if jax_kernel == "knn_pallas" else jw
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(dist.numpy(), np.asarray(jdist), atol=DIST_ATOL, rtol=0)
    if case == "k_over_valid":  # 5 valid points, k = 12: 7 missing slots
        np.testing.assert_array_equal(idx.numpy()[1, :, 5:], 0)
        np.testing.assert_array_equal(dist.numpy()[1, :, 5:], np.float32(np.sqrt(1e10)))


def test_chunked_plain_knn_equals_unchunked():
    xyz = _t(_grid_cloud(1, 2, 500))
    valid = torch.tensor([500, 333])
    whole = knn_plain(16, xyz, xyz, valid=valid, chunk=10**6)
    for chunk in (1, 7, 64):
        part = knn_plain(16, xyz, xyz, valid=valid, chunk=chunk)
        torch.testing.assert_close(part, whole, atol=0, rtol=0)


def test_routes_take_the_plain_version_on_the_cpu():
    xyz = _t(_grid_cloud(2, 1, 300))
    want = knn_plain(5, xyz, xyz[:, :40])
    for fn in (t_neighbors.knn, knn_brute, t_knn_window):
        torch.testing.assert_close(fn(5, xyz, xyz[:, :40]), want, atol=0, rtol=0)


SENTINEL = (np.float32(np.inf), 0x7FFFFFFF)  # an empty list slot
RESOLVE_THREADS, WARP = 512, 32  # the re-solve kernel's block


def _list_len(k):
    """The kernels' compile-time list length for k (knn_topk::dispatch_k)."""
    return k if k in (3, 9) else next(n for n in (4, 8, 16, 32, 64, 128, 256) if k <= n)


def _lane_lists(d2, ids, lanes, length, index_order, bound=np.inf):
    """Each of ``lanes`` lanes' k-best list over every lanes-th candidate,
    kept as the kernels keep it: ascending on (d2, id), ``length`` long; in
    index order a candidate enters on its distance alone (d2 < worst),
    else on the pair; a candidate beyond ``bound`` is skipped."""
    lists = []
    for lane in range(lanes):
        lst = []
        for j in range(lane, len(d2), lanes):
            if d2[j] > bound:
                continue
            pair = (d2[j], int(ids[j]))
            worst = lst[-1] if len(lst) == length else SENTINEL
            if (pair[0] < worst[0]) if index_order else (pair < worst):
                bisect.insort(lst, pair)
                del lst[length:]
        lists.append(lst)
    return lists


def _merge(lists, k):
    """k rounds of the arg-min on (d2, id) over the lists' heads
    (knn_topk.cuh merge_lanes and merge_rows): the winner is emitted and
    every list whose head equals it pops (pairs are unique but for the
    sentinel).  Returns the k pairs."""
    heads, out = [0] * len(lists), []
    for _ in range(k):
        cand = [lst[h] if h < len(lst) else SENTINEL for lst, h in zip(lists, heads)]
        win = min(cand)
        out.append(win)
        heads = [h + (c == win) for h, c in zip(heads, cand)]
    return out


def _rows(pairs, k):
    """Merged pairs to an output row: a slot at or above 1e10 is missing,
    (0, sqrt(1e10))."""
    d = np.array([p[0] for p in pairs], np.float32)
    i = np.array([p[1] for p in pairs], np.int64)
    missing = d >= np.float32(1e10)
    return (np.where(missing, 0, i).astype(np.int32),
            np.sqrt(np.where(missing, np.float32(1e10), d)).astype(np.float32))


def _dist2(p, qv):
    d = p - qv
    return (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + d[:, 2] * d[:, 2]


def _replay_split_brute(k, xyz, q, valid, lanes):
    """The brute kernels (csrc/knn.cu) in numpy: for each query, ``lanes``
    lanes each over every lanes-th point in index order with its own list
    (lanes = 1: knn_kernel, one thread a query), points at or beyond valid
    at 1e10, then the k-round merge of the lanes' lists."""
    b_, n, m = xyz.shape[0], xyz.shape[1], q.shape[1]
    idx = np.zeros((b_, m, k), np.int32)
    dist = np.zeros((b_, m, k), np.float32)
    for b in range(b_):
        nv = n if valid is None else int(valid[b])
        for qi in range(m):
            d2 = _dist2(xyz[b], q[b, qi])
            d2[nv:] = np.float32(1e10)
            lists = _lane_lists(d2, np.arange(n), lanes, _list_len(k), index_order=True)
            idx[b, qi], dist[b, qi] = _rows(_merge(lists, k), k)
    return idx, dist


def _emulate_window(k, xyz, q, valid=None, two_pass=False):
    """The window kernel's algorithm (csrc/knn_window.cu), step by step in
    numpy over the tables ``window_tables`` builds: scan the 3 x 3 x 3 cells
    around each query, keep the k best by (distance, index), and, when the
    guard cannot vouch for the k-th distance, rescan the whole cloud in
    place (one pass) or list the query for the re-solve pass (two passes:
    the window pass visits the queries in cell order, writes only the
    vouched rows and lists each failing query with the window's k-th
    distance; then 16 warps of 32 lanes each scan every 512th valid point
    for a listed query, skipping those beyond that distance, and the
    warps' merged lists are merged).  The cases' k are list lengths of the
    kernel (3, 9, 16, 32), so its list's last slot is the k-th.
    Returns (idx, dist, resolved per sample)."""
    t = window_tables(k, xyz, q, valid)
    pts, starts = t["pts"].numpy(), t["starts"].numpy()
    lo, cs, slack = t["lo"].numpy(), t["cs"].numpy(), t["slack"].numpy()
    qorder = t["qorder"].numpy()
    gmax = np.array([t["gxy"] - 1, t["gxy"] - 1, t["gz"] - 1])
    gid = pts[..., 3].view(np.int32)
    b_, m = q.shape[0], q.shape[1]
    idx = np.full((b_, m, k), -1, np.int32)
    dist = np.full((b_, m, k), np.nan, np.float32)
    resolved = np.zeros(b_, np.int64)
    fails = [[] for _ in range(b_)]

    def best(b, rows, qv):
        d2 = _dist2(pts[b, rows, :3], qv)
        sel = np.lexsort((gid[b, rows], d2))[:k]
        dd = np.full(k, np.inf, np.float32)
        ii = np.zeros(k, np.int32)
        dd[: len(sel)], ii[: len(sel)] = d2[sel], gid[b, rows][sel]
        return dd, ii

    for b in range(b_):
        for qi in (qorder[b] if two_pass else range(m)):
            qv = q[b, qi].numpy()
            c = np.clip(np.floor((qv - lo[b]) / cs[b]), 0, gmax).astype(int)
            c_lo, c_hi = np.maximum(c - 1, 0), np.minimum(c + 1, gmax)
            faces = [qv[a] - (lo[b, a] + np.float32(c_lo[a]) * cs[b, a])
                     for a in range(3) if c_lo[a] > 0]
            faces += [(lo[b, a] + np.float32(c_hi[a] + 1) * cs[b, a]) - qv[a]
                      for a in range(3) if c_hi[a] < gmax[a]]
            gap = min(faces, default=np.float32(np.inf))
            rows = [
                np.arange(starts[b, col + c_lo[2]], starts[b, col + c_hi[2] + 1])
                for cx in range(c_lo[0], c_hi[0] + 1)
                for cy in range(c_lo[1], c_hi[1] + 1)
                for col in [(cx * t["gxy"] + cy) * t["gz"]]
            ]
            dd, ii = best(b, np.concatenate(rows), qv)
            bound = np.float32(0.999) * (gap - slack[b])
            if not (bound > 0 and dd[-1] < bound * bound):
                resolved[b] += 1
                if two_pass:
                    fails[b].append((qi, dd[-1]))
                    continue
                dd, ii = best(b, np.arange(starts[b, -1]), qv)
            missing = dd >= 1e10
            idx[b, qi] = np.where(missing, 0, ii)
            dist[b, qi] = np.sqrt(np.where(missing, np.float32(1e10), dd))
    for b in range(b_):  # the re-solve pass over each sample's list
        nv = starts[b, -1]
        for qi, kth in fails[b]:
            d2 = _dist2(pts[b, :nv, :3], q[b, qi].numpy())
            lists = _lane_lists(d2, gid[b, :nv], RESOLVE_THREADS, _list_len(k),
                                index_order=False, bound=kth)
            warps = [_merge(lists[w:w + WARP], k) for w in range(0, RESOLVE_THREADS, WARP)]
            idx[b, qi], dist[b, qi] = _rows(_merge(warps, k), k)
    return idx, dist, resolved


def _room(seed, n=1500):
    rng = np.random.RandomState(seed)
    return _t(np.stack([t_synthetic_room(n, size=(3.0, 3.0, 2.0), rng=rng) for _ in range(2)]))


def _window_case(case):
    room = _room(3)
    k, q, valid = {
        "self_k9": (9, room, None),
        "sampled_k32_valid": (32, room[:, ::4], torch.tensor([1500, 900])),
        # queries past the bounding box: the guard sends most to the rescan
        "outside_k3": (3, room[:, :60] + torch.tensor([0.3, -0.2, 2.5]), None),
        # queries 4 m above the ceiling: the guard vouches for none
        "above_k16": (16, room[:, :80] + torch.tensor([0.0, 0.0, 4.0]), torch.tensor([1500, 1100])),
    }[case]
    return k, room, q, valid


@pytest.mark.parametrize("case", ["self_k9", "sampled_k32_valid", "outside_k3"])
def test_window_algorithm_matches_plain_knn(case):
    k, room, q, valid = _window_case(case)
    idx, dist, resolved = _emulate_window(k, room, q, valid)
    want_idx, want_dist = knn_plain(k, room, q, valid=valid)
    np.testing.assert_array_equal(idx, want_idx.numpy())
    np.testing.assert_allclose(dist, want_dist.numpy(), atol=DIST_ATOL, rtol=0)
    if case == "outside_k3":
        assert resolved.sum() > 0
    else:  # the window vouches for most queries at these densities
        assert resolved.sum() < 0.1 * q.shape[0] * q.shape[1]


@pytest.mark.parametrize("case", ["self_k9", "sampled_k32_valid", "outside_k3", "above_k16"])
def test_window_two_passes_match_one_pass_and_plain_knn(case):
    """The window pass that lists its failing queries, then the re-solve
    pass over the list, gives the one-pass rows and counts, and the plain
    kNN's rows, bit for bit."""
    k, room, q, valid = _window_case(case)
    idx, dist, resolved = _emulate_window(k, room, q, valid, two_pass=True)
    one_idx, one_dist, one_resolved = _emulate_window(k, room, q, valid)
    np.testing.assert_array_equal(resolved, one_resolved)
    np.testing.assert_array_equal(idx, one_idx)
    np.testing.assert_array_equal(dist, one_dist)
    want_idx, want_dist = knn_plain(k, room, q, valid=valid)
    np.testing.assert_array_equal(idx, want_idx.numpy())
    np.testing.assert_allclose(dist, want_dist.numpy(), atol=DIST_ATOL, rtol=0)
    if case == "above_k16":  # most queries go through the re-solve pass
        assert resolved.sum() > 0.9 * q.shape[0] * q.shape[1]


def _split_case():
    """Every point twice (ties), the second sample valid for 200 points
    only (k = 256 > valid), queries from the cloud and beside it."""
    base = _grid_cloud(12, 2, 300)
    xyz = np.concatenate([base, base], axis=1)
    q = np.concatenate([xyz[:, ::40], xyz[:, 5:10] + np.float32(0.25)], axis=1)
    return xyz, q, np.array([600, 200], np.int32)


@pytest.mark.parametrize("k", [3, 32, 256])
@pytest.mark.parametrize("lanes", [1, 8, 32])
def test_split_brute_replay_matches_plain_knn(lanes, k):
    xyz, q, valid = _split_case()
    idx, dist = _replay_split_brute(k, xyz, q, valid, lanes)
    want_idx, want_dist = knn_plain(k, _t(xyz), _t(q), valid=_t(valid))
    np.testing.assert_array_equal(idx, want_idx.numpy())
    np.testing.assert_allclose(dist, want_dist.numpy(), atol=DIST_ATOL, rtol=0)
    if k == 256:  # k > valid: the missing slots
        assert (idx[1, :, 200:] == 0).all()


def test_split_brute_replay_matches_knn_pallas(knn_results):
    """The 8-lane split on the duplicates case against the JAX kernel."""
    k, xyz, q, valid = _knn_cases()["duplicates"]
    idx, dist = _replay_split_brute(k, xyz, q, valid, 8)
    _, (jidx, jdist), _ = knn_results["duplicates"]
    np.testing.assert_array_equal(idx, np.asarray(jidx))
    np.testing.assert_allclose(dist, np.asarray(jdist), atol=DIST_ATOL, rtol=0)


def test_brute_route_by_shape():
    """Lanes by B*M against the SMs, and k (the H100's 132 SMs): the seg
    stages' small calls split, large calls keep a thread a query."""
    route = {(bm, k): brute_lanes(bm, k, 132) for bm, k in (
        (624, 32), (2500, 32), (40000, 32), (2500, 3), (10000, 3), (40000, 3), (160000, 3))}
    assert route == {(624, 32): 32, (2500, 32): 16, (40000, 32): 1, (2500, 3): 32,
                     (10000, 3): 16, (40000, 3): 8, (160000, 3): 1}
    assert brute_lanes(1, 256, 132) == 32
    xyz = _t(_grid_cloud(2, 1, 100))
    with pytest.raises(ValueError, match="lanes"):
        knn_brute(3, xyz, xyz, lanes=4)
    torch.testing.assert_close(knn_brute(3, xyz, xyz, lanes=8), knn_plain(3, xyz, xyz),
                               atol=0, rtol=0)


def test_window_tables_layout():
    room = _room(4, n=800)
    valid = torch.tensor([800, 500])
    t = window_tables(9, room, room, valid)
    assert (t["gxy"], t["gz"]) == window_grid(800, 9)
    cells = t["gxy"] ** 2 * t["gz"]
    assert t["starts"].shape == (2, cells + 1)
    np.testing.assert_array_equal(t["starts"][:, -1].numpy(), [800, 500])
    gid = t["pts"][..., 3].contiguous().view(torch.int32).long()
    for b in range(2):  # a permutation, valid points first, coordinates carried
        assert sorted(gid[b].tolist()) == list(range(800))
        assert (gid[b, : int(valid[b])] < int(valid[b])).all()
        torch.testing.assert_close(t["pts"][b, :, :3], room[b, gid[b]], atol=0, rtol=0)
        assert torch.equal(torch.sort(t["qorder"][b].long()).values, torch.arange(800))


def _near_tie_at_boundary(xyz, valid, s):
    """True where two points whose azimuths lie within NEAR_TIE sit on
    either side of a sector boundary: the two frameworks' atan2 may order
    them differently and move the boundary."""
    ang = np.arctan2(xyz[..., 0].astype(np.float64), xyz[..., 1].astype(np.float64))
    out = []
    for b in range(xyz.shape[0]):
        a = np.sort(ang[b, : valid[b]])
        n = max(int(valid[b]), 1)
        bounds = [-(-i * n // s) for i in range(1, s)]
        out.append(any(a[r] - a[r - 1] < NEAR_TIE for r in bounds if 0 < r < len(a)))
    return np.array(out)


@pytest.mark.parametrize("valid,m_valid", [
    (None, None), (np.array([1200, 1200, 700, 1101], np.int32), None),
    (np.array([1200, 1000, 777, 30], np.int32), np.array([300, 250, 194, 7], np.int32)),
])
def test_sectorized_fps_matches_jax(valid, m_valid):
    xyz = _grid_cloud(5, 4, 1200)
    got = t_sectorized_fps(_t(xyz), 300, 4, valid=None if valid is None else _t(valid),
                           m_valid=None if m_valid is None else _t(m_valid)).numpy()
    want = np.asarray(j_sectorized_fps(jnp.asarray(xyz), 300, 4, valid=valid, m_valid=m_valid))
    skip = _near_tie_at_boundary(xyz, np.full(4, 1200) if valid is None else valid, 4)
    assert skip.sum() <= 1, f"{skip.sum()} samples with a near-tie at a sector boundary"
    np.testing.assert_array_equal(got[~skip], want[~skip])


@pytest.mark.parametrize("valid_src", [None, np.array([400, 123], np.int32)])
def test_three_interpolate_matches_jax(valid_src):
    xyz = _grid_cloud(6, 2, 1600)
    src, dst = xyz[:, :400], xyz[:, 400:]
    feat = np.random.RandomState(7).randn(2, 400, 12).astype(np.float32)
    got = t_three_interpolate(_t(src), _t(dst), _t(feat),
                              valid_src=None if valid_src is None else _t(valid_src))
    want = j_three_interpolate(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(feat),
                               valid_src=valid_src)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_scene_data_helpers_match_jax():
    size = (7.0, 9.0, 3.0)
    a = t_synthetic_room(5000, size=size, rng=np.random.RandomState(8))
    b = j_synthetic_room(5000, size=size, rng=np.random.RandomState(8))
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(t_label_room(a, size), j_label_room(b, size))
    assert T_CLASS_WEIGHTS == J_CLASS_WEIGHTS
    rs = np.random.RandomState(9)
    samples = [(rs.rand(n, 3).astype(np.float32), rs.rand(n, 3).astype(np.float32),
                rs.randint(0, 13, n)) for n in (50, 80)]
    got, want = t_pad_batch(samples, 64), j_pad_batch(samples, 64)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
