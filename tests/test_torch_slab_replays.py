"""The slab umbrella route's two kernels, replayed step by step on the CPU
and held to the plain guard replay, the JAX slab kernel's own guard and the
plain composition.

The replays follow csrc/umbrella.cu (umbrella_slab_kernel,
umbrella_slab_resolve_kernel), which run only on the card:

  * the window pass: each sample x-sorted (``slab_table``); a block takes 32
    queries of one slab, 4 lanes a query; lane s takes the window slots
    t = s (mod 4) of the 384-point window, a slab of the window at a time,
    the query's own slab first, each lane's 32 screened against the group's
    least k-th distance, the marked ones inserted by the (d^2, original
    index) pair (List::insert_any_order: the window is x-sorted, not in index
    order); the group merges its lists in k rounds; the merged k-th distance
    and the margin to the nearest x outside the window give the guard, and a
    query that fails it is listed for its sample instead of written;
  * the re-solve pass: each listed query through the screened scan over the
    whole cloud and the same lane epilogue (the tq kernel's, replayed in
    test_torch_lane_replays.py);
  * the rows: each query's row is stored at its original index by its own
    span store, by the window pass or by the re-solve pass: every element
    once.

Coordinates lie on a 2^-10 grid, so every squared distance and cross
product is exact and ties are common.
"""

import numpy as np
import pytest
import torch

from repsurf_torch.ops.kernels.knn import pairwise_dist2
from repsurf_torch.ops.kernels.umbrella import (
    SLAB,
    fan_shape,
    slab_guard_plain,
    slab_table,
    umbrella_fan_features_plain,
)

from .test_torch_lane_replays import (
    SENTINEL,
    TQ_LANES,
    _grid,
    _kmax,
    _lane_epilogue,
    _merge,
    _scan_lists,
    _store_span,
    _t,
)
from .test_torch_umbrella import _jax_slab_bad

torch.set_num_threads(1)

BIG = 1e10
WINDOW = 3 * SLAB
CHUNK = 32  # window slots a lane screens at a time


def _cloud(kind):
    """[B, N, 3] on the grid and the valid counts:
    'plain'  5 slabs, x squeezed to 0.4 so some queries are re-solved,
             one sample with padding rows;
    'flat'   x squeezed to a tenth, so most windows are narrower than the
             neighbourhoods and most queries are re-solved, ties in x;
    'few'    valid counts under k (every live query of those samples fails
             the guard and takes missing slots)."""
    if kind == "plain":
        xyz = _grid(60, (2, 640, 3))
        xyz[..., 0] = np.round(xyz[..., 0] * 0.4 * 1024) / 1024
        return xyz, np.array([640, 333], np.int32)
    if kind == "flat":
        xyz = _grid(61, (2, 512, 3))
        xyz[..., 0] = np.round(xyz[..., 0] * 0.1 * 1024) / 1024
        return xyz, np.array([512, 400], np.int32)
    xyz = _grid(62, (3, 384, 3))
    xyz[0, 192:] = xyz[0, :192]  # every point twice: zero-length neighbours, tied distances
    return xyz, np.array([384, 4, 2], np.int32)


def _pair_insert(lists, key, enter):
    """List::insert_any_order of ``key`` into the sorted int64 pair keys
    ``lists`` [..., K] where ``enter``: each slot from comparisons on the
    old list, the key before every entry it precedes and the last entry
    dropped (the pair order is the key order)."""
    enter = enter & (key < lists[..., -1])
    lt = key[..., None] < lists
    prev = torch.cat([torch.zeros_like(lt[..., :1]), lt[..., :-1]], -1)
    new = torch.where(prev, torch.cat([lists[..., :1], lists[..., :-1]], -1),
                      torch.where(lt, key[..., None], lists))
    return torch.where(enter[..., None], new, lists)


def _window_pass(xyz, valid, k):
    """umbrella_slab_kernel<KMAX> on the CPU.  Returns (keys [B, N, k], the
    merged window lists; bad [B, N] bool, the listed queries), both in the
    original point order."""
    x, nv = _t(xyz), _t(valid).long()
    b, n, _ = x.shape
    n_slabs = n // SLAB
    table = slab_table(x, _t(valid))
    c0 = torch.clamp(torch.arange(n_slabs) - 1, 0, n_slabs - 3)
    win = table[:, (c0[:, None] * SLAB + torch.arange(WINDOW)).reshape(-1)]
    win = win.reshape(b, n_slabs, WINDOW, 4)
    q = table.reshape(b, n_slabs, SLAB, 4)
    wj = win[..., 3].long()  # the window's original indices
    # the scan's order: slab (own + c) mod 3 of the window at step c
    own = torch.arange(n_slabs) - c0
    steps = ((own[:, None] + torch.arange(3)) % 3)[:, :, None] * SLAB + torch.arange(SLAB)
    scan = torch.gather(win, 2, steps.reshape(1, n_slabs, WINDOW, 1).expand(b, -1, -1, 4))
    sj = scan[..., 3].long()
    d2 = pairwise_dist2(q[..., :3].reshape(b * n_slabs, SLAB, 3),
                        scan[..., :3].reshape(b * n_slabs, WINDOW, 3))
    d2 = d2.reshape(b, n_slabs, SLAB, WINDOW)
    d2 = torch.where((sj < nv[:, None, None])[:, :, None, :], d2, BIG)
    keys = (d2.view(torch.int32).to(torch.int64) << 32) | sj[:, :, None, :]
    lists = torch.full((b, n_slabs, SLAB, TQ_LANES, _kmax(k)), SENTINEL, dtype=torch.int64)
    sub = torch.arange(TQ_LANES)
    for t0 in range(0, WINDOW, CHUNK * TQ_LANES):  # a slab a step
        ends = (lists[..., -1] >> 32).to(torch.int32).view(torch.float32)
        w = ends.amin(-1, keepdim=True)  # the group's least k-th
        marks = [t0 + sub + u * TQ_LANES for u in range(CHUNK)]
        marked = [d2[..., t] <= w for t in marks]
        for t, m in zip(marks, marked):  # the marked ones, in slot order
            lists = _pair_insert(lists, keys[..., t], m)
    sentinel = lists.new_full(lists.shape[:-1] + (1,), SENTINEL)
    merged = _merge(torch.cat([lists, sentinel], -1), k)  # [B, S, SLAB, k]
    kth = torch.clamp((merged[..., k - 1] >> 32).to(torch.int32).view(torch.float32), max=BIG)
    # the margin to the nearest excluded x, and the guard
    qx = q[..., 0]
    wlo, whi = win[:, :, :1, 0], win[:, :, -1:, 0]
    right_valid = (wj[:, :, -1:] < nv[:, None, None])
    ml = torch.where((c0 > 0)[None, :, None], qx - wlo, torch.tensor(BIG))
    mr = torch.where((c0 < n_slabs - 3)[None, :, None] & right_valid, whi - qx, torch.tensor(BIG))
    m = 0.999 * torch.clamp(torch.minimum(ml, mr), min=0.0)
    qi = q[..., 3].long()
    bad = ((kth >= m * m) | (kth >= BIG)) & (qi < nv[:, None, None])
    # to the original order
    qi = qi.reshape(b, n)
    keys_o = torch.empty((b, n, k), dtype=torch.int64)
    keys_o[torch.arange(b)[:, None], qi] = merged.reshape(b, n, k)
    bad_o = torch.zeros((b, n), dtype=torch.bool)
    bad_o[torch.arange(b)[:, None], qi] = bad.reshape(b, n)
    return keys_o, bad_o


def _row_spans(feat):
    """Each query's row stored at its original index through its own stage
    (span_floats(1) floats at the row's 16-byte phase) by store_span, the
    window pass's rows and the re-solve pass's together: every element once."""
    b, n, g, c = feat.shape
    gc = g * c
    vals = feat.numpy().reshape(b * n, gc)
    flat = np.full(b * n * gc, np.nan, np.float32)
    written = np.zeros(flat.size, np.int64)
    for row in range(b * n):
        off = row * gc
        stage = np.full((gc + 6) & ~3, np.nan, np.float32)
        stage[off % 4:off % 4 + gc] = vals[row]
        _store_span(flat, off, stage, off % 4, gc, written)
    assert (written == 1).all(), "an output element written other than once"
    return torch.from_numpy(flat.reshape(b, n, g, c))


@pytest.mark.parametrize("k", [5, 9, 13])
@pytest.mark.parametrize("kind", ["plain", "flat", "few"])
def test_window_pass_lists_match_the_plain_guard(kind, k):
    xyz, valid = _cloud(kind)
    _, bad = _window_pass(xyz, valid, k)
    want = slab_guard_plain(_t(xyz), k, valid=_t(valid))
    torch.testing.assert_close(bad, want, atol=0, rtol=0)
    live = np.arange(xyz.shape[1])[None, :] < valid[:, None]
    if kind == "flat":
        assert bad.sum() > live.sum() // 2  # most queries re-solved
    if kind == "few":
        assert bad[1:].sum() == valid[1:].sum()  # every live query under k
    assert bad.any() and not bad[torch.from_numpy(~live)].any()


def test_window_pass_lists_match_the_jax_slab_kernel():
    """The listed queries against ``bad`` from the JAX slab kernel's own
    k-th distance and margin outputs in interpret mode (cls, C = 10)."""
    xyz, valid = _cloud("flat")
    _, bad = _window_pass(xyz, valid, 9)
    want = _jax_slab_bad(xyz, 9, valid)
    assert 0 < want.sum() < want.size
    np.testing.assert_array_equal(bad.numpy(), want)


@pytest.mark.parametrize("k,style,return_dist", [
    (9, "cls", True), (9, "seg", True), (5, "seg", False), (13, "cls", True)])
@pytest.mark.parametrize("kind", ["plain", "flat", "few"])
def test_two_passes_are_bit_equal_to_the_plain_composition(kind, k, style, return_dist):
    """Every live row, from the window (the guard vouches that its list is
    the global one) or from the re-solve pass, bit-equal to the plain
    composition, hence to the tq kernel's."""
    xyz, valid = _cloud(kind)
    window, bad = _window_pass(xyz, valid, k)
    # the re-solve pass: the screened scan over the whole cloud, 4 lanes
    glob = _merge(_scan_lists(xyz, valid, TQ_LANES, _kmax(k)), k)
    live = torch.from_numpy(np.arange(xyz.shape[1])[None, :] < valid[:, None])
    good = live & ~bad
    assert torch.equal(window[good], glob[good])  # what the guard vouches for
    keys = torch.where(bad[..., None], glob, window)
    got = _row_spans(_lane_epilogue(xyz, keys, style, return_dist, TQ_LANES))
    want = umbrella_fan_features_plain(_t(xyz), k, drop_self=style == "cls",
                                       rotate=style == "seg", return_dist=return_dist,
                                       style=style, valid=_t(valid))
    assert got.shape == want.shape == xyz.shape[:2] + fan_shape(k, style == "cls", return_dist)
    torch.testing.assert_close(got[live], want[live], atol=0, rtol=0)
