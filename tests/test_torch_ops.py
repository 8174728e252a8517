"""The port's point ops and geometry against the JAX package, on the CPU.

Inputs are made with numpy from a seed and handed to both sides.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repsurf_torch.geometry import polar as t_polar
from repsurf_torch.geometry import surface as t_surface
from repsurf_torch.ops import gather as t_gather
from repsurf_torch.ops import masking as t_masking
from repsurf_torch.ops import neighbors as t_neighbors
from repsurf_tpu.geometry import polar as j_polar
from repsurf_tpu.geometry import surface as j_surface
from repsurf_tpu.ops import gather as j_gather
from repsurf_tpu.ops import masking as j_masking
from repsurf_tpu.ops import neighbors as j_neighbors
from repsurf_tpu.ops.pallas.knn import knn_pallas

torch.set_num_threads(1)

# f32 transcendental and product chains may round differently in the two
# frameworks (vectorised libm, FMA contraction in XLA): about one ulp
ATOL = 1e-6


def _t(a):
    return torch.from_numpy(np.array(a))


def _n(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _points(seed, shape):
    return (np.random.RandomState(seed).rand(*shape) * 2 - 1).astype(np.float32)


def test_counts_to_mask():
    valid = np.array([5, 0, 9], np.int32)
    np.testing.assert_array_equal(
        _n(t_masking.counts_to_mask(_t(valid), 9)),
        np.asarray(j_masking.counts_to_mask(jnp.asarray(valid), 9)),
    )
    assert t_masking.BIG_DIST2 == j_masking.BIG_DIST2


def test_xyz2sphere_with_degenerate_points():
    xyz = _points(0, (4, 50, 3))
    xyz[0, :6] = [[0, 0, 0], [0, 0, 1], [0, 0, -2], [1, 0, 0], [0, -1, 0], [-1, 0, 0]]
    for normalize in (True, False):
        a = _n(t_polar.xyz2sphere(_t(xyz), normalize=normalize))
        b = np.asarray(j_polar.xyz2sphere(jnp.asarray(xyz), normalize=normalize))
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=0)


def _fans(seed, degenerate=True):
    # multiples of 1/8: every product and sum in the cross product is exact,
    # so a zero normal is zero in both frameworks, FMA or not
    v = np.round(_points(seed, (2, 16, 8, 3, 3)) * 8) / 8
    v[..., 0, :] = 0.0
    if degenerate:
        v[0, :4, 1:3, 2] = 2 * v[0, :4, 1:3, 1]  # collinear: zero normal
        v[1, 5, :, 2] = -v[1, 5, :, 1]  # every fan of one point degenerate
    return v.astype(np.float32)


@pytest.mark.parametrize("with_sign", [False, True])
def test_cal_normal_grouped(with_sign):
    fans = _fans(1)
    sign = np.array([1.0, -1.0], np.float32) if with_sign else None
    ua, da = t_surface.cal_normal(
        _t(fans), random_inv_sign=None if sign is None else _t(sign), is_group=True
    )
    ub, db = j_surface.cal_normal(
        jnp.asarray(fans), random_inv_sign=sign, is_group=True
    )
    np.testing.assert_array_equal(_n(da), np.asarray(db))
    assert _n(da).any()
    np.testing.assert_allclose(_n(ua), np.asarray(ub), atol=ATOL, rtol=0)


def test_cal_center_and_const():
    fans = _fans(2, degenerate=False)
    ca = t_surface.cal_center(_t(fans))
    cb = j_surface.cal_center(jnp.asarray(fans))
    np.testing.assert_allclose(_n(ca), np.asarray(cb), atol=ATOL, rtol=0)
    nrm = _points(3, (2, 16, 8, 3))
    for norm in (True, False):
        a = t_surface.cal_const(_t(nrm), ca, is_normalize=norm)
        b = j_surface.cal_const(jnp.asarray(nrm), cb, is_normalize=norm)
        np.testing.assert_allclose(_n(a), np.asarray(b), atol=ATOL, rtol=0)


def test_repair_invalid_group_first_good_fan():
    rs = np.random.RandomState(4)
    bad = rs.rand(3, 20, 8) < 0.4
    bad[0, 0] = True  # all bad -> fan 0
    bad[1, 2, :5] = True
    vals = [rs.randn(3, 20, 8, c).astype(np.float32) for c in (3, 1)]
    a = t_surface.repair_invalid_group(_t(bad), *map(_t, vals))
    b = j_surface.repair_invalid_group(jnp.asarray(bad), *map(jnp.asarray, vals))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(_n(x), np.asarray(y))


@pytest.mark.parametrize("rank", [2, 3])
def test_index_points(rank):
    rs = np.random.RandomState(5)
    pts = rs.randn(2, 40, 7).astype(np.float32)
    idx = rs.randint(0, 40, size=(2, 12) if rank == 2 else (2, 12, 5)).astype(np.int32)
    np.testing.assert_array_equal(
        _n(t_gather.index_points(_t(pts), _t(idx))),
        np.asarray(j_gather.index_points(jnp.asarray(pts), jnp.asarray(idx))),
    )


def test_index_points_multi_resort_select():
    rs = np.random.RandomState(6)
    a, c = rs.randn(2, 30, 3).astype(np.float32), rs.randn(2, 30, 5).astype(np.float32)
    idx = rs.randint(0, 30, size=(2, 9, 4)).astype(np.int32)
    ta = t_gather.index_points_multi(_t(idx), _t(a), None, _t(c))
    ja = j_gather.index_points_multi(jnp.asarray(idx), jnp.asarray(a), None, jnp.asarray(c))
    assert ta[1] is None and ja[1] is None
    for x, y in ((ta[0], ja[0]), (ta[2], ja[2])):
        np.testing.assert_array_equal(_n(x), np.asarray(y))
    vals = rs.randn(2, 10, 8, 4).astype(np.float32)
    order = np.argsort(rs.rand(2, 10, 8), axis=-1).astype(np.int32)
    np.testing.assert_array_equal(
        _n(t_gather.resort_points(_t(vals), _t(order))),
        np.asarray(j_gather.resort_points(jnp.asarray(vals), jnp.asarray(order))),
    )
    pick = rs.randint(0, 8, size=(2, 10)).astype(np.int32)
    np.testing.assert_array_equal(
        _n(t_gather.select_group(_t(vals), _t(pick))),
        np.asarray(j_gather.select_group(jnp.asarray(vals), jnp.asarray(pick))),
    )


@pytest.mark.parametrize("k,valid", [(9, None), (16, [120, 11]), (9, [120, 5])])
def test_knn_plain_matches_pallas_kernel(k, valid):
    xyz = _points(7, (2, 120, 3))
    q = xyz[:, :50]
    v = None if valid is None else np.array(valid, np.int32)
    ia, da = t_neighbors.knn(k, _t(xyz), _t(q), valid=None if v is None else _t(v))
    ib, db = knn_pallas(k, jnp.asarray(xyz), jnp.asarray(q), valid=v, interpret=True)
    np.testing.assert_array_equal(_n(ia), np.asarray(ib))
    np.testing.assert_allclose(_n(da), np.asarray(db), atol=ATOL, rtol=0)


def test_knn_ties_take_the_lowest_index():
    base = _points(8, (1, 20, 3))
    xyz = np.concatenate([base, base], axis=1)  # every point twice
    idx, _ = t_neighbors.knn(4, _t(xyz), _t(xyz[:, 20:]))
    ib, _ = knn_pallas(4, jnp.asarray(xyz), jnp.asarray(xyz[:, 20:]), interpret=True)
    np.testing.assert_array_equal(_n(idx), np.asarray(ib))
    np.testing.assert_array_equal(_n(idx)[0, :, 0], np.arange(20))


def _radius_clear_of(xyz, q, lo, hi, margin=1e-4):
    """A radius in [lo, hi) no query-point distance is within ``margin`` of:
    the XLA ball query's |q|^2+|p|^2-2qp form may disagree at the edge."""
    d = np.sqrt(((q[:, :, None].astype(np.float64) - xyz[:, None]) ** 2).sum(-1))
    for r in np.linspace(lo, hi, 400):
        if np.abs(d - r).min() > margin:
            return float(r)
    raise AssertionError("no clear radius")


@pytest.mark.parametrize("nsample,valid", [(8, None), (16, [100, 37]), (4, [100, 1])])
def test_ball_query_plain_matches_jax(nsample, valid):
    xyz = _points(9, (2, 100, 3)) * 0.6
    q = xyz[:, :30].copy()
    q[0, 0] += 5.0  # one empty ball
    r = _radius_clear_of(xyz, q, 0.15, 0.45)
    v = None if valid is None else np.array(valid, np.int32)
    a = t_neighbors.ball_query(r, nsample, _t(xyz), _t(q), valid=None if v is None else _t(v))
    b = j_neighbors.ball_query(r, nsample, jnp.asarray(xyz), jnp.asarray(q), valid=v)
    np.testing.assert_array_equal(_n(a), np.asarray(b))
    assert (_n(a)[0, 0] == 0).all()


def test_ball_group_is_gather_of_ball_query():
    xyz = _points(10, (2, 64, 3))
    feat = _points(11, (2, 64, 5))
    q = xyz[:, :16]
    g = t_neighbors.ball_group(0.5, 8, _t(xyz), _t(q), [_t(xyz), None, _t(feat)])
    idx = t_neighbors.ball_query(0.5, 8, _t(xyz), _t(q))
    assert g[1] is None
    np.testing.assert_array_equal(_n(g[2]), _n(t_gather.index_points(_t(feat), idx)))
