"""The plain versions of the port's kernels against the JAX package's Pallas
kernels, run in interpret mode on the CPU.

On the CPU each wrapper runs its plain version, so these tests hold the
function each CUDA kernel must compute; chip_smoke.py holds the kernels to
these plain versions on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repsurf_torch.geometry.polar import xyz2sphere as t_xyz2sphere
from repsurf_torch.geometry.umbrella import umbrella_features as t_umbrella_features
from repsurf_torch.ops.kernels.ball_group import (
    ball_group_feature,
    ball_group_feature_plain,
)
from repsurf_torch.ops.kernels.fps import fps, fps_plain
from repsurf_torch.ops.kernels.umbrella import (
    umbrella_fan_features_plain,
    umbrella_features_kernel,
)
from repsurf_torch.ops.neighbors import knn as t_knn
from repsurf_torch.ops.gather import index_points as t_index_points
from repsurf_tpu.geometry.umbrella import umbrella_features as j_umbrella_features
from repsurf_tpu.ops.pallas.ball_group import _ball_feat_core
from repsurf_tpu.ops.pallas.fps import fps_pallas
from repsurf_tpu.ops.pallas.umbrella import umbrella_features_pallas

torch.set_num_threads(1)

B, N = 2, 256
VALID = np.array([N, 97], np.int32)  # one sample with padding rows
# umbrella features pass through atan2/acos/sqrt/division chains; the Pallas
# kernel uses its own polynomial atan2/acos (~2 ulp): a few ulp of 1
UMB_ATOL = 1e-5
# the azimuth gap below which two fan neighbours may sort either way
NEAR_TIE = 1e-6


def _cloud(seed, b=B, n=N):
    return (np.random.RandomState(seed).rand(b, n, 3) * 2 - 1).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("npoint,valid", [(64, None), (64, VALID), (200, VALID)])
def test_fps_plain_matches_pallas(npoint, valid):
    xyz = _cloud(0)
    a = fps_plain(_t(xyz), npoint, valid=None if valid is None else _t(valid))
    b = np.asarray(fps_pallas(jnp.asarray(xyz), npoint, valid=valid, interpret=True))
    # only the first min(npoint, valid) slots are defined
    for i in range(B):
        m = npoint if valid is None else min(npoint, int(valid[i]))
        np.testing.assert_array_equal(a.numpy()[i, :m], b[i, :m])
        assert (a.numpy()[i, :m] < (N if valid is None else valid[i])).all()


def test_fps_return_xyz_matches_pallas_and_gather():
    xyz = _cloud(1)
    idx, sam = fps_plain(_t(xyz), 48, valid=_t(VALID), return_xyz=True)
    jidx, jsam = fps_pallas(
        jnp.asarray(xyz), 48, valid=VALID, return_xyz=True, interpret=True
    )
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(sam.numpy(), np.asarray(jsam))
    np.testing.assert_array_equal(sam.numpy(), t_index_points(_t(xyz), idx).numpy())
    # the wrapper takes the plain version for a CPU tensor
    widx, wsam = fps(_t(xyz), 48, valid=_t(VALID), return_xyz=True)
    np.testing.assert_array_equal(widx.numpy(), idx.numpy())
    np.testing.assert_array_equal(wsam.numpy(), sam.numpy())


def _near_ties(xyz, k, valid):
    """[B, N] True where two fan neighbours' azimuths lie within NEAR_TIE:
    their order, and so the fans, may differ between implementations."""
    idx, _ = t_knn(k, _t(xyz), _t(xyz), valid=None if valid is None else _t(valid))
    rel = t_index_points(_t(xyz), idx[:, :, 1:]) - _t(xyz)[:, :, None, :]
    phi = torch.sort(t_xyz2sphere(rel)[..., 2], dim=-1).values
    return (torch.diff(phi, dim=-1).amin(-1) < NEAR_TIE).numpy()


def _knn_near_ties(xyz, k, valid, gap=2e-6):
    """[B, N] True where the k-th and (k+1)-th squared distances lie within
    ``gap``: the XLA kNN's |q|^2+|p|^2-2qp form may pick the other one."""
    _, d = t_knn(k + 1, _t(xyz), _t(xyz), valid=None if valid is None else _t(valid))
    d2 = d.double() ** 2
    return (torch.diff(d2, dim=-1).amin(-1) < gap).numpy()


def _assert_close_except(a, b, skip, atol, max_share=1e-3):
    assert skip.mean() <= max_share, f"{skip.sum()} near-tie points"
    np.testing.assert_allclose(a[~skip], b[~skip], atol=atol, rtol=0)


@pytest.mark.parametrize("valid", [None, VALID])
def test_umbrella_plain_matches_pallas_tq(valid):
    xyz = _cloud(2)
    a = umbrella_fan_features_plain(
        _t(xyz), 9, drop_self=True, valid=None if valid is None else _t(valid)
    ).numpy()
    b = np.asarray(umbrella_features_pallas(
        jnp.asarray(xyz), 9, drop_self=True, style="cls", valid=valid,
        impl="tq", interpret=True,
    ))
    assert a.shape == b.shape == (B, N, 8, 10)
    _assert_close_except(a, b, _near_ties(xyz, 9, valid), UMB_ATOL)


def test_umbrella_degenerate_fans_and_missing_neighbours():
    base = _cloud(3, b=1, n=32)
    xyz = np.concatenate([base, base, base, base], axis=1)  # zero-area fans
    xyz = np.concatenate([xyz, _cloud(4, b=1, n=128)], axis=0)
    # on a 1/16 grid every product in the cross product is exact: XLA's FMA
    # contraction would otherwise leave a rounding residue in the normal of
    # a fan of duplicate points, and the JAX side would not repair it
    xyz = np.round(xyz * 16) / 16
    valid = np.array([128, 6], np.int32)  # 6 < k: missing kNN slots
    a = umbrella_fan_features_plain(_t(xyz), 9, drop_self=True, valid=_t(valid)).numpy()
    b = np.asarray(umbrella_features_pallas(
        jnp.asarray(xyz), 9, drop_self=True, style="cls", valid=valid,
        impl="tq", interpret=True,
    ))
    assert np.isfinite(a).all()
    np.testing.assert_allclose(a, b, atol=UMB_ATOL, rtol=0)


def test_umbrella_sign_outside_commutes_with_xla_route():
    """The port applies the inversion to channels 6:10 after the kernel;
    the JAX XLA route inverts the normal inside cal_normal."""
    xyz = _cloud(5)
    sign = np.array([-1.0, 1.0], np.float32)
    a = t_umbrella_features(_t(xyz), 9, random_inv_sign=_t(sign)).numpy()
    b = np.asarray(j_umbrella_features(
        jnp.asarray(xyz), 9, style="cls", impl="xla", random_inv_sign=jnp.asarray(sign)
    ))
    skip = _near_ties(xyz, 9, None) | _knn_near_ties(xyz, 9, None)
    _assert_close_except(a, b, skip, UMB_ATOL, max_share=1e-2)
    np.testing.assert_array_equal(
        umbrella_features_kernel(_t(xyz), 9, drop_self=True).numpy(),
        umbrella_fan_features_plain(_t(xyz), 9, drop_self=True).numpy(),
    )


@pytest.mark.parametrize("n_feat", [0, 128])  # C = 13 and C = 141
def test_ball_feature_plain_matches_pallas(n_feat):
    rs = np.random.RandomState(6 + n_feat)
    xyz = _cloud(6 + n_feat) * 0.8
    q_idx = fps_plain(_t(xyz), 64, valid=_t(VALID))
    q = t_index_points(_t(xyz), q_idx).numpy()
    normal = rs.randn(B, N, 10).astype(np.float32)
    tensors = [xyz, normal] + ([rs.randn(B, N, n_feat).astype(np.float32)] if n_feat else [])
    tcat = np.concatenate(tensors, axis=-1)
    pos, feat = ball_group_feature_plain(
        0.4, 16, _t(xyz), _t(q), [_t(t) for t in tensors] + [None],
        valid=_t(VALID), return_polar=True,
    )
    jpos, jfeat = _ball_feat_core(
        0.4, 16, jnp.asarray(xyz), jnp.asarray(q), jnp.asarray(tcat),
        jnp.asarray(VALID), return_polar=True, interpret=True,
    )
    assert feat.shape == (B, 64, 16, tcat.shape[-1] - 3)
    np.testing.assert_array_equal(feat.numpy(), np.asarray(jfeat))
    np.testing.assert_allclose(pos.numpy(), np.asarray(jpos), atol=1e-6, rtol=0)


def test_ball_feature_empty_ball_and_wrapper():
    xyz = _cloud(7, n=64) * 0.1
    q = xyz[:, :8] + 50.0  # every ball empty: point 0 gathered
    pos, feat = ball_group_feature(0.2, 4, _t(xyz), _t(q), [_t(xyz), _t(xyz)])
    np.testing.assert_array_equal(
        feat.numpy(), np.broadcast_to(xyz[:, :1, None, :], (B, 8, 4, 3))
    )
    np.testing.assert_array_equal(pos.numpy(), (xyz[:, None, :1] - q[:, :, None]).repeat(4, 2))


def test_wrappers_refuse_a_graph_that_needs_backward():
    """FPS returns indices and refuses a graph through it; the umbrella and
    ball-feature wrappers carry gradients (their plain versions here)."""
    xyz = _t(_cloud(8, n=32)).requires_grad_(True)
    with pytest.raises(NotImplementedError, match="indices"):
        fps(xyz, 4)
    with torch.no_grad():
        assert fps(xyz, 4).shape == (B, 4)
    feat = umbrella_features_kernel(xyz, 9, drop_self=True)
    _, grouped = ball_group_feature(0.3, 4, xyz, xyz[:, :4], [xyz, feat.sum(dim=2)])
    grouped.sum().backward()
    assert xyz.grad is not None and torch.isfinite(xyz.grad).all()
    assert xyz.grad.abs().sum() > 0
