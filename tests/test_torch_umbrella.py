"""The port's umbrella kernel entry (ops/kernels/umbrella.py) against the JAX
package's ``umbrella_features_pallas`` in interpret mode, on the CPU.

On the CPU the entry runs its plain version whatever the impl, so these
tests hold the function that all three CUDA kernels (tq, full, slab) must
compute, both styles, with and without the plane constant; the slab
kernel's guard replay against the JAX slab kernel's own guard outputs; and
the entry's refusals.  chip_smoke.py holds the kernels to the plain version
on the card.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from repsurf_torch.geometry.umbrella import azimuth_near_ties
from repsurf_torch.geometry.umbrella import umbrella_features as t_umbrella_features
from repsurf_torch.ops.kernels.umbrella import (
    SLAB,
    slab_guard_plain,
    umbrella_features_kernel,
)
from repsurf_tpu.geometry.umbrella import umbrella_features as j_umbrella_features
from repsurf_tpu.ops.pallas import umbrella as jumb

torch.set_num_threads(1)

B, N = 2, 512
VALID = np.array([N, 300], np.int32)  # one sample with padding rows
UMB_ATOL = 1e-5  # atan2/acos/sqrt/division chains; the Pallas atan2/acos are ~2 ulp
NEAR_TIE = 1e-6  # azimuth gap under which two fan neighbours may sort either way
BIG = 1e10


def _cloud(seed, b=B, n=N):
    return (np.random.RandomState(seed).rand(b, n, 3) * 2 - 1).astype(np.float32)


def _grid(seed, shape):
    """Coordinates on a 2^-10 grid: squared distances are exact in both
    frameworks' kNN forms."""
    rs = np.random.RandomState(seed)
    return (np.round((rs.rand(*shape) * 2 - 1) * 1024) / 1024).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _near_ties(xyz, k, drop_self, rotate, valid):
    return azimuth_near_ties(_t(xyz), k, drop_self=drop_self, rotate=rotate,
                             valid=None if valid is None else _t(valid), gap=NEAR_TIE).numpy()


def _style_args(style):
    return dict(drop_self=style == "cls", rotate=style == "seg", style=style)


@pytest.mark.parametrize("k", [5, 9])
@pytest.mark.parametrize("return_dist", [True, False])
@pytest.mark.parametrize("style", ["cls", "seg"])
@pytest.mark.parametrize("impl", ["tq", "full", "slab"])
def test_plain_matches_pallas(impl, style, return_dist, k):
    xyz = _cloud(10 + k)
    args = dict(_style_args(style), return_dist=return_dist)
    got = umbrella_features_kernel(_t(xyz), k, valid=_t(VALID), impl=impl, **args).numpy()
    want = np.asarray(jumb.umbrella_features_pallas(
        jnp.asarray(xyz), k, valid=jnp.asarray(VALID), impl=impl, interpret=True, **args))
    g = k - 1 if style == "cls" else k
    assert got.shape == want.shape == (B, N, g, 10 if return_dist else 9)
    skip = _near_ties(xyz, k, style == "cls", style == "seg", VALID)
    assert skip.mean() <= 1e-3, f"{skip.sum()} near-tie points"
    if impl == "slab":
        # the slab route leaves padded rows as its window found them
        skip |= np.arange(N)[None, :] >= VALID[:, None]
    np.testing.assert_allclose(got[~skip], want[~skip], atol=UMB_ATOL, rtol=0)


def _jax_slab_bad(xyz, k, valid):
    """JAX's re-solve mask (umbrella.py:770-830), recomputed from the
    interpret-mode outputs of ``_umbrella_slab_kernel``: the host side of
    ``_umbrella_slab`` up to ``bad``."""
    b, n, _ = xyz.shape
    g, c = k - 1, 10
    gc, n_slabs = g * c, n // SLAB
    x = jnp.asarray(xyz)

    def prep(p, nv):
        key = jnp.where(jnp.arange(n) < nv, p[:, 0], jnp.inf)
        order = jnp.argsort(key, stable=True).astype(jnp.int32)
        pgv = jnp.where(order < nv, order, -1).astype(jnp.float32)
        return jnp.concatenate([p[order].T, pgv[None, :]], axis=0), p[order], order

    p4, xs, order = jax.vmap(prep)(x, jnp.asarray(valid))

    def window(off):
        return pl.BlockSpec((1, 4, SLAB), lambda b_, s: (b_, 0, jnp.clip(s - 1, 0, n_slabs - 3)
                                                         + off), memory_space=pltpu.VMEM)

    out = pl.pallas_call(
        functools.partial(jumb._umbrella_slab_kernel, k, 1, False, True, "cls", n_slabs),
        grid=(b, n_slabs),
        in_specs=[window(0), window(1), window(2),
                  pl.BlockSpec((1, SLAB, 3), lambda b_, s: (b_, s, 0),
                               memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((1, SLAB, 128), lambda b_, s: (b_, s, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((b, n, 128), jnp.float32),
        interpret=True,
    )(p4, p4, p4, xs)
    inv = np.argsort(np.asarray(order), axis=-1)
    outp = np.take_along_axis(np.asarray(out), inv[..., None], axis=1)
    kth, margin = outp[..., gc], outp[..., gc + 1]
    point_ok = np.arange(n)[None, :] < valid[:, None]
    return ((kth >= np.square(np.float32(0.999) * margin)) | (kth >= BIG)) & point_ok


@pytest.mark.parametrize("k", [5, 9])
def test_slab_guard_replay_matches_jax_bad_mask(k):
    # a cloud flattened along x, so that windows of 384 points are narrower
    # than some neighbourhoods, with ties in x for the stable sort
    xyz = _cloud(20 + k)
    xyz[..., 0] *= 0.3
    xyz[:, ::7, 0] = np.round(xyz[:, ::7, 0] * 16) / 16
    want = _jax_slab_bad(xyz, k, VALID)
    got = slab_guard_plain(_t(xyz), k, valid=_t(VALID)).numpy()
    assert 0 < want.sum() < want.size // 2
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("impl,n,k,return_dist", [
    ("slab", 256, 9, True),  # under 3 slabs
    ("slab", 500, 9, True),  # not a multiple of 128
    ("full", 512, 14, True),  # 13 fans x 10 channels > 128
    ("slab", 512, 14, True),
    ("full", 512, 16, False),  # 15 x 9 > 128
    ("tq", 512, 18, True),  # 17 fans > 16
])
def test_entry_refuses_what_the_kernels_do_not_take(impl, n, k, return_dist):
    xyz = _t(_cloud(30, n=n))
    with pytest.raises(ValueError):
        umbrella_features_kernel(xyz, k, drop_self=True, return_dist=return_dist, impl=impl)


@pytest.mark.parametrize("return_dist", [True, False])
def test_seg_sign_channels_match_the_xla_route(return_dist):
    """The port inverts the normal and constant channels after the kernel
    entry; the JAX XLA route inverts the normal inside cal_normal."""
    xyz = _grid(40, (B, N, 3))
    sign = np.array([-1.0, 1.0], np.float32)
    got = t_umbrella_features(_t(xyz), 9, valid=_t(VALID), random_inv_sign=_t(sign),
                              style="seg", return_dist=return_dist, impl="kernel").numpy()
    want = np.asarray(j_umbrella_features(
        jnp.asarray(xyz), 9, style="seg", return_dist=return_dist, valid=jnp.asarray(VALID),
        random_inv_sign=jnp.asarray(sign), impl="xla"))
    skip = _near_ties(xyz, 9, False, True, VALID)
    assert skip.mean() <= 2e-3
    np.testing.assert_allclose(got[~skip], want[~skip], atol=UMB_ATOL, rtol=0)
    # the composition route applies the sign inside cal_normal: the same
    np.testing.assert_array_equal(
        got, t_umbrella_features(_t(xyz), 9, valid=_t(VALID), random_inv_sign=_t(sign),
                                 style="seg", return_dist=return_dist,
                                 impl="composition").numpy())
