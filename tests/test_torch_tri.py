"""The port's triangular RepSurf (the geometry helpers it brings,
nn/triangular.SurfaceConstructor, repsurf_ssg_tri, its trainer and CLI)
against the JAX package on the CPU.

Coordinates lie on a 2^-10 grid in [-1, 1]: squared distances and cross
products are then exact in float32 in both frameworks, so the k = 3
triangles agree exactly, ties included (both take the lowest index), and
only the continuous arithmetic is left to the tolerances.  The constructor's
clouds hold degenerate triangles on purpose: points on a line and points
stored three times.  The classifier's clouds lie in [-0.5, 0.5] (a 2^-11
grid): at 128 points in [-1, 1] most of SA1's radius-0.2 balls hold their
center alone, so the position branch's train-mode BN normalises nearly
constant channels and amplifies rounding (5.2e-4 at ``sa1.bn_l0`` from
bit-equal inputs on the train step's input, 3.2e-5 in [-0.5, 0.5];
tests/probe_torch_families.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repsurf_torch.geometry.polar import xyz2cylind as t_xyz2cylind
from repsurf_torch.geometry.surface import cal_area as t_cal_area
from repsurf_torch.geometry.surface import pca as t_pca
from repsurf_torch.geometry.surface import repair_invalid_points as t_repair
from repsurf_torch.models import _REGISTRY, RepSurfClassifier
from repsurf_torch.models import get_model as t_get_model
from repsurf_torch.nn.triangular import SurfaceConstructor
from repsurf_torch.ops.kernels.knn import knn_plain
from repsurf_torch.train import train_cls as ttc
from repsurf_torch.train.jax_params import mapping_for, state_dict_from_flax
from repsurf_tpu.geometry.polar import xyz2cylind as j_xyz2cylind
from repsurf_tpu.geometry.surface import cal_area as j_cal_area
from repsurf_tpu.geometry.surface import cal_normal as j_cal_normal
from repsurf_tpu.geometry.surface import pca as j_pca
from repsurf_tpu.geometry.surface import repair_invalid_points as j_repair
from repsurf_tpu.models import get_model as j_get_model
from repsurf_tpu.nn.triangular import SurfaceConstructor as JSurfaceConstructor
from repsurf_tpu.nn.triangular import knn_recons as j_knn_recons
from repsurf_tpu.train import optim as jopt
from repsurf_tpu.train import train_cls as jtc
from repsurf_tpu.train.torch_import import import_torch_checkpoint

from .test_torch_model import NARROW, _random_variables
from .test_torch_seg import _as_dict, _grid, _t
from .test_train_parity import _assert_update_parity

torch.set_num_threads(1)

GEO_ATOL = 1e-5  # atan2 / sqrt / SVD chains
TRI_ATOL = 1e-5  # triangle normal, centroid, plane constant
LOGP_ATOL = 1e-4  # log-probs after ~12 f32 layers
TRAIN_LOGP_ATOL = 1e-3  # train mode: BN batch statistics in each framework's order
TRI = "repsurf.repsurf_ssg_tri"


def _cloud(seed, shape):
    """Points on a 2^-11 grid in [-0.5, 0.5]."""
    return _grid(seed, shape) * 0.5


def test_xyz2cylind_matches_jax():
    rs = np.random.RandomState(0)
    xyz = (rs.randn(4, 300, 3) * 0.8).astype(np.float32)  # some |xy| > 1 and |z| > 1: clipped
    xyz[0, :5, :2] = 0.0  # on the axis
    for normalize in (True, False):
        got = t_xyz2cylind(_t(xyz), normalize=normalize).numpy()
        want = np.asarray(j_xyz2cylind(jnp.asarray(xyz), normalize=normalize))
        np.testing.assert_allclose(got, want, atol=GEO_ATOL, rtol=0)
    assert got[..., 0].max() == 1.0 and np.abs(got[..., 2]).max() == 1.0


def test_cal_area_matches_jax():
    tri = _grid(1, (2, 50, 3, 3))
    tri[0, :5, 2] = tri[0, :5, 1]  # two vertices equal: zero area
    got = t_cal_area(_t(tri)).numpy()
    want = np.asarray(j_cal_area(jnp.asarray(tri)))
    assert got.shape == (2, 50, 1) and (got[0, :5] == 0).all()
    np.testing.assert_allclose(got, want, atol=GEO_ATOL, rtol=0)


@pytest.mark.parametrize("center", [True, False])
def test_pca_matches_jax(center):
    """Explained variances, and the components up to each one's sign,
    which an SVD leaves open."""
    rs = np.random.RandomState(2)
    x = (rs.randn(200, 3) @ np.diag([1.0, 0.5, 0.2]) + 0.3).astype(np.float32)
    got, want = t_pca(_t(x), 2, center=center), j_pca(jnp.asarray(x), 2, center=center)
    assert got["k"] == want["k"] == 2 and torch.equal(got["x"], _t(x))
    np.testing.assert_allclose(got["explained_variance"].numpy(),
                               np.asarray(want["explained_variance"]), atol=GEO_ATOL, rtol=0)
    gc, wc = got["components"].numpy(), np.asarray(want["components"])
    assert gc.shape == wc.shape == (3, 2)
    np.testing.assert_allclose(gc * np.sign((gc * wc).sum(0)), wc, atol=GEO_ATOL, rtol=0)


def test_repair_invalid_points_matches_jax():
    rs = np.random.RandomState(3)
    bad = rs.rand(3, 40) < 0.3
    bad[1, :7] = True  # the first good point is past point 6
    bad[2, :] = True  # none good: point 0
    tensors = [rs.randn(3, 40, 3).astype(np.float32), rs.randn(3, 40, 1).astype(np.float32)]
    got = t_repair(_t(bad), *(_t(t) for t in tensors))
    want = j_repair(jnp.asarray(bad), *(jnp.asarray(t) for t in tensors))
    first = np.argmax(~bad[1])
    assert first >= 7
    for g, w, t in zip(got, want, tensors):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(g.numpy()[1, bad[1]],
                                      np.broadcast_to(t[1, first], g[1, bad[1]].shape))


def _degenerate_cloud():
    """Two samples of 400 points on the grid; sample 1 starts with 24
    points on a line (each point's triangle collinear, so its first valid
    point is bad) and is padded to 350; sample 0 holds 30 points stored
    three times (triangles of one vertex)."""
    xyz = _grid(4, (2, 400, 3))
    xyz[0, 340:370] = xyz[0, :30]
    xyz[0, 370:400] = xyz[0, :30]
    line = np.arange(24, dtype=np.float32) * 4 / 1024 - 0.5
    xyz[1, :24] = np.stack([line, np.full(24, 0.25), np.full(24, -0.75)], axis=-1)
    return xyz, np.array([400, 350], np.int32)


@pytest.mark.parametrize("return_dist", [False, True], ids=["no_dist", "dist"])
@pytest.mark.parametrize("inversion", ["none", "drawn"])
def test_surface_constructor_matches_jax(return_dist, inversion):
    """The triangular constructor on the degenerate cloud, with no
    inversion and with a per-sample draw that inverts one sample of two:
    every live row within TRI_ATOL, every repaired normal a unit vector."""
    xyz, valid = _degenerate_cloud()
    jm = JSurfaceConstructor(return_dist=return_dist, random_inv=inversion == "drawn")
    sign = None
    for seed in range(32):  # the first key that draws both signs
        rngs = {"random_inv": jax.random.PRNGKey(seed)} if inversion == "drawn" else {}
        parts = jm.apply({}, jnp.asarray(xyz), valid=jnp.asarray(valid), rngs=rngs)
        want = np.concatenate([np.asarray(p) for p in parts], axis=-1)
        if inversion == "none":
            break
        top = np.abs(want[..., 0]).argmax(-1)
        sign = np.sign(want[np.arange(2), top, 0]).astype(np.float32)
        if sign[0] != sign[1]:
            break
    assert inversion == "none" or sign[0] != sign[1]
    got = SurfaceConstructor(return_dist=return_dist)(
        _t(xyz), valid=_t(valid), inv_sign=None if sign is None else _t(sign)).numpy()
    assert got.shape == (2, 400, 7 if return_dist else 6)
    # the cloud's degenerate triangles, sample 1's first point among them
    group = j_knn_recons(3, jnp.asarray(xyz), jnp.asarray(xyz), valid=jnp.asarray(valid))
    _, bad = j_cal_normal(group)
    live = np.arange(400)[None] < valid[:, None]
    bad = np.asarray(bad) & live
    assert bad[0].sum() >= 90 and bad[1, :24].all()
    np.testing.assert_allclose(np.linalg.norm(got[..., :3], axis=-1)[live], 1.0, atol=1e-5)
    np.testing.assert_array_equal(got[1, :24], np.broadcast_to(got[1, 24], (24, got.shape[-1])))
    np.testing.assert_allclose(got[live], want[live], atol=TRI_ATOL, rtol=0)
    # torch's kNN, itself included, is JAX's on the grid
    idx, _ = knn_plain(3, _t(xyz), _t(xyz), valid=_t(valid))
    assert (idx[..., 0].numpy()[~bad & live] == np.nonzero(~bad & live)[1]).all()


# ---- the classifier -----------------------------------------------------


@pytest.fixture(scope="module")
def narrow_tri():
    """(JAX model without inversion, its variables, the port's model with
    those weights)."""
    jm = j_get_model(TRI, random_inv=False, **NARROW)
    variables = _random_variables(jm, 128, 5)
    tm = t_get_model(TRI, **NARROW)
    tm.load_state_dict(state_dict_from_flax(variables), strict=True)
    return jm, variables, tm


def test_full_width_parameter_count_matches_jax():
    """build_model of both trainers on the same ClsConfig."""
    cfg = dict(model=TRI)
    jm = jtc.build_model(jtc.ClsConfig(**cfg))
    want = sum(x.size for x in jax.tree_util.tree_leaves(_random_variables(jm, 32, 0)["params"]))
    tm = ttc.build_model(ttc.ClsConfig(**cfg), generator=torch.Generator().manual_seed(0))
    assert sum(p.numel() for p in tm.parameters()) == want == 1475087
    assert tm.sa1.mlp_f0.in_features == 7 and tm.sa2.mlp_f0.in_features == 7 + 128
    assert not list(tm.surface_constructor.parameters())


def test_mapping_round_trips_and_copies(narrow_tri):
    _, variables, _ = narrow_tri
    tm = t_get_model(TRI, generator=torch.Generator().manual_seed(3), **NARROW)
    sd = {k: v.numpy() for k, v in tm.state_dict().items()}
    entries = mapping_for(variables["params"])
    assert not any(name.startswith("surface_constructor") for _, _, name in entries)
    back = state_dict_from_flax(import_torch_checkpoint(sd, variables, entries))
    assert sorted(back) == sorted(sd)
    for k in sd:
        np.testing.assert_array_equal(back[k].numpy(), sd[k], err_msg=k)
    copied = state_dict_from_flax(variables)
    kernel = variables["params"]["classifier"]["Linear_2"]["kernel"]
    old = kernel[0, 0].copy()
    kernel[0, 0] = 1000.0
    assert copied["classfier.8.weight"][0, 0] == old
    kernel[0, 0] = old


@pytest.mark.parametrize("return_dist", [True, False], ids=["dist", "no_dist"])
def test_eval_logprobs_match_jax(narrow_tri, return_dist):
    jm, variables, tm = narrow_tri
    if not return_dist:
        jm = j_get_model(TRI, random_inv=False, return_dist=False, **NARROW)
        variables = _random_variables(jm, 128, 6)
        tm = t_get_model(TRI, return_dist=False, **NARROW)
        tm.load_state_dict(state_dict_from_flax(variables), strict=True)
    pts = _cloud(7, (2, 128, 3))
    want = np.asarray(jm.apply(variables, jnp.asarray(pts), train=False))
    with torch.no_grad():
        got = tm.eval()(_t(pts)).numpy()
    assert got.shape == (2, 15)
    np.testing.assert_allclose(got, want, atol=LOGP_ATOL, rtol=0)


def test_train_forward_and_batch_statistics_match_jax(narrow_tri):
    """Training mode (dropout off): BN batch statistics, then every
    running statistic."""
    _, variables, _ = narrow_tri
    pts = _cloud(8, (2, 128, 3))
    tm = t_get_model(TRI, head_dropout=0.0, **NARROW)
    tm.load_state_dict(state_dict_from_flax(variables), strict=True)
    jm = j_get_model(TRI, random_inv=False, head_dropout=0.0, **NARROW)
    want, mut = jm.apply(variables, jnp.asarray(pts), train=True, mutable=["batch_stats"])
    with torch.no_grad():
        got = tm.train()(_t(pts)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=TRAIN_LOGP_ATOL, rtol=0)
    stats = state_dict_from_flax({"params": variables["params"],
                                  "batch_stats": _as_dict(mut["batch_stats"])})
    sd = tm.state_dict()
    names = [k for k in stats if k.endswith(("running_mean", "running_var"))]
    assert names
    for k in names:
        np.testing.assert_allclose(sd[k].numpy(), stats[k].numpy(), atol=1e-5, rtol=1e-5,
                                   err_msg=k)


def test_train_step_matches_jax():
    """One SGD step (lr 0.01, no momentum, dropout 0, no inversion) of both
    trainers from the same weights, FPS 256 -> 128 included; the update
    contract of tests/test_train_parity.py."""
    jm = j_get_model(TRI, head_dropout=0.0, random_inv=False, **NARROW)
    variables = _random_variables(jm, 128, 12)
    pre = {"params": variables["params"], "batch_stats": variables["batch_stats"]}
    points = _cloud(13, (2, 256, 3))
    target = np.array([3, 11])
    kw = dict(model=TRI, num_point=128, batch_size=2, optimizer="SGD", learning_rate=0.01,
              momentum=0.0, head_dropout=0.0)
    state = jtc.ClsTrainState.create(apply_fn=jm.apply, params=variables["params"],
                                     tx=jopt.make_sgd(0.01, momentum=0.0),
                                     batch_stats=variables["batch_stats"])
    state, jloss, jcorrect = jtc.train_step(state, jnp.asarray(points), jnp.asarray(target),
                                            jax.random.PRNGKey(0), jtc.ClsConfig(**kw))
    jax_post = {"params": _as_dict(state.params), "batch_stats": _as_dict(state.batch_stats)}

    cfg = ttc.ClsConfig(**kw)
    tm = t_get_model(TRI, head_dropout=0.0, **NARROW)
    tm.load_state_dict(state_dict_from_flax(pre), strict=True)
    opt = ttc.make_optimizer(tm, cfg)
    loss, correct = ttc.train_step(tm, opt, _t(points), _t(target), cfg, signs=torch.ones(2))
    assert abs(float(loss) - float(jloss)) < 1e-4
    assert int(correct) == int(jcorrect)
    sd = {k: v.numpy() for k, v in tm.state_dict().items()}
    port_post = import_torch_checkpoint(sd, jax.tree_util.tree_map(np.copy, pre),
                                        mapping_for(pre["params"]))
    _assert_update_parity(pre, jax_post, port_post, rtol=5e-2, median_rtol=2e-2,
                          label="tri sgd ")


def test_inversion_flips_the_normals_of_its_samples():
    """inv_sign = (-1, 1) negates sample 0's surface normals (and, with
    the plane constant, that constant) and leaves sample 1's as they are."""
    xyz, valid = _degenerate_cloud()
    sc = SurfaceConstructor(return_dist=True)
    plain = sc(_t(xyz), valid=_t(valid))
    flipped = sc(_t(xyz), valid=_t(valid), inv_sign=torch.tensor([-1.0, 1.0]))
    assert torch.equal(flipped[0, :, :3], -plain[0, :, :3])
    assert torch.equal(flipped[0, :, 6], -plain[0, :, 6])
    assert torch.equal(flipped[0, :, 3:6], plain[0, :, 3:6]) and torch.equal(flipped[1], plain[1])


def test_cli_trains_and_votes_with_the_triangular_model(tmp_path, monkeypatch):
    """``cli/train_cls.main`` with ``--model repsurf.repsurf_ssg_tri``
    (narrow) at batch 8, 64 points, 2 epochs with vote evaluation."""
    from repsurf_torch.cli import train_cls as cli

    monkeypatch.setitem(_REGISTRY, TRI, lambda num_class=15, **kw: RepSurfClassifier(
        num_class, constructor="triangular", **kw, **NARROW))
    cli.main(["--synthetic", "--batch_size", "8", "--num_point", "64", "--min_val", "0",
              "--device", "cpu", "--model", TRI, "--epoch", "2", "--log_root", str(tmp_path)])
    run = tmp_path / "ScanObjectNN" / "default"
    log = (run / "logs" / "train_cls.txt").read_text()
    assert log.count("vote ") == 2 and "done" in log and TRI in log
    saved = torch.load(run / "checkpoints" / "best.pt", weights_only=True)
    assert saved["epoch"] in (1, 2) and not any(k.startswith("surface_constructor")
                                                for k in saved["model"])
