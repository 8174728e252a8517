"""The port's classification training slice (loss, augmentations,
optimizers, the ball-group backward and row grouping, the umbrella
gradient, the train step, checkpoints and the CLI) against the JAX package
on the CPU.

Coordinates lie on a 2^-10 grid where selections must agree: squared
distances are then exact in float32 in both frameworks, whichever form
each uses, so ball and kNN selections agree exactly.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repsurf_torch.data.transforms import transform_point_cloud
from repsurf_torch.models import _REGISTRY, RepSurfClassifier
from repsurf_torch.models import get_model as t_get_model
from repsurf_torch.nn.losses import smooth_cls_loss as t_smooth_cls_loss
from repsurf_torch.ops.kernels.ball_group import (
    ball_group_channels,
    ball_group_feature,
    ball_scatter,
    ball_scatter_plain,
    selection_csr,
)
from repsurf_torch.ops.kernels.umbrella import umbrella_features_kernel
from repsurf_torch.ops.neighbors import ball_group as t_ball_group
from repsurf_torch.ops.neighbors import ball_query as t_ball_query
from repsurf_torch.train import optim as topt
from repsurf_torch.train import train_cls as ttc
from repsurf_torch.train.checkpoint import (
    BestCheckpointer,
    apply_train_state,
    train_state_dict,
)
from repsurf_torch.train.jax_params import state_dict_from_flax
from repsurf_tpu.data import transforms as jtr
from repsurf_tpu.geometry.umbrella import umbrella_features as j_umbrella_features
from repsurf_tpu.models import get_model as j_get_model
from repsurf_tpu.nn.losses import smooth_cls_loss as j_smooth_cls_loss
from repsurf_tpu.ops.pallas import ball_group as jbg
from repsurf_tpu.train import optim as jopt
from repsurf_tpu.train import train_cls as jtc
from repsurf_tpu.train.torch_import import cls_umbrella_mapping, import_torch_checkpoint

from .test_torch_kernels_plain import _near_ties
from .test_torch_model import NARROW, _random_variables
from .test_train_parity import _assert_update_parity

torch.set_num_threads(1)

# the ball backward sums cotangents in each framework's own order: held to
# 1e-6 of the sum of the magnitudes of each element's contributions (the
# bound chip_smoke.py holds the kernel to).  Where a point takes a few slots
# that is about rtol/atol 1e-6, JAX's own contract (test_ball_group_pallas.py);
# point 0 takes every slot of an empty ball (64 and more here).
GRAD_TOL = 1e-6


def _assert_scatter_close(got, want, sel, w, coff=0):
    n = got.shape[1]
    bound = ball_scatter_plain(sel, torch.from_numpy(np.abs(w)).double(), n, coff).numpy()
    err = np.abs(got - want)
    assert (err <= GRAD_TOL * np.maximum(bound, 1.0)).all(), float(
        (err / np.maximum(bound, 1.0)).max())


def _grid(seed, shape, scale=1.0):
    rs = np.random.RandomState(seed)
    return (np.round((rs.rand(*shape) * 2 - 1) * scale * 1024) / 1024).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def test_smooth_cls_loss_matches_jax():
    rs = np.random.RandomState(0)
    logp = np.log(rs.dirichlet(np.ones(15), size=6)).astype(np.float32)
    target = rs.randint(0, 15, 6)
    got = float(t_smooth_cls_loss(_t(logp), _t(target)))
    want = float(j_smooth_cls_loss(jnp.asarray(logp), jnp.asarray(target)))
    assert abs(got - want) <= 1e-6 * abs(want)


@pytest.mark.parametrize("aug_scale,aug_shift", [(True, False), (False, True), (True, True)])
def test_augmentations_with_injected_draws_match_jax(aug_scale, aug_shift):
    """The JAX transform's own draws (replayed from its key splits) fed to
    the port give the same clouds."""
    pts = np.random.RandomState(1).randn(4, 50, 3).astype(np.float32)
    key = jax.random.PRNGKey(3)
    want = np.asarray(jtr.transform_point_cloud(key, jnp.asarray(pts), aug_scale, aug_shift))
    draws = []
    for on in (aug_scale, aug_shift):
        if on:
            key, sub = jax.random.split(key)
            draws.append(_t(jax.random.uniform(sub, (4, 1, 3))))
        else:
            draws.append(None)
    got = transform_point_cloud(_t(pts), aug_scale=aug_scale, aug_shift=aug_shift,
                                uniforms=tuple(draws)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    # off by default: the identity, nothing drawn
    assert transform_point_cloud(_t(pts)).equal(_t(pts))


def _run_jax(tx, grads, params, lr_fn):
    p = {k: jnp.asarray(v) for k, v in params.items()}
    st = tx.init(p)
    history = []
    for e, g in enumerate(grads):
        st = jopt.set_lr(st, lr_fn(e))
        updates, st = tx.update({k: jnp.asarray(v) for k, v in g.items()}, st, p)
        p = jax.tree_util.tree_map(lambda a, b: a + b, p, updates)
        history.append({k: np.asarray(v) for k, v in p.items()})
    return history


def _run_port(make, grads, params, lr_fn):
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = make(list(tp.values()))
    history = []
    for e, g in enumerate(grads):
        topt.set_lr(opt, lr_fn(e))
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
        history.append({k: v.detach().numpy().copy() for k, v in tp.items()})
    return history


@pytest.mark.parametrize("kind", ["adam", "sgd"])
def test_optimizers_and_step_lr_match_jax_over_50_steps(kind):
    """A shared gradient sequence through the port's optimizer and the JAX
    package's, the StepLR quirk applied each step as an epoch; the contract
    of tests/test_optim_parity.py."""
    rs = np.random.RandomState(0)
    shapes = {"w1": (7, 5), "b1": (5,), "w2": (5, 3), "scale": (3,)}
    params = {k: rs.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rs.randn(*s).astype(np.float32) for k, s in shapes.items()}
             for _ in range(50)]
    assert [topt.step_lr(1e-3, 8)(e) for e in range(50)] == [
        jopt.step_lr(1e-3, 8)(e) for e in range(50)]
    if kind == "adam":
        lr_fn = topt.step_lr(1e-3, decay_step=8, gamma=0.7)
        ours = _run_port(lambda p: topt.make_adam(p, 1e-3, 1e-4), grads, params, lr_fn)
        ref = _run_jax(jopt.make_adam(1e-3, 1e-4), grads, params, lr_fn)
    else:
        lr_fn = topt.step_lr(0.05, decay_step=8, gamma=0.7)
        ours = _run_port(lambda p: topt.make_sgd(p, 0.05, momentum=0.9, weight_decay=1e-4),
                         grads, params, lr_fn)
        ref = _run_jax(jopt.make_sgd(0.05, momentum=0.9, weight_decay=1e-4), grads, params,
                       lr_fn)
    for e, (a, b) in enumerate(zip(ours, ref)):
        for k in a:
            np.testing.assert_allclose(a[k], b[k], atol=2e-6, rtol=0, err_msg=f"step {e} {k}")


def _ball_case(seed, n_feat, b=2, n=100, m=30):
    """Grid points, queries from the cloud plus far ones (empty balls), a
    padded sample, normal and feature channels."""
    rs = np.random.RandomState(seed)
    xyz = _grid(seed, (b, n, 3))
    q = np.concatenate([xyz[:, : m - 4], xyz[:, :4] + 8.0], axis=1)  # 4 empty balls
    valid = np.array([n, 40], np.int32)
    tensors = [xyz, rs.randn(b, n, 10).astype(np.float32)]
    if n_feat:
        tensors.append(rs.randn(b, n, n_feat).astype(np.float32))
    return xyz, q, valid, tensors


@pytest.mark.parametrize("n_feat", [0, 128])  # C = 13 and C = 141
def test_ball_feature_backward_matches_jax_grad(n_feat):
    """The plain route's autograd (the CPU wrapper), the backward's plain
    version and jax.grad through _ball_feat_ad agree; radius 0.3 and S = 16
    leave most balls short, four are empty, one sample is padded."""
    xyz, q, valid, tensors = _ball_case(10 + n_feat, n_feat)
    s, c = 16, sum(t.shape[-1] for t in tensors)
    w = np.random.RandomState(2).randn(2, q.shape[1], s, c - 3).astype(np.float32)
    rest = [_t(t).requires_grad_(True) for t in tensors[1:]]
    _, feat = ball_group_feature(0.3, s, _t(xyz), _t(q), [_t(xyz), *rest], valid=_t(valid),
                                 return_polar=True)
    (feat * _t(w)).sum().backward()
    got = torch.cat([t.grad for t in rest], dim=-1).numpy()

    def loss(rest_cat):
        cat = jnp.concatenate([jnp.asarray(xyz), rest_cat], axis=-1)
        pos, f = jbg._ball_feat_ad(0.3, s, True, jnp.float32, jnp.asarray(xyz),
                                   jnp.asarray(q), cat, jnp.asarray(valid))
        return jnp.sum(f * w) + jnp.sum(pos) * 0.0

    want = np.asarray(jax.grad(loss)(jnp.asarray(np.concatenate(tensors[1:], -1))))
    sel = t_ball_query(0.3, s, _t(xyz), _t(q), valid=_t(valid))
    _assert_scatter_close(got, want, sel, w)
    d2 = ((xyz[:, None] - q[:, :, None]) ** 2).sum(-1)  # exact on the grid
    hits = ((d2 <= np.float32(0.3**2)) & (np.arange(xyz.shape[1]) < valid[:, None, None])).sum(-1)
    assert ((hits > 0) & (hits < s)).any() and (hits == 0).sum() == 8
    plain = ball_scatter(sel, _t(w), xyz.shape[1], coff=3).numpy()  # CPU: the plain version
    assert (plain[..., :3] == 0).all()
    _assert_scatter_close(plain[..., 3:], want, sel, w)


def test_ball_scatter_csr_order_gives_the_sequential_sum():
    """The backward kernel's algorithm replayed in numpy over
    ``selection_csr``: each point's slots in ascending (m, s) order, summed
    in float32 one after another, as one kernel thread does; equal to the
    float64 scatter-add within the rounding of the sum, duplicates (short
    and empty balls) and padded points included."""
    xyz, q, valid, _ = _ball_case(3, 0)
    n, s = xyz.shape[1], 16
    sel = t_ball_query(0.3, s, _t(xyz), _t(q), valid=_t(valid))
    g = np.random.RandomState(4).randn(*sel.shape, 5).astype(np.float32)
    order, starts = selection_csr(sel, n)
    order, starts = order.numpy(), starts.numpy()
    flat = sel.numpy().reshape(-1)
    rows = np.repeat(np.arange(2), sel[0].numel()) * n + flat
    gflat = g.reshape(-1, 5)
    replay = np.zeros((2 * n, 5), np.float32)
    for r in range(2 * n):
        run = order[starts[r]:starts[r + 1]]
        assert (rows[run] == r).all() and (np.diff(run) > 0).all()
        for k in run:
            replay[r] += gflat[k]
    assert starts[-1] == flat.size
    ref = ball_scatter_plain(sel, _t(g).double(), n).numpy().reshape(2 * n, 5)
    bound = ball_scatter_plain(sel, _t(np.abs(g)).double(), n).numpy().reshape(2 * n, 5)
    assert (np.abs(replay - ref) <= 1e-6 * bound).all()
    # point 0 of the first sample gathers every slot of the empty balls
    assert (flat.reshape(2, -1, s)[:, -4:] == 0).all()
    assert not np.isin(np.arange(40, n) + n, rows).any()  # padded rows never selected


def test_ball_group_rows_match_pallas_and_its_backward():
    """``ops/neighbors.ball_group`` (the plain version on the CPU) against
    ball_group_pallas in interpret mode, bit for bit, and its gradient
    against _ball_group_bwd."""
    xyz, q, valid, tensors = _ball_case(5, 20)
    s = 16
    out = jbg.ball_group_pallas(0.3, s, jnp.asarray(xyz), jnp.asarray(q),
                                [jnp.asarray(t) for t in tensors], valid=jnp.asarray(valid),
                                interpret=True)
    leaves = [_t(t).requires_grad_(True) for t in tensors]
    got = t_ball_group(0.3, s, _t(xyz), _t(q), [leaves[0], None, *leaves[1:]], valid=_t(valid))
    assert got[1] is None
    got = [got[0], *got[2:]]
    for a, b in zip(got, out):
        np.testing.assert_array_equal(a.detach().numpy(), np.asarray(b))
    tcat = torch.cat([t.detach() for t in leaves], dim=-1)
    np.testing.assert_array_equal(
        ball_group_channels(0.3, s, _t(xyz), _t(q), tcat, valid=_t(valid)).numpy(),
        np.concatenate([np.asarray(b) for b in out], -1))
    w = np.random.RandomState(6).randn(*tcat.shape[:1], q.shape[1], s, tcat.shape[-1])
    w = w.astype(np.float32)
    (torch.cat(got, dim=-1) * _t(w)).sum().backward()
    mine = torch.cat([t.grad for t in leaves], dim=-1).numpy()
    (want,) = [x for x in jbg._ball_group_bwd(
        0.3, s, (jnp.asarray(xyz), jnp.asarray(q), jnp.asarray(valid)), jnp.asarray(w))
        if x is not None]
    sel = t_ball_query(0.3, s, _t(xyz), _t(q), valid=_t(valid))
    _assert_scatter_close(mine, np.asarray(want), sel, w)
    _assert_scatter_close(ball_scatter(sel, _t(w), xyz.shape[1]).numpy(), np.asarray(want),
                          sel, w)


def test_umbrella_gradient_matches_jax_custom_vjp():
    """d(features)/d(xyz): the port's plain composition (the CPU wrapper,
    and the CUDA Function's backward) against jax.grad through
    umbrella_features(impl='pallas'), whose custom VJP is the XLA
    composition's.  The cotangent is zero at azimuth near-tie points, whose
    fans may differ between the frameworks."""
    xyz = _grid(7, (2, 128, 3))
    skip = _near_ties(xyz, 9, None)
    assert skip.mean() <= 1e-2
    w = np.random.RandomState(8).randn(2, 128, 8, 10).astype(np.float32)
    w[skip] = 0.0
    x = _t(xyz).requires_grad_(True)
    (umbrella_features_kernel(x, 9, drop_self=True) * _t(w)).sum().backward()
    got = x.grad.numpy()

    def loss(p):
        feat = j_umbrella_features(p, 9, style="cls", impl="pallas", interpret=True)
        return jnp.sum(feat * w)

    want = np.asarray(jax.grad(loss)(jnp.asarray(xyz)))
    assert np.isfinite(got).all() and np.abs(want).max() > 1.0
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max(), rtol=0)


def test_fps_still_refuses_a_graph_and_the_wrappers_carry_gradients():
    from repsurf_torch.ops.kernels.fps import fps

    xyz = _t(_grid(9, (2, 32, 3))).requires_grad_(True)
    with pytest.raises(NotImplementedError, match="indices"):
        fps(xyz, 4)
    normal = _t(np.ones((2, 32, 10), np.float32)).requires_grad_(True)
    _, feat = ball_group_feature(0.5, 4, xyz.detach(), xyz.detach()[:, :4],
                                 [xyz.detach(), normal])
    feat.sum().backward()
    assert normal.grad is not None and normal.grad.sum() == 2 * 4 * 4 * 10
    umbrella_features_kernel(xyz, 9, drop_self=True).sum().backward()
    assert xyz.grad is not None and torch.isfinite(xyz.grad).all()


def test_narrow_train_step_matches_jax():
    """One SGD step (lr 0.01, no momentum, dropout 0, no inversion) of both
    trainers from the same weights, FPS 256 -> 128 included; the update
    contract of tests/test_train_parity.py."""
    jm = j_get_model("repsurf.repsurf_ssg_umb", head_dropout=0.0, random_inv=False, **NARROW)
    variables = _random_variables(jm, 128, 12)
    pre = {"params": variables["params"], "batch_stats": variables["batch_stats"]}
    points = _grid(13, (2, 256, 3))
    target = np.array([3, 11])
    jcfg = jtc.ClsConfig(num_point=128, batch_size=2, optimizer="SGD", learning_rate=0.01,
                         momentum=0.0, head_dropout=0.0)
    state = jtc.ClsTrainState.create(apply_fn=jm.apply, params=variables["params"],
                                     tx=jopt.make_sgd(0.01, momentum=0.0),
                                     batch_stats=variables["batch_stats"])
    state, jloss, jcorrect = jtc.train_step(state, jnp.asarray(points), jnp.asarray(target),
                                            jax.random.PRNGKey(0), jcfg)
    as_dict = lambda t: {k: as_dict(v) for k, v in t.items()} if hasattr(t, "items") else t  # noqa: E731
    jax_post = {"params": as_dict(state.params), "batch_stats": as_dict(state.batch_stats)}

    cfg = ttc.ClsConfig(num_point=128, batch_size=2, optimizer="SGD", learning_rate=0.01,
                        momentum=0.0, head_dropout=0.0)
    tm = t_get_model("repsurf.repsurf_ssg_umb", head_dropout=0.0, **NARROW)
    tm.load_state_dict(state_dict_from_flax(pre), strict=True)
    opt = ttc.make_optimizer(tm, cfg)
    loss, correct = ttc.train_step(tm, opt, _t(points), _t(target), cfg,
                                   signs=torch.ones(2))
    assert abs(float(loss) - float(jloss)) < 1e-4
    assert int(correct) == int(jcorrect)
    sd = {k: v.numpy() for k, v in tm.state_dict().items()}
    port_post = import_torch_checkpoint(sd, jax.tree_util.tree_map(np.copy, pre),
                                        cls_umbrella_mapping())
    _assert_update_parity(pre, jax_post, port_post, rtol=5e-2, median_rtol=2e-2,
                          label="cls sgd ")


def _narrow_model(seed=0, **kw):
    return t_get_model("repsurf.repsurf_ssg_umb", generator=torch.Generator().manual_seed(seed),
                       **NARROW, **kw)


def test_train_step_draws_from_its_generator_only():
    """Same generator seed, same step; the draws (sign, dropout) differ
    with the seed; nothing reads torch's global generator."""
    cfg = ttc.ClsConfig(num_point=64, batch_size=4)
    points = _t(_grid(14, (4, 128, 3)))
    target = torch.tensor([0, 1, 2, 3])
    results = []
    for seed in (5, 5, 6):
        tm = _narrow_model()
        opt = ttc.make_optimizer(tm, cfg)
        torch.manual_seed(seed * 7)  # must not matter
        loss, _ = ttc.train_step(tm, opt, points, target, cfg,
                                 generator=torch.Generator().manual_seed(seed))
        results.append((float(loss), tm.classfier[0].weight.detach().clone()))
    assert results[0][0] == results[1][0] and torch.equal(results[0][1], results[1][1])
    assert results[0][0] != results[2][0]
    with pytest.raises(ValueError):
        ttc.train_step(_narrow_model(), opt, points, target, cfg)


def test_epoch_lr_and_optimizer_choice_match_jax():
    for epoch in range(0, 120, 7):
        assert ttc.epoch_lr(ttc.ClsConfig(), epoch) == jopt.step_lr(1e-3, 20)(epoch)
    tm = _narrow_model()
    adam = ttc.make_optimizer(tm, ttc.ClsConfig())
    assert isinstance(adam, torch.optim.Adam)
    assert adam.defaults["weight_decay"] == 1e-4 and adam.defaults["lr"] == 1e-3
    sgd = ttc.make_optimizer(tm, ttc.ClsConfig(optimizer="SGD", learning_rate=0.1))
    assert isinstance(sgd, torch.optim.SGD)
    assert sgd.defaults["momentum"] == 0.9 and sgd.defaults["weight_decay"] == 0.0
    assert ttc.build_model(ttc.ClsConfig(umb_pool="max")).surface_constructor.aggr_type == "max"
    with pytest.raises(NotImplementedError):
        ttc.build_model(ttc.ClsConfig(init_type="kaiming"))
    with pytest.raises(ValueError, match="return_center"):
        ttc.build_model(ttc.ClsConfig(return_center=False))


@pytest.mark.parametrize("weights_only", [False, True])
def test_checkpoint_round_trip(tmp_path, weights_only):
    cfg = ttc.ClsConfig(num_point=64, batch_size=4)
    tm = _narrow_model()
    opt = ttc.make_optimizer(tm, cfg)
    ttc.train_step(tm, opt, _t(_grid(15, (4, 128, 3))), torch.tensor([1, 2, 3, 4]), cfg,
                   generator=torch.Generator().manual_seed(0))
    ckpt = BestCheckpointer(tmp_path / "ckpt")
    assert not ckpt.exists()
    assert ckpt.maybe_save(0.5, 3, train_state_dict(tm, opt, 3, 0.5))
    assert not ckpt.maybe_save(0.4, 4, train_state_dict(tm, opt, 4, 0.4))
    assert ckpt.maybe_save(0.5, 5, train_state_dict(tm, opt, 5, 0.5))  # >= saves
    assert ckpt.exists() and os.listdir(tmp_path / "ckpt") == ["best.pt"]

    fresh = _narrow_model(seed=1)
    fresh_opt = ttc.make_optimizer(fresh, cfg)
    start, best = apply_train_state(fresh, fresh_opt, ckpt.restore(), weights_only=weights_only)
    sd, got = tm.state_dict(), fresh.state_dict()
    assert sorted(sd) == sorted(got) and any(k.endswith("running_var") for k in sd)
    for k in sd:
        assert torch.equal(sd[k], got[k]), k
    if weights_only:
        assert (start, best) == (0, 0.0) and not fresh_opt.state
    else:
        assert (start, best) == (5, 0.5)
        a, b = opt.state_dict(), fresh_opt.state_dict()
        assert a["param_groups"] == b["param_groups"]
        for i, st in a["state"].items():
            for k, v in st.items():
                assert torch.equal(v, b["state"][i][k]), (i, k)


def test_cli_trains_evaluates_checkpoints_and_resumes(tmp_path, monkeypatch, capsys):
    """``main()`` at batch 8, 64 points, 2 epochs with vote evaluation from
    epoch 0 (the narrow classifier stands in for the registry's), then a
    resume to epoch 3 that logs its start and trains epoch 3 as an unbroken
    3-epoch run does."""
    from repsurf_torch.cli import train_cls as cli

    monkeypatch.setitem(_REGISTRY, "repsurf.repsurf_ssg_umb",
                        lambda num_class=15, **kw: RepSurfClassifier(num_class, **kw, **NARROW))
    args = ["--synthetic", "--batch_size", "8", "--num_point", "64", "--min_val", "0",
            "--device", "cpu"]
    cli.main([*args, "--epoch", "2", "--log_root", str(tmp_path / "a")])
    run = tmp_path / "a" / "ScanObjectNN" / "default"
    saved = torch.load(run / "checkpoints" / "best.pt", weights_only=True)
    assert saved["epoch"] in (1, 2)
    cli.main([*args, "--epoch", "3", "--log_root", str(tmp_path / "a")])
    cli.main([*args, "--epoch", "3", "--log_root", str(tmp_path / "b")])
    log_a = (run / "logs" / "train_cls.txt").read_text()
    log_b = (tmp_path / "b" / "ScanObjectNN" / "default" / "logs" / "train_cls.txt").read_text()
    assert f"resumed from epoch {saved['epoch']}" in log_a
    assert log_a.count("vote ") == 5 - saved["epoch"] + 1 and "done" in log_a
    last = lambda log: [ln.split("] ", 1)[1] for ln in log.splitlines() if "epoch 3/3" in ln]  # noqa: E731
    assert last(log_a)[-1] == last(log_b)[-1]
    scalars = (run / "logs" / "scalars.jsonl").read_text().splitlines()
    assert len(scalars) == 4 * (2 + 3 - saved["epoch"])
    capsys.readouterr()
