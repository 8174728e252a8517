"""The port's classifier, layers, weight transfer and vote evaluation
against the JAX package, on the CPU."""

import functools
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repsurf_torch.data.transforms import fps_sample, scale_point_cloud
from repsurf_torch.models import get_model as t_get_model
from repsurf_torch.nn.layers import MaskedBatchNorm as TMaskedBatchNorm
from repsurf_torch.train.jax_params import state_dict_from_flax
from repsurf_torch.train.train_cls import ClsConfig, build_model, eval_step
from repsurf_tpu.models import get_model as j_get_model
from repsurf_tpu.nn.layers import MaskedBatchNorm as JMaskedBatchNorm
from repsurf_tpu.train.torch_import import cls_umbrella_mapping, import_torch_checkpoint

torch.set_num_threads(1)

NARROW = dict(
    sa_npoint=(32, 8),
    sa_nsample=(8, 16),
    sa_mlp=((8, 8, 16), (16, 16, 32)),
    final_mlp=(32, 32, 64),
    head_hidden=(32, 16),
)
# log-probs after ~12 f32 layers, two frameworks' matmul and reduction orders
LOGP_ATOL = 1e-4


def _random_variables(model, n_points, seed):
    """A flax {'params', 'batch_stats'} tree of numpy arrays for ``model``,
    drawn with numpy: Linear kernels U(+-1/sqrt(fan_in)), non-trivial BN
    scale/bias and running statistics.  Shapes come from jax.eval_shape, so
    nothing is initialised or compiled."""
    rs = np.random.RandomState(seed)
    shapes = jax.eval_shape(
        functools.partial(model.init, train=False),
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((2, n_points, 3)),
    )

    def draw(path, leaf):
        name = path[-1].key
        if name == "kernel":
            bound = 1.0 / np.sqrt(leaf.shape[0])
            return rs.uniform(-bound, bound, leaf.shape).astype(np.float32)
        if name in ("var", "scale"):
            return rs.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        return (rs.randn(*leaf.shape) * 0.1).astype(np.float32)

    tree = jax.tree_util.tree_map_with_path(draw, shapes)
    as_dict = lambda t: {k: as_dict(v) for k, v in t.items()} if hasattr(t, "items") else t
    return as_dict(tree)


@pytest.fixture(scope="module")
def narrow_pair():
    """(JAX model, its variables, the port's model with those weights)."""
    jm = j_get_model("repsurf.repsurf_ssg_umb", **NARROW)
    variables = _random_variables(jm, 128, 1)
    tm = t_get_model("repsurf.repsurf_ssg_umb", **NARROW)
    tm.load_state_dict(state_dict_from_flax(variables), strict=True)
    return jm, variables, tm.eval()


@pytest.mark.parametrize("variant", [{}, {"umb_pool": "avg"}, {"umb_pool": "max"},
                                     {"return_dist": False}],
                         ids=["sum", "avg", "max", "no_dist"])
def test_narrow_forward_matches_jax(narrow_pair, variant):
    """Logits on transferred weights, for each umbrella pool and without
    the plane constant."""
    jm, variables, tm = narrow_pair
    if variant:
        jm = j_get_model("repsurf.repsurf_ssg_umb", **NARROW, **variant)
        variables = _random_variables(jm, 128, 1)
        tm = t_get_model("repsurf.repsurf_ssg_umb", **NARROW, **variant)
        tm.load_state_dict(state_dict_from_flax(variables), strict=True)
        tm.eval()
    pts = (np.random.RandomState(2).rand(2, 128, 3) * 2 - 1).astype(np.float32)
    want = np.asarray(jm.apply(variables, jnp.asarray(pts), train=False))
    with torch.inference_mode():
        got = tm(torch.from_numpy(pts)).numpy()
    assert got.shape == (2, 15)
    np.testing.assert_allclose(got, want, atol=LOGP_ATOL, rtol=0)


def test_weight_round_trip_is_identity(narrow_pair):
    _, variables, _ = narrow_pair
    tm = t_get_model("repsurf.repsurf_ssg_umb", generator=torch.Generator().manual_seed(3),
                     **NARROW)
    sd = {k: v.numpy() for k, v in tm.state_dict().items()}
    back = state_dict_from_flax(import_torch_checkpoint(sd, variables, cls_umbrella_mapping()))
    assert sorted(back) == sorted(sd)
    for k in sd:
        np.testing.assert_array_equal(back[k].numpy(), sd[k], err_msg=k)


def test_transfer_copies_rather_than_aliases(narrow_pair):
    _, variables, _ = narrow_pair
    sd = state_dict_from_flax(variables)
    kernel = variables["params"]["classifier"]["Linear_2"]["kernel"]
    kernel[0, 0] += 1.0
    assert sd["classfier.8.weight"][0, 0] == kernel[0, 0] - 1.0
    kernel[0, 0] -= 1.0


def test_full_width_parameter_count_matches_jax():
    jm = j_get_model("repsurf.repsurf_ssg_umb")
    variables = _random_variables(jm, 32, 0)
    want = sum(x.size for x in jax.tree_util.tree_leaves(variables["params"]))
    tm = build_model(ClsConfig(), generator=torch.Generator().manual_seed(0))
    assert sum(p.numel() for p in tm.parameters()) == want
    assert abs(want / 1e6 - 1.483) < 0.01


@pytest.mark.parametrize("masked", [False, True])
def test_masked_batchnorm_train_statistics_match_jax(masked):
    rs = np.random.RandomState(4)
    x = (rs.randn(3, 10, 4, 6) * 2 + 1).astype(np.float32)
    valid = np.array([10, 6, 1], np.int32)
    mask = (np.arange(10)[None] < valid[:, None])[:, :, None] if masked else None
    bn = JMaskedBatchNorm()
    v = bn.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want, mut = bn.apply(v, jnp.asarray(x), mask=None if mask is None else jnp.asarray(mask),
                         mutable=["batch_stats"])
    tbn = TMaskedBatchNorm(6).train()
    got = tbn(torch.from_numpy(x), mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5, rtol=0)
    np.testing.assert_allclose(tbn.running_mean.numpy(),
                               np.asarray(mut["batch_stats"]["mean"]), atol=1e-6, rtol=0)
    np.testing.assert_allclose(tbn.running_var.numpy(),
                               np.asarray(mut["batch_stats"]["var"]), atol=1e-5, rtol=0)


def test_eval_step_vote_accumulation(narrow_pair):
    _, _, tm = narrow_pair
    cfg = ClsConfig(num_point=128, batch_size=2, num_votes=3)
    rs = np.random.RandomState(5)
    raw = torch.from_numpy((rs.rand(2, 256, 3) * 2 - 1).astype(np.float32))
    target = torch.tensor([3, 7])
    uniforms = torch.from_numpy(rs.rand(2, 2, 1, 3).astype(np.float32))
    signs = torch.tensor([[1.0, -1.0], [-1.0, -1.0], [1.0, 1.0]])
    s, v, vote_sum = eval_step(tm, raw, target, cfg, uniforms=uniforms, signs=signs)
    with torch.inference_mode():
        pts = fps_sample(raw, 128)
        want, first = 0.0, None
        for i in range(3):
            p = pts if i == 0 else pts * ((uniforms[i - 1] * 2.0 - 1.0) * 0.2 + 1.0)
            logp = tm(p, inv_sign=signs[i])
            first = logp if first is None else first
            want = want + logp
    torch.testing.assert_close(vote_sum, want, atol=0, rtol=0)
    assert int(s) == int((first.argmax(-1) == target).sum())
    assert int(v) == int((want.argmax(-1) == target).sum())
    # drawn from a generator: reproducible from its seed
    a = eval_step(tm, raw, target, cfg, generator=torch.Generator().manual_seed(9))[2]
    b = eval_step(tm, raw, target, cfg, generator=torch.Generator().manual_seed(9))[2]
    torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_scale_point_cloud_matches_jax_formula():
    rs = np.random.RandomState(6)
    pts = rs.randn(4, 20, 3).astype(np.float32)
    u = rs.rand(4, 1, 3).astype(np.float32)
    got = scale_point_cloud(torch.from_numpy(pts), uniforms=torch.from_numpy(u)).numpy()
    want = np.asarray(jnp.asarray(pts) * ((jnp.asarray(u) * 2.0 - 1.0) * 0.2 + 1.0))
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        scale_point_cloud(torch.from_numpy(pts))


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import pkgutil, sys, importlib, repsurf_torch\n"
        "for m in pkgutil.walk_packages(repsurf_torch.__path__, 'repsurf_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'repsurf_tpu'))]\n"
        "assert not bad, bad\n"
        "for name in ('train.train_cls', 'train.train_seg', 'train.optim', 'models.repsurf_seg',\n"
        "             'ops.kernels.knn', 'ops.kernels.knn_window', 'ops.sector', 'ops.interpolate',\n"
        "             'nn.losses', 'nn.metrics', 'data.s3dis', 'data.synthetic_scene',\n"
        "             'data.voxelize', 'train.eval_s3dis', 'cli.test_s3dis'):\n"
        "    assert 'repsurf_torch.' + name in sys.modules, name\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
