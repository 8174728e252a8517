"""The batch norm of repsurf_torch on the CPU: the plain mirrors of the CUDA
kernels (``ops/kernels/batch_norm.py``), which write out the torch
composition's operations and autograd's backward of it, against autograd of
``MaskedBatchNorm``'s composition in float64, bit for bit; the autograd
Function through ``gradcheck``; the mask's row groups; the ReLU fused at the
models' call sites; and a training forward that builds no tensor from a host
number.  The kernels themselves run on the card (``chip_smoke.py``, phase
``batch norm``, element for element against the composition there)."""

import numpy as np
import pytest
import torch
from torch import nn

from repsurf_torch.nn.layers import Dropout, Linear, MaskedBatchNorm, run_layers
from repsurf_torch.ops.kernels import batch_norm as bn
from repsurf_torch.ops.kernels import kernel_launches
from repsurf_torch.train import train_cls, train_seg

MOMENTUM, EPS = 0.1, 1e-5


def _inputs(shape, mask_shape, seed, counted=None):
    """x (float64, rows of unit spread around 3), a bool mask (about 2/3 of
    its entries true, or exactly the first ``counted`` entries), the affine
    parameters and running buffers, and a gradient of the output."""
    g = torch.Generator().manual_seed(seed)
    c = shape[-1]
    x = torch.randn(shape, generator=g, dtype=torch.float64) + 3.0
    mask = None
    if mask_shape is not None:
        if counted is None:
            mask = torch.rand(mask_shape, generator=g) < 0.67
        else:
            mask = (torch.arange(int(np.prod(mask_shape))) < counted).reshape(mask_shape)
    weight = torch.rand(c, generator=g, dtype=torch.float64) + 0.5
    bias = torch.randn(c, generator=g, dtype=torch.float64) * 0.5
    rm = torch.randn(c, generator=g, dtype=torch.float64)
    rv = torch.rand(c, generator=g, dtype=torch.float64) + 0.5
    grad = torch.randn(shape, generator=g, dtype=torch.float64)
    return x, mask, weight, bias, rm, rv, grad


def _composition(x, mask, weight, bias, rm, rv, grad, relu):
    """Autograd of the module's composition (its CPU route): (mean, var,
    y, dx, dweight, dbias, running_mean, running_var)."""
    m = MaskedBatchNorm(x.shape[-1]).double().train()
    with torch.no_grad():
        m.weight.copy_(weight)
        m.bias.copy_(bias)
        m.running_mean.copy_(rm)
        m.running_var.copy_(rv)
    xr = x.clone().requires_grad_(True)
    y = m(xr, mask=mask, relu=relu)
    y.backward(grad)
    # the statistics the composition normalised with, by its own formula
    axes = tuple(range(x.ndim - 1))
    if mask is None:
        w, cnt = 1.0, float(np.prod(x.shape[:-1]))
    else:
        mk = mask[..., 0] if mask.ndim == x.ndim else mask
        w = torch.broadcast_to(mk, x.shape[:-1]).to(x.dtype)[..., None]
        cnt = float(w.sum())
    cnt = max(cnt, 1.0)
    mean = (x * w).sum(axes) / cnt
    var = ((x - mean) ** 2 * w).sum(axes) / cnt
    return (mean, var, y.detach(), xr.grad, m.weight.grad, m.bias.grad, m.running_mean,
            m.running_var)


def _mirrors(x, mask, weight, bias, rm, rv, grad, relu):
    groups, s = bn.row_groups(mask, x.shape[:-1])
    rm, rv = rm.clone(), rv.clone()
    mean, invstd, count = bn.batch_norm_stats_plain(x, groups, s, rm, rv, MOMENTUM, EPS)
    y = bn.batch_norm_normalize_plain(x, mean, invstd, False, EPS, weight, bias, relu)
    dx, dweight, dbias = bn.batch_norm_backward_plain(grad, x, groups, s, mean, invstd, False,
                                                      EPS, weight, bias, count, relu)
    var = invstd.pow(-2) - EPS
    return mean, var, y, dx, dweight, dbias, rm, rv


def _close(got, want, name, tol=0.0):
    """Equal (tol 0), or within tol of want's largest magnitude."""
    scale = max(float(want.abs().max()), 1e-300)
    assert float((got - want).abs().max()) <= tol * scale, name


NAMES = ("mean", "var", "y", "dx", "dweight", "dbias", "running_mean", "running_var")


def _check_mirrors(shape, mask_shape, relu, seed, counted=None):
    args = _inputs(shape, mask_shape, seed, counted)
    want = _composition(*args, relu)
    got = _mirrors(*args, relu)
    for name, a, b in zip(NAMES, got, want):
        # var comes back from invstd: float64 rounding of rsqrt and its square
        _close(a, b, name, tol=1e-9 if name == "var" else 0.0)


@pytest.mark.parametrize("relu", [False, True], ids=["plain", "relu"])
@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("layout", ["BNC", "BNSC"])
@pytest.mark.parametrize("c", [3, 4, 10, 32, 512])
def test_mirrors_match_autograd_of_the_composition(c, layout, masked, relu):
    """Statistics, output, dx, dweight, dbias and the running buffers of
    the plain mirrors equal to autograd of the module's composition in
    float64: [B, N, C] with a [B, N, 1] mask, [B, N, S, C] with a [B, N, 1]
    mask broadcast over the S neighbours."""
    shape = (2, 7, c) if layout == "BNC" else (2, 5, 4, c)
    _check_mirrors(shape, shape[:2] + (1,) if masked else None, relu, seed=c)


@pytest.mark.parametrize("counted", [0, 1, 2, 3])
@pytest.mark.parametrize("layout", ["BNC", "BNSC"])
def test_mirrors_at_few_counted_rows(counted, layout):
    """1, 2 and 3 counted rows (a [B, N, 1] mask over [B, N, S, C] counts S
    rows an entry), and none, where the count is clamped to 1 and the mean
    and variance are 0."""
    shape = (2, 5, 6) if layout == "BNC" else (2, 5, 4, 6)
    _check_mirrors(shape, (2, 5, 1), relu=True, seed=counted, counted=counted)


def test_mirrors_with_a_sample_without_valid_rows():
    """The second sample has no valid row: it counts nothing, and its
    outputs still feed every gradient."""
    mask = torch.zeros(2, 6, 1, dtype=torch.bool)
    mask[0, :4] = True
    args = list(_inputs((2, 6, 16, 8), None, seed=7))
    args[1] = mask
    want = _composition(*args, True)
    for name, a, b in zip(NAMES, _mirrors(*args, True), want):
        _close(a, b, name, tol=1e-9 if name == "var" else 0.0)


@pytest.mark.parametrize("mask_shape,shape,groups,rows", [
    ((2, 5, 1), (2, 5, 16, 3), 10, 16),  # PT's attention: one entry a point
    ((2, 5, 1), (2, 5, 3), 10, 1),  # the module's [..., 1] form, dropped
    ((2, 5), (2, 5, 7), 10, 1),
    ((2, 1, 1), (2, 5, 4, 3), 2, 20),  # a sample's flag over all its rows
    ((1, 5), (2, 5, 3), 10, 1),  # broadcast over a leading axis: every row
])
def test_row_groups(mask_shape, shape, groups, rows):
    mask = torch.rand(mask_shape, generator=torch.Generator().manual_seed(0)) < 0.5
    got, s = bn.row_groups(mask, shape[:-1])
    assert (got.shape, s, got.dtype, got.is_contiguous()) == ((groups,), rows, torch.bool, True)
    lead = shape[:-1]
    m = mask[..., 0] if mask.ndim == len(shape) else mask
    want = torch.broadcast_to(m, lead).reshape(-1)
    assert torch.equal(got.repeat_interleave(s), want)
    assert bn.row_groups(None, lead) == (None, 1)


@pytest.fixture
def entry_points(monkeypatch):
    """The Function's kernel entry points, replaced by the plain mirrors
    (which is what they run on the CPU), each call recorded."""
    calls = []

    def recorded(name, fn):
        def call(*a):
            calls.append(name)
            return fn(*a)
        return call

    monkeypatch.setattr(bn, "batch_norm_stats", recorded("stats", bn.batch_norm_stats_plain))
    monkeypatch.setattr(bn, "batch_norm_normalize",
                        recorded("normalize", bn.batch_norm_normalize_plain))
    monkeypatch.setattr(bn, "batch_norm_backward",
                        recorded("backward", bn.batch_norm_backward_plain))
    return calls


@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("relu", [False, True], ids=["plain", "relu"])
@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_function_passes_gradcheck(entry_points, masked, relu, training):
    """``batch_norm``'s autograd Function, its backward written out,
    against finite differences of the whole function (the statistics
    recomputed from each perturbed x) in x, weight and bias."""
    x, mask, weight, bias, rm, rv, _ = _inputs((2, 4, 3, 5), (2, 4, 1) if masked else None,
                                               seed=11)
    x, weight, bias = (t.clone().requires_grad_(True) for t in (x, weight, bias))

    def fn(x, weight, bias):
        return bn.batch_norm(x, weight, bias, rm.clone(), rv.clone(), mask, training, MOMENTUM,
                             EPS, relu)

    assert torch.autograd.gradcheck(fn, (x, weight, bias), eps=1e-6, atol=1e-7, rtol=1e-6)
    want = ["stats"] * training + ["normalize"]
    assert entry_points[:len(want)] == want and "backward" in entry_points


# The models' forward and gradient checksums at tiny sizes before the ReLU
# was fused into the norms (the parent tree, torch 2.13 on the CPU, one
# thread): the projection of the output on fixed noise, of every gradient
# on fixed noise, the buffers' sum after the step, and the state dict's
# keys (a hash of their sorted list, and their count).
BEFORE = {
    "repsurf.repsurf_umb_ssg": (-208.50276905636417, 55513.23117146797, 4699.2210818119,
                                "de02ab58dfeff63f", 184, -3.7963898898650745),
    "pointnet2.pointnet2_ssg": (253.73875003970164, -129733.69348493565, 3502.9963560009783,
                                "299696278b06e612", 134, 25.222536113812126),
    "pointtransformer.pointtransformer": (-91.20712334146305, -147785.99220759823,
                                          17041.158654193066, "fe0b2cf545b51c8e", 809,
                                          -28.452880186487928),
    "repsurf.repsurf_ssg_umb": (-1.9033511187575187, -1665.0266256212035, 3478.4286125844665,
                                "581a31c459f895af", 99, None),
}


def _noise(t, seed):
    return torch.randn(t.shape, generator=torch.Generator().manual_seed(seed),
                       dtype=torch.float64)


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", list(BEFORE))
def test_fused_call_sites_keep_the_numbers(name, one_thread):
    """Every model with the ReLU fused into its norms (SharedMLP, the
    umbrella MLPs, PointTransformer's layers, transitions and blocks, the
    heads) gives the training forward, the gradients, the buffers and the
    state dict it gave before, and the same evaluation forward."""
    import hashlib

    rng = np.random.RandomState(0)
    coord = torch.from_numpy(rng.rand(2, 2048, 3).astype(np.float32) * 4)
    feat = torch.from_numpy(rng.rand(2, 2048, 3).astype(np.float32))
    valid = torch.tensor([2048, 1500])
    pts = torch.from_numpy(rng.rand(4, 1200, 6).astype(np.float32) * 2 - 1)
    if name == "repsurf.repsurf_ssg_umb":
        cfg = train_cls.ClsConfig(num_point=1024)
        model = train_cls.build_model(cfg, generator=torch.Generator().manual_seed(5))
        out = train_cls.train_forward(model, pts, cfg, generator=torch.Generator().manual_seed(6))
    else:
        model = train_seg.build_model(train_seg.SegConfig(model=name),
                                      generator=torch.Generator().manual_seed(3))
        out = train_seg.train_forward(model, {"coord": coord, "feat": feat, "valid": valid},
                                      torch.Generator().manual_seed(4))
    loss = (out.double() * _noise(out, 1)).sum()
    loss.backward()
    grads = sum(float((p.grad.double() * _noise(p, 2 + i)).sum())
                for i, (_, p) in enumerate(model.named_parameters()) if p.grad is not None)
    buffers = sum(float(b.double().sum()) for _, b in model.named_buffers())
    keys = hashlib.sha256("\n".join(model.state_dict().keys()).encode()).hexdigest()[:16]
    want_out, want_grads, want_buffers, want_keys, want_n, want_eval = BEFORE[name]
    assert (keys, len(model.state_dict())) == (want_keys, want_n)
    # float32 forwards: a different vector path could round otherwise; a
    # ReLU added or lost moves these by far more than 1e-4
    assert float(loss.detach()) == pytest.approx(want_out, rel=1e-4)
    assert grads == pytest.approx(want_grads, rel=1e-4)
    assert buffers == pytest.approx(want_buffers, rel=1e-4)
    if want_eval is not None:
        model.eval()
        with torch.no_grad():
            got = float((model(coord, feat, valid).double() * _noise(out, 1)).sum())
        assert got == pytest.approx(want_eval, rel=1e-4)


def test_run_layers_fuses_only_a_following_relu(monkeypatch):
    """A norm followed by an ``nn.ReLU`` applies it (the module is not
    called); a norm followed by anything else, or last, does not; a
    Dropout gets the generator."""
    gen = torch.Generator().manual_seed(0)
    seq = nn.Sequential(Linear(4, 6, generator=gen), MaskedBatchNorm(6), nn.ReLU(),
                        Linear(6, 6, generator=gen), MaskedBatchNorm(6), Dropout(0.5),
                        Linear(6, 3, generator=gen), MaskedBatchNorm(3))
    seen = []
    norm_forward = MaskedBatchNorm.forward

    def recorded(self, x, mask=None, relu=False):
        seen.append(relu)
        return norm_forward(self, x, mask=mask, relu=relu)

    def no_relu(self, x):
        raise AssertionError("a ReLU after a norm ran as its own module")

    monkeypatch.setattr(MaskedBatchNorm, "forward", recorded)
    monkeypatch.setattr(nn.ReLU, "forward", no_relu)
    x = torch.randn(2, 5, 4, generator=gen)
    mask = torch.ones(2, 5, 1, dtype=torch.bool)
    y = run_layers(seq.train(), x, mask, torch.Generator().manual_seed(1))
    assert seen == [True, False, False] and y.shape == (2, 5, 3)
    monkeypatch.undo()
    h = torch.relu(seq[1](seq[0](x), mask=mask))
    h = seq[5](seq[4](seq[3](h), mask=mask), generator=torch.Generator().manual_seed(1))
    assert torch.equal(y, seq[7](seq[6](h), mask=mask))


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_training_forward_builds_no_tensor_from_a_host_number(monkeypatch, masked):
    """No ``torch.tensor`` in a training forward: a tensor built from a
    host number on the card is a blocking copy (the unmasked count was one)."""
    m = MaskedBatchNorm(5).train()
    x = torch.randn(3, 4, 5)
    mask = torch.rand(3, 4, 1) < 0.5 if masked else None

    def refused(*a, **k):
        raise AssertionError("torch.tensor inside MaskedBatchNorm.forward")

    monkeypatch.setattr(torch, "tensor", refused)
    y = m(x, mask=mask, relu=True)
    z = bn.batch_norm(x, m.weight, m.bias, m.running_mean, m.running_var, mask, relu=True)
    monkeypatch.undo()
    assert y.shape == z.shape == x.shape


def test_kernel_launches_count_batch_norm_by_route():
    """The counter the CLIs log: every route, 0 on the CPU (the plain
    versions run there)."""
    m = MaskedBatchNorm(3).train()
    m(torch.randn(4, 3), relu=True).sum().backward()
    assert kernel_launches()["batch_norm"] == {"stats": 0, "normalize": 0, "backward": 0,
                                               "eval": 0}
