"""repsurf_torch's PointTransformer held to the benchmark's plain PyTorch
reference (``benchmark/reference/pointtransformer.py``, written from the
published code) on the CPU, at the published widths on two clouds of 2,048
points with seeded random weights: the forward in evaluation and in
training, one ``train_seg.train_step`` (loss, gradients, AdamW's change),
the analytic FLOPs (``benchmark/work/pointtransformer.py``) against
torch's FLOP counter, the reference's imports, and the model's spans."""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils.flop_counter import FlopCounterMode

from benchmark.data.synthetic_scene import raw_room
from benchmark.harness import common, program, training
from benchmark.reference import losses
from benchmark.reference import pointtransformer as ref
from benchmark.work import fps as fps_work
from benchmark.work import pointtransformer as pt_work
from repsurf_torch.train import train_seg

torch.set_num_threads(2)

CONF = json.loads((common.BENCH / "configs" / "pointtransformer.s3dis.json").read_text())
ARCH = CONF["arch"]
N = 2048
GAIN = CONF["init"]["weight_gain"]


def clouds(seed, valid=(N, 1500)):
    """Two synthetic rooms of N points (centred, colours in [0, 1]), their
    labels and ``valid`` real points each."""
    rng = np.random.RandomState(seed)
    rooms = [raw_room(rng, N) for _ in valid]
    coord = torch.from_numpy(np.stack([c - c.mean(0) for c, _, _ in rooms]).astype(np.float32))
    feat = torch.from_numpy(np.stack([rgb / 255.0 for _, rgb, _ in rooms]).astype(np.float32))
    label = torch.from_numpy(np.stack([lab for _, _, lab in rooms]))
    return coord, feat, label, torch.tensor(valid)


def model(seed):
    m = train_seg.build_model(train_seg.SegConfig(**CONF["program"]))
    return program.init_weights(m, seed, GAIN, torch.device("cpu"))


# Evaluation uses the running statistics, so the two agree to float32
# rounding of differently ordered sums (the weighted sum over neighbours, a
# matmul's blocking): 2e-6 of the largest logit.  Training normalises by
# batch statistics, which amplify those roundings through 18 blocks (up to
# 1.8e-5 of logits of about 3 found, seeds 3-5): 2e-5 relative.
@pytest.mark.parametrize("train,tol", [(False, 2e-6), (True, 2e-5)], ids=["eval", "train"])
def test_forward_matches_reference(train, tol):
    net = model(5).train(train)
    coord, feat, _, valid = clouds(3)
    with torch.no_grad():
        want = net(coord, feat, valid)
        plan = ref.pt_plan(ARCH, coord, valid, train)
        got = ref.pt_forward(program.snapshot(net), ARCH, plan, feat, train)
    for b, v in enumerate(valid.tolist()):
        scale = want[b, :v].abs().max()
        assert 0.5 < scale < 50  # logits of about unit spread at this gain
        assert (got[b, :v] - want[b, :v]).abs().max() <= tol * scale


@pytest.fixture
def float64_geometry(monkeypatch):
    """Let the program run in float64: its kNN and FPS key float32 bits,
    so they take the float32 coordinates (the cell's exact geometry, the
    same indices) and the interpolation weights come back in float64."""
    import repsurf_torch.nn.pointtransformer as pt_nn
    import repsurf_torch.ops.interpolate as interp

    knn, sample, weights = pt_nn.knn, pt_nn.sample, interp.interpolate_weights
    monkeypatch.setattr(pt_nn, "knn", lambda k, a, b, valid=None: knn(k, a.float(), b.float(),
                                                                      valid=valid))
    monkeypatch.setattr(pt_nn, "sample", lambda c, *a: sample(c.float(), *a))
    monkeypatch.setattr(interp, "interpolate_weights", lambda k, a, b, v: tuple(
        t.double() if t.is_floating_point() else t for t in weights(k, a.float(), b.float(), v)))


def reference_step(start, coord, feat, label, valid, weight):
    """The reference's loss, gradients and AdamW change of one step from
    ``start`` (float64 parameters; the plan from float32 coordinates)."""
    p = {k: v.clone() for k, v in start.items()}
    names = [k for k in p if not k.endswith(training.BUFFERS)]
    for n in names:
        p[n].requires_grad_(True)
    plan = ref.pt_plan(ARCH, coord, valid, train=True)
    plan.centers = [c.double() for c in plan.centers]
    plan.interp = [(i, w.double()) for i, w in plan.interp]
    logits = ref.pt_forward(p, ARCH, plan, feat.double(), True)
    loss = losses.weighted_ce(logits, label, weight, CONF["train"]["ignore_label"])
    grads = torch.autograd.grad(loss, [p[n] for n in names])
    training.Adam([p[n] for n in names], CONF["train"]).step(grads)
    change = {n: p[n].detach() - start[n] for n in names}
    return float(loss.detach()), dict(zip(names, grads)), change


@pytest.mark.parametrize("seed", [4, 9])
def test_train_step_matches_reference(seed, float64_geometry):
    """One ``train_step`` in float64 against the reference's.  In float32
    the two part on rounding alone: a ReLU or a max-pool that flips on a
    last bit sends a row's gradient elsewhere, and on clouds this small a
    few such rows move a leaf's gradient by up to 17 % (seed 9; in float64
    the same step agrees to 7e-14).  So the step is compared in float64,
    where a wrong term shows and rounding does not; the float32 forward is
    compared above."""
    cfg = train_seg.SegConfig(**CONF["program"])
    net = model(6).double()
    start = program.snapshot(net)
    coord, feat, label, valid = clouds(seed, valid=(N, N))
    weight = torch.tensor(CONF["train"]["class_weights"], dtype=torch.float64)
    optimizer = train_seg.make_optimizer(net, cfg)
    batch = {"coord": coord.double(), "feat": feat.double(), "label": label, "valid": valid}
    loss, _ = train_seg.train_step(net, optimizer, batch, weight, cfg)
    want_loss, want_grad, want_change = reference_step(start, coord, feat, label, valid, weight)
    # float64 roundings through 18 blocks, forward and backward: found
    # 2e-16 (loss) and 7e-14 (a leaf's gradient) of the norm; 1e-10 leaves
    # room and fails any term that is not the reference's
    assert abs(float(loss) - want_loss) <= 1e-10 * want_loss
    med = float(np.median([g.norm() for g in want_grad.values()]))
    for name, q in net.named_parameters():
        g = want_grad[name]
        # each leaf to its norm, or the median leaf's where it is near 0
        assert (q.grad - g).norm() <= 1e-10 * max(float(g.norm()), med), name
        if g.norm() < training.QUIET * med:
            # rounding alone, as the cell's check leaves it out: a bias
            # that a batch norm or the softmax takes away again (linear_q,
            # linear_k, linear_p.0, linear_w.2, linear_w.5...) has a zero
            # gradient, and AdamW's first step turns its rounding into
            # +-lr
            continue
        # AdamW's first step, lr * g / (|g| + eps) plus the decay, turns a
        # gradient's rounding into up to lr / (4 eps) = 1.5e5 times as much
        # change in an element whose gradient is near eps (1e-8): found 2e-10
        # of a leaf's change
        d = q.detach() - start[name]
        assert (d - want_change[name]).norm() <= 1e-8 * want_change[name].norm(), name


def counted(fn):
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        fn()
    return counter.get_total_flops()


@pytest.mark.parametrize("valid", [(N, N), (N, 1500)], ids=["full", "padded"])
def test_flops_match_flop_counter_on_the_reference(valid):
    """Every Linear of the reference counted, each cloud at its own size:
    a cloud's forward alone reads what ``pt_flops`` counts for it."""
    start = program.snapshot(model(7))
    coord, feat, _, _ = clouds(5)

    def alone(b, v):
        c, f = coord[b:b + 1, :v], feat[b:b + 1, :v]
        plan = ref.pt_plan(ARCH, c, None, train=False)
        return counted(lambda: ref.pt_forward(start, ARCH, plan, f, False))

    assert sum(alone(b, v) for b, v in enumerate(valid)) == pt_work.pt_flops(ARCH, list(valid))


def test_flops_match_flop_counter_on_the_program():
    net = model(7).eval()
    coord, feat, _, valid = clouds(5, valid=(N, N))
    assert counted(lambda: net(coord, feat, valid)) == pt_work.pt_flops(ARCH, [N, N])


def test_fps_calls_count_each_stage():
    train = pt_work.pt_fps_calls(ARCH, [80000], train=True)
    plain = pt_work.pt_fps_calls(ARCH, [80000, 1500], train=False, votes=2)
    assert len(train) == 4 and len(plain) == 8
    assert train[0] == fps_work.call(fps_work.sectors(80000, 20000, 4))
    assert train[1:] == [fps_work.call([(20000, 5000)]), fps_work.call([(5000, 1250)]),
                         fps_work.call([(1250, 312)])]
    assert plain[0] == fps_work.call([(80000, 20000), (1500, 375)]) and plain[:4] == plain[4:]


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r); import benchmark.reference.pointtransformer, "
            "benchmark.work.pointtransformer; print(sorted({m.split('.')[0] for m in "
            "sys.modules} & {'repsurf_torch', 'repsurf_tpu', 'jax', 'jaxlib', 'flax'}))"
            % str(common.REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True)
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_spans_of_a_profiled_forward(train, tmp_path):
    """``pt.attention`` once a block (18), ``pt.down`` once a strided
    TransitionDown (4), ``pt.up`` once a TransitionUp (5)."""
    net = model(8).train(train)
    coord, feat, _, valid = clouds(6)
    with profile(activities=[ProfilerActivity.CPU]) as prof, torch.no_grad():
        net(coord, feat, valid)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    names = [e["name"] for e in json.loads(path.read_text())["traceEvents"]
             if e.get("cat") == "user_annotation"]
    blocks = sum(ARCH["enc_blocks"])
    assert {n: names.count(n) for n in ("pt.attention", "pt.down", "pt.up")} == {
        "pt.attention": blocks, "pt.down": 4, "pt.up": 5}
