"""repsurf_torch's PointNeXt held to the benchmark's plain PyTorch reference
(``benchmark/reference/pointnext.py``, written from the published code) on
the CPU, on seeded random weights, at scaled-down widths on two crops of
2,048 points: the forward in evaluation and in training, the plan's
indices against the program's own, one ``train_seg.train_step`` with the
label-smoothed loss (loss, gradients, AdamW's change) in float64, the
loss against torch's, the parameter count at the published widths,
``build_model`` and a step of the seg training CLI."""

import json

import numpy as np
import pytest
import torch

from benchmark.data.synthetic_scene import raw_room
from benchmark.harness import common, program, training
from benchmark.reference import pointnext as ref
from benchmark.traffic.seg_crop_train import crop
from repsurf_torch.models import _REGISTRY, SEG_RECIPES, PointNeXtSegmentor, get_model
from repsurf_torch.models.pointnext_seg import RECIPE
from repsurf_torch.nn.losses import weighted_cross_entropy
from repsurf_torch.ops.gather import index_points
from repsurf_torch.ops.interpolate import interpolate_weights
from repsurf_torch.ops.neighbors import ball_query
from repsurf_torch.ops.sampling import farthest_point_sample
from repsurf_torch.train import train_seg

torch.set_num_threads(2)

NAME = "pointnext.pointnext_xl"
CONF = json.loads((common.BENCH / "configs" / "pointnext_xl.s3dis.json").read_text())
N = 2048
# the published depth and radii at a quarter of the widths (16 .. 256)
NARROW = {"width": 16}
ARCH = {**CONF["arch"], **NARROW}
GAIN = CONF["init"]["weight_gain"]
CFG = train_seg.SegConfig(**CONF["program"])


def clouds(seed, valid=(N, 1500)):
    """Two crops of N points of the cell's rooms (0.04 voxels, so a ball
    holds what it holds in the cell), standardised colours, labels, and
    ``valid`` real points each."""
    rng = np.random.RandomState(seed)
    crops = [crop(rng, *raw_room(rng, 220000), N, 0.04) for _ in valid]
    mean, std = (np.array(CONF["infer"][k], np.float32) for k in ("rgb_mean", "rgb_std"))
    coord = torch.from_numpy(np.stack([c for c, _, _ in crops]))
    feat = torch.from_numpy(np.stack([(rgb / 255.0 - mean) / std for _, rgb, _ in crops])
                            .astype(np.float32))
    label = torch.from_numpy(np.stack([lab for _, _, lab in crops]))
    return coord, feat, label, torch.tensor(valid)


def model(seed):
    m = get_model(NAME, **NARROW)
    return program.init_weights(m, seed, GAIN, torch.device("cpu"))


# Evaluation and training alike, the program's ops on the CPU are the
# reference's ops in its order (the same matmuls, gathers and sums), and the
# two are equal bit for bit at seeds 3-5; 1e-6 of the largest logit leaves
# room for a BLAS that blocks a matmul by its shape and fails any term that
# is not the reference's.
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_forward_matches_reference(train):
    net = model(5).train(train)
    coord, feat, _, valid = clouds(3)
    with torch.no_grad():
        want = net(coord, feat, valid, generator=torch.Generator().manual_seed(1))
        plan = ref.pnx_plan(ARCH, coord, valid, train)
        got = ref.pnx_forward(program.snapshot(net), ARCH, plan, feat, train, None,
                              torch.Generator().manual_seed(1))
    for b, v in enumerate(valid.tolist()):
        scale = want[b, :v].abs().max()
        assert 0.1 < scale < 100
        assert (got[b, :v] - want[b, :v]).abs().max() <= 1e-6 * scale


def test_plan_indices_are_the_programs():
    """FPS picks, both balls of every stage and the decoder's 3-NN: the
    reference's plain plan and the program's ops give the same indices
    (exact: both test d2 <= float32(r**2) on direct differences and break
    ties on the lowest index)."""
    coord, _, _, valid = clouds(4)
    plan = ref.pnx_plan(ARCH, coord, valid, train=True)
    c, v = coord, valid
    for i, (r_sa, r_block) in enumerate(ref.radii(ARCH), start=1):
        m, nv = c.shape[1] // 4, v // 4
        idx = farthest_point_sample(c, m, valid=v)
        nc = index_points(c, idx)
        assert torch.equal(nc, plan.centers[i]) and torch.equal(nv, plan.valids[i])
        down = ball_query(r_sa, ARCH["nsample"], c, nc, valid=v)
        near = ball_query(r_block, ARCH["nsample"], nc, nc, valid=nv)
        live = torch.arange(m)[None, :] < nv[:, None]  # rows past valid are padding
        assert torch.equal(down[live].long(), plan.down[i][live]), i
        assert torch.equal(near[live].long(), plan.near[i][live]), i
        knn_idx, weight = interpolate_weights(3, nc, c, nv)
        assert torch.equal(knn_idx.long(), plan.interp[i - 1][0])
        assert torch.equal(weight, plan.interp[i - 1][1])
        c, v = nc, nv
    # a ball at 0.1 in a 0.04-voxel crop holds about 15 points, fewer than 32:
    # most are short and padded, which the comparison covers
    hits = (plan.down[1] != plan.down[1][..., :1]).sum(-1) + 1
    assert 5 < float(hits.float().median()) < 32


def test_smoothed_loss_matches_torch():
    """The reference's written-out formula, the program's ``seg_loss`` and
    torch's unweighted ``cross_entropy(label_smoothing=0.2)``, with ignored
    points; float64 sums in another order: 1e-12 relative.  The program is
    given class weights other than 1 (the CLI passes RepSurf's), which the
    smoothed loss does not use."""
    g = torch.Generator().manual_seed(0)
    logits = torch.randn(3, 500, 13, generator=g, dtype=torch.float64)
    label = torch.randint(0, 13, (3, 500), generator=g)
    label[0, :50] = 255
    want = torch.nn.functional.cross_entropy(logits.reshape(-1, 13), label.reshape(-1),
                                             ignore_index=255, label_smoothing=0.2)
    got = ref.smoothed_ce(logits, label, 0.2, 255)
    weight = 0.5 + torch.rand(13, generator=g, dtype=torch.float64)
    prog = train_seg.seg_loss(logits, label, weight, CFG)
    assert abs(float(got) - float(want)) <= 1e-12 * float(want)
    assert abs(float(prog) - float(want)) <= 1e-12 * float(want)


def test_no_smoothing_keeps_the_weighted_cross_entropy():
    g = torch.Generator().manual_seed(1)
    logits = torch.randn(2, 300, 13, generator=g)
    label = torch.randint(0, 13, (2, 300), generator=g)
    weight = torch.rand(13, generator=g)
    cfg = train_seg.SegConfig()
    assert cfg.label_smoothing == 0.0
    assert torch.equal(train_seg.seg_loss(logits, label, weight, cfg),
                       weighted_cross_entropy(logits, label, weight, cfg.ignore_label))


@pytest.fixture
def float64_geometry(monkeypatch):
    """Let the program run in float64 on the cell's float32 geometry: FPS,
    the balls and the 3-NN take the float32 coordinates (the same indices
    as the reference's plan), the gathers and the relative positions stay
    in float64."""
    import repsurf_torch.nn.blocks as blocks
    import repsurf_torch.nn.pointnext as pnx_nn
    import repsurf_torch.ops.interpolate as interp

    sample, weights = blocks.sample, interp.interpolate_weights

    def group(radius, nsample, xyz, new_xyz, tensors, valid=None):
        idx = ball_query(radius, nsample, xyz.float(), new_xyz.float(), valid=valid)
        return (index_points(xyz, idx) - new_xyz[:, :, None],
                index_points(torch.cat(tensors, -1), idx)[..., 3:])

    monkeypatch.setattr(pnx_nn, "ball_group_feature", group)
    monkeypatch.setattr(pnx_nn, "sample", lambda c, *a: sample(c.float(), *a))
    monkeypatch.setattr(interp, "interpolate_weights", lambda k, a, b, v: tuple(
        t.double() if t.is_floating_point() else t for t in weights(k, a.float(), b.float(), v)))


def reference_step(start, coord, feat, label, valid, gen):
    """The reference's loss, gradients and AdamW change of one step from
    ``start`` (float64 parameters; the plan from float32 coordinates)."""
    p = {k: v.clone() for k, v in start.items()}
    names = [k for k in p if not k.endswith(training.BUFFERS)]
    for n in names:
        p[n].requires_grad_(True)
    plan = ref.pnx_plan(ARCH, coord, valid, train=True)
    plan.centers = [c.double() for c in plan.centers]
    plan.interp = [(i, w.double()) for i, w in plan.interp]
    logits = ref.pnx_forward(p, ARCH, plan, feat.double(), True, None, gen)
    loss = ref.smoothed_ce(logits, label, CONF["train"]["label_smoothing"],
                           CONF["train"]["ignore_label"])
    grads = torch.autograd.grad(loss, [p[n] for n in names])
    training.Adam([p[n] for n in names], CONF["train"]).step(grads)
    change = {n: p[n].detach() - start[n] for n in names}
    return float(loss.detach()), dict(zip(names, grads)), change


@pytest.mark.parametrize("seed", [4, 9])
def test_train_step_matches_reference(seed, float64_geometry):
    """One ``train_step`` (the label-smoothed loss, dropout drawn from the
    step's generator) in float64 against the reference's.  In float32 the
    two part on rounding alone, a ReLU or a max over the slots flipping on
    a last bit (as Point Transformer's step does); in float64 a wrong term
    shows and rounding does not."""
    net = model(6).double()
    start = program.snapshot(net)
    coord, feat, label, valid = clouds(seed, valid=(N, N))
    optimizer = train_seg.make_optimizer(net, CFG)
    batch = {"coord": coord.double(), "feat": feat.double(), "label": label, "valid": valid}
    loss, _ = train_seg.train_step(net, optimizer, batch, torch.ones(13, dtype=torch.float64),
                                   CFG, generator=torch.Generator().manual_seed(11))
    want_loss, want_grad, want_change = reference_step(start, coord, feat, label, valid,
                                                       torch.Generator().manual_seed(11))
    # float64 roundings through 19 aggregations, forward and backward: 1e-10
    # leaves room for sums in another order and fails any term that is not
    # the reference's
    assert abs(float(loss) - want_loss) <= 1e-10 * want_loss
    med = float(np.median([g.norm() for g in want_grad.values()]))
    for name, q in net.named_parameters():
        g = want_grad[name]
        # each leaf to its norm, or the median leaf's where it is near 0
        assert (q.grad - g).norm() <= 1e-10 * max(float(g.norm()), med), name
        if g.norm() < training.QUIET * med:
            # rounding alone, as the cell's check leaves it out: a bias that
            # a batch norm takes away again has a zero gradient, and AdamW's
            # first step turns its rounding into +-lr
            continue
        # AdamW's first step, lr * g / (|g| + eps) plus the decay, turns a
        # gradient's rounding into far more change in an element whose
        # gradient is near eps (1e-8): 1e-8 of a leaf's change
        d = q.detach() - start[name]
        assert (d - want_change[name]).norm() <= 1e-8 * want_change[name].norm(), name


def test_parameter_count_is_the_configurations_and_the_papers():
    net = train_seg.build_model(CFG)
    n = sum(p.numel() for p in net.parameters())
    assert n == CONF["parameters"] == 41576461
    assert abs(n - 41.6e6) <= 0.01 * 41.6e6  # the paper's 41.6 M


def test_build_model_takes_the_recipes_fields():
    assert isinstance(train_seg.build_model(CFG), PointNeXtSegmentor)
    recipe = SEG_RECIPES[NAME]
    assert recipe is RECIPE and "repsurf.repsurf_umb_ssg" not in SEG_RECIPES
    # the cell's program holds the model's recipe, field for field
    assert {k: CONF["program"][k] for k in recipe} == recipe
    assert CONF["train"]["label_smoothing"] == recipe["label_smoothing"]
    with pytest.raises(ValueError, match="num_sector"):
        train_seg.build_model(train_seg.SegConfig(model=NAME, in_channel=4))


def test_cli_trains_a_pointnext_step(tmp_path, monkeypatch):
    """``cli/train_seg`` with ``--model pointnext.pointnext_xl`` on the
    synthetic rooms: the recipe's fields (4 input channels, plain FPS, the
    label smoothing) reach the step, at scaled-down widths, and each step's
    loss is the unweighted smoothed cross-entropy, though the CLI passes
    RepSurf's class weights (float32 sums in another order: 1e-5
    relative)."""
    from repsurf_torch.cli import train_seg as cli
    from repsurf_torch.data.s3dis import CLASS_WEIGHTS

    monkeypatch.setitem(_REGISTRY, NAME, lambda **kw: _REGISTRY_XL(**kw, width=8))
    seen, seg_loss = [], train_seg.seg_loss

    def recorded(logits, label, class_weight, cfg):
        loss = seg_loss(logits, label, class_weight, cfg)
        seen.append((logits.detach(), label, class_weight, float(loss.detach())))
        return loss

    monkeypatch.setattr(train_seg, "seg_loss", recorded)
    run = cli.main(["--synthetic", "--synthetic_rooms", "2", "--synthetic_raw", "4000",
                    "--voxel_max", "1024", "--batch_size", "2", "--batch_size_val", "2",
                    "--loop", "1", "--min_val", "0", "--epoch", "1", "--device", "cpu",
                    "--model", NAME, "--log_root", str(tmp_path)])
    assert isinstance(run.model, PointNeXtSegmentor) and run.model.stem.in_features == 4
    assert run.losses and all(np.isfinite(list(run.losses.values())))
    log = (tmp_path / "S3DIS" / "default" / "logs" / "train_seg.txt").read_text()
    assert all(f in log for f in ("in_channel=4", "num_sector=1", "label_smoothing=0.2"))
    assert seen
    for logits, label, class_weight, loss in seen:
        assert torch.equal(class_weight.cpu(), torch.tensor(CLASS_WEIGHTS[5]))
        want = torch.nn.functional.cross_entropy(
            logits.reshape(-1, 13), label.reshape(-1).long(), ignore_index=255,
            label_smoothing=0.2)
        assert abs(loss - float(want)) <= 1e-5 * float(want)


_REGISTRY_XL = _REGISTRY[NAME]
