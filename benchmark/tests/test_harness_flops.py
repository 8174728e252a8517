"""The analytic work: FLOP counts equal what torch's FLOP counter reads
over the program's forward (every Linear counted, 2 * in * out a row), each
cloud at its own real size; FPS work counts the picks the configuration
needs over each cloud's real points."""

import json

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import work
from benchmark.harness import common
from benchmark.work import fps as fps_work
from benchmark.work import model as model_work


def _conf(name):
    return json.loads((common.BENCH / "configs" / f"{name}.json").read_text())


def _seg_model():
    from repsurf_torch.train import train_seg

    conf = _conf("repsurf_umb_ssg.s3dis")
    return conf, train_seg.build_model(train_seg.SegConfig(**conf["program"])).eval()


def _seg_counted(model, b, n, valid=None):
    g = torch.Generator().manual_seed(0)
    coord = torch.rand(b, n, 3, generator=g)
    feat = torch.rand(b, n, 3, generator=g)
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        model(coord, feat, torch.full((b,), n) if valid is None else torch.tensor(valid))
    return counter.get_total_flops()


def test_seg_forward_flops():
    conf, model = _seg_model()
    assert _seg_counted(model, 2, 2048) == model_work.seg_flops(conf["arch"], [2048, 2048])


def test_seg_flops_count_real_points_only():
    """A padded batch counts as its clouds' forwards at their own sizes,
    less than the padded launch reads."""
    conf, model = _seg_model()
    alone = _seg_counted(model, 1, 2048) + _seg_counted(model, 1, 1500)
    assert model_work.seg_flops(conf["arch"], [2048, 1500]) == alone
    assert alone < _seg_counted(model, 2, 2048, valid=[2048, 1500])


def test_cls_forward_flops():
    from repsurf_torch.train import train_cls

    conf = _conf("repsurf_ssg_umb.scanobjectnn")
    model = train_cls.build_model(train_cls.ClsConfig(**conf["program"])).eval()
    b = 2
    pts = torch.rand(b, conf["arch"]["num_point"], 3, generator=torch.Generator().manual_seed(0))
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        model(pts, inv_sign=torch.ones(b))
    assert counter.get_total_flops() == model_work.cls_flops(conf["arch"], [2048] * b)


def test_fps_work_counts_real_points_and_kept_picks():
    arch = _conf("repsurf_umb_ssg.s3dis")["arch"]
    one = fps_work.seg_calls(arch, [80000], train=False)
    assert one[0] == (9 * 80000 * 20000, 4 * (3 * 80000 + 4 * 20000))
    two = fps_work.seg_calls(arch, [80000, 5000], train=False)
    assert two[0][0] == one[0][0] + 9 * 5000 * 1250
    # sectorized: each sector (20,001, then 3 x 20,000 points) keeps a
    # quarter of the 20,000 picks
    sec = fps_work.seg_calls(arch, [80001], train=True)[0]
    assert sec[0] == 9 * 5000 * (20001 + 3 * 20000)
    assert fps_work.sectors(10, 7, 4) == [(3, 1), (2, 1), (3, 1), (2, 2)]
    cls = fps_work.cls_calls(_conf("repsurf_ssg_umb.scanobjectnn")["arch"], [2048] * 4, False,
                             votes=2)
    assert len(cls) == 1 + 2 * 2 and cls[0][0] == 9 * 4 * 2048 * 1024


def test_work_of_units_follows_the_configuration():
    conf = _conf("repsurf_umb_ssg.s3dis")
    fwd = {"points": 8192, "valid": [8192, 3000]}
    infer = work.of_units(conf, [{"train": False, "votes": 1, "forwards": [fwd, fwd]}])
    train = work.of_units(conf, [{"train": True, "votes": 1, "forwards": [fwd]}])
    assert infer["model_flops"] == 2 * model_work.seg_flops(conf["arch"], fwd["valid"])
    assert train["model_flops"] == 3 * model_work.seg_flops(conf["arch"], fwd["valid"])
    assert infer["fps_bound_s"] == 2 * fps_work.bound_s(
        fps_work.seg_calls(conf["arch"], fwd["valid"], False))
