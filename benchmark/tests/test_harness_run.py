"""Whole runs of each cell at a tiny size on the CPU (the harness's look for
a card skipped): the result line's keys, the imports, and ``correct`` coming
out false when the timed path is broken underneath or the control stands in
for the program."""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark.harness import common, runner, training
from benchmark.reference import models

from benchmark.tests.conftest import tiny

CELLS = ["s3dis_seg_train", "s3dis_scene_infer", "scanobjectnn_cls_serve",
         "scanobjectnn_cls_train"]
KEYS = {"correct", "attempted", "failed", "metrics", "device", "compared"}


def _run(cell, seed=2**31 + 11):
    return runner.run(cell, seed, 0.5, False, device="cpu", overrides=tiny(cell))


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run(cell):
    """A sound run's line, correct under the cell's limits (a training
    cell's tiny ones, ``conftest.TINY``), so that a planted fault is the
    only thing that can fail the runs below."""
    result, checks = _run(cell)
    assert set(result) == KEYS and list(result)[-1] == "compared"
    assert result["correct"], checks
    spec = common.load_spec(cell)
    assert set(result["metrics"]) == {m["name"] for m in spec.end_to_end}
    assert all(v["value"] > 0 for v in result["metrics"].values())
    assert result["attempted"] >= 1 and result["failed"] == 0


def test_run_py_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is here")
    out = subprocess.run([sys.executable, str(common.BENCH / "run.py"), "--workload",
                          "scanobjectnn_cls_serve", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, cwd=common.REPO)
    assert out.returncode != 0 and out.stdout == ""


def test_a_run_loads_no_jax():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from benchmark.harness import runner, common\n"
            "from benchmark.tests.conftest import tiny\n"
            "runner.run('scanobjectnn_cls_serve', 5, 0.2, False, device='cpu', "
            "overrides=tiny('scanobjectnn_cls_serve'))\n"
            "print(common.forbidden_loaded(), 'repsurf_torch' in sys.modules)"
            % str(common.REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True)
    assert out.stdout.strip().splitlines()[-1] == "[] True"


def test_forbidden_names_compare_whole():
    sys.modules.setdefault("repsurf_tpu_lookalike_x", type(sys)("repsurf_tpu_lookalike_x"))
    try:
        assert "repsurf_tpu" not in common.forbidden_loaded()
    finally:
        sys.modules.pop("repsurf_tpu_lookalike_x", None)


# -- faults planted in the program's timed path ------------------------------

def _train_unchanged(monkeypatch):
    monkeypatch.setattr(torch.optim.AdamW, "step", lambda self, closure=None: None)
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)


def _half(batch):
    return batch.shape[0] // 2


def _seg_half(monkeypatch):
    from repsurf_torch.train import train_seg

    real = train_seg.train_step

    def step(model, optimizer, batch, *a, **k):
        h = _half(batch["coord"])
        return real(model, optimizer, {n: v[:h] for n, v in batch.items()}, *a, **k)

    monkeypatch.setattr(train_seg, "train_step", step)


def _cls_train_half(monkeypatch):
    from repsurf_torch.train import train_cls

    real = train_cls.train_step

    def step(model, optimizer, points, target, *a, **k):
        h = _half(points)
        return real(model, optimizer, points[:h], target[:h], *a, **k)

    monkeypatch.setattr(train_cls, "train_step", step)


def _serve_half(monkeypatch):
    from repsurf_torch.train import train_cls

    real = train_cls.eval_step

    def step(model, points, target, cfg, generator=None, uniforms=None, signs=None):
        h = _half(points)
        s, v, out = real(model, points[:h], target[:h], cfg, generator=generator,
                         signs=signs[:, :h])
        rest = out.mean(0, keepdim=True).expand(points.shape[0] - h, -1)
        return s, v, torch.cat([out, rest])

    monkeypatch.setattr(train_cls, "eval_step", step)


def _serve_altered(monkeypatch):
    from repsurf_torch.train import train_cls

    real = train_cls.eval_step

    def step(*a, **k):
        s, v, out = real(*a, **k)
        out = out.clone()
        out[0, 0] += 0.5
        return s, v, out

    monkeypatch.setattr(train_cls, "eval_step", step)


def _scene_half(monkeypatch):
    from repsurf_torch.models.repsurf_seg import RepSurfSegmentor

    real = RepSurfSegmentor.forward

    def forward(self, pos, feature, valid=None, **k):
        h = max(pos.shape[0] // 2, 1)
        out = real(self, pos[:h], feature[:h], None if valid is None else valid[:h], **k)
        rest = out.mean(0, keepdim=True).expand(pos.shape[0] - h, -1, -1)
        return torch.cat([out, rest])

    monkeypatch.setattr(RepSurfSegmentor, "forward", forward)


def _scene_altered(monkeypatch):
    from repsurf_torch.train import eval_s3dis

    real = eval_s3dis.scene_votes

    def votes(*a, **k):
        out = real(*a, **k).clone()
        out[0] = out[0].roll(1)
        return out

    monkeypatch.setattr(eval_s3dis, "scene_votes", votes)


FAULTS = [
    ("s3dis_seg_train", _train_unchanged), ("s3dis_seg_train", _seg_half),
    ("scanobjectnn_cls_train", _train_unchanged), ("scanobjectnn_cls_train", _cls_train_half),
    ("scanobjectnn_cls_serve", _serve_half), ("scanobjectnn_cls_serve", _serve_altered),
    ("s3dis_scene_infer", _scene_half), ("s3dis_scene_infer", _scene_altered),
]


@pytest.mark.parametrize("cell,fault", FAULTS, ids=lambda x: getattr(x, "__name__", x))
def test_fault_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    result, checks = _run(cell)
    assert not result["correct"], checks


def _control_fails(cell, device, overrides, seed=77):
    """Set a cell up, let the control stand in for the program, and return
    whether it fails one of the cell's numbers."""
    import importlib

    spec = common.load_spec(cell)
    for key, values in overrides.items():
        (spec.config["infer"] if key == "infer" else getattr(spec, key)).update(values)
    kind = importlib.import_module(f"benchmark.traffic.{spec.traffic['kind']}")
    state = kind.setup(runner.Context(spec, seed, device))
    limits = spec.cell["limits"]
    if hasattr(kind, "reference"):
        kind.free(state)
        ref = kind.reference(state)
        ctl = kind.reference(state, prec=models.Precision(tf32=True))
        return any(v > lim for _, v, lim in training.checks(ctl, ref, limits))
    runner.run_window(kind, state, 0.2, "test")
    kind.check(state)
    (_, limit), = limits.items()
    return kind.control(state) > limit


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    """The control, the reference with TF32 products in the program's place,
    fails one of the cell's numbers at a tiny size."""
    assert _control_fails(cell, "cpu", tiny(cell))


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct_on_card(cell, card):
    """The same at the cell's own size, on the card."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    assert _control_fails(cell, card, {}, seed=4001)


def test_result_line_is_json(capsys):
    result, checks = _run("scanobjectnn_cls_serve")
    line = json.dumps(result)
    assert json.loads(line)["compared"]["logp_gap"]["limit"] == checks[0][2]
    assert np.isfinite(checks[0][1])
