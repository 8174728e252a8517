"""The plain reference agrees with the program on the CPU at a tiny size,
and imports nothing of the program, of JAX or of the JAX package."""

import json
import subprocess
import sys

import numpy as np
import torch

from benchmark.data.synthetic_scene import raw_room
from benchmark.harness import common, program
from benchmark.reference import losses, models, ops


def _conf(name):
    return json.loads((common.BENCH / "configs" / f"{name}.json").read_text())


def _seg_inputs(b=2, n=2048, seed=3):
    rng = np.random.RandomState(seed)
    rooms = [raw_room(rng, n) for _ in range(b)]
    coord = torch.from_numpy(np.stack([c - c.mean(0) for c, _, _ in rooms]))
    feat = torch.from_numpy(np.stack([rgb / 255.0 for _, rgb, _ in rooms]).astype(np.float32))
    label = torch.from_numpy(np.stack([lab for _, _, lab in rooms]))
    return coord, feat, label


def test_seg_eval_forward_matches_program():
    from repsurf_torch.train import train_seg

    conf = _conf("repsurf_umb_ssg.s3dis")
    model = train_seg.build_model(train_seg.SegConfig(**conf["program"])).eval()
    program.init_weights(model, 5, 2.0, torch.device("cpu"))
    coord, feat, _ = _seg_inputs()
    valid = torch.tensor([2048, 1500])
    with torch.no_grad():
        want = model(coord, feat, valid)
        plan = models.seg_plan(conf["arch"], coord, valid, train=False)
        got = models.seg_forward(program.snapshot(model), conf["arch"], plan, feat, False)
    for b, v in enumerate(valid.tolist()):
        assert torch.allclose(got[b, :v], want[b, :v], rtol=1e-4, atol=1e-4)


def test_seg_train_step_matches_program():
    from repsurf_torch.train import train_seg

    conf = _conf("repsurf_umb_ssg.s3dis")
    cfg = train_seg.SegConfig(**conf["program"])
    model = train_seg.build_model(cfg)
    program.init_weights(model, 6, 2.0, torch.device("cpu"))
    start = program.snapshot(model)
    coord, feat, label = _seg_inputs(seed=4)
    valid = torch.full((2,), 2048)
    weight = torch.tensor(conf["train"]["class_weights"])
    logits = train_seg.train_forward(model, {"coord": coord, "feat": feat, "valid": valid},
                                     torch.Generator().manual_seed(9))
    want = losses.weighted_ce(logits, label, weight, 255)
    gen = torch.Generator().manual_seed(9)
    plan = models.seg_plan(conf["arch"], coord, valid, train=True)
    sign = models.random_sign(2, gen, coord.device)
    p = {k: v.clone().requires_grad_(not k.endswith(("running_mean", "running_var")))
         for k, v in start.items()}
    got = losses.weighted_ce(models.seg_forward(p, conf["arch"], plan, feat, True, sign, gen),
                             label, weight, 255)
    assert abs(got.item() - want.item()) <= 1e-5 * abs(want.item())
    want.backward()
    grads = torch.autograd.grad(got, [p[n] for n, _ in model.named_parameters()])
    for (n, q), g in zip(model.named_parameters(), grads):
        assert torch.allclose(g, q.grad, rtol=1e-3, atol=1e-6), n


def test_cls_forward_matches_program():
    from repsurf_torch.data.transforms import fps_sample
    from repsurf_torch.train import train_cls

    conf = _conf("repsurf_ssg_umb.scanobjectnn")
    model = train_cls.build_model(train_cls.ClsConfig(**conf["program"])).eval()
    program.init_weights(model, 7, 2.0, torch.device("cpu"))
    raw = torch.rand(3, 1200, 3, generator=torch.Generator().manual_seed(1)) * 2 - 1
    sign = torch.tensor([1.0, -1.0, 1.0])
    with torch.no_grad():
        want = model(fps_sample(raw, 1024), inv_sign=sign)
        got = models.cls_forward(program.snapshot(model), conf["arch"],
                                 models.cls_plan(conf["arch"], raw), False, sign)
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-5)


def test_ops_match_program_plain_versions():
    from repsurf_torch.ops.kernels.fps import fps_plain
    from repsurf_torch.ops.kernels.knn import knn_plain
    from repsurf_torch.ops.neighbors import ball_query

    xyz = torch.rand(2, 700, 3, generator=torch.Generator().manual_seed(2))
    valid = torch.tensor([700, 433])
    assert torch.equal(ops.fps(xyz, 100, valid)[1, :433 // 4].int(),
                       fps_plain(xyz, 100, valid)[1, :433 // 4])
    i1, d1 = ops.knn(9, xyz, xyz[:, :50], valid)
    i2, d2 = knn_plain(9, xyz, xyz[:, :50], valid)
    assert torch.equal(i1.int(), i2) and torch.equal(d1, d2)
    assert torch.equal(ops.ball_query(0.2, 16, xyz, xyz[:, :40], valid).int(),
                       ball_query(0.2, 16, xyz, xyz[:, :40], valid))


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2**-10, 1.0 + 2**-11 + 2**-13, 1.0 + 2**-12], dtype=torch.float32)
    assert models.tf32_round(x).tolist() == [1.0 + 2**-10, 1.0 + 2**-10, 1.0]


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r); import benchmark.reference.models, "
            "benchmark.reference.scene, benchmark.reference.losses; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'repsurf_torch', 'repsurf_tpu', 'jax', 'jaxlib', 'flax'}))" % str(common.REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True)
    assert out.stdout.strip() == "[]"
