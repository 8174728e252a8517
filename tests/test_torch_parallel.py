"""Data parallelism in the port (``repsurf_torch/parallel``) against the JAX
package's sharded steps on the CPU.

The port's ranks are two gloo processes spawned here (each with a 60 s
collective timeout, and the pair with a deadline of its own, so a hang
fails within minutes instead of eating the suite's limit); JAX's steps run
over ``make_mesh(2)`` of the suite's virtual CPU devices.  Both steps build
a narrow model without the random normal inversion and with dropout off,
so both frameworks compute the same thing, and step the same global batch
from the same weights with plain SGD (linear in the gradient).  One seg
step with ``bn="per_device"`` and one with ``bn="sync"`` are held to JAX's
``make_seg_train_step`` by the update contract of tests/test_torch_seg.py
(per leaf rtol 5e-2, median 2e-2) and each rank's BN buffers to its
device's within 1e-5; the cls step to ``make_cls_train_step`` the same way,
but its buffers within CLS_BUFFER_ATOL of JAX's and bit-equal to the port's
own one-process step on the rank's rows.
The port's sync BN over two ranks equals its batch norm over the
concatenated batch in one process within 1e-5 (a ``MaskedBatchNorm``'s
outputs, input gradients and buffers, and every buffer of the narrow model
after a training forward); the model's logits, 20 layers on, within
tests/test_torch_seg.py's train-mode tolerance (the statistics are summed
in another order).

The rank function lives here and imports no JAX: a spawned rank imports
this module by name.
"""

import numpy as np
import pytest
import torch

from repsurf_torch.models import get_model as t_get_model
from repsurf_torch.nn.layers import MaskedBatchNorm
from repsurf_torch.parallel import distributed, pad_to_multiple, shard_batch
from repsurf_torch.parallel.mesh import shard_rows
from repsurf_torch.parallel.shard_step import (
    bn_process_group,
    make_cls_train_step,
    make_seg_train_step,
)
from repsurf_torch.train import train_cls as ttc
from repsurf_torch.train import train_seg as tts

torch.set_num_threads(1)

SEG = "repsurf.repsurf_umb_ssg"
CLS = "repsurf.repsurf_ssg_umb"
SPAWN_TIMEOUT_S = 240
SYNC_ATOL = 1e-5
# the cls forward's own noise: one single-device train step of each
# framework on one rank's rows (these inputs) already puts the classifier's
# BN buffers up to 2.4e-5 apart
CLS_BUFFER_ATOL = 1e-4


def _rank(rank, world, init_method, job_path, out_dir):
    """One rank: join the gloo group, run the job's steps on this rank's
    rows of the global batch, save what it saw."""
    torch.set_num_threads(1)
    distributed.init_distributed("gloo", world, rank, init_method, timeout_s=60)
    try:
        job = torch.load(job_path, weights_only=False)
        out = {}
        if job["kind"] == "seg":
            cfg = tts.SegConfig(**job["cfg"])
            batch = {k: torch.from_numpy(v)
                     for k, v in shard_batch(job["batch"], rank, world).items()}
            w = torch.from_numpy(job["weight"])
            for bn in ("per_device", "sync"):
                model = t_get_model(SEG, **job["model_kw"])
                model.load_state_dict(job["state"])
                loss, parts = make_seg_train_step(cfg, bn=bn)(model, tts.make_optimizer(model, cfg),
                                                              batch, w)
                out[bn] = {"loss": float(loss), "parts": [p.numpy() for p in parts],
                           "state": {k: v.numpy() for k, v in model.state_dict().items()}}
            model = t_get_model(SEG, **job["model_kw"])
            model.load_state_dict(job["state"])
            with bn_process_group(model, torch.distributed.group.WORLD), torch.no_grad():
                logits = tts.train_forward(model, batch)
            out["sync_forward"] = {"logits": logits.numpy(), "state": {
                k: v.numpy() for k, v in model.state_dict().items()}}
            out["bn"] = _bn_run(job["bn_x"][shard_rows(4, rank, world)],
                                job["bn_mask"][shard_rows(4, rank, world)],
                                torch.distributed.group.WORLD)
        else:
            cfg = ttc.ClsConfig(**job["cfg"])
            model = t_get_model(CLS, **job["model_kw"])
            model.load_state_dict(job["state"])
            rows = shard_rows(job["points"].shape[0], rank, world)
            signs = torch.ones(rows.stop - rows.start)
            loss, correct = make_cls_train_step(cfg)(model, ttc.make_optimizer(model, cfg),
                                                     job["points"], job["target"], signs=signs)
            out["cls"] = {"loss": float(loss), "correct": int(correct),
                          "state": {k: v.numpy() for k, v in model.state_dict().items()}}
        torch.save(out, f"{out_dir}/rank{rank}.pt")
    finally:
        distributed.shutdown()


def _bn_run(x, mask, group):
    """A training forward and backward of one MaskedBatchNorm(16) with
    non-trivial affine parameters -> (output, input gradient, buffers)."""
    bn = MaskedBatchNorm(16, process_group=group).train()
    with torch.no_grad():
        bn.weight.copy_(torch.linspace(0.5, 1.5, 16))
        bn.bias.copy_(torch.linspace(-0.2, 0.2, 16))
    x = torch.from_numpy(x).requires_grad_(True)
    y = bn(x, torch.from_numpy(mask))
    (y * torch.arange(16.0)).sum().backward()
    return {"y": y.detach().numpy(), "grad": x.grad.numpy(),
            "buffers": [bn.running_mean.numpy(), bn.running_var.numpy()]}


def _run_ranks(tmp_path, job, world=2):
    path = str(tmp_path / "job.pt")
    torch.save(job, path)
    distributed.spawn(_rank, world, args=(world, f"tcp://127.0.0.1:{distributed.free_port()}",
                                          path, str(tmp_path)), timeout_s=SPAWN_TIMEOUT_S)
    return [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(world)]


def _jax_mesh_step(kind, cfg, narrow_kw, monkeypatch, *args, bn=None):
    """JAX's sharded step over two devices with the narrow model (the
    package's ``build_model`` patched for this call)."""
    import jax

    from repsurf_tpu.models import get_model as j_get_model
    from repsurf_tpu.parallel import shard_step
    from repsurf_tpu.parallel.mesh import make_mesh
    from repsurf_tpu.train import train_cls as jtc
    from repsurf_tpu.train import train_seg as jts

    module = jts if kind == "seg" else jtc
    name = SEG if kind == "seg" else CLS
    monkeypatch.setattr(module, "build_model", lambda cfg, axis_name=None: j_get_model(
        name, random_inv=False, head_dropout=0.0, **narrow_kw,
        **({"axis_name": axis_name} if kind == "seg" else {})))
    mesh = make_mesh(2)
    if kind == "seg":
        step = shard_step.make_seg_train_step(cfg, mesh, bn=bn)
    else:
        step = shard_step.make_cls_train_step(cfg, mesh)
    return step(*args[:2], shard_step.stack_batch_stats(args[2], 2), *args[3:],
                jax.random.PRNGKey(0))


def _as_dict(t):
    return {k: _as_dict(v) for k, v in t.items()} if hasattr(t, "items") else np.asarray(t)


def _assert_buffers(port_state, jax_stats, mapping_fn, params, atol=SYNC_ATOL):
    """Each BN running statistic of the port's rank equal to its JAX
    device's within ``atol`` (and as much relative)."""
    from repsurf_torch.train.jax_params import state_dict_from_flax

    want = state_dict_from_flax({"params": params, "batch_stats": jax_stats}, mapping_fn())
    names = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert names
    for k in names:
        np.testing.assert_allclose(port_state[k], want[k].numpy(), atol=atol, rtol=atol,
                                   err_msg=k)


def _port_post(state, pre, mapping):
    from repsurf_tpu.train.torch_import import import_torch_checkpoint

    import jax

    return import_torch_checkpoint(state, jax.tree_util.tree_map(np.copy, pre), mapping)


@pytest.fixture(scope="module")
def seg_case():
    """(narrow widths, random flax variables, the port's state dict of
    them, a global batch of 4 samples, class weights)."""
    from repsurf_torch.data.s3dis import CLASS_WEIGHTS
    from repsurf_torch.train.jax_params import state_dict_from_flax
    from repsurf_tpu.models import get_model as j_get_model

    from .test_torch_seg import NARROW, _batch, _random_variables

    jm = j_get_model(SEG, head_dropout=0.0, random_inv=False, **NARROW)
    variables = _random_variables(jm, 64, 3)
    a, b = _batch(6), _batch(7)
    batch = {k: np.concatenate([a[k], b[k]]) for k in a}
    return (NARROW, variables, state_dict_from_flax(variables), batch,
            np.asarray(CLASS_WEIGHTS[5], np.float32))


def _bn_inputs():
    rs = np.random.RandomState(4)
    x = (rs.randn(4, 300, 16) * 3 + rs.randn(16)).astype(np.float32)
    mask = np.arange(300)[None, :] < np.array([300, 120, 7, 260])[:, None]
    return x, mask


def test_seg_steps_match_jax_sharded_steps(tmp_path, seg_case, monkeypatch):
    import jax.numpy as jnp

    from repsurf_tpu.parallel.shard_step import unstack_batch_stats
    from repsurf_tpu.train import train_seg as jts
    from repsurf_tpu.train.optim import make_sgd
    from repsurf_tpu.train.torch_import import seg_umbrella_mapping

    from .test_torch_seg import TRAIN_LOGIT_ATOL
    from .test_train_parity import _assert_update_parity

    narrow, variables, state, batch, w = seg_case
    common = dict(optimizer="SGD", head_dropout=0.0)
    bn_x, bn_mask = _bn_inputs()
    ranks = _run_ranks(tmp_path, {"kind": "seg", "cfg": common, "model_kw": dict(
        random_inv=False, head_dropout=0.0, **narrow), "state": state, "batch": batch,
        "weight": w, "bn_x": bn_x, "bn_mask": bn_mask})
    jcfg = jts.SegConfig(voxel_max=batch["coord"].shape[1], batch_size=4, **common)
    tx = make_sgd(jcfg.learning_rate, jcfg.momentum, jcfg.weight_decay)
    pre = {"params": variables["params"], "batch_stats": variables["batch_stats"]}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    for bn in ("per_device", "sync"):
        params, _, stats, jloss, jparts = _jax_mesh_step(
            "seg", jcfg, narrow, monkeypatch, variables["params"], tx.init(variables["params"]),
            variables["batch_stats"], jbatch, jnp.asarray(w), bn=bn)
        got = ranks[0][bn]
        assert abs(got["loss"] - float(jloss)) < 1e-4, bn
        assert ranks[1][bn]["loss"] == got["loss"]
        for a, c in zip(got["parts"], jparts):
            np.testing.assert_array_equal(a, np.asarray(c), err_msg=bn)
        for r in range(2):  # every rank holds the same parameters
            assert all(np.array_equal(ranks[r][bn]["state"][k], got["state"][k])
                       for k in got["state"] if not k.endswith(("mean", "var"))), (bn, r)
            _assert_buffers(ranks[r][bn]["state"], _as_dict(unstack_batch_stats(stats, r)),
                            seg_umbrella_mapping, variables["params"])
        jax_post = {"params": _as_dict(params),
                    "batch_stats": _as_dict(unstack_batch_stats(stats, 0))}
        _assert_update_parity(pre, jax_post,
                              _port_post(got["state"], pre, seg_umbrella_mapping()),
                              rtol=5e-2, median_rtol=2e-2, label=f"seg {bn} ")
    # per-device statistics differ between the ranks, synchronised ones do not
    mean = "sa1.bn_l0.running_mean"
    assert not np.array_equal(ranks[0]["per_device"]["state"][mean],
                              ranks[1]["per_device"]["state"][mean])
    assert np.array_equal(ranks[0]["sync"]["state"][mean], ranks[1]["sync"]["state"][mean])

    # sync BN over two ranks == batch norm over the concatenated batch
    want = _bn_run(bn_x, bn_mask, None)
    for key in ("y", "grad"):
        got = np.concatenate([r["bn"][key] for r in ranks])
        np.testing.assert_allclose(got, want[key], atol=SYNC_ATOL, rtol=0, err_msg=key)
    for r in ranks:
        for a, c in zip(r["bn"]["buffers"], want["buffers"]):
            np.testing.assert_allclose(a, c, atol=SYNC_ATOL, rtol=SYNC_ATOL)
    model = t_get_model(SEG, random_inv=False, head_dropout=0.0, **narrow)
    model.load_state_dict(state)
    with torch.no_grad():
        logits = tts.train_forward(model, {k: torch.from_numpy(v) for k, v in batch.items()})
    live = np.arange(batch["coord"].shape[1])[None, :] < batch["valid"][:, None]
    got = np.concatenate([r["sync_forward"]["logits"] for r in ranks])
    np.testing.assert_allclose(got[live], logits.numpy()[live], atol=TRAIN_LOGIT_ATOL, rtol=0)
    for k, v in model.state_dict().items():
        for r in ranks:
            np.testing.assert_allclose(r["sync_forward"]["state"][k], v.numpy(), atol=SYNC_ATOL,
                                       rtol=SYNC_ATOL, err_msg=k)


def test_cls_step_matches_jax_sharded_step(tmp_path, monkeypatch):
    import jax.numpy as jnp

    from repsurf_torch.train.jax_params import state_dict_from_flax
    from repsurf_tpu.models import get_model as j_get_model
    from repsurf_tpu.parallel.shard_step import unstack_batch_stats
    from repsurf_tpu.train import train_cls as jtc
    from repsurf_tpu.train.optim import make_sgd
    from repsurf_tpu.train.torch_import import cls_umbrella_mapping

    from .test_torch_model import NARROW, _random_variables
    from .test_torch_seg import _grid
    from .test_train_parity import _assert_update_parity

    jm = j_get_model(CLS, head_dropout=0.0, random_inv=False, **NARROW)
    variables = _random_variables(jm, 128, 12)
    points = _grid(13, (4, 256, 3))
    target = np.array([3, 11, 0, 7])
    common = dict(num_point=128, batch_size=4, optimizer="SGD", learning_rate=0.01,
                  head_dropout=0.0)
    ranks = _run_ranks(tmp_path, {"kind": "cls", "cfg": dict(momentum=0.0, **common),
                                  "model_kw": dict(head_dropout=0.0, **NARROW),
                                  "state": state_dict_from_flax(variables), "points": points,
                                  "target": target})
    jcfg = jtc.ClsConfig(**common)
    tx = make_sgd(0.01, momentum=0.9)
    params, _, stats, jloss, jcorrect = _jax_mesh_step(
        "cls", jcfg, NARROW, monkeypatch, variables["params"], tx.init(variables["params"]),
        variables["batch_stats"], jnp.asarray(points), jnp.asarray(target))
    got = ranks[0]["cls"]
    assert abs(got["loss"] - float(jloss)) < 1e-4
    assert got["correct"] == int(jcorrect) == ranks[1]["cls"]["correct"]
    cfg = ttc.ClsConfig(momentum=0.0, **common)
    for r in range(2):
        _assert_buffers(ranks[r]["cls"]["state"], _as_dict(unstack_batch_stats(stats, r)),
                        cls_umbrella_mapping, variables["params"], atol=CLS_BUFFER_ATOL)
        alone = t_get_model(CLS, head_dropout=0.0, **NARROW)
        alone.load_state_dict(state_dict_from_flax(variables))
        ttc.train_step(alone, ttc.make_optimizer(alone, cfg), torch.from_numpy(points[2 * r:][:2]),
                       torch.from_numpy(target[2 * r:][:2]), cfg, signs=torch.ones(2))
        for k, v in alone.state_dict().items():
            if k.endswith(("running_mean", "running_var")):
                assert np.array_equal(ranks[r]["cls"]["state"][k], v.numpy()), (r, k)
    pre = {"params": variables["params"], "batch_stats": variables["batch_stats"]}
    jax_post = {"params": _as_dict(params), "batch_stats": _as_dict(unstack_batch_stats(stats, 0))}
    _assert_update_parity(pre, jax_post, _port_post(got["state"], pre, cls_umbrella_mapping()),
                          rtol=5e-2, median_rtol=2e-2, label="cls dp ")


def test_pad_and_shard_match_jax():
    from repsurf_tpu.parallel.mesh import pad_to_multiple as j_pad

    from .test_parallel import _seg_batch

    batch = _seg_batch(np.random.RandomState(0), 3)
    got, want = pad_to_multiple(batch, 4, 255), j_pad(batch, 4, 255)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert pad_to_multiple(batch, 3) is batch
    parts = [shard_batch(got, r, 2) for r in range(2)]
    for k in got:
        np.testing.assert_array_equal(np.concatenate([p[k] for p in parts]), got[k])
    with pytest.raises(ValueError):
        shard_batch(batch, 0, 2)


def test_process_info_outside_and_inside_a_group():
    assert distributed.process_info() == (0, 1) and distributed.is_main_process()
    distributed.init_distributed("gloo", 1, 0, timeout_s=60)
    try:
        assert distributed.process_info() == (0, 1)
        assert distributed.local_batch_size(8) == 8
        x = torch.tensor([1.0, 2.0], requires_grad=True)
        y = distributed.all_reduce_sum(x * 3)
        y.sum().backward()
        assert torch.equal(y, torch.tensor([3.0, 6.0])) and torch.equal(x.grad,
                                                                         torch.full((2,), 3.0))
    finally:
        distributed.shutdown()
    with pytest.raises(ValueError):
        distributed.init_distributed("gloo", 2, 0)


def test_seg_cli_with_two_processes(tmp_path):
    from repsurf_torch.cli import train_seg as cli

    root = tmp_path / "log"
    assert cli.main(["--synthetic", "--synthetic_rooms", "2", "--synthetic_raw", "3000",
                     "--voxel_max", "1024", "--batch_size", "2", "--batch_size_val", "2",
                     "--loop", "1", "--min_val", "0", "--epoch", "1", "--device", "cpu",
                     "--n_devices", "2", "--bn", "per_device", "--log_root", str(root)]) is None
    log = (root / "S3DIS" / "default" / "logs" / "train_seg.txt").read_text()
    assert "data-parallel step over 2 processes, bn=per_device" in log
    assert "train epoch 1/1" in log and log.count("] val epoch 1:") == 1  # rank 0 alone
    assert log.count("kernel launches") == 1


def _scanobjectnn_files(root, sizes=(("training", 8), ("test", 4))):
    """Small ScanObjectNN-layout h5 files of SyntheticObjects15 clouds."""
    import h5py

    from repsurf_torch.data.synthetic_object import SyntheticObjects15

    split_dir = root / "ScanObjectNN" / "main_split"
    split_dir.mkdir(parents=True)
    for split, n in sizes:
        ds = SyntheticObjects15("train" if split == "training" else "test", num_point=256,
                                size=n)
        with h5py.File(split_dir / f"{split}_objectdataset_augmentedrot_scale75.h5", "w") as f:
            f["data"] = np.stack([ds[i][0] for i in range(n)])
            f["label"] = np.array([ds[i][1] for i in range(n)])


def test_cls_cli_with_two_processes(tmp_path):
    from repsurf_torch.cli import train_cls as cli

    _scanobjectnn_files(tmp_path)
    root = tmp_path / "log"
    assert cli.main(["--data_dir", str(tmp_path), "--batch_size", "8", "--num_point", "64",
                     "--epoch", "1", "--min_val", "0", "--device", "cpu", "--dp_mode",
                     "shard_map", "--n_devices", "2", "--log_root", str(root)]) is None
    log = (root / "ScanObjectNN" / "default" / "logs" / "train_cls.txt").read_text()
    assert "data-parallel step over 2 processes" in log and "train=8 test=4" in log
    assert log.count("epoch 1/1 loss") == 1 and log.count("vote ") == 1  # rank 0 alone
