"""Reference-format checkpoints (``repsurf_torch/train/torch_import.py``)
against the JAX package's importer on the CPU.

A reference payload is built inside each test: 1x1-convolution weights
([O, I, 1] and [O, I, 1, 1]), the DataParallel ``module.`` prefix, a
``num_batches_tracked`` counter in every BatchNorm, wrapped as the
reference's trainers save it.  For the two umbrella models the port's
logits after ``load_reference_weights`` must equal the JAX model's after
``import_torch_checkpoint`` of the same file, at the eval-forward
tolerances of tests/test_torch_model.py and test_torch_seg.py; the other
four names round-trip exactly; the test CLI serves the same labels from
the reference file as from the port's payload of the same weights.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repsurf_torch.models import _REGISTRY, RepSurfSegmentor
from repsurf_torch.models import get_model as t_get_model
from repsurf_torch.train.checkpoint import train_state_dict
from repsurf_torch.train.torch_import import (
    load_reference_state_dict,
    load_reference_weights,
    reference_state_dict,
    restore_any_weights,
)
from repsurf_tpu.models import get_model as j_get_model
from repsurf_tpu.train import torch_import as ti

from . import test_torch_model as tmodel
from . import test_torch_seg as tseg

torch.set_num_threads(1)


def _reference_payload(mapping, seed, wrap):
    """A reference-format payload for ``mapping`` (``_shaped_mapping``'s
    entries), random values from ``seed``: Linear kernels
    U(+-1/sqrt(fan_in)) as conv weights, BN scale/bias/statistics, the
    ``module.`` prefix and ``num_batches_tracked``."""
    rs = np.random.RandomState(seed)
    sd = {}
    for i, (kind, name, shape, has_bias) in enumerate(mapping):
        if kind == "linear":
            kin, kout = shape
            w = rs.uniform(-1, 1, (kout, kin)).astype(np.float32) / np.sqrt(kin)
            sd[name + ".weight"] = torch.from_numpy(w[..., None] if i % 2 else w[..., None, None])
            if has_bias:
                sd[name + ".bias"] = torch.from_numpy(rs.uniform(-0.1, 0.1, kout)
                                                      .astype(np.float32))
        else:
            c = shape
            sd[name + ".weight"] = torch.from_numpy(rs.uniform(0.5, 1.5, c).astype(np.float32))
            sd[name + ".bias"] = torch.from_numpy((rs.randn(c) * 0.1).astype(np.float32))
            sd[name + ".running_mean"] = torch.from_numpy((rs.randn(c) * 0.1).astype(np.float32))
            sd[name + ".running_var"] = torch.from_numpy(rs.uniform(0.5, 1.5, c)
                                                         .astype(np.float32))
            sd[name + ".num_batches_tracked"] = torch.tensor(7)
    sd = {"module." + k: v for k, v in sd.items()}
    return {wrap: sd, "epoch": 12, "optimizer": None} if wrap else sd


def _shaped_mapping(mapping, variables):
    """JAX's mapping as (kind, torch name, shape, has a bias): (kin, kout)
    for a Linear, C for a BN; a Linear without a bias in flax gets none in
    the payload."""
    out = []
    for kind, path, name in mapping:
        node = variables["params"]
        for p in path:
            node = node[p]
        out.append((kind, name, node["kernel"].shape if kind == "linear"
                    else node["scale"].shape[0], "bias" in node))
    return out


def _save(tmp_path, payload, name="ref.pth"):
    path = str(tmp_path / name)
    torch.save(payload, path)
    return path


def test_reference_state_dict_undoes_the_reference_layout():
    payload = {"state_dict": {
        "module.a.weight": torch.ones(4, 3, 1, 1), "module.a.bias": torch.zeros(4),
        "module.b.weight": torch.ones(4, 3, 1), "module.bn.num_batches_tracked": torch.tensor(3),
        "c.weight": torch.ones(4, 3)}}
    sd = reference_state_dict(payload)
    assert sorted(sd) == ["a.bias", "a.weight", "b.weight", "c.weight"]
    assert all(sd[k].shape == (4, 3) for k in ("a.weight", "b.weight", "c.weight"))
    sd["a.weight"] += 1  # a copy, not a view of the payload
    assert float(payload["state_dict"]["module.a.weight"].max()) == 1.0
    with pytest.raises(ValueError, match="1x1"):
        reference_state_dict({"k.weight": torch.ones(4, 3, 3)})


@pytest.mark.parametrize("wrap", ["model_state_dict", None])
def test_cls_reference_file_gives_jax_logits(tmp_path, wrap):
    jm = j_get_model("repsurf.repsurf_ssg_umb", **tmodel.NARROW)
    variables = tmodel._random_variables(jm, 128, 1)
    mapping = _shaped_mapping(ti.cls_umbrella_mapping(), variables)
    path = _save(tmp_path, _reference_payload(mapping, 5, wrap))
    jvars = ti.import_torch_checkpoint(ti.load_torch_state_dict(path), variables,
                                       ti.cls_umbrella_mapping())
    tm = t_get_model("repsurf.repsurf_ssg_umb", **tmodel.NARROW)
    load_reference_weights(tm, path)
    pts = (np.random.RandomState(2).rand(2, 128, 3) * 2 - 1).astype(np.float32)
    want = np.asarray(jm.apply(jvars, jnp.asarray(pts), train=False))
    with torch.inference_mode():
        got = tm.eval()(torch.from_numpy(pts)).numpy()
    np.testing.assert_allclose(got, want, atol=tmodel.LOGP_ATOL, rtol=0)


@pytest.mark.parametrize("wrap", ["state_dict", None])
def test_seg_reference_file_gives_jax_logits(tmp_path, wrap):
    jm = j_get_model("repsurf.repsurf_umb_ssg", head_dropout=0.0, random_inv=False,
                     **tseg.NARROW)
    variables = tseg._random_variables(jm, 64, 1)
    mapping = _shaped_mapping(ti.seg_umbrella_mapping(), variables)
    path = _save(tmp_path, _reference_payload(mapping, 6, wrap))
    jvars = ti.import_torch_checkpoint(ti.load_torch_state_dict(path), variables,
                                       ti.seg_umbrella_mapping())
    tm = t_get_model("repsurf.repsurf_umb_ssg", head_dropout=0.0, random_inv=False,
                     **tseg.NARROW)
    load_reference_weights(tm, path)
    b = tseg._batch(0)
    want = np.asarray(jm.apply(jvars, jnp.asarray(b["coord"]), jnp.asarray(b["feat"]),
                               jnp.asarray(b["valid"]), train=False))
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(b["coord"]), torch.from_numpy(b["feat"]),
                        torch.from_numpy(b["valid"])).numpy()
    live = np.arange(tseg.N)[None, :] < tseg.VALID[:, None]
    np.testing.assert_allclose(got[live], want[live], atol=tseg.LOGIT_ATOL, rtol=0)


def _as_reference(sd):
    """The port's state dict in the reference's layout: every 2-D weight as
    a 1x1 convolution (alternating [O, I, 1, 1] and [O, I, 1]), the
    ``module.`` prefix, a ``num_batches_tracked`` beside every running
    mean."""
    out = {}
    for i, (k, v) in enumerate(sd.items()):
        if k.endswith("weight") and v.ndim == 2:
            v = v[..., None, None] if i % 2 else v[..., None]
        out["module." + k] = v.clone()
        if k.endswith("running_mean"):
            out["module." + k[:-len("running_mean")] + "num_batches_tracked"] = torch.tensor(1)
    return {"state_dict": out}


@pytest.mark.parametrize("name", ["repsurf.repsurf_ssg_umb_2x", "repsurf.repsurf_ssg_tri",
                                  "pointnet2.pointnet2_ssg", "pointtransformer.pointtransformer"])
def test_reference_layout_round_trips_exactly(tmp_path, name):
    src = t_get_model(name, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():  # non-trivial buffers, so they are checked too
        for k, v in src.named_buffers():
            v.copy_(torch.rand(v.shape, generator=torch.Generator().manual_seed(len(k))) + 0.5)
    want = src.state_dict()
    path = _save(tmp_path, _as_reference(want))
    dst = t_get_model(name, generator=torch.Generator().manual_seed(2))
    load_reference_weights(dst, path)
    got = dst.state_dict()
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert sorted(load_reference_state_dict(path)) == sorted(want)


def test_test_cli_serves_the_same_labels_from_both_formats(tmp_path, monkeypatch):
    from repsurf_torch.cli import test_s3dis

    monkeypatch.setitem(_REGISTRY, "repsurf.repsurf_umb_ssg",
                        lambda num_class=13, **kw: RepSurfSegmentor(num_class, **kw,
                                                                    **tseg.NARROW))
    model = t_get_model("repsurf.repsurf_umb_ssg", generator=torch.Generator().manual_seed(4))
    port = _save(tmp_path, train_state_dict(model, torch.optim.SGD(model.parameters(), lr=0.1),
                                            3, 0.5), "best.pt")
    ref = _save(tmp_path, _as_reference(model.state_dict()))
    served = {}
    for kind, path in (("port", port), ("reference", ref)):
        root = tmp_path / kind
        test_s3dis.main(["--synthetic", "--synthetic_rooms", "1", "--synthetic_raw", "3000",
                         "--voxel_max", "1024", "--device", "cpu", "--visual", "--log_root",
                         str(root), "--model_path", path])
        log = (root / "S3DIS" / "default" / "logs" / "test_s3dis.txt").read_text()
        assert f"({kind} format)" in log
        visual = root / "S3DIS" / "default" / "visual"
        served[kind] = [np.loadtxt(visual / f) for f in sorted(os.listdir(visual))
                        if f.endswith("_pred.txt")]
    assert len(served["port"]) == 1
    np.testing.assert_array_equal(served["port"][0], served["reference"][0])
    restored = t_get_model("repsurf.repsurf_umb_ssg")
    assert restore_any_weights(restored, ref) == "reference"
    assert all(torch.equal(a, b) for a, b in zip(restored.state_dict().values(),
                                                 model.state_dict().values()))
