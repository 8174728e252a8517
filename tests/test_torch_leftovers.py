"""The port's small counterparts of the JAX package on the CPU: the
procedural object dataset (``data/synthetic_object.py``), the 2x
classifier's size, ``utils.profile_trace``."""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repsurf_torch.data import synthetic_object as tso
from repsurf_torch.models import get_model as t_get_model
from repsurf_torch.utils import profile_trace
from repsurf_tpu.data import synthetic_object as jso
from repsurf_tpu.models import get_model as j_get_model

torch.set_num_threads(1)


@pytest.mark.parametrize("split", ["train", "test"])
def test_synthetic_objects15_equal_jax(split):
    got = tso.SyntheticObjects15(split, num_point=512, size=30, seed=4)
    want = jso.SyntheticObjects15(split, num_point=512, size=30, seed=4)
    assert len(got) == len(want) == 30
    for i in range(30):  # two of each of the 15 classes
        (gp, gl), (wp, wl) = got[i], want[i]
        assert gl == wl == i % tso.NUM_CLASS and gp.dtype == wp.dtype == np.float32
        np.testing.assert_array_equal(gp, wp)
    assert tso.CLASS_NAMES == jso.CLASS_NAMES
    np.testing.assert_allclose(np.linalg.norm(gp, axis=1).max(), 1.0, rtol=1e-6)


def test_synthetic_object_draws_equal_jax():
    for label in (None, 0, 11):
        got = tso.synthetic_object(np.random.RandomState(8), 300, label=label,
                                   background_prob=1.0)
        want = jso.synthetic_object(np.random.RandomState(8), 300, label=label,
                                    background_prob=1.0)
        assert got[1] == want[1]
        np.testing.assert_array_equal(got[0], want[0])


def test_repsurf_ssg_umb_2x_has_the_reference_size():
    """6.806 M parameters (classification/README.md:84), as the JAX model,
    whose count comes from its shapes alone (nothing is initialised)."""
    tm = t_get_model("repsurf.repsurf_ssg_umb_2x")
    count = sum(p.numel() for p in tm.parameters())
    shapes = jax.eval_shape(
        functools.partial(j_get_model("repsurf.repsurf_ssg_umb_2x").init, train=False),
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 32, 3)))
    assert count == sum(int(np.prod(x.shape))
                        for x in jax.tree_util.tree_leaves(shapes["params"]))
    assert abs(count / 1e6 - 6.806) < 0.02, count


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    with profile_trace(str(tmp_path)) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert prof is not None
    traces = list(tmp_path.glob("trace_*.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    with profile_trace(str(tmp_path / "off"), enabled=False) as prof:
        pass
    assert prof is None and not (tmp_path / "off").exists()
