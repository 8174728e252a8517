"""Weight transfer from the JAX package's flax models to the port.

``state_dict_from_flax`` is the exact inverse of the JAX package's
``import_torch_checkpoint(..., cls_umbrella_mapping())`` for the classifier
and of ``import_torch_checkpoint(..., seg_umbrella_mapping())`` for the
segmentation model (repsurf_tpu/train/torch_import.py):

  Linear kernel [in, out]    -> weight [out, in]
  BatchNorm scale / bias     -> weight / bias
  batch_stats mean / var     -> running_mean / running_var

The input is a ``{'params', 'batch_stats'}`` tree of numpy arrays; this
module imports neither jax nor the JAX package.
"""

import numpy as np
import torch


def _shared_mlp(scope, n_layers):
    return [
        entry
        for i in range(n_layers)
        for entry in (
            ("linear", [scope, "SharedMLP_0", f"Linear_{i}"], f"{scope}.mlp_convs.{i}"),
            ("bn", [scope, "SharedMLP_0", f"MaskedBatchNorm_{i}"], f"{scope}.mlp_bns.{i}"),
        )
    ]


def _sa_entries(sa_layers):
    """SA-CD stages: Linear_0 (pos)/BN_0/Linear_1 (feat)/BN_1/SharedMLP_0;
    ``sa_layers[i]`` counts sa{i+1}'s MLP layers."""
    entries = []
    for s, n_layers in enumerate(sa_layers, start=1):
        t = f"sa{s}"
        entries += [
            ("linear", [t, "Linear_0"], f"{t}.mlp_l0"),
            ("bn", [t, "MaskedBatchNorm_0"], f"{t}.bn_l0"),
            ("linear", [t, "Linear_1"], f"{t}.mlp_f0"),
            ("bn", [t, "MaskedBatchNorm_1"], f"{t}.bn_f0"),
        ] + _shared_mlp(t, n_layers - 1)
    return entries


def cls_umbrella_mapping(n_sa=3, mlp_layers=(3, 3, 3)):
    """(kind, flax path, torch name) for repsurf_ssg_umb-style classifiers,
    in the flax construction order: umbrella Linear_0/BN_0/Linear_1/BN_1/
    Linear_2; SA-CD Linear_0 (pos)/BN_0/Linear_1 (feat)/BN_1/SharedMLP_0;
    head Linear_0/BN_0/Linear_1/BN_1/Linear_2."""
    sc = "surface_constructor"
    entries = [
        ("linear", [sc, "Linear_0"], f"{sc}.mlps.0"),
        ("bn", [sc, "MaskedBatchNorm_0"], f"{sc}.mlps.1"),
        ("linear", [sc, "Linear_1"], f"{sc}.mlps.3"),
        ("bn", [sc, "MaskedBatchNorm_1"], f"{sc}.mlps.4"),
        ("linear", [sc, "Linear_2"], f"{sc}.mlps.6"),
    ]
    entries += _sa_entries(mlp_layers[:n_sa])
    entries += [
        ("linear", ["classifier", "Linear_0"], "classfier.0"),
        ("bn", ["classifier", "MaskedBatchNorm_0"], "classfier.1"),
        ("linear", ["classifier", "Linear_1"], "classfier.4"),
        ("bn", ["classifier", "MaskedBatchNorm_1"], "classfier.5"),
        ("linear", ["classifier", "Linear_2"], "classfier.8"),
    ]
    return entries


def seg_umbrella_mapping(sa_layers=(3, 3, 3, 3), fp_layers=(2, 2, 2, 3)):
    """(kind, flax path, torch name) for repsurf_umb_ssg-style segmentors:
    umbrella Linear_0/BN_0/Linear_1 -> mlps.0/1/3; SA-CD as the
    classifier's; FP-CD Linear_0 (coarse)/BN_0, then Linear_1 (skip)/BN_1
    except fp1, then SharedMLP_0; head Linear_0/BN_0/Linear_1 ->
    classifier.0/1/4.  ``sa_layers[i]`` counts sa{i+1}'s MLP layers,
    ``fp_layers`` the FP MLPs in the reference order fp4 .. fp1."""
    sc = "surface_constructor"
    entries = [
        ("linear", [sc, "Linear_0"], f"{sc}.mlps.0"),
        ("bn", [sc, "MaskedBatchNorm_0"], f"{sc}.mlps.1"),
        ("linear", [sc, "Linear_1"], f"{sc}.mlps.3"),
    ]
    entries += _sa_entries(sa_layers)
    n_fp = len(fp_layers)
    for f in range(1, n_fp + 1):
        t = f"fp{f}"
        entries += [
            ("linear", [t, "Linear_0"], f"{t}.mlp_f0"),
            ("bn", [t, "MaskedBatchNorm_0"], f"{t}.norm_f0"),
        ]
        if f > 1:
            entries += [
                ("linear", [t, "Linear_1"], f"{t}.mlp_s0"),
                ("bn", [t, "MaskedBatchNorm_1"], f"{t}.norm_s0"),
            ]
        entries += _shared_mlp(t, fp_layers[n_fp - f] - 1)
    entries += [
        ("linear", ["classifier", "Linear_0"], "classifier.0"),
        ("bn", ["classifier", "MaskedBatchNorm_0"], "classifier.1"),
        ("linear", ["classifier", "Linear_1"], "classifier.4"),
    ]
    return entries


def _mlp_layers(block):
    shared = block.get("SharedMLP_0", {})
    return 1 + sum(1 for k in shared if k.startswith("Linear_"))


def _mapping_for(params):
    """The mapping for the tree's own model and depth: its SA (and FP)
    stages and the number of layers in each stage's MLP."""
    n_sa = sum(1 for k in params if k.startswith("sa"))
    sa_layers = tuple(_mlp_layers(params[f"sa{s}"]) for s in range(1, n_sa + 1))
    n_fp = sum(1 for k in params if k.startswith("fp"))
    if n_fp:
        fp_layers = tuple(_mlp_layers(params[f"fp{f}"]) for f in range(n_fp, 0, -1))
        return seg_umbrella_mapping(sa_layers, fp_layers)
    return cls_umbrella_mapping(n_sa, sa_layers)


def _node(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def _tensor(x):
    # np.array, not np.asarray: the state dict must own its memory, not
    # alias the caller's arrays
    return torch.from_numpy(np.array(x, np.float32))


def state_dict_from_flax(variables):
    """flax ``{'params', 'batch_stats'}`` tree -> the port's state dict."""
    params, stats = variables["params"], variables["batch_stats"]
    sd = {}
    for kind, path, name in _mapping_for(params):
        p = _node(params, path)
        if kind == "linear":
            sd[f"{name}.weight"] = _tensor(np.asarray(p["kernel"]).T)
            if "bias" in p:
                sd[f"{name}.bias"] = _tensor(p["bias"])
        else:
            s = _node(stats, path)
            sd[f"{name}.weight"] = _tensor(p["scale"])
            sd[f"{name}.bias"] = _tensor(p["bias"])
            sd[f"{name}.running_mean"] = _tensor(s["mean"])
            sd[f"{name}.running_var"] = _tensor(s["var"])
    return sd
