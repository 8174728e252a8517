"""Weight transfer from the JAX package's flax classifier to the port.

``state_dict_from_flax`` is the exact inverse of the JAX package's
``import_torch_checkpoint(..., cls_umbrella_mapping())``:

  Linear kernel [in, out]    -> weight [out, in]
  BatchNorm scale / bias     -> weight / bias
  batch_stats mean / var     -> running_mean / running_var

The input is a ``{'params', 'batch_stats'}`` tree of numpy arrays; this
module imports neither jax nor the JAX package.
"""

import numpy as np
import torch


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
    for s in range(1, n_sa + 1):
        t = f"sa{s}"
        entries += [
            ("linear", [t, "Linear_0"], f"{t}.mlp_l0"),
            ("bn", [t, "MaskedBatchNorm_0"], f"{t}.bn_l0"),
            ("linear", [t, "Linear_1"], f"{t}.mlp_f0"),
            ("bn", [t, "MaskedBatchNorm_1"], f"{t}.bn_f0"),
        ]
        for i in range(mlp_layers[s - 1] - 1):
            entries += [
                ("linear", [t, "SharedMLP_0", f"Linear_{i}"], f"{t}.mlp_convs.{i}"),
                ("bn", [t, "SharedMLP_0", f"MaskedBatchNorm_{i}"], f"{t}.mlp_bns.{i}"),
            ]
    entries += [
        ("linear", ["classifier", "Linear_0"], "classfier.0"),
        ("bn", ["classifier", "MaskedBatchNorm_0"], "classfier.1"),
        ("linear", ["classifier", "Linear_1"], "classfier.4"),
        ("bn", ["classifier", "MaskedBatchNorm_1"], "classfier.5"),
        ("linear", ["classifier", "Linear_2"], "classfier.8"),
    ]
    return entries


def _mapping_for(params):
    """The mapping for the tree's own depth: its SA stages and the number
    of layers in each stage's MLP."""
    n_sa = sum(1 for k in params if k.startswith("sa"))
    layers = []
    for s in range(1, n_sa + 1):
        shared = params[f"sa{s}"].get("SharedMLP_0", {})
        layers.append(1 + sum(1 for k in shared if k.startswith("Linear_")))
    return cls_umbrella_mapping(n_sa, tuple(layers))


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
