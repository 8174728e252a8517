"""Weight transfer from the JAX package's flax models to the port.

``state_dict_from_flax`` is the exact inverse of the JAX package's
``import_torch_checkpoint(..., cls_umbrella_mapping())`` for the classifier
and of ``import_torch_checkpoint(..., seg_umbrella_mapping())`` for the
segmentation model (repsurf_tpu/train/torch_import.py); for the triangular
classifier, PointNet++ and PointTransformer, whose mappings the JAX package
lacks, ``mapping_for`` builds them in the same (kind, flax path, torch
name) form, which its ``import_torch_checkpoint`` takes:

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


def cls_umbrella_mapping(n_sa=3, mlp_layers=(3, 3, 3), umbrella=True):
    """(kind, flax path, torch name) for repsurf_ssg_umb-style classifiers,
    in the flax construction order: umbrella Linear_0/BN_0/Linear_1/BN_1/
    Linear_2 (none for the parameter-free triangular constructor,
    ``umbrella=False``); SA-CD Linear_0 (pos)/BN_0/Linear_1 (feat)/BN_1/
    SharedMLP_0; head Linear_0/BN_0/Linear_1/BN_1/Linear_2."""
    sc = "surface_constructor"
    entries = [
        ("linear", [sc, "Linear_0"], f"{sc}.mlps.0"),
        ("bn", [sc, "MaskedBatchNorm_0"], f"{sc}.mlps.1"),
        ("linear", [sc, "Linear_1"], f"{sc}.mlps.3"),
        ("bn", [sc, "MaskedBatchNorm_1"], f"{sc}.mlps.4"),
        ("linear", [sc, "Linear_2"], f"{sc}.mlps.6"),
    ] if umbrella else []
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


def pointnet2_mapping(sa_layers=(3, 3, 3, 3), fp_layers=(2, 2, 2, 3)):
    """(kind, flax path, torch name) for pointnet2_ssg: each SA and FP
    stage a SharedMLP_0 (``mlp_convs.j`` / ``mlp_bns.j``), the head as
    repsurf_umb_ssg's.  ``fp_layers`` in the reference order fp4 .. fp1."""
    n_fp = len(fp_layers)
    entries = []
    for s, n_layers in enumerate(sa_layers, start=1):
        entries += _shared_mlp(f"sa{s}", n_layers)
    for f in range(1, n_fp + 1):
        entries += _shared_mlp(f"fp{f}", fp_layers[n_fp - f])
    return entries + [
        ("linear", ["classifier", "Linear_0"], "classifier.0"),
        ("bn", ["classifier", "MaskedBatchNorm_0"], "classifier.1"),
        ("linear", ["classifier", "Linear_1"], "classifier.4"),
    ]


def _pt_layer(path, name):
    """PointTransformerLayer: q, k, v; the positional MLP Linear_3/BN_0/
    Linear_4; the attention MLP BN_1/Linear_5/BN_2/Linear_6."""
    return [
        ("linear", path + ["Linear_0"], f"{name}.linear_q"),
        ("linear", path + ["Linear_1"], f"{name}.linear_k"),
        ("linear", path + ["Linear_2"], f"{name}.linear_v"),
        ("linear", path + ["Linear_3"], f"{name}.linear_p.0"),
        ("bn", path + ["MaskedBatchNorm_0"], f"{name}.linear_p.1"),
        ("linear", path + ["Linear_4"], f"{name}.linear_p.3"),
        ("bn", path + ["MaskedBatchNorm_1"], f"{name}.linear_w.0"),
        ("linear", path + ["Linear_5"], f"{name}.linear_w.2"),
        ("bn", path + ["MaskedBatchNorm_2"], f"{name}.linear_w.3"),
        ("linear", path + ["Linear_6"], f"{name}.linear_w.5"),
    ]


def _pt_block(scope, name):
    """PointTransformerBlock: Linear_0/BN_0, the layer, BN_1, Linear_1/BN_2."""
    return [
        ("linear", [scope, "Linear_0"], f"{name}.linear1"),
        ("bn", [scope, "MaskedBatchNorm_0"], f"{name}.bn1"),
        *_pt_layer([scope, "PointTransformerLayer_0"], f"{name}.transformer2"),
        ("bn", [scope, "MaskedBatchNorm_1"], f"{name}.bn2"),
        ("linear", [scope, "Linear_1"], f"{name}.linear3"),
        ("bn", [scope, "MaskedBatchNorm_2"], f"{name}.bn3"),
    ]


def _pt_down(scope, name):
    """TransitionDown: Linear_0/BN_0 -> linear, bn."""
    return [("linear", [scope, "Linear_0"], f"{name}.linear"),
            ("bn", [scope, "MaskedBatchNorm_0"], f"{name}.bn")]


def _pt_up(scope, name, head):
    """TransitionUp.  Fusion: Linear_0/BN_0 -> linear1.0/1 (the fine
    features), Linear_1/BN_1 -> linear2.0/1 (the coarse).  Head: Linear_0
    -> linear2.0 (the mean), Linear_1/BN_0 -> linear1.0/1."""
    if head:
        return [("linear", [scope, "Linear_0"], f"{name}.linear2.0"),
                ("linear", [scope, "Linear_1"], f"{name}.linear1.0"),
                ("bn", [scope, "MaskedBatchNorm_0"], f"{name}.linear1.1")]
    return [("linear", [scope, "Linear_0"], f"{name}.linear1.0"),
            ("bn", [scope, "MaskedBatchNorm_0"], f"{name}.linear1.1"),
            ("linear", [scope, "Linear_1"], f"{name}.linear2.0"),
            ("bn", [scope, "MaskedBatchNorm_1"], f"{name}.linear2.1")]


def pointtransformer_mapping(enc_blocks=(2, 3, 4, 6, 3)):
    """(kind, flax path, torch name) for pointtransformer: enc{i}_down ->
    enc{i}.0, enc{i}_block{b} -> enc{i}.b; dec{i}_up -> dec{i}.0 (dec5 in
    head mode), dec{i}_block1 -> dec{i}.1; the head Linear_0/BN_0/Linear_1
    -> cls.0/1/3."""
    entries = []
    for i, n_blocks in enumerate(enc_blocks, start=1):
        entries += _pt_down(f"enc{i}_down", f"enc{i}.0")
        for b in range(1, n_blocks):
            entries += _pt_block(f"enc{i}_block{b}", f"enc{i}.{b}")
    for i in range(len(enc_blocks), 0, -1):
        entries += _pt_up(f"dec{i}_up", f"dec{i}.0", head=i == len(enc_blocks))
        entries += _pt_block(f"dec{i}_block1", f"dec{i}.1")
    return entries + [
        ("linear", ["Linear_0"], "cls.0"),
        ("bn", ["MaskedBatchNorm_0"], "cls.1"),
        ("linear", ["Linear_1"], "cls.3"),
    ]


def _mlp_layers(block):
    shared = block.get("SharedMLP_0", {})
    return ("Linear_0" in block) + sum(1 for k in shared if k.startswith("Linear_"))


def mapping_for(params):
    """The mapping for the tree's own model and depth: PointTransformer by
    its encoder blocks, else its SA (and FP) stages and the number of
    layers in each stage's MLP; PointNet++ stages have no CD first layer,
    the triangular classifier no constructor parameters."""
    if "enc1_down" in params:
        n_enc = sum(1 for k in params if k.endswith("_down"))
        blocks = [1 + sum(1 for k in params if k.startswith(f"enc{i}_block"))
                  for i in range(1, n_enc + 1)]
        return pointtransformer_mapping(tuple(blocks))
    n_sa = sum(1 for k in params if k.startswith("sa"))
    sa_layers = tuple(_mlp_layers(params[f"sa{s}"]) for s in range(1, n_sa + 1))
    n_fp = sum(1 for k in params if k.startswith("fp"))
    fp_layers = tuple(_mlp_layers(params[f"fp{f}"]) for f in range(n_fp, 0, -1))
    if "Linear_0" not in params["sa1"]:
        return pointnet2_mapping(sa_layers, fp_layers)
    if n_fp:
        return seg_umbrella_mapping(sa_layers, fp_layers)
    return cls_umbrella_mapping(n_sa, sa_layers, umbrella="surface_constructor" in params)


def _node(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def _tensor(x):
    # np.array, not np.asarray: the state dict must own its memory, not
    # alias the caller's arrays
    return torch.from_numpy(np.array(x, np.float32))


def state_dict_from_flax(variables, mapping=None):
    """flax ``{'params', 'batch_stats'}`` tree -> the port's state dict,
    by ``mapping`` (default: ``mapping_for`` the tree)."""
    params, stats = variables["params"], variables["batch_stats"]
    sd = {}
    for kind, path, name in mapping or mapping_for(params):
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
