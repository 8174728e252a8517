"""Model FLOPs from the configuration and the traffic's shapes, counted
analytically: every Linear (the reference's 1x1 convolutions) costs
2 * in * out a row it is applied to; norms, activations, pools and the
geometry are not counted.  Each cloud counts at its own ``valid`` size, as
a forward of that cloud alone would: padding is not work.  Counted from the
architecture, not from what the program launches, so the same work counts
whatever implements it."""


def _rows(layers):
    return sum(2 * i * o * r for i, o, r in layers)


def _seg_cloud(arch, points):
    """repsurf_umb_ssg's forward FLOPs for one cloud of ``points`` points."""
    layers = []
    c = arch["repsurf_channel"]
    fans = points * (arch["group_size"] + 1)
    layers += [(10, c, fans), (c, c, fans)]
    n, feat_in, sizes = points, c + arch["in_channel"], [points]
    pos_c = 6 if arch["return_polar"] else 3
    for mlp in arch["sa_mlp"]:
        n = n // arch["stride"]
        sizes.append(n)
        rows = n * arch["nsample"]
        layers += [(pos_c, mlp[0], rows), (feat_in, mlp[0], rows)]
        layers += [(a, b, rows) for a, b in zip(mlp, mlp[1:])]
        feat_in = c + mlp[-1]
    prev = arch["sa_mlp"][-1][-1]
    stages = len(arch["sa_mlp"])
    for j in range(stages, 0, -1):
        mlp = arch["fp_mlp"][stages - j]
        fine = sizes[j - 1]
        layers.append((prev, mlp[0], sizes[j]))
        if j > 1:
            layers.append((arch["sa_mlp"][j - 2][-1], mlp[0], fine))
        layers += [(a, b, fine) for a, b in zip(mlp, mlp[1:])]
        prev = mlp[-1]
    layers += [(prev, arch["head_hidden"], points), (arch["head_hidden"], arch["num_class"], points)]
    return _rows(layers)


def seg_flops(arch, valid):
    """repsurf_umb_ssg's forward FLOPs over clouds of ``valid`` points."""
    return sum(_seg_cloud(arch, n) for n in valid)


def _cls_cloud(arch):
    """repsurf_ssg_umb's forward FLOPs for one cloud (``num_point`` points
    after the input's sampling, whatever the raw size)."""
    c = arch["repsurf_channel"]
    fans = arch["num_point"] * arch["group_size"]
    layers = [(10, c, fans), (c, c, fans), (c, c, fans)]
    feat_in = c
    pos_c = 6 if arch["return_polar"] else 3
    for npoint, nsample, mlp in zip(arch["sa_npoint"], arch["sa_nsample"], arch["sa_mlp"]):
        rows = npoint * nsample
        layers += [(pos_c, mlp[0], rows), (feat_in, mlp[0], rows)]
        layers += [(a, b, rows) for a, b in zip(mlp, mlp[1:])]
        feat_in = c + mlp[-1]
    mlp = arch["final_mlp"]
    rows = arch["sa_npoint"][-1]
    layers += [(pos_c, mlp[0], rows), (feat_in, mlp[0], rows)]
    layers += [(a, b, rows) for a, b in zip(mlp, mlp[1:])]
    prev = mlp[-1]
    for h in arch["head_hidden"]:
        layers.append((prev, h, 1))
        prev = h
    layers.append((prev, arch["num_class"], 1))
    return _rows(layers)


def cls_flops(arch, valid):
    """repsurf_ssg_umb's forward FLOPs over clouds of ``valid`` raw points."""
    return len(valid) * _cls_cloud(arch)
