"""PointNeXt's work, counted analytically from the configuration's ``arch``
as ``model.py`` and ``fps.py`` count RepSurf's: every Linear costs
2 * in * out a row it is applied to, a local aggregation's Linear one row a
slot (M queries x ``nsample``); norms, activations, the max over the slots,
the interpolation, dropout and the geometry are not counted.  Each cloud
counts at its own ``valid`` size: padding is not work."""

from . import fps
from .model import _rows


def _sizes(arch, n):
    """Real points of each stage of a cloud of n points (24,000 -> 6,000 ->
    1,500 -> 375 -> 93)."""
    sizes = [n]
    for stride in arch["strides"][1:]:
        sizes.append(sizes[-1] // stride)
    return sizes


def _pnx_cloud(arch, n):
    w, k, e = arch["width"], arch["nsample"], arch["expansion"]
    widths = [w * 2 ** i for i in range(len(arch["blocks"]))]
    sizes = _sizes(arch, n)
    layers = [(arch["in_channel"], w, n)]
    for i in range(1, len(widths)):
        c, m = widths[i], sizes[i]
        layers.append((widths[i - 1] + 3, c, m * k))
        for _ in range(1, arch["blocks"][i]):
            layers += [(c + 3, c, m * k), (c, e * c, m), (e * c, c, m)]
    for i in range(len(widths) - 1, 0, -1):
        out = widths[i - 1]
        layers += [(out + widths[i], out, sizes[i - 1]), (out, out, sizes[i - 1])]
    layers += [(w, w, n), (w, arch["num_class"], n)]
    return _rows(layers)


def pnx_flops(arch, valid):
    """pointnext's forward FLOPs over clouds of ``valid`` points."""
    return sum(_pnx_cloud(arch, n) for n in valid)


def pnx_fps_calls(arch, valid, train, votes=1):
    """The FPS calls of one pointnext forward over clouds of ``valid``
    points: each stage keeps n // stride of the n points before it, by
    plain FPS in training too."""
    calls, sizes = [], list(valid)
    for stride in arch["strides"][1:]:
        picks = [n // stride for n in sizes]
        calls.append(fps.call(list(zip(sizes, picks))))
        sizes = picks
    return calls * votes
