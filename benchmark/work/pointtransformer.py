"""Point Transformer's work, counted analytically from the configuration's
``arch`` as ``model.py`` and ``fps.py`` count RepSurf's: every Linear costs
2 * in * out a row it is applied to (the attention's ``linear_p`` and
``linear_w`` a neighbour row, the head's ``linear2`` one row a cloud);
norms, activations, the softmax, the weighted sum, pools and the geometry
are not counted.  Each cloud counts at its own ``valid`` size: padding is
not work."""

from . import fps
from .model import _rows


def _sizes(arch, n):
    """Real points of each stage of a cloud of n points."""
    sizes = [n]
    for stride in arch["strides"][1:]:
        sizes.append(sizes[-1] // stride)
    return sizes


def _block(c, rows, k, share):
    """(in, out, rows) of a residual block's Linears at width c."""
    pair = rows * k
    return [(c, c, rows)] * 5 + [(3, 3, pair), (3, c, pair), (c, c // share, pair),
                                 (c // share, c // share, pair)]


def _pt_cloud(arch, n):
    planes, k, share = arch["planes"], arch["nsample"], arch["share_planes"]
    sizes = _sizes(arch, n)
    layers = [(arch["in_channel"], planes[0], sizes[0])]
    for i, (c, blocks) in enumerate(zip(planes, arch["enc_blocks"])):
        if i > 0:
            layers.append((3 + planes[i - 1], c, sizes[i] * k))
        for _ in range(blocks):  # blocks - 1 in the encoder, one in the decoder
            layers += _block(c, sizes[i], k, share)
    last = len(planes) - 1
    layers += [(planes[last], planes[last], 1), (2 * planes[last], planes[last], sizes[last])]
    for i in range(last - 1, -1, -1):
        layers += [(planes[i], planes[i], sizes[i]), (planes[i + 1], planes[i], sizes[i + 1])]
    layers += [(planes[0], planes[0], n), (planes[0], arch["num_class"], n)]
    return _rows(layers)


def pt_flops(arch, valid):
    """pointtransformer's forward FLOPs over clouds of ``valid`` points."""
    return sum(_pt_cloud(arch, n) for n in valid)


def pt_fps_calls(arch, valid, train, votes=1):
    """The FPS calls of one pointtransformer forward over clouds of
    ``valid`` points: each strided stage keeps n // stride of the n points
    before it (80,000 -> 20,000 -> 5,000 -> 1,250 -> 312), stage 2
    sectorized in training (``num_sector`` sectors)."""
    calls, sizes = [], list(valid)
    s = arch["num_sector"]
    for i, stride in enumerate(arch["strides"][1:], start=1):
        picks = [n // stride for n in sizes]
        if i == 1 and train and s > 1:
            calls.append(fps.call([p for n, m in zip(sizes, picks) for p in fps.sectors(n, m, s)]))
        else:
            calls.append(fps.call(list(zip(sizes, picks))))
        sizes = picks
    return calls * votes
