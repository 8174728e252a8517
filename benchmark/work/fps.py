"""Furthest-point sampling's work: each of ``npoint`` rounds takes one
squared distance and one running minimum over every point (9 float32
operations a point), the inputs read once and the picks (an index and three
coordinates) written once.  The calls are those the configuration's
sampling needs for clouds of ``valid`` real points each: padding is not
work, and a sectorized stage counts the picks it keeps, not the spare
rounds a static shape adds.  One call a stage, all clouds together."""

from ..harness.roofline import bound

FPS_FLOPS = 9


def call(pairs):
    """(flops, bytes) of one FPS call over clouds given as (points, picks)."""
    return (sum(FPS_FLOPS * n * m for n, m in pairs),
            sum(4 * (3 * n + 4 * m) for n, m in pairs))


def sectors(n, m, s):
    """(points, picks) of the ``s`` azimuth sectors of a cloud of n points
    that keeps m picks: sectors of ceil-bounded counts, m // s picks from
    each and the remainder from the last, each at most its count."""
    bounds = [-(-k * n // s) for k in range(s + 1)]
    counts = [b - a for a, b in zip(bounds, bounds[1:])]
    take = [m // s] * s
    take[-1] += m % s
    return [(c, min(t, c)) for c, t in zip(counts, take)]


def seg_calls(arch, valid, train, votes=1):
    """The FPS calls of one repsurf_umb_ssg forward over clouds of ``valid``
    points: stage i keeps n // stride of the n points of stage i - 1; the
    first stage sectorized in training (``num_sector`` sectors)."""
    calls, sizes = [], list(valid)
    s = arch["num_sector"]
    for i in range(len(arch["sa_mlp"])):
        picks = [n // arch["stride"] for n in sizes]
        if i == 0 and train and s > 1:
            calls.append(call([p for n, m in zip(sizes, picks) for p in sectors(n, m, s)]))
        else:
            calls.append(call(list(zip(sizes, picks))))
        sizes = picks
    return calls * votes


def cls_calls(arch, valid, train, votes=1):
    """The FPS calls of one repsurf_ssg_umb request or step over clouds of
    ``valid`` raw points: the input's to ``num_point`` once, then each ball
    stage's, once a vote."""
    first = call([(n, arch["num_point"]) for n in valid])
    stages, n = [], arch["num_point"]
    for m in arch["sa_npoint"]:
        stages.append(call([(n, m)] * len(valid)))
        n = m
    return [first] + stages * votes


def bound_s(calls):
    """Least seconds the card could take for the calls, summed."""
    return sum(bound(f, b)[0] for f, b in calls) / 1e3
