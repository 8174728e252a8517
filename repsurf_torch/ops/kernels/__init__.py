"""Hand-written CUDA kernels for sm_90a, each beside its plain PyTorch
version.

Every wrapper (``fps.fps``, ``umbrella.umbrella_features_kernel``,
``ball_group.ball_group_feature``, ``ball_group.ball_group_channels``,
``knn.knn_brute``, ``knn_window.knn_window``, ``chunk_mean.chunk_mean``,
``batch_norm.batch_norm_stats`` / ``batch_norm_normalize`` /
``batch_norm_backward``) runs the plain version for a tensor on the CPU and
launches its kernel for a tensor on a CUDA device, counting launches in its
``launches`` attributes.  The umbrella and ball wrappers and
``batch_norm.batch_norm`` are ``torch.autograd.Function``s on a CUDA
device; the ball groupings' and the batch norm's backwards are kernels too
(``ball_group.ball_scatter``, ``batch_norm.batch_norm_backward``).  The
sources are in ``repsurf_torch/csrc`` and are built at first use
(``build.py``).
"""


# steps of a CUDA graph (``train/step_graph.py``): 'captures', 'replays',
# and 'eager' (steps on a CUDA device run without a graph)
step_graph = {"captures": 0, "replays": 0, "eager": 0}


def _counters():
    """Each launch counter as (owner, attribute): an int, or a dict of ints."""
    from .ball_group import ball_group_channels, ball_group_feature
    from .batch_norm import batch_norm
    from .chunk_mean import chunk_mean
    from .fps import fps
    from .knn import knn_brute
    from .knn_window import knn_window
    from .umbrella import umbrella_features_kernel as umbrella

    return ((fps, "launches"), (fps, "launches_by_route"), (fps, "launches_by_shape"),
            (knn_window, "launches"), (knn_window, "launches_by_k"),
            (knn_window, "launches_by_shape"), (knn_window, "resolve_launches"),
            (knn_brute, "launches"), (knn_brute, "launches_by_route"),
            (knn_brute, "launches_by_k"), (knn_brute, "launches_by_shape"),
            (ball_group_feature, "launches"), (ball_group_feature, "launches_by_channels"),
            (ball_group_feature, "backward_launches_by_channels"),
            (ball_group_feature, "launches_by_shape"),
            (ball_group_channels, "launches_by_channels"),
            (ball_group_channels, "backward_launches_by_channels"),
            (umbrella, "launches"), (umbrella, "launches_by_style"),
            (umbrella, "slab_resolve_launches"), (chunk_mean, "launches"),
            (batch_norm, "launches"))


def launch_counts():
    """A copy of every launch counter, for ``launches_since``."""
    return [(o, a, dict(v) if isinstance(v, dict) else v)
            for o, a in _counters() for v in (getattr(o, a),)]


def launches_since(before):
    """The launches counted since ``launch_counts()`` gave ``before``, for
    ``add_launches``."""
    delta = []
    for o, a, was in before:
        now = getattr(o, a)
        d = ({k: n - was.get(k, 0) for k, n in now.items() if n != was.get(k, 0)}
             if isinstance(now, dict) else now - was)
        if d:
            delta.append((o, a, d))
    return delta


def add_launches(delta, times=1):
    """Add ``times`` x ``delta`` (``launches_since``) to the counters: a CUDA
    graph's capture issues launches that do not run (``times`` -1), and
    each replay runs them (1)."""
    for o, a, d in delta:
        if isinstance(d, dict):
            counter = getattr(o, a)
            for k, n in d.items():
                counter[k] = counter.get(k, 0) + times * n
        else:
            setattr(o, a, getattr(o, a) + times * d)


def kernel_launches():
    """The kernels' launch counts in this process (all 0 on the CPU, where
    the plain versions run): FPS by route, window kNN and its re-solve,
    brute kNN by route, both kNN kernels by k, FPS and both kNN kernels by
    shape ("BxN->M", kNN with ",k=K"), the ball-feature kernel and its
    backward by channel count, the ball-feature kernel by shape
    ("BxN->M,S=nsample,C=channels"), the umbrella kernel by impl, the chunk
    mean, the batch norm by route (a call each: 'stats', 'normalize',
    'backward', 'eval'), and the steps of a CUDA graph (``step_graph``:
    'captures', 'replays', 'eager').  Each counts launches on the card: a
    wrapper counts as it issues, and a CUDA graph takes back what its
    capture counted and counts it again at each replay (``add_launches``)."""
    from .ball_group import ball_group_feature
    from .batch_norm import batch_norm
    from .chunk_mean import chunk_mean
    from .fps import fps
    from .knn import knn_brute
    from .knn_window import knn_window
    from .umbrella import umbrella_features_kernel

    return {"fps": dict(fps.launches_by_route), "knn_window": knn_window.launches,
            "knn_window_resolve": knn_window.resolve_launches,
            "knn_window_by_k": dict(knn_window.launches_by_k),
            "knn_brute": dict(knn_brute.launches_by_route),
            "knn_brute_by_k": dict(knn_brute.launches_by_k),
            "fps_by_shape": dict(fps.launches_by_shape),
            "knn_window_by_shape": dict(knn_window.launches_by_shape),
            "knn_brute_by_shape": dict(knn_brute.launches_by_shape),
            "ball_feature_by_c": dict(ball_group_feature.launches_by_channels),
            "ball_feature_bwd_by_c": dict(ball_group_feature.backward_launches_by_channels),
            "ball_feature_by_shape": dict(ball_group_feature.launches_by_shape),
            "umbrella": dict(umbrella_features_kernel.launches),
            "chunk_mean": chunk_mean.launches, "batch_norm": dict(batch_norm.launches),
            "step_graph": dict(step_graph)}
