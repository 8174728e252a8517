"""Hand-written CUDA kernels for sm_90a, each beside its plain PyTorch
version.

Every wrapper (``fps.fps``, ``umbrella.umbrella_features_kernel``,
``ball_group.ball_group_feature``, ``ball_group.ball_group_channels``,
``knn.knn_brute``, ``knn_window.knn_window``) runs the plain version for a
tensor on the CPU and launches its kernel for a tensor on a CUDA device,
counting launches in its ``launches`` attributes.  The umbrella and ball
wrappers are ``torch.autograd.Function``s on a CUDA device; the ball
groupings' backward is a kernel too (``ball_group.ball_scatter``).  The
sources are in ``repsurf_torch/csrc`` and are built at first use
(``build.py``).
"""


def kernel_launches():
    """The kernels' launch counts in this process (all 0 on the CPU, where
    the plain versions run): FPS by route, window kNN and its re-solve,
    brute kNN by route, both kNN kernels by k, FPS and both kNN kernels by
    shape ("BxN->M", kNN with ",k=K"), the ball-feature kernel and its
    backward by channel count, the umbrella kernel by impl."""
    from .ball_group import ball_group_feature
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
            "umbrella": dict(umbrella_features_kernel.launches)}
