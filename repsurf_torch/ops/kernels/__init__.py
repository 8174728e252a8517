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
