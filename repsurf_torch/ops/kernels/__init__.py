"""Hand-written CUDA kernels for sm_90a, each beside its plain PyTorch
version.

Every wrapper (``fps.fps``, ``umbrella.umbrella_fan_features``,
``ball_group.ball_group_feature``) runs the plain version for a tensor on
the CPU and launches its kernel for a tensor on a CUDA device, counting
launches in its ``launches`` attribute.  The sources are in
``repsurf_torch/csrc`` and are built at first use (``build.py``).
"""
