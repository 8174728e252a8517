"""Point ops: masking, gathers, neighbor search, sampling, and the CUDA
kernels with their plain versions (``ops.kernels``)."""
