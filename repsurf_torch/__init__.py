"""repsurf_torch — the PyTorch / CUDA port of repsurf_tpu for NVIDIA Hopper.

It mirrors repsurf_tpu's sub-packages (ops, geometry, nn, models, data,
train) and names, so each module's counterpart is easy to find.  The JAX
package is the reference the port is tested against; this package imports
torch and numpy only.

Layout convention (the same as repsurf_tpu at every public function):
    points  : [B, N, C]  float32  (channels-last; padded to a static N)
    valid   : [B] int32 number of valid rows per sample (rows [0, valid[b])
              are real points, the rest padding), or None for full batches

Every kernel the JAX package wrote in Pallas and that this port covers is a
hand-written CUDA kernel for sm_90a (``csrc/``), built with nvcc at first use
and bound with ctypes (``ops/kernels``).  Each sits beside a plain PyTorch
version of the same function: a wrapper runs the plain version for a tensor
on the CPU and the kernel for a tensor on a CUDA device.
"""

__version__ = "0.1.0"
