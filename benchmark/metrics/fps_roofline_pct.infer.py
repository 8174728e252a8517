"""fps_roofline_pct.infer: the least time the card could take for the FPS work
the configuration needs in the traced units (work/fps.py, the larger of
operations and bytes over the peaks) over the device time of the FPS
kernels (names holding fps_kernel) in the trace, in %."""

from benchmark.harness.readers import kernel_roofline_pct


def read(record):
    return kernel_roofline_pct(record, "fps_kernel", "fps_bound_s")
