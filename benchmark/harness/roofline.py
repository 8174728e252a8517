"""Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at its 700 W
limit) and the least time a piece of work could take on it: frozen copies
of the program's ``chip_smoke.PEAK_F32_FLOPS``, ``PEAK_BYTES_PER_S`` and
``bound()``.  float32 outside the tensor cores: every configuration here
computes in float32 with TF32 off."""

PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


def bound(flops, nbytes):
    """(ms, 'operations' | 'bytes'): the least time the card could take for
    work of ``flops`` float32 operations moving ``nbytes`` (each input read
    once, each output written once)."""
    t_ops, t_mem = flops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_mem else (t_mem, "bytes")
