"""mfu_pct.infer: the model's float32 FLOPs of the window (analytic, Linears
only, a training step three forwards) over the window's seconds times the
card's float32 peak, in %."""

from benchmark.harness.readers import mfu_pct as read  # noqa: F401
