"""device_idle_pct.infer: the share of the traced span in which the card ran
no kernel, copy or set, in %."""

from benchmark.harness.readers import idle_pct as read  # noqa: F401
