"""Summed bound of the traced forward sweep calls over their kernels' device time (%)."""

from benchmark.harness.readers import sweep_forward_roofline as read  # noqa: F401
