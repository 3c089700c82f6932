"""Summed bound of the traced backward sweep calls over their kernels' device time (%)."""

from benchmark.harness.readers import sweep_backward_roofline as read  # noqa: F401
