"""Convolution flops of the window's work over its time, as a share of the float32 peak (%)."""

from benchmark.harness.readers import mfu as read  # noqa: F401
