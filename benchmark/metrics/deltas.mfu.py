"""Convolution flops of the window's keyframes over the time of its calls, as a share of the
float32 peak (%)."""

from benchmark.harness.readers import mfu as read  # noqa: F401
