"""Summed bound of the traced DLT solves over the dlt_solve kernels' device time (%)."""

from benchmark.harness.deltas import dlt_roofline as read  # noqa: F401
