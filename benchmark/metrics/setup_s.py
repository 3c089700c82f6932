"""Set-up seconds: process start to the window's start (host clock)."""

from benchmark.harness.readers import setup_s as read  # noqa: F401
