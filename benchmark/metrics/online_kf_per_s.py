"""Keyframes predicted over the whole window, rejected frames and scene starts included."""

from benchmark.harness.readers import keyframes_per_window_s as read  # noqa: F401
