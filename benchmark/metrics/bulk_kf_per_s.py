"""Keyframes of the window's evaluate_scene_batched calls over the time of those calls."""

from benchmark.harness.readers import keyframes_per_call_s as read  # noqa: F401
