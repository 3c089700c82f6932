"""Graph and kernel launches inside encode_and_predict, per keyframe (traced)."""

from benchmark.harness.readers import launches_per_keyframe as read  # noqa: F401
