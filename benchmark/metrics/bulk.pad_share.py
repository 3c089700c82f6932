"""Keyframe slots computed by predict_pair_steps that no keyframe asked for (%)."""

from benchmark.harness.readers import pad_share as read  # noqa: F401
