"""95th percentile of the host wall time of encode_and_predict over every
keyframe of the window (ms)."""

from benchmark.harness.readers import keyframe_ms_p95 as read  # noqa: F401
