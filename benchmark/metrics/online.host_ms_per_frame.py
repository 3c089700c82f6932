"""Host time of the window outside encode_and_predict, per frame streamed (ms)."""

from benchmark.harness.readers import host_ms_per_frame as read  # noqa: F401
