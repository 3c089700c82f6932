"""Self time of the keyframe buffer's span (dvmvs.stream.buffer), per frame streamed (ms)."""

from benchmark.harness.spans import buffer_ms_per_frame as read  # noqa: F401
