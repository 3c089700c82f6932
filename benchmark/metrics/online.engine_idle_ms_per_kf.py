"""Device-idle time under the engine's and graphs' spans (dvmvs.engine.*,
dvmvs.graph.*), per keyframe read back (ms)."""

from benchmark.harness.spans import online_engine_idle_ms_per_kf as read  # noqa: F401
