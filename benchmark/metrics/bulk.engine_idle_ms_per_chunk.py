"""Device-idle time under the engine's and graphs' spans (dvmvs.engine.*,
dvmvs.graph.*), per chunk read back (ms)."""

from benchmark.harness.spans import bulk_engine_idle_ms_per_chunk as read  # noqa: F401
