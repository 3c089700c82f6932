"""Device-idle time under the bulk driver's spans (dvmvs.bulk.*), per chunk read back (ms)."""

from benchmark.harness.spans import bulk_driver_idle_ms_per_chunk as read  # noqa: F401
