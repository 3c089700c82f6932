"""Window time over the optimizer steps completed in it (ms)."""

from benchmark.harness.readers import step_ms as read  # noqa: F401
