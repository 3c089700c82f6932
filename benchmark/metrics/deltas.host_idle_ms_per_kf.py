"""Device-idle time under the baseline estimator's and graphs' spans
(dvmvs.baseline.*, dvmvs.graph.*), per depth read back (ms)."""

from benchmark.harness.deltas import host_idle_ms_per_kf as read  # noqa: F401
