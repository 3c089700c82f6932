"""Graph captures and bank allocations (dvmvs.graph.capture and
dvmvs.engine.bank_alloc spans) in the traced window, per scene."""

from benchmark.harness.spans import rebuilds_per_scene as read  # noqa: F401
