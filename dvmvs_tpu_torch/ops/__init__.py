"""Geometry, sampling, warping and the plane-sweep cost volume."""
