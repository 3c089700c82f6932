"""Inference engine and the online loop."""
