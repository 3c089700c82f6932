"""Host-side helpers: keyframe buffer, metrics, results, weight bridge."""
