"""Baseline depth estimators (counterpart of dvmvs_tpu/baselines/).

MVDepthNet, GP-MVS, DPSNet and DELTAS as ``nn.Module``s behind the
``DepthEstimator`` protocol: each consumes the same keyframe-index files,
preprocessing and result format as the main system
(``apps/run_testing_baseline.py``), so the metrics compare directly. Every
module carries the reference implementation's state-dict names, and
``utils/baseline_weights.py`` maps the JAX package's Flax variables onto
them. Importing a baseline's module registers it in ``BASELINE_REGISTRY``.
"""

from dvmvs_tpu_torch.baselines.registry import (
    BASELINE_REGISTRY,
    DepthEstimator,
    register_baseline,
)
