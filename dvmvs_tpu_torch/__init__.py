"""dvmvs_tpu_torch: the PyTorch/CUDA port of dvmvs_tpu for NVIDIA Hopper.

The online pairnet/fusionnet step (apps/run_testing_online.py ->
utils/keyframe_buffer.py -> apps/engine.py) and training (apps/run_training.py
-> parallel/train.py -> models/training_heads.py) run on one GPU; the
plane-sweep cost volume and its backward are hand-written CUDA kernels
(csrc/plane_sweep.cu, csrc/plane_sweep_bwd.cu) with plain PyTorch versions
for CPU tensors. Module names follow dvmvs_tpu, which stays
the numerical reference. This package imports torch and never jax.
"""

__version__ = "0.1.0"
