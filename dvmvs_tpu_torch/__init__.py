"""dvmvs_tpu_torch: the PyTorch/CUDA port of dvmvs_tpu for NVIDIA Hopper.

The online pairnet/fusionnet step (apps/run_testing_online.py ->
utils/keyframe_buffer.py -> apps/engine.py) runs on one GPU; the plane-sweep
cost volume is a hand-written CUDA kernel (csrc/plane_sweep.cu) with a plain
PyTorch version for CPU tensors. Module names follow dvmvs_tpu, which stays
the numerical reference. This package imports torch and never jax.
"""

__version__ = "0.1.0"
