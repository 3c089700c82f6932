"""The benchmark of the PyTorch/CUDA port (``dvmvs_tpu_torch``); see ``run.py``."""
