"""NCHW PyTorch modules of pairnet and fusionnet."""
