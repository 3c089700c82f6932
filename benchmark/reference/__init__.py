"""The plain reference the benchmark holds the port to: DeepVideoMVS's
FusionNet and PairNet, the gather plane sweep and the loops around them,
in plain PyTorch. It imports nothing of the port."""
