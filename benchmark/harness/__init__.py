"""The yardstick: finding a cell's files, traffic, weights, flops, traces,
rooflines, the checks and the metric readers."""
