"""Training data: crawler, preprocessing, dataset and input pipeline (NumPy)."""
