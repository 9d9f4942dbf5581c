"""The float64 NumPy oracle (ground truth of the loss)."""
