"""Errors and profiling helpers of the PyTorch port."""
