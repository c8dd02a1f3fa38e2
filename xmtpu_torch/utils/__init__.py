"""Errors, the device rule, logging and profiling of the PyTorch port."""
