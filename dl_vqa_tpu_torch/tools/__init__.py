"""Measurement scripts for the port's kernels; they run on a machine with a GPU."""
