"""Operators: hand-written GPU kernels live under `ops.kernels`."""
