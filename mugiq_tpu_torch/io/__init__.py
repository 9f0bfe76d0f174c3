"""Gauge input (NERSC, ILDG), eigenvector checkpoints, loop-data output."""
